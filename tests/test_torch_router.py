"""The port's fleet Router against sav_tpu's, on the CPU: each scenario is
one script (fake transport, fake views, fake clocks, ``workers=0`` so
``admit`` dispatches inline) run once through each Router; everything it
observes — routing choices, admission sheds, drains and resumes, down
marks and recovery, reroutes and retries, the exceptions raised, the span
ring's records (trace ids masked), ``stats()``, ``live()``, ``summary()``,
``kind=router`` beats, the exported router trace, the written summary and
the shadow's scoring and alerts — must be equal. ``projected_wait_s`` is
compared on a grid. The shadow worker is a thread on both sides, so the
shadow scenarios wait until it has scored, then compare.

The import proof: in a fresh interpreter the router, fleet, telemetry,
quality fold, rollup, alerts, fleet readers and supervisor import neither
torch nor numpy.

Every comparison is exact equality.
"""

import gzip
import itertools
import json
import os
import subprocess
import sys
import threading
import time
import types

import pytest

import sav_tpu.obs.alerts as jax_alerts
import sav_tpu.obs.fleet as jax_obs_fleet
import sav_tpu.serve.batcher as jax_batcher
import sav_tpu.serve.router as jax_router
import sav_tpu.serve.telemetry as jax_telemetry
import sav_tpu_torch.obs.alerts as alerts
import sav_tpu_torch.obs.fleet as obs_fleet
import sav_tpu_torch.serve.batcher as batcher
import sav_tpu_torch.serve.router as router_mod
import sav_tpu_torch.serve.telemetry as telemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _side(router, batch, tele, fleet, alert):
    return types.SimpleNamespace(
        Router=router.Router, projected_wait_s=router.projected_wait_s,
        ReplicaTransportError=router.ReplicaTransportError,
        ReplicaShedError=router.ReplicaShedError, RouterShedError=router.RouterShedError,
        read_router_summary=router.read_router_summary,
        DeadlineInfeasibleError=batch.DeadlineInfeasibleError,
        QueueFullError=batch.QueueFullError, ServeClosedError=batch.ServeClosedError,
        router_views=tele.router_views, read_router_beats=fleet.read_router_beats,
        alerts=alert,
    )


PORT = _side(router_mod, batcher, telemetry, obs_fleet, alerts)
JAX = _side(jax_router, jax_batcher, jax_telemetry, jax_obs_fleet, jax_alerts)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def sleep(self, s):
        # At least a nanosecond: a remainder below the clock's ulp would
        # otherwise leave it where it was, and a poll loop would never end.
        self.t += max(float(s), 1e-9)


class FakeTransport:
    """Per-rank scripted behaviour: a result dict, an exception (built from
    the side's own classes by a factory), or a callable. Records every send
    as (rank, meta without the trace id)."""

    def __init__(self, behaviour, clock=None, send_s=0.0):
        self.behaviour = dict(behaviour)
        self.sends = []
        self.clock, self.send_s = clock, send_s

    def send(self, rank, payload, meta, timeout_s):
        self.sends.append((rank, {k: v for k, v in meta.items() if k != "trace"}))
        if self.clock is not None:
            self.clock.sleep(self.send_s)  # an exchange takes time
        b = self.behaviour[rank]
        if callable(b):
            b = b()
        if isinstance(b, BaseException):
            raise b
        return dict(b)


class StampingTransport:
    """The TcpTransport seam: stamps connect/sent at scripted instants."""

    supports_stamps = True

    def __init__(self, clock, *, connect_s=0.002, exchange_s=0.010):
        self.clock = clock
        self.connect_s = connect_s
        self.exchange_s = exchange_s
        self.sends = 0

    def send(self, rank, payload, meta, timeout_s, stamp_fn=None):
        self.sends += 1
        if stamp_fn is not None:
            stamp_fn("connect")
        self.clock.sleep(self.connect_s)
        if stamp_fn is not None:
            stamp_fn("sent")
        self.clock.sleep(self.exchange_s)
        return {"ok": True, "pred": rank}


def _view(**kw):
    base = {"queued": 0, "inflight": 0, "est_step_s": 0.01, "p99_ms": 10.0,
            "last_beat_unix": 100.0, "beats": 5, "final": False, "suspect": False,
            "pid": 1000}
    base.update(kw)
    return base


def _make(side, views, transport, clock=None, **kw):
    clock = clock or FakeClock()
    defaults = dict(views_fn=lambda: views, max_batch=2, default_step_s=0.01,
                    default_deadline_s=1.0, refresh_secs=0.0, workers=0, clock=clock,
                    wall_clock=FakeClock(100.0), sleep=clock.sleep, perf=FakeClock(0.0))
    defaults.update(kw)
    return side.Router(transport, **defaults), clock


def _mask(value):
    """A record with the router's trace ids (``r<pid>-<seq>``) masked."""
    if isinstance(value, dict):
        return {k: ("<rid>" if k == "rid" else _mask(v)) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_mask(v) for v in value]
    return value


def _admit(side, router, *args, **kw):
    """What one admit did: the result, or the exception's class and text."""
    try:
        return {"result": router.admit(*args, **kw).result(timeout=0)}
    except (side.QueueFullError, side.ServeClosedError, side.ReplicaTransportError,
            RuntimeError) as e:
        return {"raised": type(e).__name__, "message": str(e)}


def _observe(router, clock=None):
    out = {"stats": router.stats(), "summary": router.summary(), "live": router.live(),
           "ring": _mask(router._ring.records())}
    if clock is not None:
        out["clock"] = clock()
    return out


# ------------------------------------------------------------- scenarios


def route_min_wait(side, tmp):
    views = {0: _view(queued=8, est_step_s=0.1), 1: _view(queued=0, est_step_s=0.1),
             2: _view(queued=0, est_step_s=0.01)}
    router, _ = _make(side, views, FakeTransport({r: {"ok": True} for r in range(3)}))
    out = {"first": router.route(), "drained": router.drain(2), "second": router.route()}
    views[1]["suspect"] = True
    router.refresh()
    out["third"] = router.route()
    out["resume"] = router.resume(2)
    out["fourth"] = router.route()
    out.update(_observe(router))
    router.close()
    return out


def admission_shed(side, tmp):
    views = {0: _view(queued=20, inflight=2, est_step_s=0.2),
             1: _view(queued=40, inflight=1, est_step_s=0.2)}
    router, _ = _make(side, views, FakeTransport({0: {"ok": True}, 1: {"ok": True}}))
    out = {"infeasible": _admit(side, router, b"x"),
           "fits": _admit(side, router, b"x", deadline_s=10.0)}
    router.close()
    out.update(_observe(router))
    out["closed"] = _admit(side, router, b"x")
    return out


def failover_reroute_recover(side, tmp):
    views = {0: _view(est_step_s=0.001), 1: _view(est_step_s=0.1)}
    transport = FakeTransport({0: side.ReplicaTransportError("connection reset"),
                               1: {"ok": True, "pred": 7}})
    router, _ = _make(side, views, transport)
    out = {"served": _admit(side, router, b"x"), "after": _observe(router)}
    views[0]["last_beat_unix"] = 105.0
    transport.behaviour[0] = {"ok": True, "pred": 0}
    router.refresh()
    out["recovered"] = _observe(router)
    out["route"] = router.route()
    out["sends"] = transport.sends
    router.close()
    return out


def all_down_sheds(side, tmp):
    views = {0: _view(), 1: _view()}
    transport = FakeTransport({0: side.ReplicaTransportError("dead"),
                               1: side.ReplicaTransportError("dead")})
    router, clock = _make(side, views, transport)
    out = {"shed": _admit(side, router, b"x", deadline_s=0.25)}
    out.update(_observe(router, clock))
    router.close()
    return out


def straggler_drain_resume(side, tmp):
    views = {0: _view(p99_ms=10.0), 1: _view(p99_ms=10.5), 2: _view(p99_ms=200.0)}
    router, _ = _make(side, views, FakeTransport({r: {"ok": True} for r in range(3)}))
    router.refresh()
    out = {"drained": _observe(router), "route": router.route()}
    views[2]["p99_ms"] = 11.0
    router.refresh()
    out["resumed"] = _observe(router)
    router.close()
    return out


def never_drains_last(side, tmp):
    views = {0: _view(p99_ms=500.0), 1: _view(p99_ms=10.0)}
    router, _ = _make(side, views, FakeTransport({0: {"ok": True}, 1: {"ok": True}}))
    views[1]["suspect"] = True
    router.refresh()
    out = {"drain": router.drain(0), "route": router.route()}
    out.update(_observe(router))
    router.close()
    return out


def replica_shed_retries(side, tmp):
    calls = {"n": 0}

    def shed_then_ok():
        calls["n"] += 1
        if calls["n"] < 3:
            raise side.ReplicaShedError("replica queue full")
        return {"ok": True}

    router, clock = _make(side, {0: _view()}, FakeTransport({0: shed_then_ok}))
    out = {"served": _admit(side, router, b"x", deadline_s=5.0), "calls": calls["n"]}
    calls["n"] = -10**6  # sheds until the deadline
    out["shed"] = _admit(side, router, b"y", deadline_s=0.3)
    out.update(_observe(router, clock))
    router.close()
    return out


def app_error_fails_request(side, tmp):
    router, _ = _make(side, {0: _view()},
                      FakeTransport({0: RuntimeError("replica 0 failed the request")}))
    out = {"failed": _admit(side, router, b"x")}
    out.update(_observe(router))
    router.close()
    return out


def restarted_replica_clears_outstanding(side, tmp):
    views = {0: _view(last_beat_unix=None), 1: _view(queued=3, est_step_s=None)}
    router, _ = _make(side, views,
                      FakeTransport({0: {"ok": True}, 1: {"ok": True}, 2: {"ok": True}}),
                      ranks=[0, 1, 2])
    out = {"seeded": _observe(router), "route": router.route()}
    views[1]["pid"] = 2000  # a restart under the same rank
    views[1]["est_step_s"] = 0.005
    router.refresh()
    out["restarted"] = _observe(router)
    out["served"] = [_admit(side, router, b"x") for _ in range(3)]
    views[0]["final"] = True
    router.refresh()
    out["final"] = _observe(router)
    router.close()
    return out


def seeded_mixed_script(side, tmp):
    """A longer seeded script: random views, behaviours and deadlines."""
    import random

    rng = random.Random(7)
    views = {r: _view(queued=rng.randint(0, 6), est_step_s=rng.choice([0.01, 0.02, 0.05]),
                      p99_ms=rng.choice([10.0, 11.0, 60.0])) for r in range(4)}
    behaviours = [lambda r: {"ok": True, "pred": r},
                  lambda r: side.ReplicaTransportError(f"replica {r} reset"),
                  lambda r: side.ReplicaShedError(f"replica {r} full")]
    clock = FakeClock()
    # Each exchange takes 2 ms: a replica whose beats stay fresh while its
    # transport fails is marked down, recovered by the next refresh and
    # tried again until the deadline passes.
    transport = FakeTransport({r: {"ok": True, "pred": r} for r in range(4)}, clock, 0.002)
    router, clock = _make(side, views, transport, clock=clock, default_deadline_s=0.5)
    steps = []
    for i in range(60):
        rank = rng.randrange(4)
        transport.behaviour[rank] = rng.choices(behaviours, weights=[8, 1, 1])[0](rank)
        if rng.random() < 0.2:
            views[rank].update(queued=rng.randint(0, 12), p99_ms=rng.choice([10.0, 90.0]),
                               last_beat_unix=100.0 + i, suspect=rng.random() < 0.1)
        steps.append({"admit": _admit(side, router, b"x",
                                      deadline_s=rng.choice([0.05, 0.3, 1.0])),
                      "route": router.route()})
        clock.sleep(0.01)
    out = {"steps": steps, "sends": transport.sends}
    out.update(_observe(router, clock))
    router.close()
    return out


def traces_heartbeats_and_export(side, tmp):
    clock = FakeClock()
    router, _ = _make(side, {0: _view(), 1: _view(est_step_s=0.5)},
                      StampingTransport(clock), clock=clock, log_dir=tmp)
    out = {"served": [_admit(side, router, b"x", deadline_s=1.0) for _ in range(3)]}
    clock.sleep(0.05)
    out["beat"] = router.router_beat()
    out.update(_observe(router))
    router.close()
    beats = side.read_router_beats(tmp)
    out["beats"] = [{k: v for k, v in b.items() if k != "host"} for b in beats]
    with gzip.open(os.path.join(tmp, "serve_traces", "requests_router.trace.json.gz")) as f:
        out["export"] = _mask_export(json.load(f))
    out["written"] = side.read_router_summary(tmp)
    return out


def _mask_export(doc):
    text = json.dumps(doc)
    import re

    return json.loads(re.sub(r'r\d+-\d+', "<rid>", text))


def plain_transport_stamps(side, tmp):
    router, _ = _make(side, {0: _view()}, FakeTransport({0: {"ok": True}}))
    out = {"served": _admit(side, router, b"x")}
    out.update(_observe(router))
    router.close()
    return out


def views_from_heartbeat_files(side, tmp):
    """The router fed by ``router_views`` over real serve beats on disk:
    replica 1 went silent, so it is suspect and down."""
    os.makedirs(os.path.join(tmp, "fleet"), exist_ok=True)
    for proc, times, kw in ((0, range(11), {}), (1, range(4), {"queued": 3, "step": 0.2})):
        with open(os.path.join(tmp, "fleet", f"proc_{proc}.jsonl"), "w") as f:
            for t in times:
                f.write(json.dumps({
                    "schema": 1, "kind": "serve", "proc": proc, "procs": 2, "t": float(t),
                    "pid": 1000 + proc, "queued": kw.get("queued", 0), "inflight": 0,
                    "requests": 10, "shed": 0, "dtype": "bfloat16",
                    "w": {"p99_ms": 12.0, "step_s_avg": kw.get("step", 0.01),
                          "queue_depth_last": 0, "throughput_rps": 50.0},
                    "slo": {"hit_frac": 1.0, "burn_rate": 0.0, "burning": False},
                }) + "\n")
    router, _ = _make(side, {}, FakeTransport({0: {"ok": True}, 1: {"ok": True}}),
                      views_fn=lambda: side.router_views(tmp, now=10.0))
    out = {"served": _admit(side, router, b"x"), "route": router.route()}
    out.update(_observe(router))
    router.close()
    return out


def _shadow(side, tmp, behaviour, dtypes, requests, *, log_dir=None, ticks=False):
    views = {0: _view(dtype=dtypes[0]), 1: _view(dtype=dtypes[1])}
    transport = FakeTransport(behaviour)
    router, _ = _make(side, views, transport, default_deadline_s=5.0, shadow_rank=1,
                      shadow_frac=1.0, log_dir=log_dir)
    served = []
    for i in range(requests):
        served.append(_admit(side, router, b"img"))
        deadline = time.monotonic() + 10.0
        while True:
            snap = router._shadow_scorer.snapshot()
            if snap["scored"] + snap["shed"] >= i + 1 or time.monotonic() > deadline:
                break
            time.sleep(0.005)
        if ticks:
            router._quality_tick()
    router.close()
    out = {"served": served, "route": router.route(), "sends": transport.sends}
    out.update(_observe(router))
    if log_dir:
        out["alerts"] = [{k: v for k, v in e.items() if k != "t"}
                         for e in side.alerts.read_alerts(log_dir)]
        out["episodes"] = {k: {kk: vv for kk, vv in v.items() if kk != "last_t"}
                           for k, v in side.alerts.episodes(side.alerts.read_alerts(log_dir)).items()}
    return out


def shadow_agreement(side, tmp):
    result = {"ok": True, "pred": 7, "logits": [0.0, 1.0, 4.0]}
    return _shadow(side, tmp, {0: result, 1: result}, ("bfloat16", "bfloat16"), 3)


def shadow_int8_envelope(side, tmp):
    return _shadow(side, tmp, {0: {"ok": True, "pred": 2, "logits": [0.0, 2.0, 10.0]},
                               1: {"ok": True, "pred": 2, "logits": [0.0, 2.0, 10.8]}},
                   ("bfloat16", "int8"), 2)


def shadow_disagreement_alert(side, tmp):
    return _shadow(side, tmp, {0: {"ok": True, "pred": 7, "logits": [0.0, 1.0, 4.0]},
                               1: {"ok": True, "pred": 3, "logits": [9.0, 1.0, 0.0]}},
                   ("bfloat16", "bfloat16"), 3, log_dir=tmp, ticks=True)


def shadow_transport_failure(side, tmp):
    return _shadow(side, tmp, {0: {"ok": True, "pred": 7},
                               1: side.ReplicaTransportError("shadow down")},
                   ("bfloat16", "bfloat16"), 2)


SCENARIOS = [route_min_wait, admission_shed, failover_reroute_recover, all_down_sheds,
             straggler_drain_resume, never_drains_last, replica_shed_retries,
             app_error_fails_request, restarted_replica_clears_outstanding,
             seeded_mixed_script, traces_heartbeats_and_export, plain_transport_stamps,
             views_from_heartbeat_files, shadow_agreement, shadow_int8_envelope,
             shadow_disagreement_alert, shadow_transport_failure]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_router_matches_sav_tpus_under_the_same_script(scenario, tmp_path):
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    got = scenario(PORT, str(tmp_path / "port"))
    want = scenario(JAX, str(tmp_path / "jax"))
    assert json.loads(json.dumps(got, default=str)) == json.loads(json.dumps(want, default=str))


def test_the_scenarios_exercise_what_they_name(tmp_path):
    """The parity above compares like with like; these pin that the script
    reached the behaviour each scenario is named for."""
    out = failover_reroute_recover(PORT, str(tmp_path))
    assert out["after"]["stats"]["rerouted"] == 1 and out["sends"][:2] == [(0, {}), (1, {})]
    assert out["after"]["stats"]["replicas"]["0"]["state"] == "down"
    assert out["recovered"]["stats"]["replicas"]["0"]["state"] == "active"
    assert all_down_sheds(PORT, str(tmp_path))["shed"]["raised"] == "RouterShedError"
    assert admission_shed(PORT, str(tmp_path))["infeasible"]["raised"] == "DeadlineInfeasibleError"
    drained = straggler_drain_resume(PORT, str(tmp_path))
    assert drained["drained"]["stats"]["replicas"]["2"]["state"] == "draining"
    assert drained["resumed"]["stats"]["replicas"]["2"]["state"] == "active"
    assert replica_shed_retries(PORT, str(tmp_path))["calls"] == 3
    shadow = shadow_disagreement_alert(PORT, str(tmp_path / "shadow"))
    assert shadow["summary"]["shadow"]["breach"] == 3
    assert shadow["episodes"]["shadow-agreement"]["fired"] == 1
    assert shadow["episodes"]["shadow-agreement"]["resolved"] == 1
    mixed = seeded_mixed_script(PORT, str(tmp_path))
    assert mixed["stats"]["rerouted"] > 0 and mixed["stats"]["completed"] > 0
    assert mixed["summary"]["shed"] > 0


def test_a_shadow_rank_never_leaves_the_fleet_without_a_live_replica():
    """A fault of sav_tpu's router, repaired in the port: the straggler
    attribution and the last-active count included the shadow rank, so one
    live replica slower than an idle shadow (whose p99 is its mirrors') was
    drained and every request shed. The port leaves the shadow out of both:
    the live replica serves; sav_tpu's drains it (held here so the
    difference stays deliberate)."""
    outcomes = {}
    for name, side in (("port", PORT), ("jax", JAX)):
        views = {0: _view(p99_ms=900.0, dtype="bfloat16"),
                 1: _view(p99_ms=250.0, dtype="bfloat16")}
        router, _ = _make(side, views, FakeTransport({0: {"ok": True}, 1: {"ok": True}}),
                          shadow_rank=1, shadow_frac=1.0)
        router.refresh()
        outcomes[name] = (router.stats()["replicas"]["0"]["state"], router.route(),
                          sorted(_admit(side, router, b"x", deadline_s=0.2)))
        assert router.drain(0) is False or name == "jax"
        router.close()
    assert outcomes["port"] == ("active", 0, ["result"])
    assert outcomes["jax"] == ("draining", None, ["message", "raised"])
    # Three live replicas and a shadow: the straggler is still drained.
    views = {0: _view(p99_ms=10.0), 1: _view(p99_ms=10.5), 2: _view(p99_ms=200.0),
             3: _view(p99_ms=1.0)}
    router, _ = _make(PORT, views, FakeTransport({r: {"ok": True} for r in range(4)}),
                      shadow_rank=3, shadow_frac=1.0)
    router.refresh()
    assert [router.stats()["replicas"][str(r)]["state"] for r in range(4)] == [
        "active", "active", "draining", "active"]
    router.close()


def test_projected_wait_matches_sav_tpu_on_a_grid():
    for queued, inflight, fresh, max_batch, step in itertools.product(
            (-5, 0, 1, 7, 8, 9, 40), (-1, 0, 2), (0, 3, 16), (0, 1, 2, 8, 32),
            (-1.0, 0.0, 0.013, 0.2)):
        kw = dict(queued=queued, inflight=inflight, fresh_outstanding=fresh,
                  max_batch=max_batch, est_step_s=step)
        assert PORT.projected_wait_s(**kw) == JAX.projected_wait_s(**kw), kw


@pytest.mark.parametrize("side", [PORT, JAX], ids=["port", "jax"])
def test_close_fails_queued_and_stops_admission(side):
    """Threaded dispatch (one worker): a request a worker already sent
    completes, one still queued fails with ServeClosedError, and admission
    is closed — on both sides."""
    views = {0: _view()}
    release = threading.Event()

    class Blocking:
        sent = 0

        def send(self, rank, payload, meta, timeout_s):
            Blocking.sent += 1
            release.wait(10.0)
            return {"ok": True}

    router = side.Router(Blocking(), views_fn=lambda: views, workers=1, max_batch=2,
                         refresh_secs=3600.0, max_inflight=2)
    first = router.admit(b"a", deadline_s=30.0)
    deadline = time.monotonic() + 5.0
    while Blocking.sent == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    second = router.admit(b"b", deadline_s=30.0)
    with pytest.raises(side.QueueFullError):
        router.admit(b"c", deadline_s=30.0)  # past max_inflight
    threading.Timer(0.3, release.set).start()
    router.close()
    with pytest.raises(side.ServeClosedError):
        second.result(timeout=5.0)
    assert first.result(timeout=5.0) == {"ok": True}
    with pytest.raises(side.ServeClosedError):
        router.admit(b"d")
    assert router.stats()["rejected"] == 1


def test_shadow_validation_matches():
    for side in (PORT, JAX):
        with pytest.raises(ValueError, match="shadow_frac"):
            side.Router(FakeTransport({}), views_fn=lambda: {}, workers=0, shadow_rank=1,
                        shadow_frac=0.0)


def test_router_fleet_surface_imports_neither_torch_nor_numpy():
    """The router, the fleet, the serve telemetry, the quality fold, the
    rollup, the alerts, the fleet readers and the supervisor: stdlib only,
    so routing cannot sync a device value and the pool's parent never loads
    the backend."""
    code = (
        "import sys\n"
        "import sav_tpu_torch.serve.router, sav_tpu_torch.serve.fleet\n"
        "import sav_tpu_torch.serve.telemetry, sav_tpu_torch.serve.serve_fleet\n"
        "import sav_tpu_torch.obs.quality, sav_tpu_torch.obs.rollup\n"
        "import sav_tpu_torch.obs.alerts, sav_tpu_torch.obs.fleet\n"
        "import sav_tpu_torch.train.supervisor\n"
        "from sav_tpu_torch.serve import Router, ReplicaPool, TcpTransport\n"
        "print(json.dumps(['torch' in sys.modules, 'numpy' in sys.modules]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", "import json\n" + code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [False, False]


def test_threaded_dispatch_accounts_for_every_request():
    """32 dispatch workers (more than the cores), a 10 µs switch interval,
    2,000 requests: replica 2 resets its first connection (marked down, its
    request rerouted), replica 1 sheds every fifth exchange (retried). Every
    future resolves once, the router's counters add up, and nothing is left
    in flight."""
    import threading as _threading

    lock = _threading.Lock()
    calls = {0: 0, 1: 0, 2: 0}

    class Transport:
        def send(self, rank, payload, meta, timeout_s):
            with lock:
                calls[rank] += 1
                n = calls[rank]
            if rank == 2 and n == 1:
                raise PORT.ReplicaTransportError("connection reset")
            if rank == 1 and n % 5 == 0:
                raise PORT.ReplicaShedError("replica queue full")
            return {"ok": True, "pred": rank}

    # Replica 2 projects the shortest wait, so the first request goes there.
    views = {0: _view(est_step_s=0.001), 1: _view(est_step_s=0.001),
             2: _view(est_step_s=0.0005)}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        router = PORT.Router(Transport(), views_fn=lambda: views, workers=32, max_batch=4,
                             default_deadline_s=30.0, refresh_secs=0.01, max_inflight=4096)
        futures = [router.admit(b"x") for _ in range(2000)]
        results = [f.result(timeout=60.0) for f in futures]
        router.close()
    finally:
        sys.setswitchinterval(interval)
    stats = router.stats()
    assert len(results) == 2000 and all(r["ok"] for r in results)
    assert stats["completed"] == 2000 and stats["inflight"] == 0
    assert stats["rerouted"] == stats["transport_failures"] == 1
    replicas = stats["replicas"]
    assert replicas["2"]["state"] == "down"
    assert sum(r["completed"] for r in replicas.values()) == 2000
    assert replicas["1"]["failures"] == calls[1] // 5
    assert all(r["outstanding"] == 0 for r in replicas.values())
