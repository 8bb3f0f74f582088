"""The port's heartbeat rollups (``sav_tpu_torch.obs.rollup``) against
``sav_tpu.obs.rollup`` on the CPU: byte-identical heartbeat streams in two
log directories, rolled incrementally by each side's ``Roller`` through torn
tails, a compaction, a flush, a truncated stream and a lost cursor; after
every step the ``rollup_<res>.jsonl`` files are compared byte for byte and
the cursor and the roller's counters exactly. Then the readers and the
projections on the same lines. Every comparison is exact equality."""

import json
import os

import numpy as np
import pytest

from sav_tpu.obs import rollup as jax_rollup
from sav_tpu_torch.obs import rollup

T0 = 1_722_000_000.0


def _serve_beat(rng, proc, t, i):
    beat = {"schema": 1, "schema_version": 2, "kind": "serve", "proc": proc, "procs": 2,
            "t": round(t, 3), "host": "h", "pid": 10 + proc, "up_s": round(t - T0, 3),
            "requests": 40 * i, "batches": 5 * i, "shed": int(rng.integers(0, 3)),
            "w": {"window_s": 30.0, "requests": int(rng.integers(0, 400)),
                  "throughput_rps": round(float(rng.uniform(50, 900)), 2),
                  "queue_depth_last": int(rng.integers(0, 30)),
                  "queue_depth_avg": round(float(rng.uniform(0, 20)), 2),
                  "occupancy": round(float(rng.uniform(0.3, 1.0)), 4),
                  "overruns": int(rng.integers(0, 2)), "shed": 0, "step_s_avg": 0.004,
                  "p50_ms": round(float(rng.uniform(3, 9)), 3),
                  "p99_ms": round(float(rng.uniform(9, 60)), 3), "flag": True},
            "slo": {"target": 0.99, "burn_rate": round(float(rng.uniform(0, 3)), 4)},
            "capacity_rps": round(float(rng.uniform(800, 1200)), 2),
            "queued": int(rng.integers(0, 30)), "inflight": int(rng.integers(0, 3)),
            "rejected": int(rng.integers(0, 2))}
    if i % 5 == 0:
        beat["w"]["p99_ms"] = None
        beat["slo"]["burn_rate"] = None
    if i % 4 == 0:
        beat["quality"] = {"n": 64, "churn": round(float(rng.uniform(0, 1)), 3),
                           "pairs": {"a": 1}}
    return beat


def _router_beat(rng, t, i):
    return {"kind": "router", "t": round(t, 3),
            "w": {"window_s": 30.0, "p99_ms": round(float(rng.uniform(10, 80)), 3),
                  "queue_depth_last": int(rng.integers(0, 9))},
            "completed": 100 * i, "throughput_rps": round(float(rng.uniform(100, 2000)), 2),
            "inflight": int(rng.integers(0, 9)), "router_overhead_ms": 0.25,
            "shadow": {"agree": round(float(rng.uniform(0.9, 1.0)), 4), "breach": 0}}


def _train_beat(rng, t, i):
    return {"kind": "hb", "t": round(t, 3), "step": 10 * i,
            "loss": round(float(rng.uniform(1, 7)), 4),
            "images_per_sec": round(float(rng.uniform(1000, 2000)), 1)}


def _chunks(seed: int, n_chunks: int = 4, per_chunk: int = 30) -> list:
    """Per chunk, the bytes each stream gains: beats 3.7-4.3 s apart for
    three replicas (one lags), the router and a training stream, with
    event/final lines, a garbage line and a torn tail that the next chunk
    completes."""
    rng = np.random.default_rng(seed)
    clocks = {"proc_0.jsonl": T0, "proc_1.jsonl": T0 + 1.3, "proc_2.jsonl": T0 - 40.0,
              "router.jsonl": T0 + 0.4}
    counters = dict.fromkeys(clocks, 0)
    pending_tail = dict.fromkeys(clocks, b"")
    chunks = []
    for c in range(n_chunks):
        chunk = {}
        for name in clocks:
            lines = [pending_tail[name]] if pending_tail[name] else []
            pending_tail[name] = b""
            for _ in range(per_chunk):
                counters[name] += 1
                i = counters[name]
                clocks[name] += float(rng.uniform(3.7, 4.3))
                t = clocks[name]
                if name == "router.jsonl":
                    record = _router_beat(rng, t, i)
                elif name == "proc_2.jsonl":
                    record = _train_beat(rng, t, i)
                else:
                    record = _serve_beat(rng, int(name[5]), t, i)
                lines.append(json.dumps(record).encode() + b"\n")
                if i % 23 == 0:
                    lines.append(json.dumps({"kind": "event", "event": "x", "t": t}).encode()
                                 + b"\n")
                if i % 31 == 0:
                    lines.append(b'{"kind": "serve", "t": \n')  # a glued, torn line
            if c < n_chunks - 1 and name != "router.jsonl":
                tail = json.dumps(_serve_beat(rng, 0, clocks[name] + 1.0, 999)).encode() + b"\n"
                cut = len(tail) // 2
                lines.append(tail[:cut])
                pending_tail[name] = tail[cut:]
            chunk[name] = b"".join(lines)
        chunks.append(chunk)
    return chunks


def _append(log_dir, chunk):
    root = os.path.join(log_dir, "fleet")
    os.makedirs(root, exist_ok=True)
    for name, data in chunk.items():
        with open(os.path.join(root, name), "ab") as f:
            f.write(data)


def _same_state(port_dir, jax_dir, port_roller, jax_roller):
    assert port_roller.stats() == jax_roller.stats()
    for res in rollup.RESOLUTIONS:
        paths = [rollup.rollup_path(d, res) for d in (port_dir, jax_dir)]
        assert os.path.exists(paths[0]) == os.path.exists(paths[1])
        if os.path.exists(paths[1]):
            with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
                assert a.read() == b.read(), f"rollup_{res}.jsonl differs"
    cursors = []
    for d in (port_dir, jax_dir):
        with open(rollup.cursor_path(d)) as f:
            cursors.append(json.load(f))
    assert cursors[0] == cursors[1]


@pytest.mark.parametrize("seed", [0, 3])
def test_roller_files_and_cursor_equal_sav_tpus(tmp_path, seed):
    dirs = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    # A small retention (4 buckets a series) so the 10 s tier compacts.
    rollers = {"port": rollup.Roller(dirs["port"], retention_buckets=4),
               "jax": jax_rollup.Roller(dirs["jax"], retention_buckets=4)}
    chunks = _chunks(seed)
    for chunk in chunks:
        for d in dirs.values():
            _append(d, chunk)
        stats = {name: r.roll_once() for name, r in rollers.items()}
        assert stats["port"] == stats["jax"]
        _same_state(dirs["port"], dirs["jax"], rollers["port"], rollers["jax"])
        # A second roll with no new complete line closes no bucket (it reads
        # only the torn tail again).
        before = rollers["port"].buckets_closed
        for r in rollers.values():
            r.roll_once()
        assert rollers["port"].buckets_closed == before
        _same_state(dirs["port"], dirs["jax"], rollers["port"], rollers["jax"])
    assert rollers["port"].buckets_closed > 0
    for r in rollers.values():
        r.flush()
    _same_state(dirs["port"], dirs["jax"], rollers["port"], rollers["jax"])
    # The compaction ran: the 10 s tier holds fewer lines than were closed.
    ten = rollup.read_rollup(dirs["port"], 10)
    assert ten == jax_rollup.read_rollup(dirs["jax"], 10)
    series_count = len({(line["proc"], line["metric"]) for line in ten})
    assert len(ten) <= 4 * series_count * 2
    on_disk = 0
    for res in rollup.RESOLUTIONS:
        with open(rollup.rollup_path(dirs["port"], res)) as f:
            on_disk += sum(1 for _ in f)
    assert on_disk < rollers["port"].buckets_closed
    # A truncated stream makes both rebuild from byte 0.
    for d in dirs.values():
        path = os.path.join(d, "fleet", "proc_1.jsonl")
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[: len(data) // 3])
    for r in rollers.values():
        r.roll_once()
    _same_state(dirs["port"], dirs["jax"], rollers["port"], rollers["jax"])
    # A lost cursor: a full re-roll over the existing tiers, no double count.
    for d in dirs.values():
        os.remove(rollup.cursor_path(d))
        with open(rollup.cursor_path(d) + "x", "w") as f:
            f.write("{")
    for r in rollers.values():
        r.roll_once()
    _same_state(dirs["port"], dirs["jax"], rollers["port"], rollers["jax"])
    # A torn cursor is a lost one.
    for d in dirs.values():
        with open(rollup.cursor_path(d), "w") as f:
            f.write('{"v": 1, "streams"')
    for r in rollers.values():
        r.roll_once()
    _same_state(dirs["port"], dirs["jax"], rollers["port"], rollers["jax"])
    # The one-shot helper.
    for d in dirs.values():
        _append(d, {"proc_0.jsonl": json.dumps(_serve_beat(np.random.default_rng(1), 0,
                                                           T0 + 9000.0, 5)).encode() + b"\n"})
    assert rollup.roll(dirs["port"], flush=True) == jax_rollup.roll(dirs["jax"], flush=True)
    for res in rollup.RESOLUTIONS:
        with open(rollup.rollup_path(dirs["port"], res), "rb") as a, \
                open(rollup.rollup_path(dirs["jax"], res), "rb") as b:
            assert a.read() == b.read()


def test_readers_and_projections_equal_sav_tpus(tmp_path):
    log_dir = str(tmp_path)
    for chunk in _chunks(5, n_chunks=2):
        _append(log_dir, chunk)
    rollup.Roller(log_dir).roll_once()
    # A replayed append (a crash between append and cursor write): the
    # newest of the duplicate lines wins on both sides.
    path = rollup.rollup_path(log_dir, 10)
    with open(path) as f:
        first = json.loads(f.readline())
    first["mean"] = -1.0
    with open(path, "a") as f:
        f.write(json.dumps(first) + "\n")
        f.write('{"v": 1, "res": 10, "bucket": ')  # torn tail of a killed roller
    for res in rollup.RESOLUTIONS:
        for kw in ({}, {"metric": "p99_ms"}, {"proc": 1}, {"proc": "router"},
                   {"metric": "router_throughput_rps", "proc": "router"}):
            assert rollup.read_rollup(log_dir, res, **kw) == jax_rollup.read_rollup(
                log_dir, res, **kw)
    res, lines = rollup.finest_rollup(log_dir)
    assert (res, lines) == jax_rollup.finest_rollup(log_dir)
    assert res == 10 and any(line["mean"] == -1.0 for line in lines)
    assert rollup.finest_rollup(str(tmp_path / "empty")) == (None, [])
    metrics = sorted({line["metric"] for line in lines})
    assert {"p99_ms", "queue_depth", "capacity_rps", "burn_rate", "quality_churn",
            "router_shadow_agree", "loss", "router_overhead_ms"} <= set(metrics)
    for metric in metrics:
        for proc in (None, 0, 1, "router"):
            points = rollup.series(lines, metric, proc=proc)
            assert points == jax_rollup.series(lines, metric, proc=proc)
            assert rollup.robust_slope(points) == jax_rollup.robust_slope(points)
            for horizon in (0.0, 60.0, 600.0):
                assert (rollup.project_load(points, horizon_s=horizon)
                        == jax_rollup.project_load(points, horizon_s=horizon))


def test_slope_and_projection_edge_cases():
    rng = np.random.default_rng(11)
    cases = [[], [(1.0, 2.0)], [(1.0, 2.0), (1.0, 5.0)], [(0, 1), (10, 0)],
             [(float(t), float(v)) for t, v in zip(rng.uniform(0, 1e3, 150),
                                                   rng.normal(100, 30, 150))],
             [(t, 5.0 + 0.5 * t) for t in range(80)] + [(40.5, 1e6)],
             [("x", 1.0), (2.0, None), (3.0, 4.0), (5.0, 9.0)]]
    for points in cases:
        assert rollup.robust_slope(points) == jax_rollup.robust_slope(points)
        assert rollup.project_load(points) == jax_rollup.project_load(points)
    assert rollup.project_load([(0, 10.0), (10, 0.0)], horizon_s=100.0)["projected_rps"] == 0.0


def test_metrics_from_equals_sav_tpus():
    rng = np.random.default_rng(2)
    records = [_serve_beat(rng, 0, T0, i) for i in range(1, 9)]
    records += [_router_beat(rng, T0, 3), _train_beat(rng, T0, 4),
                {"kind": "final", "t": T0}, {"kind": "serve"}, {"kind": "serve", "w": 3},
                {"kind": "router", "router_overhead_ms": 1.0, "w": {"p99_ms": True}}, {}]
    for record in records:
        assert rollup.metrics_from(record) == jax_rollup.metrics_from(record)
