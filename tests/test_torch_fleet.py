"""The port's serve fleet on the CPU: the endpoint registry (its files read
by sav_tpu's readers too), ``TcpTransport`` against a local server speaking
the replica protocol, ``ReplicaPool.wait_ready`` failing fast on a dead
chain, the fleet CLI's flag vocabulary (sav_tpu's, plus ``--device``) and
its refusals, and one fleet smoke: ``python -m sav_tpu_torch.serve.bench
--replicas 2 --device cpu`` on a tiny ViT with replica 1 SIGKILLed mid-flood
— every admitted request completes or is honestly shed, none is lost, the
router reroutes, and the supervisor restarts the victim once
(``killed:SIGKILL``). Nothing here asserts on wall time or on which replica
was faster."""

import argparse
import json
import os
import socketserver
import subprocess
import sys
import threading
import time

import pytest

from sav_tpu.serve import fleet as jax_fleet
from sav_tpu_torch.serve import bench, serve_fleet
from sav_tpu_torch.serve.fleet import (
    ReplicaPool,
    TcpTransport,
    pid_alive,
    read_endpoint,
    read_endpoints,
    write_endpoint,
)
from sav_tpu_torch.serve.router import ReplicaShedError, ReplicaTransportError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_TIMEOUT_S = 300


def test_endpoint_registry_roundtrip_and_sav_tpus_readers(tmp_path):
    log_dir = str(tmp_path)
    path = write_endpoint(log_dir, 1, host="127.0.0.1", port=4242,
                          startup={"compiled_from_scratch": 0}, platform="cpu")
    assert path and os.path.exists(path)
    doc = read_endpoint(log_dir, 1)
    assert doc["port"] == 4242 and doc["pid"] == os.getpid() and doc["platform"] == "cpu"
    assert doc["startup"]["compiled_from_scratch"] == 0
    assert read_endpoints(log_dir) == {1: doc}
    assert jax_fleet.read_endpoints(log_dir) == {1: doc}
    jax_fleet.write_endpoint(str(tmp_path / "jax"), 1, host="127.0.0.1", port=4242,
                             pid=doc["pid"], startup={"compiled_from_scratch": 0},
                             platform="cpu")
    theirs = read_endpoint(str(tmp_path / "jax"), 1)
    assert {k: v for k, v in theirs.items() if k != "t"} == {
        k: v for k, v in doc.items() if k != "t"}
    assert pid_alive(os.getpid())
    reaped = subprocess.Popen([sys.executable, "-c", "pass"])
    reaped.wait()
    assert not pid_alive(reaped.pid) and not pid_alive(None)
    assert read_endpoint(log_dir, 7) is None


class _Replica(socketserver.ThreadingTCPServer):
    """A local server speaking the replica protocol: one JSON header line,
    the payload, one JSON reply line; ``mode`` picks the reply."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self):
        self.mode = "ok"
        self.headers = []
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                header = json.loads(self.rfile.readline())
                outer.headers.append(header)
                payload = self.rfile.read(int(header.get("nbytes", 0)))
                if outer.mode == "torn":
                    self.wfile.write(b'{"ok": tr')
                    return
                if outer.mode == "silent":
                    return
                reply = {"ping": {"ok": True, "pong": True, "rank": 0},
                         "ok": {"ok": True, "pred": len(payload), "rank": 0},
                         "shed": {"ok": False, "shed": True, "error": "queue full"},
                         "error": {"ok": False, "error": "boom"}}[
                    "ping" if header["op"] == "ping" else outer.mode]
                self.wfile.write(json.dumps(reply).encode() + b"\n")

        super().__init__(("127.0.0.1", 0), Handler)


def test_tcp_transport_against_a_local_server(tmp_path):
    log_dir = str(tmp_path)
    server = _Replica()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        transport = TcpTransport(log_dir)
        with pytest.raises(ReplicaTransportError, match="no endpoint registration"):
            transport.send(0, b"abc", {}, 1.0)
        write_endpoint(log_dir, 0, host="127.0.0.1", port=server.server_address[1])
        stamps = []
        reply = transport.send(0, b"abcd", {"trace": "r1-0", "want_logits": True}, 1.0,
                               stamp_fn=stamps.append)
        assert reply == {"ok": True, "pred": 4, "rank": 0} and stamps == ["connect", "sent"]
        header = server.headers[-1]
        assert header == {"trace": "r1-0", "want_logits": True, "op": "infer", "nbytes": 4,
                          "deadline_ms": 1000.0}
        assert transport.ping(0)["pong"] is True
        server.mode = "shed"
        with pytest.raises(ReplicaShedError, match="queue full"):
            transport.send(0, b"x", {}, 1.0)
        server.mode = "error"
        with pytest.raises(RuntimeError, match="boom"):
            transport.send(0, b"x", {}, 1.0)
        for mode, match in (("torn", "torn reply"), ("silent", "closed without a reply")):
            server.mode = mode
            with pytest.raises(ReplicaTransportError, match=match):
                transport.send(0, b"x", {}, 1.0)
    finally:
        server.shutdown()
        server.server_close()
    # The replica is gone: connection refused, the router's reroute cue.
    with pytest.raises(ReplicaTransportError):
        TcpTransport(log_dir).send(0, b"x", {}, 0.5)
    assert TcpTransport.supports_stamps is True


def test_pool_wait_ready_fails_fast_on_a_dead_chain(tmp_path):
    pool = ReplicaPool(replicas=1,
                       child_argv_fn=lambda r: [sys.executable, "-c", "import sys; sys.exit(2)"],
                       log_dir=str(tmp_path), max_restarts=1, backoff_base_s=0.05)
    pool.start()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="supervisor chain ended"):
        pool.wait_ready(timeout_s=120.0)
    assert time.monotonic() - t0 < 30.0
    status = pool.stop()
    assert status["ranks"]["0"]["exit_code"] not in (None, 0) and not status["ranks"]["0"]["alive"]


def test_flag_vocabulary_is_sav_tpus_and_round_trips(capsys):
    """Every flag sav_tpu's replica_argv forwards is declared by the port's
    add_model_args and by the bench's parser; the port's replica argv parses
    back with its values; the flags the port does not carry are refused with
    their ROADMAP item."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import serve_fleet as jax_serve_fleet
    finally:
        sys.path.pop(0)
    theirs, ours = argparse.ArgumentParser(), argparse.ArgumentParser()
    jax_serve_fleet.add_model_args(theirs)
    serve_fleet.add_model_args(ours)
    flags = {a.option_strings[0] for a in ours._actions if a.option_strings}
    their_flags = {a.option_strings[0] for a in theirs._actions if a.option_strings}
    assert flags == their_flags | {"--device", "--seed"}
    bench_flags = {a.option_strings[0] for a in bench.parser()._actions if a.option_strings}
    assert flags <= bench_flags
    ns = argparse.Namespace(model="vit_ti_patch16", num_classes=10, image_size=32,
                            backend="auto", max_batch=2, max_queue=64, deadline_ms=500.0,
                            heartbeat_secs=0.5, slo_target=0.99,
                            model_overrides='{"num_layers": 1}', buckets="1,2",
                            checkpoint=None, layout_preset=None, compilation_cache_dir=None,
                            attn_tune_cache=None, probe_every=5.0, seed=3, device="cpu")
    argv = serve_fleet.replica_argv(ns, 1, "/tmp/logs")
    assert argv[:3] == [sys.executable, "-m", "sav_tpu_torch.serve.serve_fleet"]
    ours.add_argument("--replica-rank", type=int)
    ours.add_argument("--log-dir")
    ours.add_argument("--manifest")
    parsed = ours.parse_args(argv[3:])
    assert (parsed.replica_rank, parsed.max_batch, parsed.buckets, parsed.probe_every,
            parsed.seed, parsed.device) == (1, 2, "1,2", 5.0, 3, "cpu")
    assert parsed.manifest.endswith("manifest-serve-r1.json")
    for flag, item in (("--layout-preset", "A9"), ("--compilation-cache-dir", "A10"),
                       ("--attn-tune-cache", "B follow-up 4")):
        with pytest.raises(SystemExit) as e:
            serve_fleet.main([flag, "x"])
        assert e.value.code == 2 and f"{flag} is not ported yet" in capsys.readouterr().err
        assert item in serve_fleet.NOT_CARRIED[flag[2:].replace("-", "_")]


def test_bench_validation_is_sav_tpus(capsys, monkeypatch):
    for argv, match in ((["--replicas", "2", "--quant-weights"], "--quant-weights"),
                        (["--shadow-rank", "1"], "--replicas >= 2"),
                        (["--replicas", "2", "--shadow-rank", "2"], "one of the replica"),
                        (["--noise-weights", "1:0.5"], "needs --replicas"),
                        (["--layout-preset", "tp2"], "A9")):
        with pytest.raises(SystemExit) as e:
            bench.main(argv)
        assert e.value.code == 2 and match in capsys.readouterr().err
    monkeypatch.setenv("SAV_LOCKWATCH", "1")
    with pytest.raises(SystemExit):
        bench.main(["--replicas", "2"])
    assert "A11" in capsys.readouterr().err


def test_cpu_fleet_smoke_loses_nothing_through_a_sigkill(tmp_path):
    """Two replicas of a tiny ViT on the CPU behind the router, a flood of
    48, replica 1 SIGKILLed after 40 % of it, a probe thread on each
    replica: every request completes or is shed honestly, none lost; the
    router rerouted what the dead replica held; the supervisor restarted it
    once, for the SIGKILL; after the restart the router routes to it again
    and its probe reproduces its predecessor's bits."""
    log_dir = str(tmp_path / "fleet")
    argv = [sys.executable, "-m", "sav_tpu_torch.serve.bench", "--replicas", "2",
            "--device", "cpu", "--model", "vit_ti_patch16", "--image-size", "32",
            "--num-classes", "10", "--model-overrides",
            '{"num_layers": 2, "embed_dim": 32, "num_heads": 2, "patch_shape": [8, 8]}',
            "--max-batch", "4", "--requests", "48", "--max-queue", "256",
            "--deadline-ms", "60000", "--log-dir", log_dir, "--chaos-kill-rank", "1",
            "--heartbeat-secs", "0.25", "--probe-every", "0.5", "--probe-requests", "8",
            "--chaos-recovery-timeout", "120"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=FLEET_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    accounting = line["accounting"]
    assert line["outcome"] == "ok" and accounting["lost"] == 0 and accounting["errors"] == 0
    assert accounting["completed"] + accounting["shed"] == accounting["offered"] == 48
    assert line["rerouted"] > 0 and line["transport_failures"] > 0
    assert line["restarts"] == 1
    assert line["pool"]["ranks"]["1"]["restart_reasons"] == ["killed:SIGKILL"]
    assert line["pool"]["ranks"]["0"]["restarts"] == 0
    chaos = line["chaos"]
    assert chaos["killed_pid"] and chaos["restored_unix"] >= chaos["kill_unix"]
    assert line["probe_routed"]["1"] > 0
    after = chaos["probe_after_restart"]
    assert after["probe_ok"] >= 1 and after["probe_mismatch"] == 0
    assert line["replica_platforms"] == {"0": "cpu", "1": "cpu"}
    assert line["probe_ok_frac"] == 1.0
    for rank in ("0", "1"):
        assert line["replica_runs"][rank]["outcome"] == "ok"
        assert line["pool"]["ranks"][rank]["exit_code"] == 0  # SIGTERM: a graceful leave
    assert line["parent_imported_torch"] is False


def test_a_fleet_whose_replica_cannot_start_fails_and_finalizes(tmp_path):
    """A replica that dies at startup (an unknown model) ends its supervisor
    chain; the bench fails fast naming the rank, and its fleet manifest is
    finalized with that outcome, not left running."""
    log_dir = str(tmp_path / "fleet")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "sav_tpu_torch.serve.bench", "--replicas", "1", "--device",
         "cpu", "--model", "no_such_model", "--log-dir", log_dir, "--max-restarts", "0",
         "--replica-startup-timeout", "120"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=FLEET_TIMEOUT_S)
    assert proc.returncode == 1
    assert "replica 0's supervisor chain ended" in proc.stderr
    (name,) = [f for f in os.listdir(log_dir) if f.startswith("manifest-fleet-")]
    with open(os.path.join(log_dir, name)) as f:
        doc = json.load(f)
    assert doc["kind"] == "serve_fleet" and doc["outcome"] == "error"
