"""The port's supervisor (sav_tpu_torch.train.supervisor) and the
``python -m sav_tpu_torch.train`` shell around it, against sav_tpu's, on
the CPU: the pure functions on shared inputs, supervised fake children, the
chain's accounting, the import contract, the exit codes, and one real
chain through a SIGKILL and a NaN batch that ends bit-equal to an
uninterrupted run over the skip-applied stream."""

import copy
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sav_tpu.obs import fleet as jax_fleet
from sav_tpu.obs import manifest as jax_manifest
from sav_tpu.obs import recorder as jax_recorder
from sav_tpu.train import supervisor as jax_sup
from sav_tpu_torch.data.synthetic import synth_resumable_iterator
from sav_tpu_torch.train import Checkpointer, TrainConfig, Trainer, main
from sav_tpu_torch.train import supervisor as sup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SAV_")}
    env["PYTHONPATH"] = ROOT
    env.update(extra)
    return env


# ------------------------------------------------------------ pure functions


@pytest.mark.parametrize("argv,extra", [
    (["--supervise", "--synth-data", "-c", "d", "--max-restarts", "3"], ()),
    (["--max-restarts=3", "--restart-backoff", "0.5", "--steps", "8", "--supervise"], ()),
    (["--skip-steps", "4,5", "--supervise", "--skip-steps=7", "-m", "x"], ("--skip-steps",)),
    (["--synth-data", "--restart-backoff"], ()),
])
def test_strip_supervisor_flags_equals_sav_tpus(argv, extra):
    assert (sup.strip_supervisor_flags(argv, extra_value_flags=extra)
            == jax_sup.strip_supervisor_flags(argv, extra_value_flags=extra))


@pytest.mark.parametrize("spec", [None, "", "5", "12, 3,,12", "0", "-1", "a,2"])
def test_parse_skip_steps_equals_sav_tpus(spec):
    try:
        want = jax_sup.parse_skip_steps(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(",")[0]):
            sup.parse_skip_steps(spec)
    else:
        assert sup.parse_skip_steps(spec) == want


@pytest.mark.parametrize("skips,start", [
    (set(), 0), ({3}, 0), ({3, 4, 9}, 0), ({6, 7}, 4), ({2}, 5), ({10}, 0)])
def test_skip_step_batches_equals_sav_tpus(skips, start):
    def stream():
        return ({"i": np.array([i])} for i in range(start + 1, start + 11))

    seen_ours, seen_theirs = [], []
    ours = [b["i"][0] for b in sup.skip_step_batches(
        stream(), skips, start_step=start, on_skip=lambda p, b: seen_ours.append(p))]
    theirs = [b["i"][0] for b in jax_sup.skip_step_batches(
        stream(), skips, start_step=start, on_skip=lambda p, b: seen_theirs.append(p))]
    assert ours == theirs and seen_ours == seen_theirs


@pytest.mark.parametrize("step,skips", [
    (0, set()), (5, {3}), (5, {6}), (5, {5, 6}), (12, {3, 7, 30}), (8, {10})])
def test_resume_schedule_position_equals_sav_tpus(step, skips):
    assert sup.resume_schedule_position(step, skips) == jax_sup.resume_schedule_position(
        step, skips)


@pytest.mark.parametrize("env_kind", ["off", "nan", "hang_once", "uint8"])
def test_chaos_wrap_equals_sav_tpus(tmp_path, env_kind):
    env = {"off": {}, "nan": {"SAV_CHAOS_NAN_STEP": "3"},
           "hang_once": {"SAV_CHAOS_HANG_STEP": "2", "SAV_CHAOS_HANG_SECS": "0.01",
                         "SAV_CHAOS_ONCE_DIR": str(tmp_path)},
           "uint8": {"SAV_CHAOS_NAN_STEP": "2"}}[env_kind]
    dtype = np.uint8 if env_kind == "uint8" else np.float32

    def stream():
        return ({"images": np.full((2, 2), i, dtype), "labels": np.array([i])}
                for i in range(1, 5))

    outs = []
    for module in (sup, jax_sup):
        wrapped = module.chaos_wrap(stream(), start_step=0, env=env)
        if env_kind == "uint8":
            with pytest.raises(ValueError, match="float batch"):
                list(wrapped)
            continue
        outs.append([b["images"].copy() for b in wrapped])
    for ours, theirs in zip(*outs):
        np.testing.assert_array_equal(ours, theirs)
    if env_kind == "hang_once":
        assert os.listdir(tmp_path) == ["chaos_hang_2.fired"]


def _checkpoint_dir(tmp_path, names):
    root = tmp_path / "ckpt"
    root.mkdir()
    for name in names:
        (root / name).mkdir()
    (root / "resume.json").write_text("{}")
    return str(root)


@pytest.mark.parametrize("names", [[], ["4", "12", "8"], [".16.tmp-0a1b", "4"], ["x", "07"]])
def test_latest_checkpoint_step_equals_sav_tpus(tmp_path, names):
    root = _checkpoint_dir(tmp_path, names)
    assert sup.latest_checkpoint_step(root) == jax_sup.latest_checkpoint_step(root)
    assert sup.latest_checkpoint_step(None) is None


def test_chain_readers_equal_sav_tpus(tmp_path):
    log = tmp_path / "fleet"
    log.mkdir()
    lines = [{"kind": "hb", "pid": 7, "step": 2}, {"kind": "event", "pid": 7},
             {"kind": "hb", "pid": 8, "step": 2}, {"kind": "hb", "pid": 7, "step": 4}]
    (log / "proc_0.jsonl").write_text("\n".join(map(json.dumps, lines)) + '\n{"kind": "h')
    for pid in (7, 8, 9):
        assert (sup.read_attempt_heartbeats(str(tmp_path), pid)
                == jax_sup.read_attempt_heartbeats(str(tmp_path), pid))
    for step, created in ((8, 10.0), (12, 30.0), (4, 20.0)):
        bundle = tmp_path / "incidents" / f"step_{step:08d}"
        bundle.mkdir(parents=True)
        (bundle / "incident.json").write_text(json.dumps({"step": step, "created_unix": created}))
    assert sup.newest_incident(str(tmp_path)) == jax_sup.newest_incident(str(tmp_path))
    assert sup.newest_incident(str(tmp_path))["step"] == 12
    assert sup.load_chain(str(tmp_path)) is None


def _chain_doc(**changes):
    doc = {"outcome": "ok", "metrics": {"goodput_frac": 0.9, "accounted_frac": 0.995},
           "notes": {"chain": {"attempts": [
               {"attempt": 1, "restart_reason": "hang", "exit_code": 4},
               {"attempt": 2, "restart_reason": None, "exit_code": 0}]}}}
    doc.update(changes)
    return doc


@pytest.mark.parametrize("doc,kw", [
    (_chain_doc(), {}), (_chain_doc(), {"expect_attempts": 3}),
    (_chain_doc(outcome="error"), {}),
    (_chain_doc(metrics={"goodput_frac": 0.5, "accounted_frac": 0.5}), {}),
    (_chain_doc(metrics={}), {}), (_chain_doc(notes={}), {}),
])
def test_verify_chain_equals_sav_tpus(doc, kw):
    assert sup.verify_chain(doc, **kw) == jax_sup.verify_chain(doc, **kw)


@pytest.mark.parametrize("code,outcome", [
    (0, None), (0, "ok"), (-9, None), (-15, "running"), (3, None), (4, None), (2, None),
    (1, "nonfinite"), (1, "oom"), (1, None), (4, "hang"), (1, "bogus")])
def test_classify_exit_equals_sav_tpus(code, outcome):
    assert sup.classify_exit(code, outcome) == jax_sup.classify_exit(code, outcome)


# -------------------------------------------------------------- Supervisor


def _fake_child(code, *args):
    return [sys.executable, "-c", code, *args]


_COUNTDOWN = (
    "import os, signal, sys, time\n"
    "time.sleep(0.3)\n"
    "p = sys.argv[1]\n"
    "n = int(open(p).read())\n"
    "open(p, 'w').write(str(n - 1))\n"
    "if n > 0:\n"
    "    {fail}\n"
)


@pytest.mark.parametrize("fail,max_restarts,want_rc,want_reasons", [
    ("sys.exit(3)", 5, 0, ["backend_unreachable", "backend_unreachable", None]),
    ("os.kill(os.getpid(), signal.SIGKILL)", 5, 0, ["killed:SIGKILL", "killed:SIGKILL", None]),
    ("sys.exit(4)", 1, 4, ["hang", "hang"]),
    ("sys.exit(2)", 5, 2, ["usage_error"]),
])
def test_supervisor_chains_equal_sav_tpus(tmp_path, fail, max_restarts, want_rc, want_reasons):
    """The same fake children under both supervisors: the same exit code,
    reasons and backoff; sav_tpu's verify_chain accepts the port's chain
    where it succeeded (the 0.3 s children make the supervisor's own
    bookkeeping a visible share of the wall, so 0.95 as sav_tpu's test)."""
    chains = {}
    for name, module in (("ours", sup), ("theirs", jax_sup)):
        log = tmp_path / name
        log.mkdir()
        (log / "n").write_text("2")
        sleeps = []
        supervisor = module.Supervisor(
            _fake_child(_COUNTDOWN.format(fail=fail), str(log / "n")), log_dir=str(log),
            checkpoint_dir=str(log / "ckpt"), max_restarts=max_restarts, backoff_base_s=0.5,
            sleep=sleeps.append)
        rc = supervisor.run()
        chains[name] = (rc, sleeps, module.load_chain(str(log)))
    (rc, sleeps, doc), (jax_rc, jax_sleeps, jax_doc) = chains["ours"], chains["theirs"]
    attempts = doc["notes"]["chain"]["attempts"]
    assert rc == jax_rc == want_rc and sleeps == jax_sleeps
    assert [a["restart_reason"] for a in attempts] == want_reasons == [
        a["restart_reason"] for a in jax_doc["notes"]["chain"]["attempts"]]
    assert doc["kind"] == "supervisor" and doc["outcome"] == jax_doc["outcome"]
    assert sorted(doc["metrics"]) == sorted(jax_doc["metrics"])
    assert (jax_sup.verify_chain(doc, min_accounted=0.95) == []) == (want_rc == 0)
    assert json.load(open(tmp_path / "ours" / "supervisor.json")) == jax_manifest.RunManifest.load(
        str(tmp_path / "ours" / "supervisor.json"))


def test_supervisor_request_stop_ends_a_serve_chain(tmp_path):
    supervisor = sup.Supervisor(_fake_child("import time; time.sleep(30)"), log_dir=str(tmp_path),
                                checkpoint_dir=None, serve=True, max_restarts=3)
    threading.Timer(0.5, lambda: (supervisor.request_stop(),
                                  supervisor.child.send_signal(signal.SIGTERM))).start()
    assert supervisor.run() == 0 and supervisor.stop_requested
    attempts = sup.load_chain(str(tmp_path))["notes"]["chain"]["attempts"]
    assert len(attempts) == 1 and attempts[0]["stopped"] and attempts[0]["lost_s"] == 0.0


def test_decide_skip_once_and_never_from_a_stale_bundle(tmp_path):
    ours = sup.Supervisor(["true"], log_dir=str(tmp_path), checkpoint_dir=None)
    theirs = jax_sup.Supervisor(["true"], log_dir=str(tmp_path), checkpoint_dir=None)
    bundle = tmp_path / "incidents" / "step_00000025"
    bundle.mkdir(parents=True)
    (bundle / "incident.json").write_text(json.dumps(
        {"step": 25, "trigger": "nonfinite", "created_unix": time.time() - 3600.0}))
    for s in (ours, theirs):
        assert s._decide_skip("nonfinite", time.time() - 5.0) == []
    (bundle / "incident.json").write_text(json.dumps(
        {"step": 25, "trigger": "nonfinite", "created_unix": time.time()}))
    for s in (ours, theirs):
        assert s._decide_skip("hang", time.time() - 5.0) == []
        assert s._decide_skip("nonfinite", time.time() - 5.0) == [25]
        assert s._decide_skip("nonfinite", time.time() - 5.0) == []
        assert s.skipped_steps == {25}


def _attempt_sets():
    base = {"wall_s": 10.0, "per_step_s": 0.5}
    return [
        [dict(base, exit_code=-9, resumed_from_step=0), dict(base, exit_code=0,
                                                             resumed_from_step=8)],
        [dict(base, exit_code=1, resumed_from_step=4, per_step_s=None),
         dict(base, exit_code=4, resumed_from_step=6, wall_s=3.0),
         dict(base, exit_code=0, resumed_from_step=6, per_step_s=0.25)],
        [dict(base, exit_code=3, resumed_from_step=0, per_step_s=None, wall_s=2.0)],
        [dict(base, exit_code=0, resumed_from_step=0, stopped=True)],
    ]


@pytest.mark.parametrize("index", range(len(_attempt_sets())))
def test_account_equals_sav_tpus(tmp_path, index):
    root = _checkpoint_dir(tmp_path, ["12"])
    results = []
    for module in (sup, jax_sup):
        s = module.Supervisor(["true"], log_dir=str(tmp_path), checkpoint_dir=root,
                              clock=lambda: 100.0)
        s._t0, s._backoff_total = 70.0, 1.5
        s.attempts = copy.deepcopy(_attempt_sets()[index])
        results.append((s._account(), s.attempts))
    assert results[0] == results[1]


# ------------------------------------------------ import contract, the CLI


def test_supervisor_module_imports_neither_torch_nor_numpy():
    probe = ("import sys\nimport sav_tpu_torch.train.supervisor\n"
             "import sav_tpu_torch.obs.manifest, sav_tpu_torch.obs.fleet\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'numpy', 'jax', 'sav_tpu')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_the_supervise_parent_never_imports_torch():
    """``--supervise`` in its own process, its Supervisor.run stubbed to
    report: torch (so CUDA) never loaded, the child's argv the command less
    the supervisor's flags, the user's --skip-steps moved into the
    supervisor's ledger."""
    probe = (
        "import sys\n"
        "import sav_tpu_torch.train.supervisor as s\n"
        "def run(self):\n"
        "    print('TORCH', 'torch' in sys.modules, 'numpy' in sys.modules)\n"
        "    print('ARGV', ' '.join(self.child_argv[1:]))\n"
        "    print('SKIPS', sorted(self.skipped_steps))\n"
        "    return 0\n"
        "s.Supervisor.run = run\n"
        "from sav_tpu_torch.train import main\n"
        "main(['--supervise', '--synth-data', '-c', 'ckpt', '--max-restarts', '2',\n"
        "      '--skip-steps', '5', '--restart-backoff=1', '--steps', '4'])\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.strip().splitlines())
    assert lines["TORCH"] == "False False"
    assert lines["ARGV"] == "-m sav_tpu_torch.train --synth-data -c ckpt --steps 4"
    assert lines["SKIPS"] == "[5]"


@pytest.mark.parametrize("argv", [
    ["--supervise", "--synth-data"],
    ["--supervise", "--synth-data", "-c", "x", "--skip-steps", "0"],
    ["--synth-data", "--device", "cpu", "--watchdog-soft-secs", "5"],
    ["--synth-data", "--device", "cpu", "--preset", "no_such_preset"],
])
def test_usage_errors_exit_2(tmp_path, argv, capsys):
    with pytest.raises(SystemExit) as exit_info:
        main([a if a != "x" else str(tmp_path / "c") for a in argv])
    assert exit_info.value.code == 2


def test_device_cuda_without_a_card_exits_3_under_the_supervisor(tmp_path):
    """``--device cuda`` where no card answers: the child's probe gives up
    (exit 3, manifest 'backend_unreachable', never a CPU run), and the
    chain with no restart left ends 3, classified backend_unreachable."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sav_tpu_torch.train", "--supervise", "--max-restarts", "0",
         "--synth-data", "--preset", "elastic_smoke", "--device", "cuda", "--backend-wait", "2",
         "-c", str(tmp_path)],
        cwd=ROOT, env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 3, proc.stderr
    assert time.perf_counter() - t0 < 120
    chain = jax_sup.load_chain(str(tmp_path))
    attempts = chain["notes"]["chain"]["attempts"]
    assert [a["restart_reason"] for a in attempts] == ["backend_unreachable"]
    assert chain["outcome"] == "backend_unreachable" and chain["exit_code"] == 3
    attempt = jax_manifest.RunManifest.load(str(tmp_path / attempts[0]["manifest"]))
    assert (attempt["outcome"], attempt["exit_code"]) == ("backend_unreachable", 3)
    probes = attempt["notes"]["backend_probe"]["probes"]
    assert probes and probes[-1]["elapsed_s"] <= 2.0 + 2.0  # within the deadline
    assert not (tmp_path / "fleet").exists()  # it never trained


# ------------------------------------------------------------- a real chain

_CHAIN_STEPS, _NAN_AT, _HANG_AT, _KILL_AT = 16, 10, 7, 6
# The CPU threads of the children and of the reference: a CPU reduction's
# order, and so its last bits, follows the thread count.
_THREADS = 2


class _Killer(threading.Thread):
    """SIGKILLs the first attempt once its heartbeat reaches _KILL_AT (the
    child sleeps in its feed from position _HANG_AT on, so the kill lands
    at that step, between the saves of steps 4 and 8)."""

    def __init__(self, log_dir):
        super().__init__(daemon=True)
        self.log_dir, self.child, self.kills = log_dir, None, []
        self._stop = threading.Event()

    def on_spawn(self, attempt, popen):
        self.child = popen

    def run(self):
        while not self._stop.is_set() and not self.kills:
            child = self.child
            if child is not None and child.poll() is None:
                beats = sup.read_attempt_heartbeats(self.log_dir, child.pid)
                if beats and beats[-1]["step"] >= _KILL_AT:
                    os.kill(child.pid, signal.SIGKILL)
                    self.kills.append(beats[-1]["step"])
            time.sleep(0.05)


def test_a_supervised_chain_survives_a_sigkill_and_a_nan_bit_equal(tmp_path):
    """``python -m sav_tpu_torch.train --supervise --device cpu`` on the
    small ViT (2 layers, width 64, 32²), as a subprocess, with the chain's
    supervisor given a kill hook: a SIGKILL at step 6 (after the save of
    step 4), a NaN batch at position 10 (debug_nans kills the attempt, the
    recorder names step 10, the next attempt skips it), and the chain ends
    ok with the final state bit-equal to one uninterrupted fit over the
    skip-applied stream. Each attempt's first batch is the reference
    stream's batch at its resume position."""
    ckpt = tmp_path / "run"
    argv = ["--synth-data", "--preset", "elastic_smoke", "--device", "cpu",
            "--steps", str(_CHAIN_STEPS), "--batch-size", "4", "-c", str(ckpt),
            "--checkpoint-every-steps", "4", "--debug-nans", "--record"]
    killer = _Killer(str(ckpt))
    supervisor = sup.Supervisor(
        [sys.executable, "-m", "sav_tpu_torch.train", *argv], log_dir=str(ckpt),
        checkpoint_dir=str(ckpt), max_restarts=3, backoff_base_s=0.1, on_spawn=killer.on_spawn,
        env=_env(SAV_CHAOS_NAN_STEP=str(_NAN_AT), SAV_CHAOS_HANG_STEP=str(_HANG_AT),
                 SAV_CHAOS_HANG_SECS="120", SAV_CHAOS_ONCE_DIR=str(tmp_path / "once"),
                 OMP_NUM_THREADS=str(_THREADS)),
        capture=True)
    killer.start()
    try:
        assert supervisor.run() == 0
    finally:
        killer._stop.set()
    doc = jax_sup.load_chain(str(ckpt))
    assert jax_sup.verify_chain(doc, min_accounted=0.99) == sup.verify_chain(doc) == []
    chain = doc["notes"]["chain"]
    attempts = chain["attempts"]
    assert [a["restart_reason"] for a in attempts] == ["killed:SIGKILL", "nonfinite", None]
    assert [a["resumed_from_step"] for a in attempts] == [0, 4, 8]
    assert chain["skipped_steps"] == [_NAN_AT] and attempts[1]["skip_decided"] == [_NAN_AT]
    assert killer.kills == [_KILL_AT]
    # The files the chain left, through sav_tpu's readers.
    incident = jax_sup.newest_incident(str(ckpt))
    assert (incident["step"], incident["trigger"]) == (_NAN_AT, "nonfinite")
    beats = jax_fleet.read_heartbeats(str(ckpt))[0]
    assert {b["pid"] for b in beats if b["kind"] == "hb"} == {a["pid"] for a in attempts}
    assert max(b["step"] for b in beats if b["kind"] == "hb") == _CHAIN_STEPS
    assert jax_fleet.aggregate_fleet(str(ckpt))["processes"]["0"]["outcome"] == "ok"
    logged = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    assert logged[-1]["step"] == _CHAIN_STEPS and np.isfinite(logged[-1]["loss"])
    assert json.loads((ckpt / "goodput.json").read_text())["steps"] == _CHAIN_STEPS - 8
    # The reference: the same config (the run's own config.json), one fit
    # over the skip-applied stream.
    saved = Checkpointer(str(ckpt), read_only=True)
    final = saved.restore_raw(_CHAIN_STEPS)
    config = TrainConfig(**{**final["config"], "checkpoint_dir": None, "debug_nans": False,
                            "record": False})
    reference = Trainer(config, device="cpu")
    stream = sup.skip_step_batches(
        synth_resumable_iterator(seed=config.seed, batch_size=4, image_size=32,
                                 num_classes=10), {_NAN_AT})
    batches = [next(stream) for _ in range(_CHAIN_STEPS)]
    threads = torch.get_num_threads()
    torch.set_num_threads(_THREADS)  # the children's: CPU sums run in its order
    try:
        state, _ = reference.fit(iter(batches), num_steps=_CHAIN_STEPS,
                                 state=reference.init_state())
    finally:
        torch.set_num_threads(threads)
    want = state.state_dict()
    for kind in ("params", "batch_stats"):
        assert set(final[kind]) == set(want[kind])
        for name, tensor in want[kind].items():
            assert torch.equal(final[kind][name], tensor), name
    assert final["opt_state"]["count"] == want["opt_state"]["count"] == _CHAIN_STEPS
    for key in ("mu", "nu"):
        assert set(final["opt_state"][key]) == set(want["opt_state"][key])
        for name, tensor in want["opt_state"][key].items():
            assert torch.equal(final["opt_state"][key][name], tensor), (key, name)
    for name, gen_state in want["generators"].items():
        assert torch.equal(final["generators"][name], gen_state), name
    # Resume provenance: each attempt's next batch is the reference's.
    for a in attempts:
        note = jax_manifest.RunManifest.load(str(ckpt / a["manifest"]))["notes"]["resume"]
        assert note["from_step"] == a["resumed_from_step"]
        assert note["next_batch_hash"] == jax_recorder.batch_fingerprint(
            batches[a["resumed_from_step"]])["hash"]
