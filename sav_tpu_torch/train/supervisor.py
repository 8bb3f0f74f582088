"""Supervised training: bounded restarts, manifest chains, rewind-and-skip
and goodput-loss accounting (the port's own copy of
``sav_tpu/train/supervisor.py``).

:class:`Supervisor` re-runs ``python -m sav_tpu_torch.train`` as a child
process until it succeeds:

- **Bounded restarts.** The child is spawned again on failure with
  exponential backoff, up to ``max_restarts``. Exit 0 ends the chain; exit
  2 (usage error) is terminal, since restarting a typo does not help.
  Everything else (the backend probe's exit 3, the watchdog's exit 4, a
  crash, a signal) restarts. Resume is the trainer's own step-exact
  restore from ``-c``: the supervisor only lists the checkpoint directory.
- **Manifest chain.** Each attempt's ``manifest.json`` is copied under
  ``<log_dir>/attempts/`` before the next attempt overwrites it, and one
  supervisor manifest (``supervisor.json``, a
  :class:`~sav_tpu_torch.obs.manifest.RunManifest`) carries the chain:
  per-attempt outcome, restart reason, resumed-from step, wall and lost
  seconds.
- **Goodput accounting.** Lost wall time is ``goodput/lost_s``: for a
  failed attempt, its wall time minus the step time of the steps that
  survived into the next attempt's restore point (seconds per step from
  the attempt's own heartbeats, flushed per line, so a SIGKILL leaves
  them). ``goodput_frac`` = 1 − (lost + backoff) / wall, and
  ``accounted_frac`` says how much of the wall the chain explains.
- **Rewind-and-skip.** When an attempt dies ``nonfinite``, the flight
  recorder's newest incident names the step; the next attempt gets
  ``--skip-steps <step>`` so its data stream drops that batch
  (:func:`skip_step_batches`, applied by the child). Each step is skipped
  at most once a chain.

The files, their layout and the environment variables
(``SAV_SUPERVISED_ATTEMPT``, ``SAV_CHAOS_*``) are ``sav_tpu``'s, so either
side's readers read the other's chains.

Import contract: stdlib only at module scope (no torch, no numpy). The
supervising process never initialises CUDA: it stays alive exactly when a
child's first CUDA call would hang or fail. :func:`chaos_wrap` imports
numpy lazily.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Iterator, Optional

from sav_tpu_torch.obs.manifest import OUTCOMES, RunManifest

CHAIN_SCHEMA = 1

#: Exit codes with contract meaning:
#:   0 — done;  2 — usage error (terminal, restarting cannot help);
#:   3 — backend unreachable (utils.backend_probe);  4 — hang watchdog.
EXIT_OK = 0
EXIT_USAGE = 2
EXIT_BACKEND = 3
EXIT_HANG = 4

# Supervisor-only CLI flags stripped from the child's argv. Maps flag →
# whether it consumes a value argument.
SUPERVISOR_FLAGS = {
    "--supervise": False,
    "--max-restarts": True,
    "--restart-backoff": True,
}


def strip_supervisor_flags(argv: list, extra_value_flags: tuple = ()) -> list:
    """Child argv = the supervisor's argv minus the supervisor-only flags
    (both ``--flag value`` and ``--flag=value`` spellings).

    ``extra_value_flags``: additional value-taking flags to strip —
    ``python -m sav_tpu_torch.train --supervise`` strips the user's
    ``--skip-steps`` and seeds
    the supervisor's cumulative skip ledger with it instead, so the
    supervisor-appended skip set (which includes the user's) is the only
    one the child sees (click's last-value-wins would otherwise drop
    whichever came first).
    """
    flags = dict(SUPERVISOR_FLAGS)
    for name in extra_value_flags:
        flags[name] = True
    out = []
    skip_next = False
    for arg in argv:
        if skip_next:
            skip_next = False
            continue
        name = arg.split("=", 1)[0]
        if name in flags:
            skip_next = flags[name] and "=" not in arg
            continue
        out.append(arg)
    return out


def parse_skip_steps(spec: Optional[str]) -> set:
    """``"120,121"`` → {120, 121} (1-indexed completed-step numbers)."""
    if not spec:
        return set()
    steps = set()
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        try:
            step = int(part)
        except ValueError:
            raise ValueError(
                f"--skip-steps entries must be integers, got {part!r}"
            ) from None
        if step < 1:
            raise ValueError(
                f"--skip-steps entries are 1-indexed step numbers, got {step}"
            )
        steps.add(step)
    return steps


def skip_step_batches(
    it: Iterator[dict],
    skip_steps: set,
    *,
    start_step: int = 0,
    on_skip: Optional[Callable[[int, dict], None]] = None,
) -> Iterator[dict]:
    """Drop the batches at the named *schedule positions* (PaLM-style
    rewind-and-skip, the data-plane half).

    Positions are 1-indexed steps of the uninterrupted schedule: position
    ``p`` is the batch the original run consumed at step ``p``. Dropping
    shifts every later batch one step earlier — the bad example is never
    trained on, the total step count is unchanged (exactly the published
    rewind-and-skip semantics). ``start_step`` anchors the counter for
    resumed streams (the iterator's first batch is position
    ``start_step + 1``). ``on_skip(position, batch)`` fires once per
    dropped batch — the train CLI wires it to a manifest note carrying the
    batch's blake2b fingerprint so the skip is auditable.
    """
    pending = set(skip_steps)
    it = iter(it)

    def gen():
        pos = start_step
        for batch in it:
            pos += 1
            while pos in pending:
                pending.discard(pos)
                if on_skip is not None:
                    on_skip(pos, batch)
                try:
                    batch = next(it)
                except StopIteration:
                    return
                pos += 1
            yield batch

    return gen()


def resume_schedule_position(step: int, skip_steps) -> int:
    """Original-schedule position of the batch consumed at ``step`` once
    ``skip_steps`` positions have been dropped.

    Rewind-and-skip shifts the stream: after dropping position ``p``,
    step ``s >= p`` consumes a LATER original batch. A restart that
    resumes after a skip must rebuild its (position-keyed) data stream
    from this shifted position — and keep the full chain-level skip set
    — or it would re-train an already-consumed batch and desync the
    effective schedule from the skip-applied reference. Both the train CLI
    (stream construction) and the chaos verifier (expected-hash
    recomputation) use this one function, so they cannot drift.
    """
    pos = step
    for p in sorted(set(skip_steps)):
        if p <= pos:
            pos += 1
    return pos


# --------------------------------------------------------- chaos injection


def chaos_wrap(
    it: Iterator[dict],
    *,
    start_step: int = 0,
    env: Optional[dict] = None,
) -> Iterator[dict]:
    """Fault-injection seam for chaos runs (``chip_smoke.py``'s supervised
    chain, the tests).

    Env-gated and position-keyed so it is a no-op in production and
    deterministic under restarts (positions are uninterrupted-schedule
    steps, like :func:`skip_step_batches`):

      SAV_CHAOS_NAN_STEP=N   — replace the batch at position N's images
                               with NaN (float batches only): the step
                               goes nonfinite, debug_nans kills the run,
                               the recorder dumps the bundle — the
                               planted incident rewind-and-skip must cure.
      SAV_CHAOS_HANG_STEP=N  — sleep SAV_CHAOS_HANG_SECS (default 3600)
                               before yielding position N: no step
                               completes, the watchdog's exit-4 contract
                               fires.
      SAV_CHAOS_ONCE_DIR=D   — fire the hang at most once across the
                               whole restart chain (a marker file in D
                               records it). Without this a restarted run
                               replays position N and hangs again: a NaN
                               has a cure (skip the batch), a hang does
                               not — it models a transient infra fault.

    NaN re-injection after a restart is intended: the poisoned position
    is data, and the skip wrapper (applied *outside* this one) drops it.
    """
    env = env if env is not None else os.environ
    nan_at = env.get("SAV_CHAOS_NAN_STEP")
    hang_at = env.get("SAV_CHAOS_HANG_STEP")
    if not nan_at and not hang_at:
        return it
    nan_at = int(nan_at) if nan_at else None
    hang_at = int(hang_at) if hang_at else None
    hang_secs = float(env.get("SAV_CHAOS_HANG_SECS", 3600.0))
    once_dir = env.get("SAV_CHAOS_ONCE_DIR")

    def _hang_armed(pos: int) -> bool:
        if once_dir is None:
            return True
        marker = os.path.join(once_dir, f"chaos_hang_{pos}.fired")
        if os.path.exists(marker):
            return False
        try:
            os.makedirs(once_dir, exist_ok=True)
            with open(marker, "w") as f:
                f.write(str(time.time()))
        except OSError:
            pass  # marker failure must not turn the fault off
        return True

    def gen():
        import numpy as np  # lazy: module import stays stdlib-only

        pos = start_step
        for batch in it:
            pos += 1
            if hang_at is not None and pos == hang_at and _hang_armed(pos):
                time.sleep(hang_secs)
            if nan_at is not None and pos == nan_at:
                batch = dict(batch)
                images = np.array(batch["images"], copy=True)
                if images.dtype.kind != "f":
                    raise ValueError(
                        "SAV_CHAOS_NAN_STEP needs a float batch to poison, "
                        f"got {images.dtype} (run the chaos child without "
                        "--device-preprocess)"
                    )
                images[...] = np.nan
                batch["images"] = images
            yield batch

    return gen()


# ------------------------------------------------------------ chain reading


def latest_checkpoint_step(checkpoint_dir: Optional[str]) -> Optional[int]:
    """Newest *committed* checkpoint step, read without torch.

    The port's Checkpointer commits a step by renaming its temporary
    directory (``.<step>.tmp-<hex>``) to the bare step number, so
    integer-named directories are exactly the committed set; a torn
    temporary directory left by a killed save is skipped.
    """
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return None
    steps = [
        int(name)
        for name in os.listdir(checkpoint_dir)
        if name.isdigit() and os.path.isdir(os.path.join(checkpoint_dir, name))
    ]
    return max(steps) if steps else None


def read_attempt_heartbeats(log_dir: str, pid: int) -> list:
    """This attempt's heartbeat records (``kind: hb``) from the shared
    ``fleet/proc_0.jsonl`` stream, filtered by the child's pid — attempts
    append to one file, the pid tells them apart. Torn tails skipped."""
    path = os.path.join(log_dir, "fleet", "proc_0.jsonl")
    records = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail of a killed writer
                if rec.get("kind") == "hb" and rec.get("pid") == pid:
                    records.append(rec)
    except OSError:
        pass
    return records


def newest_incident(log_dir: str) -> Optional[dict]:
    """Newest flight-recorder incident bundle's ``incident.json`` (with
    its path under ``"path"``), or None. Memdump bundles are skipped —
    they carry no step context to rewind to."""
    root = os.path.join(log_dir, "incidents")
    if not os.path.isdir(root):
        return None
    best = None
    for name in sorted(os.listdir(root)):
        if not name.startswith("step_"):
            continue
        path = os.path.join(root, name, "incident.json")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        doc["path"] = os.path.dirname(path)
        if best is None or doc.get("created_unix", 0) >= best.get(
            "created_unix", 0
        ):
            best = doc
    return best


def load_chain(log_dir: str) -> Optional[dict]:
    """The supervisor manifest (``<log_dir>/supervisor.json``) as a dict,
    or None when the run was never supervised."""
    path = os.path.join(log_dir, "supervisor.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def verify_chain(
    doc: dict,
    *,
    min_accounted: float = 0.99,
    expect_attempts: Optional[int] = None,
) -> list:
    """Structural checks on a supervisor manifest; returns a list of
    problem strings (empty = verified). The chaos harness layers its
    data-level checks (batch-hash match, loss continuity, skip-once) on
    top of this."""
    problems = []
    if doc.get("outcome") != "ok":
        problems.append(f"chain outcome is {doc.get('outcome')!r}, not ok")
    chain = (doc.get("notes") or {}).get("chain") or {}
    attempts = chain.get("attempts") or []
    if not attempts:
        problems.append("chain has no attempts")
        return problems
    if expect_attempts is not None and len(attempts) != expect_attempts:
        problems.append(
            f"expected {expect_attempts} attempts, chain has {len(attempts)}"
        )
    metrics = doc.get("metrics") or {}
    accounted = metrics.get("accounted_frac")
    if not isinstance(accounted, (int, float)):
        problems.append("no accounted_frac metric")
    elif accounted < min_accounted:
        problems.append(
            f"goodput accounting covers only {accounted:.2%} of wall time "
            f"(< {min_accounted:.0%})"
        )
    if not isinstance(metrics.get("goodput_frac"), (int, float)):
        problems.append("no goodput_frac metric")
    for a in attempts[:-1]:
        if a.get("restart_reason") is None:
            problems.append(
                f"attempt {a.get('attempt')} restarted without a reason"
            )
    if attempts[-1].get("exit_code") != 0:
        problems.append(
            f"final attempt exit code {attempts[-1].get('exit_code')}"
        )
    return problems


# --------------------------------------------------------------- supervisor


def _signal_name(code: int) -> str:
    try:
        return signal.Signals(-code).name
    except (ValueError, ImportError):
        return f"SIG{-code}"


def classify_exit(
    exit_code: Optional[int], manifest_outcome: Optional[str]
) -> str:
    """Restart-reason label for one attempt: the child's own finalized
    manifest outcome when it got far enough to write one, else the exit
    code's contract meaning (a SIGKILL leaves the manifest at 'running',
    which means nothing — the signal is the fact)."""
    if manifest_outcome in OUTCOMES and manifest_outcome != "ok":
        return manifest_outcome
    if exit_code == EXIT_OK:
        return "ok"
    if exit_code is not None and exit_code < 0:
        return f"killed:{_signal_name(exit_code)}"
    if exit_code == EXIT_BACKEND:
        return "backend_unreachable"
    if exit_code == EXIT_HANG:
        return "hang"
    if exit_code == EXIT_USAGE:
        return "usage_error"
    return f"crash:rc={exit_code}"


class Supervisor:
    """Run a training command under bounded-restart supervision.

    Args:
      child_argv: full child command (``[sys.executable, "-m",
        "sav_tpu_torch.train", ...]``).
      log_dir: the run's telemetry sink (shared with the child): the
        supervisor manifest, preserved attempt manifests, and the
        heartbeat/incident artifacts it reads all live here.
      checkpoint_dir: the child's ``-c`` directory — observed (stdlib
        directory listing only, never torch) for resumed-from steps.
      max_restarts: restart budget (attempts = restarts + 1).
      backoff_base_s / backoff_max_s: exponential restart backoff
        (base · 2^(restart−1), capped). Deterministic — no jitter — so
        soak chains replay.
      capture: redirect each attempt's stdout+stderr to
        ``attempts/attempt_<k>.out`` (the chaos harness's mode) instead
        of inheriting the supervisor's.
      skip_steps: initial rewind-and-skip ledger (the user's own
        ``--skip-steps``, stripped from the child argv by the CLI); the
        cumulative set — initial + incident-decided — is passed to EVERY
        attempt so the schedule shift survives later restarts.
      on_spawn: callback ``(attempt, popen)`` — the chaos harness's kill
        hook.
      env: extra child environment (merged over ``os.environ``).
      serve: serve-mode chain (``sav_tpu``'s replica fleet; the port's is
        ROADMAP queue A5.8): a serving child never exits 0 on its
        own — it serves until told to stop — so the chain's success
        path is :meth:`request_stop` (the pool calls it, then SIGTERMs
        the child): once a stop is requested, the NEXT child exit ends
        the chain with outcome ``ok`` regardless of the raw code (a
        SIGTERM-killed server is a completed serve, not a crash), and
        its wall time is never booked as lost. Rewind-and-skip is
        training-only and stays off this path (serving has no schedule
        to rewind).
      manifest_src: the child manifest the per-attempt preservation
        copies aside (default ``<log_dir>/manifest.json``; serve
        replicas write ``manifest-serve-r<rank>.json`` into the SHARED
        fleet log dir, which is not this supervisor's chain dir).
      sleep / clock: injectable for tests.

    The supervisor itself never imports torch (the parent of an on-card
    job must not be hangable by the backend) and never exits the
    process: :meth:`run` *returns* the chain's exit code.
    """

    def __init__(
        self,
        child_argv: list,
        *,
        log_dir: str,
        checkpoint_dir: Optional[str],
        max_restarts: int = 16,
        backoff_base_s: float = 5.0,
        backoff_max_s: float = 300.0,
        capture: bool = False,
        on_spawn: Optional[Callable] = None,
        env: Optional[dict] = None,
        skip_steps=None,
        serve: bool = False,
        manifest_src: Optional[str] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.time,
    ):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self.child_argv = list(child_argv)
        self.log_dir = log_dir
        self.checkpoint_dir = checkpoint_dir
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.capture = capture
        self.on_spawn = on_spawn
        self.env = dict(env) if env else {}
        self.serve = bool(serve)
        self.manifest_src = manifest_src
        self._stop_requested = threading.Event()
        self._sleep = sleep
        self._clock = clock
        self.child: Optional[subprocess.Popen] = None
        self.attempts: list = []
        self.skipped_steps: set = set(skip_steps or ())
        self._backoff_total = 0.0
        self.manifest = RunManifest(
            os.path.join(log_dir, "supervisor.json"),
            kind="supervisor",
            argv=list(child_argv),
        )

    def request_stop(self) -> None:
        """Mark the chain as deliberately stopping (serve mode's success
        path — the pool calls this BEFORE signalling the child so the
        resulting exit ends the chain instead of burning a restart).
        Callable from any thread; the caller still delivers the signal."""
        self._stop_requested.set()

    @property
    def stop_requested(self) -> bool:
        return self._stop_requested.is_set()

    # ------------------------------------------------------------- internals

    def _attempt_dir(self) -> str:
        path = os.path.join(self.log_dir, "attempts")
        os.makedirs(path, exist_ok=True)
        return path

    def _preserve_manifest(self, attempt: int) -> Optional[str]:
        """Copy the attempt's manifest aside before the next attempt
        overwrites it; returns the preserved path + parsed outcome."""
        src = self.manifest_src or os.path.join(self.log_dir, "manifest.json")
        if not os.path.exists(src):
            return None
        dst = os.path.join(
            self._attempt_dir(), f"attempt_{attempt:03d}.manifest.json"
        )
        try:
            with open(src) as f:
                payload = f.read()
            tmp = f"{dst}.tmp"
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, dst)
            return dst
        except OSError:
            return None

    def _manifest_outcome(self, preserved: Optional[str]) -> Optional[str]:
        if preserved is None:
            return None
        try:
            with open(preserved) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        outcome = doc.get("outcome")
        return outcome if outcome in OUTCOMES else None

    def _decide_skip(
        self, outcome: Optional[str], since_unix: float
    ) -> list:
        """Rewind-and-skip decision after a ``nonfinite`` death: skip the
        incident bundle's recorded step, once per chain.

        ``since_unix``: the dead attempt's start time — a bundle created
        before it is a LEFTOVER from an earlier run sharing the log dir
        (or an attempt that dumped nothing this time), and skipping its
        step would drop a good batch while the real bad one replays.
        """
        if outcome != "nonfinite":
            return []
        incident = newest_incident(self.log_dir)
        if incident is None:
            return []
        created = incident.get("created_unix")
        # 1s slack: the bundle's clock and ours are the same host's, but
        # the dump may have started microseconds around the spawn stamp.
        if isinstance(created, (int, float)) and created < since_unix - 1.0:
            print(
                "supervisor: newest incident bundle "
                f"({incident.get('path')}) predates this attempt — "
                "treating it as stale, no rewind-and-skip",
                file=sys.stderr,
            )
            return []
        steps = []
        step = incident.get("step")
        # A replay verdict (sav_tpu's tools/replay_step.py) names the first bad
        # step more precisely than the detection step; prefer it.
        verdict_path = os.path.join(
            incident.get("path", ""), "replay_verdict.json"
        )
        try:
            with open(verdict_path) as f:
                first_bad = json.load(f).get("first_bad_step")
            if isinstance(first_bad, int):
                step = first_bad
        except (OSError, json.JSONDecodeError):
            pass
        if isinstance(step, int) and step >= 1:
            if step not in self.skipped_steps:
                self.skipped_steps.add(step)
                steps.append(step)
        return steps

    def _account(self) -> dict:
        """Chain-level goodput accounting over the attempts so far.

        Per failed attempt: salvaged = steps that survived into the next
        attempt's restore point; lost = wall − salvaged · per-step time
        (per-step from the attempt's own heartbeats, falling back to the
        chain median). A successful attempt loses nothing; restart
        *backoff* is booked separately. ``accounted_frac`` is the share
        of supervisor wall time the chain explains (attempt walls +
        backoff) — the ≥99% soak criterion.
        """
        per_steps = [
            a["per_step_s"] for a in self.attempts
            if a.get("per_step_s") is not None
        ]
        fallback = (
            sorted(per_steps)[len(per_steps) // 2] if per_steps else None
        )
        lost_total = 0.0
        for i, a in enumerate(self.attempts):
            if a.get("exit_code") == EXIT_OK or a.get("stopped"):
                # A requested stop (serve mode) is a completed serve,
                # not lost wall — the replica was serving until told
                # to exit.
                a["lost_s"] = 0.0
                continue
            nxt = (
                self.attempts[i + 1] if i + 1 < len(self.attempts) else None
            )
            resumed_next = (
                nxt.get("resumed_from_step") if nxt is not None
                else latest_checkpoint_step(self.checkpoint_dir)
            )
            salvaged = max(
                (resumed_next or 0) - (a.get("resumed_from_step") or 0), 0
            )
            a["salvaged_steps"] = salvaged
            per_step = a.get("per_step_s") or fallback
            if per_step is not None:
                lost = max(a["wall_s"] - salvaged * per_step, 0.0)
            else:
                # Died before the first heartbeat: nothing salvageable
                # was measured — the whole attempt is lost time.
                lost = a["wall_s"]
            a["lost_s"] = round(lost, 3)
            lost_total += lost
        wall = max(self._clock() - self._t0, 1e-9)
        attempts_wall = sum(a["wall_s"] for a in self.attempts)
        return {
            "wall_s": round(wall, 3),
            "attempts_wall_s": round(attempts_wall, 3),
            "lost_s": round(lost_total, 3),
            "backoff_s": round(self._backoff_total, 3),
            "goodput_frac": round(
                max(1.0 - (lost_total + self._backoff_total) / wall, 0.0), 6
            ),
            "accounted_frac": round(
                min((attempts_wall + self._backoff_total) / wall, 1.0), 6
            ),
        }

    def _publish(self, goodput: dict) -> None:
        self.manifest.note("chain", {
            "schema": CHAIN_SCHEMA,
            "attempts": self.attempts,
            "skipped_steps": sorted(self.skipped_steps),
            "goodput": goodput,
        })
        self.manifest.set_metrics({
            "attempts": float(len(self.attempts)),
            "goodput_frac": goodput["goodput_frac"],
            "accounted_frac": goodput["accounted_frac"],
            "goodput/lost_s": goodput["lost_s"],
            "goodput/backoff_s": goodput["backoff_s"],
        })

    # ------------------------------------------------------------------ run

    def run(self) -> int:
        """Supervise until success, a terminal failure, or budget
        exhaustion; returns the exit code for the caller to exit with."""
        self._t0 = self._clock()
        self.manifest.begin()
        attempt = 0
        while True:
            attempt += 1
            resumed_from = latest_checkpoint_step(self.checkpoint_dir) or 0
            argv = list(self.child_argv)
            if self.skipped_steps:
                # The CUMULATIVE skip set rides every attempt: a skip
                # shifts every later batch one step earlier, and a
                # restart resuming past the skipped position must
                # rebuild its stream from the shifted position
                # (resume_schedule_position in the CLI) — dropping the
                # set after one attempt would re-train a consumed batch.
                argv += [
                    "--skip-steps",
                    ",".join(map(str, sorted(self.skipped_steps))),
                ]
            env = dict(os.environ)
            env.update(self.env)
            env["SAV_SUPERVISED_ATTEMPT"] = str(attempt)
            out = None
            if self.capture:
                out = open(
                    os.path.join(
                        self._attempt_dir(), f"attempt_{attempt:03d}.out"
                    ),
                    "w",
                )
            t_start = self._clock()
            try:
                self.child = subprocess.Popen(
                    argv, env=env,
                    stdout=out if out is not None else None,
                    stderr=subprocess.STDOUT if out is not None else None,
                )
            except OSError as e:
                if out is not None:
                    out.close()
                self.manifest.finalize(
                    "error", error=f"spawn failed: {e!r}", exit_code=1
                )
                return 1
            if self.on_spawn is not None:
                try:
                    self.on_spawn(attempt, self.child)
                except Exception:
                    pass  # a chaos-hook bug must not kill supervision
            try:
                # Supervising IS waiting: the CHILD's watchdog bounds the
                # child (exit-4); the supervisor has no deadline of its
                # own to enforce on top.
                rc = self.child.wait()
            finally:
                if out is not None:
                    out.close()
            wall = self._clock() - t_start
            preserved = self._preserve_manifest(attempt)
            outcome = self._manifest_outcome(preserved)
            reason = classify_exit(rc, outcome)
            beats = read_attempt_heartbeats(self.log_dir, self.child.pid)
            last_hb = beats[-1] if beats else None
            per_step = None
            if last_hb and last_hb.get("steps"):
                step_s = (last_hb.get("b") or {}).get("step")
                if isinstance(step_s, (int, float)) and step_s > 0:
                    per_step = step_s / last_hb["steps"]
            record = {
                "attempt": attempt,
                "pid": self.child.pid,
                "start_unix": round(t_start, 3),
                "wall_s": round(wall, 3),
                "exit_code": rc,
                "outcome": outcome or ("ok" if rc == 0 else "running"),
                "restart_reason": None if rc == EXIT_OK else reason,
                "resumed_from_step": resumed_from,
                "last_step": (
                    last_hb.get("step") if last_hb else resumed_from
                ),
                "per_step_s": (
                    round(per_step, 6) if per_step is not None else None
                ),
                "skip_steps": sorted(self.skipped_steps),
                "manifest": (
                    os.path.relpath(preserved, self.log_dir)
                    if preserved else None
                ),
            }
            if self._stop_requested.is_set():
                # Serve-mode success path: the pool asked the chain to
                # stop, then signalled the child — whatever code the
                # dying server returned, this is a completed serve, not
                # a failure to restart from.
                record["stopped"] = True
                record["outcome"] = outcome or "ok"
                record["restart_reason"] = None
                self.attempts.append(record)
                goodput = self._account()
                self._publish(goodput)
                self.manifest.finalize(
                    "ok", exit_code=0, notes={"stop_requested": True}
                )
                return 0
            self.attempts.append(record)
            if rc == EXIT_OK:
                goodput = self._account()
                self._publish(goodput)
                self.manifest.finalize("ok", exit_code=0)
                return 0
            if rc == EXIT_USAGE:
                goodput = self._account()
                self._publish(goodput)
                self.manifest.finalize(
                    "error",
                    error="child usage error (exit 2): restarting cannot "
                    "help; fix the command line",
                    exit_code=EXIT_USAGE,
                )
                return EXIT_USAGE
            decided = (
                [] if self.serve else self._decide_skip(outcome, t_start)
            )
            if decided:
                self.attempts[-1]["skip_decided"] = list(decided)
            restarts_used = attempt - 1
            if restarts_used >= self.max_restarts:
                goodput = self._account()
                self._publish(goodput)
                final = outcome if outcome in OUTCOMES else "error"
                self.manifest.finalize(
                    final if final != "ok" else "error",
                    error=(
                        f"restart budget exhausted after {attempt} attempts "
                        f"(last: {reason})"
                    ),
                    exit_code=rc if isinstance(rc, int) and rc > 0 else 1,
                )
                return rc if isinstance(rc, int) and rc > 0 else 1
            backoff = min(
                self.backoff_base_s * (2 ** (attempt - 1)),
                self.backoff_max_s,
            )
            print(
                f"supervisor: attempt {attempt} ended ({reason}); "
                f"restarting in {backoff:.1f}s "
                f"(restart {attempt}/{self.max_restarts}"
                + (
                    f", rewind-and-skip step(s) {decided}"
                    if decided else ""
                )
                + ")",
                file=sys.stderr,
            )
            goodput = self._account()
            self._publish(goodput)
            t_sleep = self._clock()
            self._sleep(backoff)
            self._backoff_total += self._clock() - t_sleep
