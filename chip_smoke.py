#!/usr/bin/env python3
"""On-card smoke test of sav_tpu_torch, the PyTorch/CUDA port of sav_tpu.

Run from the root of the repository on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: refuse to run without CUDA; print the card's name and power limit
   (nvidia-smi); turn TF32 off for every f32 comparison.
2. build: compile every kernel in sav_tpu_torch/csrc with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serve shape and at small, ragged, biased and strided shapes.
4. timing: the kernel, its plain version and one PyTorch library call
   (yardstick only) at the serve shape, beside the card's bound.
5. serve: ServeEngine serves deit_s_patch16 (bf16, random weights from a
   seed) to concurrent clients; every attention core must have gone through
   the kernel (12 launches per batch), and 8 rows must agree with the same
   weights served on the dense attention path.

The line before the last is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and FLOP/s by the
# inputs' type (bf16 on the tensor cores, f32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# The DeiT-S/16 serve shape at the top bucket: B=32, L=197, H=6, D=64.
SERVE_SHAPE = (32, 197, 197, 6, 64)
SERVE_REQUESTS = 96
CLIENTS = 4
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
LSE_TOL = 2e-5
SERVE_TOL = 3e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is false; run it on a "
            "machine with an NVIDIA GPU"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    return smi


def phase_build() -> None:
    from sav_tpu_torch.ops import _build
    from sav_tpu_torch.ops import fused_attention as fa

    t0 = time.perf_counter()
    built = _build.build_all()
    log(
        f"build: {len(built)} kernel source(s) in {time.perf_counter() - t0:.1f} s "
        f"{json.dumps({k: round(v, 1) for k, v in built.items()})}"
    )
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            log(f"  nvcc {name}: {line.strip()}")
    lib = fa._lib()
    for kv_len, dim, itemsize in ((197, 64, 2), (197, 64, 4), (50, 32, 4), (1, 8, 2)):
        c_bytes = lib.sav_fused_attention_smem_bytes(kv_len, dim, itemsize)
        py_bytes = fa.fused_smem_bytes(kv_len, dim, itemsize)
        if c_bytes != py_bytes:
            raise AssertionError(
                f"shared-memory rule differs at kv={kv_len} d={dim} itemsize={itemsize}: "
                f"kernel {c_bytes}, fused_eligible {py_bytes}"
            )


def _inputs(shape, dtype, seed, device, *, bias_shape=None, packed=False):
    b, lq, lk, h, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=device)

    if packed:  # q/k/v as strided views of one [B, L, 3, H, D] tensor
        q, k, v = randn(b, lq, 3, h, d).to(dtype).unbind(2)
    else:
        q = randn(b, lq, h, d).to(dtype)
        k = randn(b, lk, h, d).to(dtype)
        v = randn(b, lk, h, d).to(dtype)
    bias = randn(*bias_shape) if bias_shape else None
    return q, k, v, bias


def _within(got, ref, tol) -> float:
    err = (got.float() - ref.float()).abs()
    bad = err > tol + tol * ref.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} elements off, max abs err {err.max().item():.3e}")
    return err.max().item()


def check_kernel(name, shape, dtype, device, *, bias_shape=None, with_lse=False, packed=False):
    """The kernel against its plain version computed in f32 from the same
    inputs. bf16 allows one bf16 rounding of P and one of O."""
    from sav_tpu_torch.ops import fused_attention as fa

    q, k, v, bias = _inputs(shape, dtype, 7, device, bias_shape=bias_shape, packed=packed)
    with torch.inference_mode():
        got = fa.fused_attention(q, k, v, bias, with_lse=with_lse)
        ref = fa.fused_attention_reference(
            q.float(), k.float(), v.float(), bias, with_lse=with_lse
        )
    if with_lse:
        (got, got_lse), (ref, ref_lse) = got, ref
    err = _within(got, ref, TOL[dtype])
    note = ""
    if with_lse:
        note = f", lse max abs err {_within(got_lse, ref_lse, LSE_TOL):.3e}"
    log(f"kernel {name} {shape} {str(dtype)[6:]}: max abs err {err:.3e} (tol {TOL[dtype]}){note}")
    return err


def phase_kernels(device="cuda", serve_shape=SERVE_SHAPE) -> float:
    """All cases; returns the max abs error at the serve shape in bf16."""
    bf16, f32 = torch.bfloat16, torch.float32
    b, lq, lk, h, d = serve_shape
    serve_err = check_kernel("serve", serve_shape, bf16, device)
    serve_err = max(serve_err, check_kernel("serve+lse", serve_shape, bf16, device, with_lse=True))
    check_kernel("serve-f32+lse", serve_shape, f32, device, with_lse=True)
    check_kernel("packed-qkv", serve_shape, bf16, device, packed=True)
    for bias_shape in ((2, 4, 50, 50), (1, 1, 50, 50), (1, 4, 50, 50), (2, 1, 50, 50)):
        check_kernel(f"bias{bias_shape[:2]}", (2, 50, 50, 4, 32), f32, device, bias_shape=bias_shape)
    check_kernel("ragged-50+lse", (2, 50, 50, 2, 32), bf16, device, with_lse=True)
    check_kernel("ragged-50", (2, 50, 50, 2, 32), f32, device)
    check_kernel("one-query", (2, 1, lk, 2, d), f32, device)
    check_kernel("short-kv", (2, 196, 49, 2, 64), f32, device)
    return serve_err


def _median_ms(fn, iters=30, warmup=5) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush (64 MB > the 50 MB L2) and a device-side spin that keeps the
    host's enqueue time out of the measured span."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_timing() -> dict:
    import torch.nn.functional as F

    from sav_tpu_torch.ops import fused_attention as fa

    dtype = torch.bfloat16
    b, lq, lk, h, d = SERVE_SHAPE
    q, k, v, _ = _inputs(SERVE_SHAPE, dtype, 11, "cuda")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, L, D] views
    with torch.inference_mode():
        times = {
            "ms": _median_ms(lambda: fa.fused_attention(q, k, v)),
            "plain_ms": _median_ms(lambda: fa.fused_attention_reference(q, k, v)),
            "library_ms": _median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
        }
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * q.element_size()
    flops = 4 * b * h * lq * lk * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    times["bound_ms"] = max(bytes_ms, flops_ms)
    times["bound_by"] = "bytes" if bytes_ms >= flops_ms else "operations"
    log(
        f"timing {SERVE_SHAPE} bf16, median of 30, cold L2: kernel {times['ms']:.4f} ms, "
        f"plain {times['plain_ms']:.4f} ms, scaled_dot_product_attention "
        f"{times['library_ms']:.4f} ms; bound {times['bound_ms']:.4f} ms by "
        f"{times['bound_by']} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)"
    )
    return times


def _serve(engine, images, clients) -> list:
    results = [None] * len(images)
    errors = []

    def client(indices):
        try:
            futures = [(i, engine.submit(images[i])) for i in indices]
            for i, future in futures:
                results[i] = future.result(timeout=300)
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(e)

    threads = [
        threading.Thread(target=client, args=(range(c, len(images), clients),))
        for c in range(clients)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"serving failed: {errors or 'a client did not finish'}")
    return results


def phase_serve(device="cuda", model_name="deit_s_patch16", requests=SERVE_REQUESTS,
                max_batch=32, overrides=None, image_size=224) -> int:
    """Serve ``requests`` seeded images; returns the kernel's launches."""
    from sav_tpu_torch import ServeConfig, ServeEngine, create_model
    from sav_tpu_torch.ops import fused_attention as fa

    overrides = overrides or {}
    model = create_model(model_name, image_size=image_size, seed=0, **overrides)
    # The head is zero at init: draw it (std 0.02, DeiT's init for linear
    # layers), or every logit is 0 and the agreement check is vacuous.
    torch.nn.init.normal_(model.head.weight, std=0.02, generator=torch.Generator().manual_seed(1))
    dense = create_model(
        model_name, image_size=image_size, backend="xla", logits_dtype=torch.float32, **overrides
    )
    dense.load_state_dict(model.state_dict())
    layers = len(model.encoder.blocks)

    def config(**kw):
        # A generous deadline: admission must not shed in a smoke run.
        return ServeConfig(model_name=model_name, image_size=image_size,
                           compute_dtype="bfloat16", deadline_ms=5000.0,
                           device=device, **kw)

    images = np.random.default_rng(0).integers(
        0, 256, (requests, image_size, image_size, 3), dtype=np.uint8
    )
    engine = ServeEngine(config(max_batch=max_batch), model=model)
    log(f"serve startup: {json.dumps(engine.startup_report)}")
    fa.reset_launches()
    with engine:
        logits = np.stack(_serve(engine, images, CLIENTS))
    launches = fa.LAUNCHES
    summary = engine.stats()
    ledger = summary["ledger"]
    if summary["errors"] or ledger["requests"] != requests:
        raise AssertionError(f"serving incomplete: {json.dumps(summary)}")
    if logits.shape != (requests, model.head.out_features) or not np.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {logits.shape}, finite {np.isfinite(logits).all()}")
    if launches != layers * ledger["batches"]:
        raise AssertionError(
            f"fused kernel launched {launches} times for {ledger['batches']} batches; "
            f"expected {layers} per batch"
        )
    log(
        f"serve {model_name} bf16: {requests} requests from {CLIENTS} clients in "
        f"{ledger['batches']} batches {json.dumps(ledger['bucket_occupancy'])}; "
        f"kernel launches {launches} = {layers} x {ledger['batches']}; "
        f"p50 {ledger['latency_ms']['p50']} ms, p99 {ledger['latency_ms']['p99']} ms, "
        f"{ledger['throughput_rps']} images/s"
    )

    fa.reset_launches()
    with ServeEngine(config(max_batch=8, attention_backend="xla"), model=dense) as ref_engine:
        ref = np.stack(_serve(ref_engine, images[:8], 1))
    if fa.LAUNCHES:
        raise AssertionError("the dense reference engine launched the fused kernel")
    err = _within(torch.from_numpy(logits[:8]), torch.from_numpy(ref), SERVE_TOL)
    log(
        f"serve agreement, fused kernel vs dense attention (f32 softmax), 8 rows: "
        f"max abs err {err:.3e} (tol {SERVE_TOL}), logits max |x| {np.abs(ref).max():.3f}"
    )
    return launches


def main() -> None:
    smi = phase_device()
    phase_build()
    serve_err = phase_kernels()
    times = phase_timing()
    launches = phase_serve()
    record = {
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "sav_tpu_torch/csrc/fused_attention.cu",
        "replaces": "sav_tpu/ops/fused_attention.py:146",
        "tpu_kernel": "_fused_kernel",
        "checked": True,
        "launches": launches,
        "max_abs_err": serve_err,
        **times,
    }
    log(f"card: {smi}")
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
