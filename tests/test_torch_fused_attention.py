"""The port's fused attention (sav_tpu_torch.ops.fused_attention) against
sav_tpu's, on the CPU.

On CPU tensors the port's wrapper runs its plain version
(``fused_attention_reference``), so these tests hold the kernel's arithmetic
against sav_tpu's ``fused_attention`` (the Pallas kernel in interpret mode)
from the same numpy inputs. The CUDA kernel itself is checked against the
same plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops.fused_attention import DEFAULT_BLOCK_Q, _fused_forward
from sav_tpu.ops.fused_attention import fused_attention as jax_fused_attention
from sav_tpu_torch.ops import attention as port_attention
from sav_tpu_torch.ops import fused_attention as port_fused

torch.set_num_threads(2)

# tests/test_fused_attention.py:47-49 (f32) and :132-135 (bf16).
F32_TOL = 2e-5
BF16_TOL = 3e-2


def _qkv(b, lq, lk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, lq, h, d), (b, lk, h, d), (b, lk, h, d))
    )


def _port(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize(
    "b,lq,lk,h,d",
    [
        (2, 197, 197, 2, 64),  # DeiT/ViT-S @ 224
        (2, 50, 50, 2, 32),  # ragged
        (2, 1, 197, 2, 64),  # one query row (class attention)
        (2, 196, 49, 2, 64),  # short kv
    ],
)
def test_fused_matches_sav_tpu_f32(b, lq, lk, h, d):
    q, k, v = _qkv(b, lq, lk, h, d)
    ref = np.asarray(jax_fused_attention(*map(jnp.asarray, (q, k, v))))
    out = port_fused.fused_attention(*_port((q, k, v)))
    assert out.dtype == torch.float32 and out.shape == (b, lq, h, d)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize(
    "bias_shape", [(2, 4, 50, 50), (1, 1, 50, 50), (1, 4, 50, 50), (2, 1, 50, 50)]
)
def test_fused_bias_patterns_match_sav_tpu(bias_shape):
    q, k, v = _qkv(2, 50, 50, 4, 32, seed=1)
    bias = np.random.default_rng(9).standard_normal(bias_shape).astype(np.float32)
    ref = np.asarray(
        jax_fused_attention(*map(jnp.asarray, (q, k, v, bias)))
    )
    out = port_fused.fused_attention(*_port((q, k, v, bias)))
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)


def test_fused_lse_matches_sav_tpu():
    b, l, h, d = 2, 50, 2, 32
    q, k, v = _qkv(b, l, l, h, d, seed=2)
    scale = d ** -0.5
    ref_out, ref_lse = _fused_forward(
        *map(jnp.asarray, (q, k, v)), None, scale,
        DEFAULT_BLOCK_Q, None, None, with_lse=True,
    )
    # sav_tpu stores lse as [B·H, Lq_p, 128] (the row repeated across lanes).
    ref_lse = np.asarray(ref_lse)[:, :l, 0].reshape(b, h, l)
    out, lse = port_fused.fused_attention(*_port((q, k, v)), with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, l)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=F32_TOL, rtol=F32_TOL)


def test_fused_bf16_matches_sav_tpu():
    q, k, v = _qkv(2, 197, 197, 2, 64, seed=3)
    ref = jax_fused_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    )
    out = port_fused.fused_attention(*_port((q, k, v), torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=BF16_TOL, rtol=BF16_TOL
    )


def test_scale_is_applied_to_the_f32_product():
    """bf16 inputs: the scores are the exact f32 product, scaled afterwards
    (sav_tpu's fused kernel), not q scaled in bf16 first (xla_attention)."""
    q, k, v = _port(_qkv(1, 8, 8, 1, 32, seed=4), torch.bfloat16)
    _, lse = port_fused.fused_attention(q, k, v, with_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 32 ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), atol=1e-6, rtol=1e-6)


def test_fused_eligible_band_and_budget_error():
    assert port_fused.fused_eligible(197, 197, 64, itemsize=2)
    assert port_fused.fused_eligible(197, 197, 64, itemsize=4)
    # D off the multiple of 8 runs zero-padded, within the padded D's budget.
    assert port_fused.fused_eligible(197, 197, 60) == port_fused.fused_eligible(197, 197, 64)
    assert not port_fused.fused_eligible(197, 197, 512)  # D over 256
    assert not port_fused.fused_eligible(8, 8, 257)  # padded to 264: over 256
    assert not port_fused.fused_eligible(4096, 4096, 64)  # K/V over 227 KB
    # bf16 takes the tensor-core forward (208 bf16 rows of 72 for K and for
    # V); f32 the CUDA-core one (K, V and each warp's f32 q and score rows).
    assert port_fused.fused_smem_bytes(197, 64, 2) == 59904
    assert port_fused.fused_smem_bytes(197, 64, 4) == 120912
    q, k, v = _port(_qkv(1, 8, 4096, 1, 64))
    with pytest.raises(ValueError, match="shared memory"):
        port_fused.fused_attention(q, k, v)


def test_wrapper_rejects_bad_inputs():
    q, k, v = _port(_qkv(1, 8, 8, 2, 32))
    with pytest.raises(ValueError, match=r"\[B, L, H, D\]"):
        port_fused.fused_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="mismatched"):
        port_fused.fused_attention(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(ValueError, match="4-D"):
        port_fused.fused_attention(q, k, v, torch.zeros(8, 8))


def test_cpu_path_counts_no_launch():
    """LAUNCHES counts kernel launches only; the CPU plain path is none."""
    port_fused.reset_launches()
    port_fused.fused_attention(*_port(_qkv(1, 8, 8, 1, 32)))
    assert port_fused.LAUNCHES == 0


def test_dense_attention_matches_xla_attention_logits_dtypes():
    from sav_tpu.ops.attention import xla_attention

    q, k, v = _qkv(2, 17, 17, 2, 32, seed=5)
    ref = np.asarray(xla_attention(*map(jnp.asarray, (q, k, v)), logits_dtype=jnp.float32))
    out = port_attention.dense_attention(*_port((q, k, v)), logits_dtype="float32")
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)
    # bf16 compute with the block default (logits in the compute dtype).
    ref16 = xla_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), logits_dtype=jnp.bfloat16
    )
    out16 = port_attention.dense_attention(
        *_port((q, k, v), torch.bfloat16), logits_dtype=torch.bfloat16
    )
    np.testing.assert_allclose(
        out16.float().numpy(), np.asarray(ref16, np.float32), atol=BF16_TOL, rtol=BF16_TOL
    )


def test_resolve_attention_backend_rule():
    resolve = port_attention.resolve_attention_backend
    assert resolve(197, 197, 64) == "fused"
    assert resolve(197, 197, 64, dtype="float32", requested="auto") == "fused"
    assert resolve(197, 197, 64, requested="xla") == "xla"
    assert resolve(8, 4096, 64, requested="fused") == "fused"
    assert resolve(4096, 4096, 64) == "pallas"  # outside the fused band: flash
    assert resolve(197, 197, 64, requested="pallas") == "pallas"
    with pytest.raises(ValueError, match="unknown"):
        resolve(197, 197, 64, requested="cudnn")


def test_dot_product_attention_dispatches():
    q, k, v = _port(_qkv(2, 17, 17, 2, 32, seed=6))
    fused = port_attention.dot_product_attention(q, k, v)
    torch.testing.assert_close(fused, port_fused.fused_attention_reference(q, k, v))
    dense = port_attention.dot_product_attention(q, k, v, backend="xla")
    torch.testing.assert_close(dense, port_attention.dense_attention(q, k, v))
    with pytest.raises(ValueError, match=r"\[B, L, H, D\]"):
        port_attention.dot_product_attention(q[0], k[0], v[0])


# ---------------------------------------------------------------- backward

# tests/test_fused_attention.py:52-55 (f32 grads) and :132-135 (bf16).
GRAD_ATOL, GRAD_RTOL = 1e-4, 5e-4


def _jax_grads(fn, arrays):
    """jax.grad of sum(out²) w.r.t. every input, as numpy."""
    import jax

    argnums = tuple(range(len(arrays)))
    grads = jax.grad(lambda *a: jnp.sum(jnp.square(fn(*a).astype(jnp.float32))), argnums)(
        *map(jnp.asarray, arrays)
    )
    return [np.asarray(g, np.float32) for g in grads]


def _port_grads(arrays, dtype=torch.float32, **kw):
    """Gradients of sum(out²) through the port's fused_attention (on CPU
    tensors: the autograd Function's plain forward and plain backward)."""
    tensors = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    out = port_fused.fused_attention(*tensors, **kw)
    out.float().square().sum().backward()
    return [t.grad.float().numpy() for t in tensors]


@pytest.mark.parametrize(
    "b,lq,lk,h,d",
    [
        (2, 197, 197, 2, 64),  # DeiT/ViT-S @ 224
        (2, 50, 50, 2, 32),  # ragged
        (2, 1, 197, 2, 64),  # one query row (class attention)
        (2, 196, 49, 2, 64),  # short kv
    ],
)
def test_fused_grads_match_sav_tpu_f32(b, lq, lk, h, d):
    arrays = _qkv(b, lq, lk, h, d, seed=20)
    ref = _jax_grads(jax_fused_attention, arrays)
    port_fused.reset_launches()
    got = _port_grads(arrays)
    assert port_fused.BWD_LAUNCHES == 0  # the CPU path launches no kernel
    for name, g, r in zip("qkv", got, ref):
        assert np.abs(r).max() > 1e-3, name  # non-vacuous
        np.testing.assert_allclose(g, r, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_fused_grads_match_sav_tpu_bf16():
    arrays = _qkv(2, 197, 197, 2, 64, seed=21)
    ref = _jax_grads(
        jax_fused_attention, [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrays]
    )
    got = _port_grads(arrays, torch.bfloat16)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g, r, atol=BF16_TOL, rtol=BF16_TOL, err_msg=name)


@pytest.mark.parametrize(
    "bias_shape", [(2, 4, 50, 50), (1, 1, 50, 50), (1, 4, 50, 50), (2, 1, 50, 50)]
)
def test_fused_bias_grads_match_dense_recompute(bias_shape):
    """With a bias the backward is the dense recompute, with the bias
    gradient summed over its broadcast axes: against sav_tpu's
    ``_dense_recompute_bwd`` and against jax.grad through its fused kernel."""
    from sav_tpu.ops.flash_attention import _dense_recompute_bwd

    q, k, v = _qkv(2, 50, 50, 4, 32, seed=22)
    bias = np.random.default_rng(23).standard_normal(bias_shape).astype(np.float32)
    g = np.random.default_rng(24).standard_normal(q.shape).astype(np.float32)
    scale = 32 ** -0.5
    ref = _dense_recompute_bwd(*map(jnp.asarray, (q, k, v, bias, g)), scale)
    got = port_attention.dense_recompute_bwd(*_port((q, k, v, bias, g)), scale)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert tuple(a.shape) == r.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)

    jax_grads = _jax_grads(jax_fused_attention, (q, k, v, bias))
    port_grads = _port_grads((q, k, v, bias))
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), port_grads, jax_grads):
        np.testing.assert_allclose(a, r, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize(
    "b,lq,lk,h,d", [(2, 197, 197, 2, 64), (2, 50, 50, 2, 32), (2, 1, 197, 2, 64), (2, 196, 49, 2, 64)]
)
def test_bwd_reference_matches_autograd_of_fwd_reference(b, lq, lk, h, d):
    """The backward kernel's plain version is the exact derivative of the
    forward's plain version (f32, where the casts are no-ops)."""
    q, k, v = (t.requires_grad_() for t in _port(_qkv(b, lq, lk, h, d, seed=25)))
    out, lse = port_fused.fused_attention_reference(q, k, v, with_lse=True)
    g = torch.from_numpy(np.random.default_rng(26).standard_normal(out.shape).astype(np.float32))
    ref = torch.autograd.grad(out, (q, k, v), g)
    got = port_fused.fused_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(), g
    )
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=2e-5, rtol=2e-5)


def test_bwd_reference_casts_like_the_tpu_kernel():
    """bf16: ds is rounded to the k/q dtype before dq/dk and p to the dO
    dtype before dv, all products summed in f32 (``_fused_bwd_kernel``)."""
    q, k, v = _port(_qkv(1, 8, 8, 1, 32, seed=27), torch.bfloat16)
    out, lse = port_fused.fused_attention_reference(q, k, v, with_lse=True)
    g = torch.from_numpy(np.random.default_rng(28).standard_normal(out.shape).astype(np.float32)).bfloat16()
    dq, dk, dv = port_fused.fused_attention_bwd_reference(q, k, v, out, lse, g)
    scale = 32 ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float()) - delta)
    want_dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), g.float()).bfloat16()
    want_dq = (torch.einsum("bhqk,bkhd->bqhd", ds.bfloat16().float(), k.float()) * scale).bfloat16()
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert torch.equal(dv, want_dv) and torch.equal(dq, want_dq)


def test_bwd_wrapper_runs_plain_version_on_cpu_and_counts_no_launch():
    q, k, v = _port(_qkv(2, 17, 17, 2, 32, seed=29))
    out, lse = port_fused.fused_attention(q, k, v, with_lse=True)
    g = torch.ones_like(out)
    port_fused.reset_launches()
    got = port_fused.fused_attention_bwd(q, k, v, out, lse, g)
    want = port_fused.fused_attention_bwd_reference(q, k, v, out, lse, g)
    assert port_fused.LAUNCHES == port_fused.BWD_LAUNCHES == 0
    assert sum(port_fused.BWD_VARIANT_LAUNCHES.values()) == 0
    for a, r in zip(got, want):
        assert torch.equal(a, r)


def test_backward_band_counts_the_backward_bytes():
    # The CUDA-core variant (f32, and bf16 above head dim 128) keeps f32
    # dK/dV in shared memory: at L=197, D=64, f32 takes 1 row per warp
    # (224,928 bytes); in bf16 its rule would take 4 (225,184 bytes).
    assert port_fused.fused_bwd_smem_bytes(197, 64, 2, 4) == 225184
    assert port_fused.fused_bwd_rows(197, 64, 2) == 4
    assert port_fused.fused_bwd_smem_bytes(197, 64, 4, 1) == 224928
    assert port_fused.fused_bwd_rows(197, 64, 4) == 1
    assert port_fused.fused_eligible(197, 197, 64, itemsize=4, backward=True)
    assert not port_fused.fused_eligible(204, 204, 64, itemsize=4, backward=True)
    # The tensor-core variant (bf16 up to head dim 128) keeps bf16 K/V (208
    # rows of 72), two stages of 32-row q and dO tiles, a 256 x 40 dS tile
    # and the lse and delta of 224 q rows: 100,608 bytes at L=197, D=64,
    # one round of kv rows.
    assert port_fused.fused_bwd_mma_smem_bytes(197, 197, 64) == 100608
    assert port_fused.fused_bwd_mma_smem_bytes(1, 197, 64) == 100608 - 192 * 8
    assert port_fused.fused_bwd_mma_rounds(197, 64) == 1
    assert port_fused.fused_bwd_mma_rounds(197, 128) == 2  # 8 warps above 64
    assert port_fused.fused_eligible(264, 264, 64, backward=True)
    assert port_fused.fused_eligible(640, 640, 64, backward=True)
    assert not port_fused.fused_eligible(641, 641, 64, backward=True)
    # auto's crossover to the flash kernels stays at kv 264 for D=64.
    assert port_fused.fused_auto_eligible(264, 264, 64, backward=True)
    assert not port_fused.fused_auto_eligible(268, 268, 64, backward=True)
    assert port_fused.fused_eligible(577, 577, 64)  # ViT at 384: forward only
    resolve = port_attention.resolve_attention_backend
    assert resolve(577, 577, 64) == "fused"
    assert resolve(577, 577, 64, backward=True) == "pallas"  # trains through flash
    # Past the tensor-core backward's band (640) and inside the forward's
    # (800 at D=64 in bf16 on the tensor cores), a differentiated call raises.
    assert port_fused.fused_eligible(672, 672, 64)
    q, k, v = (t.requires_grad_() for t in _port(_qkv(1, 8, 672, 1, 64), torch.bfloat16))
    with pytest.raises(ValueError, match="flash kernels"):
        port_fused.fused_attention(q, k, v)
    with torch.no_grad():  # the forward alone still takes the shape
        assert port_fused.fused_attention(q, k, v).shape == (1, 8, 1, 64)


def test_with_lse_is_forward_only():
    q, k, v = (t.requires_grad_() for t in _port(_qkv(1, 8, 8, 1, 32)))
    with pytest.raises(ValueError, match="forward-only"):
        port_fused.fused_attention(q, k, v, with_lse=True)


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_dot_product_attention_grads_match_sav_tpu(backend):
    """The seam is differentiable on both backends: against jax.grad of
    sav_tpu's dispatched attention on the same backend (f32)."""
    from sav_tpu.ops.attention import dot_product_attention as jax_dpa

    arrays = _qkv(2, 17, 17, 2, 32, seed=30)
    ref = _jax_grads(lambda q, k, v: jax_dpa(q, k, v, backend=backend, logits_dtype=jnp.float32), arrays)
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = port_attention.dot_product_attention(*tensors, backend=backend, logits_dtype="float32")
    out.square().sum().backward()
    for name, t, r in zip("qkv", tensors, ref):
        np.testing.assert_allclose(t.grad.numpy(), r, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_backward_variant_rule():
    """bf16 at head dims up to 128 runs the backward on the tensor cores;
    f32 at any head dim, and bf16 above 128, on the CUDA cores (exact f32,
    no TF32)."""
    tc, cc = port_fused.TENSOR_CORE, port_fused.CUDA_CORE
    for dim in (8, 32, 40, 48, 64, 72, 128):
        assert port_fused.fused_bwd_variant(dim, 2) == tc
        assert port_fused.fused_bwd_variant(dim, 4) == cc
    for dim in (136, 256):
        assert port_fused.fused_bwd_variant(dim, 2) == cc
    # 16 warps of 16 kv rows up to head dim 64, 8 above.
    assert [port_fused.fused_bwd_mma_warps(d) for d in (8, 48, 64, 72, 128)] == [16, 16, 16, 8, 8]
    assert [port_fused.fused_bwd_mma_rounds(kv, 64) for kv in (1, 256, 257, 640)] == [1, 1, 2, 3]


@pytest.mark.parametrize("itemsize", [2, 4])
def test_backward_band_holds_every_shape_auto_sends(itemsize):
    """Every (kv_len, head_dim) that auto's rule sends to the fused backward
    is inside the band of the variant that runs it, at every head dim the
    kernel takes; in bf16 the tensor-core band is the wider one."""
    for dim in range(8, 257, 8):
        auto = [kv for kv in range(1, 1300, 3)
                if port_fused.fused_auto_eligible(kv, kv, dim, itemsize=itemsize, backward=True)]
        assert all(port_fused.fused_eligible(kv, kv, dim, itemsize=itemsize, backward=True)
                   for kv in auto), dim
        if itemsize == 2 and dim <= port_fused.MMA_MAX_DIM:
            assert port_fused.fused_eligible(max(auto) + 8, max(auto) + 8, dim, backward=True), dim


def test_forward_variant_rule():
    """bf16 at head dims up to 128 runs the forward on the tensor cores; f32
    at any head dim, and bf16 above 128, on the CUDA cores (exact f32, no
    TF32); another itemsize is refused. The wrapper tallies each launch
    under its variant, and the CPU plain path under none."""
    tc, cc = port_fused.TENSOR_CORE, port_fused.CUDA_CORE
    for dim in (8, 32, 40, 48, 64, 72, 128):
        assert port_fused.fused_fwd_variant(dim, 2) == tc
        assert port_fused.fused_fwd_variant(dim, 4) == cc
    for dim in (136, 256):
        assert port_fused.fused_fwd_variant(dim, 2) == cc
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        port_fused.fused_fwd_variant(64, 8)
    # 4 warps of 32 rows up to head dim 64, of 16 above.
    assert [port_fused.fused_fwd_mma_rows(d) for d in (8, 40, 64, 72, 128)] == [128, 128, 128, 64, 64]
    port_fused.reset_launches()
    port_fused.fused_attention(*_port(_qkv(1, 8, 8, 1, 32), torch.bfloat16), with_lse=True)
    assert port_fused.LAUNCHES == 0
    assert port_fused.FWD_VARIANT_LAUNCHES == {tc: 0, cc: 0}


@pytest.mark.parametrize(
    "q_len,kv_len,dim",
    [
        (197, 197, 64),  # DeiT-S serve and train
        (1, 197, 48),  # CaiT-XXS class attention
        (577, 577, 64),  # ViT-B/16@384 serve
        (1, 577, 48),  # CaiT class attention at 384², serve
    ],
)
def test_every_bf16_main_path_shape_takes_the_tensor_core_forward(q_len, kv_len, dim):
    """The variant-aware shared-memory rule keeps every bf16 main-path shape
    of the forward inside the band, on the tensor cores, and ``auto``
    serves it through the fused forward."""
    assert port_fused.fused_eligible(q_len, kv_len, dim, itemsize=2)
    assert port_fused.fused_fwd_variant(dim, 2) == port_fused.TENSOR_CORE
    assert port_fused.fused_smem_bytes(kv_len, dim, 2) <= port_fused.SMEM_LIMIT
    assert port_attention.resolve_attention_backend(q_len, kv_len, dim) == "fused"


def test_tensor_core_band_takes_every_shape_of_the_cuda_core_band():
    """In bf16 up to head dim 128 the tensor-core forward takes every kv
    length the CUDA-core forward took (its bf16 K/V rows are smaller than
    the CUDA-core block's K/V and f32 score columns), and more; ``auto``
    keeps the CUDA-core band, so its forward crossover to the flash kernels
    does not move (kv 679 at head dim 64)."""
    for dim in range(8, port_fused.MMA_MAX_DIM + 1, 8):
        old = [kv for kv in range(1, 2600, 7)
               if port_fused._cuda_core_smem_bytes(kv, dim, 2) <= port_fused.SMEM_LIMIT]
        assert all(port_fused.fused_eligible(kv, kv, dim, itemsize=2) for kv in old), dim
        assert port_fused.fused_eligible(max(old) + 7, max(old) + 7, dim, itemsize=2), dim
        assert not port_fused.fused_auto_eligible(max(old) + 7, max(old) + 7, dim), dim
    assert port_fused.fused_auto_eligible(679, 679, 64)
    assert not port_fused.fused_auto_eligible(680, 680, 64)
    assert port_fused.fused_eligible(800, 800, 64) and not port_fused.fused_eligible(801, 801, 64)
    resolve = port_attention.resolve_attention_backend
    assert resolve(679, 679, 64) == "fused" and resolve(700, 700, 64) == "pallas"


def _full_row_softmax_f64(q, k, v, bias=None, block_kv=None):
    """Attention in float64 with p rounded to bf16 (the value dtype) before
    PV and the division by l last: over the whole kv row after its max
    (``block_kv=None``), or as an online softmax over tiles of ``block_kv``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * q.shape[-1] ** -0.5
    if bias is not None:
        s = s + bias.double()
    block_kv = block_kv or s.shape[-1]
    m = torch.full(s.shape[:-1] + (1,), float("-inf"), dtype=torch.float64)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (q.shape[-1],), dtype=torch.float64)
    for start in range(0, s.shape[-1], block_kv):
        st = s[..., start:start + block_kv]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(torch.float32).to(torch.bfloat16).double(),
                          v[:, start:start + block_kv].double())
        acc = acc * alpha + pv
        m = m_new
    return (acc / l).permute(0, 2, 1, 3), (m + torch.log(l)).squeeze(-1)


def _rows_within(got, want, tol):
    """Share of output rows (all head-dim entries of one query of one head)
    within ``tol`` of ``want``."""
    return ((got.double() - want).abs().amax(-1) <= tol).double().mean().item()


@pytest.mark.parametrize("with_bias", [False, True])
def test_forward_reference_rounds_p_after_the_full_row_max(with_bias):
    """The plain version the card holds the tensor-core forward against
    takes the full-row max before it rounds p to the value dtype, and divides
    by the f32 row sum last: against a float64 twin that does the same (f32 q
    and k, bf16 v, so the output stays f32 and the cast of p is the only bf16
    rounding) its rows agree to 1e-6, but for the rare p that sits within f32
    rounding of a bf16 rounding boundary and rounds the other way, which
    moves its row by one bf16 ulp of that p (at most 1e-3 here); the lse
    agrees to 1e-6. An online softmax at the flash kernels' 64-column tile
    rounds p per tile: most rows move by more than 1e-6, so the tensor-core
    forward must not reuse it."""
    q, k, v = _port(_qkv(2, 40, 200, 2, 32, seed=32))
    v = v.bfloat16()
    bias = torch.from_numpy(
        np.random.default_rng(33).standard_normal((2, 1, 40, 200)).astype(np.float32)
    ) if with_bias else None
    out, lse = port_fused.fused_attention_reference(q, k, v, bias, with_lse=True)
    want, want_lse = _full_row_softmax_f64(q, k, v, bias)
    torch.testing.assert_close(lse.double(), want_lse, atol=1e-6, rtol=1e-6)
    assert _rows_within(out, want, 1e-6) >= 0.9
    assert _rows_within(out, want, 1e-3) == 1.0
    online, online_lse = _full_row_softmax_f64(q, k, v, bias, block_kv=64)
    torch.testing.assert_close(online_lse, want_lse, atol=1e-9, rtol=1e-9)
    assert _rows_within(out, online, 1e-6) < 0.5
