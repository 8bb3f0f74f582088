"""The port's flash attention (sav_tpu_torch.ops.flash_attention) against
sav_tpu's, on the CPU.

On CPU tensors the port's wrappers run their plain versions
(``flash_attention_reference``, ``flash_bwd_dq_reference``,
``flash_bwd_dkv_reference``), so these tests hold the kernels' arithmetic
against sav_tpu's ``flash_attention`` (the Pallas kernels in interpret mode)
from the same numpy inputs. The CUDA kernels themselves are checked against
the same plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops.flash_attention import _flash_forward
from sav_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from sav_tpu_torch.ops import attention as port_attention
from sav_tpu_torch.ops import flash_attention as port_flash

torch.set_num_threads(2)

# tests/test_flash_attention.py: f32 forward 2e-5 (:41), bf16 3e-2 (:131),
# blocked-backward gradients 1e-4 / 5e-4 (:104), biased gradients
# 5e-5 / 5e-4 (:73).
F32_TOL = 2e-5
BF16_TOL = 3e-2
GRAD_ATOL, GRAD_RTOL = 1e-4, 5e-4
BIAS_GRAD_ATOL = 5e-5


def _qkv(b, lq, lk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, lq, h, d), (b, lk, h, d), (b, lk, h, d))
    )


def _port(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _blocks(blk):
    return {} if blk is None else {"block_q": blk, "block_kv": blk}


@pytest.mark.parametrize(
    "b,lq,lk,h,d,blk",
    [
        (1, 130, 130, 1, 64, None),  # three of the port's 64-row kv tiles
        (1, 50, 50, 1, 32, None),  # ragged
        (1, 1, 130, 1, 64, None),  # one query row (class attention)
        (1, 130, 49, 1, 64, None),  # short kv
        # 128-row blocks on the JAX side so that its cross-tile path runs too.
        (1, 200, 136, 1, 40, 128),
    ],
)
def test_plain_forward_matches_pallas_kernel_f32(b, lq, lk, h, d, blk):
    q, k, v = _qkv(b, lq, lk, h, d)
    ref = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v)), **_blocks(blk)))
    out = port_flash.flash_attention(*_port((q, k, v)))
    assert out.dtype == torch.float32 and out.shape == (b, lq, h, d)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)


def test_plain_forward_matches_pallas_kernel_bf16():
    q, k, v = _qkv(1, 130, 130, 1, 64, seed=1)
    ref = jax_flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    out = port_flash.flash_attention(*_port((q, k, v), torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=BF16_TOL, rtol=BF16_TOL
    )


@pytest.mark.parametrize("b,lq,lk,h,d", [(1, 130, 130, 1, 64), (2, 50, 50, 2, 32)])
def test_lse_matches_pallas_residual(b, lq, lk, h, d):
    """The f32 lse ``[B, H, Lq]`` is lane 0 of the TPU's padded, lane-broadcast
    ``[B·H, q_len_p, 128]`` residual."""
    q, k, v = _qkv(b, lq, lk, h, d, seed=2)
    _, ref = _flash_forward(
        *map(jnp.asarray, (q, k, v)), None, d ** -0.5, 256, 256, None, with_lse=True
    )
    ref = np.asarray(ref)[:, :lq, 0].reshape(b, h, lq)
    out, lse = port_flash.flash_attention(*_port((q, k, v)), with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, lq)
    np.testing.assert_allclose(lse.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("bias_shape", [(2, 2, 50, 50), (1, 1, 50, 50)])
def test_bias_patterns_match_pallas_kernel(bias_shape):
    q, k, v = _qkv(2, 50, 50, 2, 32, seed=3)
    bias = np.random.default_rng(4).standard_normal(bias_shape).astype(np.float32)
    ref = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v, bias))))
    out = port_flash.flash_attention(*_port((q, k, v, bias)))
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)


def _jax_grads(arrays, **kw):
    def loss(*args):
        return jnp.sum(jnp.square(jax_flash_attention(*args, **kw)))

    return jax.grad(loss, argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))


def _port_grads(arrays):
    inputs = [t.requires_grad_() for t in _port(arrays)]
    out = port_flash.flash_attention(*inputs)
    torch.square(out).sum().backward()
    return [t.grad for t in inputs]


@pytest.mark.parametrize(
    "b,lq,lk,h,d,blk",
    [
        (1, 50, 50, 1, 32, None),  # padded q rows and kv columns
        (1, 1, 130, 1, 64, None),  # one query row
        (1, 200, 136, 1, 40, 128),  # several q and kv tiles, odd head dim
    ],
)
def test_blocked_grads_match_jax_grad_of_pallas_kernel(b, lq, lk, h, d, blk):
    arrays = _qkv(b, lq, lk, h, d, seed=5)
    ref = _jax_grads(arrays, **_blocks(blk))
    port_flash.reset_launches()
    got = _port_grads(arrays)
    assert port_flash.LAUNCHES == port_flash.BWD_DQ_LAUNCHES == port_flash.BWD_DKV_LAUNCHES == 0
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def test_biased_grads_go_through_the_dense_recompute():
    """With a bias the backward is the dense recompute, with dbias
    un-broadcast to the bias's (1, H) shape."""
    arrays = (*_qkv(2, 50, 50, 2, 32, seed=6),
              np.random.default_rng(7).standard_normal((1, 2, 50, 50)).astype(np.float32))
    ref = _jax_grads(arrays)
    got = _port_grads(arrays)
    assert got[3].shape == (1, 2, 50, 50)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=BIAS_GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("b,lq,lk,h,d", [(2, 70, 130, 2, 16), (1, 1, 65, 1, 8)])
def test_plain_backward_is_the_derivative_of_the_plain_forward(b, lq, lk, h, d):
    q, k, v = (t.requires_grad_() for t in _port(_qkv(b, lq, lk, h, d, seed=8)))
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((b, lq, h, d)).astype(np.float32))
    out, lse = port_flash.flash_attention_reference(q, k, v, with_lse=True)
    want = torch.autograd.grad(out, (q, k, v), g)
    got = port_flash.flash_attention_bwd_reference(q, k, v, out.detach(), lse.detach(), g)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, r, atol=F32_TOL, rtol=F32_TOL, msg=name)


def test_forward_reference_rounds_like_online_softmax_step():
    """bf16: the unnormalised p is cast to the value dtype before PV, tile by
    tile, and the division by the f32 row sum comes last; so the result
    depends on the kv tile, and one tile equals the fused kernel's order."""
    from sav_tpu_torch.ops import fused_attention as port_fused

    q, k, v = _port(_qkv(1, 8, 96, 1, 32, seed=10), torch.bfloat16)
    one_tile = port_flash.flash_attention_reference(q, k, v, block_kv=96)
    assert torch.equal(one_tile, port_fused.fused_attention_reference(q, k, v))
    scale = 32 ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m0 = s[..., :64].amax(-1, keepdim=True)
    m1 = torch.maximum(m0, s[..., 64:].amax(-1, keepdim=True))
    p0, p1 = torch.exp(s[..., :64] - m0), torch.exp(s[..., 64:] - m1)
    alpha = torch.exp(m0 - m1)
    l = alpha * p0.sum(-1, keepdim=True) + p1.sum(-1, keepdim=True)

    def pv(p, vv):
        return torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(), vv.float())

    acc = pv(p0, v[:, :64]) * alpha + pv(p1, v[:, 64:])
    want = (acc / l).permute(0, 2, 1, 3).bfloat16()
    assert torch.equal(port_flash.flash_attention_reference(q, k, v), want)


def test_bwd_reference_casts_like_the_tpu_kernels():
    """bf16: ds is rounded to the k/q dtype before dq/dk and p to the dO
    dtype before dv, all products summed in f32, the scale applied to the
    f32 dq/dk products (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``)."""
    q, k, v = _port(_qkv(1, 8, 8, 1, 32, seed=11), torch.bfloat16)
    out, lse = port_flash.flash_attention_reference(q, k, v, with_lse=True)
    g = torch.from_numpy(np.random.default_rng(12).standard_normal(out.shape).astype(np.float32)).bfloat16()
    dq, dk, dv = port_flash.flash_attention_bwd_reference(q, k, v, out, lse, g)
    scale = 32 ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float()) - delta)
    want_dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), g.float()).bfloat16()
    want_dq = (torch.einsum("bhqk,bkhd->bqhd", ds.bfloat16().float(), k.float()) * scale).bfloat16()
    want_dk = (torch.einsum("bhqk,bqhd->bkhd", ds.bfloat16().float(), q.float()) * scale).bfloat16()
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert torch.equal(dv, want_dv) and torch.equal(dq, want_dq) and torch.equal(dk, want_dk)


def test_wrappers_run_plain_versions_on_cpu_and_count_no_launch():
    q, k, v = _port(_qkv(2, 70, 70, 2, 32, seed=13))
    port_flash.reset_launches()
    out, lse = port_flash.flash_attention(q, k, v, with_lse=True)
    g = torch.ones_like(out)
    delta = port_flash.bwd_delta(out, g)
    dq = port_flash.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale=32 ** -0.5)
    dk, dv = port_flash.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale=32 ** -0.5)
    assert port_flash.LAUNCHES == port_flash.BWD_DQ_LAUNCHES == port_flash.BWD_DKV_LAUNCHES == 0
    for a, r in zip((dq, dk, dv), port_flash.flash_attention_bwd_reference(q, k, v, out, lse, g)):
        assert torch.equal(a, r)


def test_eligibility_and_shared_memory_rule():
    assert all(port_flash.flash_eligible(d) for d in (8, 16, 32, 40, 48, 64, 128))
    assert port_flash.flash_eligible(60)  # zero-padded to 64 by the wrappers
    assert not port_flash.flash_eligible(130)  # padded to 136: over MAX_DIM
    assert not port_flash.flash_eligible(256)  # over MAX_DIM
    # 64-row f32 tiles at a row stride of D + 4, and 64 x 68 score tiles.
    assert port_flash.flash_smem_bytes(64) == {"fwd": 69632, "bwd_dq": 87040, "bwd_dkv": 104960}
    assert max(port_flash.flash_smem_bytes(128).values()) == 170496
    # bf16: the tensor-core variants keep bf16 rows of round_up(D, 16) + 8:
    # the forward a 128-row q tile and two stages of 64-row k and v tiles,
    # dq 64 q and dO rows and the same k/v ring, dk/dv 64 k and v rows, two
    # stages of 64-row q and dO tiles and their f32 lse and delta.
    assert port_flash.flash_smem_bytes(64, itemsize=2) == {
        "fwd": 55296, "bwd_dq": 384 * 72 * 2, "bwd_dkv": 384 * 72 * 2 + 1024}
    assert port_flash.flash_smem_bytes(40, itemsize=2)["fwd"] == 384 * 56 * 2
    assert port_flash.flash_smem_bytes(128, itemsize=2)["fwd"] == 104448
    assert all(port_flash.flash_eligible(d, itemsize=2) for d in (8, 16, 32, 40, 48, 64, 128))
    assert not port_flash.flash_eligible(136, itemsize=2)
    q, k, v = _port(_qkv(1, 8, 8, 1, 130))
    with pytest.raises(ValueError, match="multiple of 8"):
        port_flash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="forward-only"):
        port_flash.flash_attention(*(t.requires_grad_() for t in _port(_qkv(1, 8, 8, 1, 32))),
                                   with_lse=True)


def test_dispatch_takes_flash_outside_the_fused_band():
    """``pallas`` runs the flash path; ``auto`` keeps the fused kernel inside
    its band and takes flash where a grad is needed past the fused
    backward's band (kv > 264 at head dim 64), raising only for head dims
    flash does not take."""
    resolve = port_attention.resolve_attention_backend
    assert resolve(577, 577, 64) == "fused"  # forward band holds ViT at 384
    assert resolve(577, 577, 64, backward=True) == "pallas"
    assert resolve(1, 577, 48, backward=True) == "pallas"  # CaiT class attention at 384
    assert resolve(197, 197, 64, backward=True) == "fused"
    with pytest.raises(NotImplementedError, match="multiples of 8"):
        resolve(4096, 4096, 256)
    q, k, v = _port(_qkv(1, 300, 300, 1, 64, seed=14))
    out = port_attention.dot_product_attention(q, k, v, backend="pallas")
    assert torch.equal(out, port_flash.flash_attention_reference(q, k, v))
    q.requires_grad_()
    out = port_attention.dot_product_attention(q, k, v)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__


def test_forward_variant_rule():
    """bf16 runs the forward on the tensor cores, f32 on the CUDA cores (no
    TF32); the wrapper tallies each launch under its variant, and the CPU
    plain path under none."""
    assert port_flash.flash_fwd_variant(2) == port_flash.TENSOR_CORE
    assert port_flash.flash_fwd_variant(4) == port_flash.CUDA_CORE
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        port_flash.flash_fwd_variant(8)
    port_flash.reset_launches()
    port_flash.flash_attention(*_port(_qkv(1, 8, 8, 1, 32), torch.bfloat16))
    assert port_flash.VARIANT_LAUNCHES == {port_flash.TENSOR_CORE: 0, port_flash.CUDA_CORE: 0}
    assert port_flash.MMA_BLOCK_KV == port_flash.BLOCK == 64


def _online_softmax_f64(q, k, v, block_kv):
    """The online softmax in float64, tile by tile, with p rounded to bf16
    (the value dtype) before PV and the division by l last."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * q.shape[-1] ** -0.5
    m = torch.full(s.shape[:-1] + (1,), float("-inf"), dtype=torch.float64)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (q.shape[-1],), dtype=torch.float64)
    for start in range(0, k.shape[1], block_kv):
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


def test_reference_at_the_tensor_core_kv_tile_matches_float64():
    """The plain version the card holds the bf16 forward against, at the
    kernel's kv tile (passed explicitly), is the online softmax at that tile:
    against a float64 twin that rounds p to bf16 at the same tile, it agrees
    to f32 rounding (f32 q and k, bf16 v, so the output stays f32 and the
    cast of p is the only bf16 rounding). A tile of another size moves the
    result by more than that."""
    q, k, v = _port(_qkv(2, 40, 200, 2, 32, seed=31))
    v = v.bfloat16()
    out, lse = port_flash.flash_attention_reference(
        q, k, v, block_kv=port_flash.MMA_BLOCK_KV, with_lse=True)
    want, want_lse = _online_softmax_f64(q, k, v, port_flash.MMA_BLOCK_KV)
    torch.testing.assert_close(out.double(), want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse.double(), want_lse, atol=1e-6, rtol=1e-6)
    other, _ = _online_softmax_f64(q, k, v, 40)
    assert (other - want).abs().max() > 1e-4


@pytest.mark.parametrize("dtype,serve_577", [(torch.bfloat16, "fused"), (torch.float32, "pallas")])
def test_dispatch_at_every_main_path_shape_is_unchanged(dtype, serve_577):
    """Where each main path's attention goes: DeiT-S (197 tokens, 6 heads of
    64) and CaiT's class attention (1 query over 197) take the fused
    kernels both ways; the ViT-B/16@384 fine-tune (577) and CaiT's class
    attention at 384² (1 over 577) train through the flash kernels and
    serve through the fused forward in bf16 (in f32 its K/V outgrow the
    fused forward's shared memory, so flash); BoTNet-T3's stage 4 (14x14
    and 7x7, 4 heads of 128) takes the relative-position kernels."""
    resolve = port_attention.resolve_attention_backend
    for q_len, kv_len, dim, train, serve in (
        (197, 197, 64, "fused", "fused"),
        (1, 197, 48, "fused", "fused"),
        (577, 577, 64, "pallas", serve_577),
        (1, 577, 48, "pallas", serve_577),
    ):
        assert resolve(q_len, kv_len, dim, dtype=dtype, backward=True) == train
        assert resolve(q_len, kv_len, dim, dtype=dtype) == serve
    for grid in (14, 7):
        assert port_attention.resolve_relative_backend(grid, grid, 128) == "pallas"


def test_backward_variant_rule():
    """bf16 runs dq and dk/dv on the tensor cores, f32 on the CUDA cores (no
    TF32), as the forward; any other itemsize raises."""
    assert port_flash.flash_bwd_variant(2) == port_flash.TENSOR_CORE
    assert port_flash.flash_bwd_variant(4) == port_flash.CUDA_CORE
    for itemsize in (1, 8):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            port_flash.flash_bwd_variant(itemsize)


@pytest.mark.parametrize("dim", range(8, 136, 8))
def test_bf16_backward_blocks_fit_at_every_head_dim(dim):
    """The tensor-core dq and dk/dv blocks fit the 227 KB a block may have at
    every head dim the kernels take, so ``flash_eligible`` takes the same
    head dims in both dtypes."""
    smem = port_flash.flash_smem_bytes(dim, itemsize=2)
    row = (-(-dim // 16) * 16 + 8) * 2
    assert smem["bwd_dq"] == (2 * port_flash.BWD_MMA_ROWS + 4 * port_flash.BLOCK) * row
    assert smem["bwd_dkv"] == ((2 * port_flash.BWD_MMA_ROWS + 4 * port_flash.BWD_MMA_Q_TILE) * row
                               + 4 * port_flash.BWD_MMA_Q_TILE * 4)
    assert max(smem.values()) <= port_flash.SMEM_LIMIT
    assert port_flash.flash_eligible(dim, itemsize=2) and port_flash.flash_eligible(dim, itemsize=4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_wrappers_on_cpu_count_no_launch_in_any_tally(dtype):
    """On CPU tensors dq and dk/dv (directly and through autograd) run their
    plain versions and add to no counter and no tally by variant."""
    arrays = _qkv(1, 70, 40, 2, 32, seed=41)
    port_flash.reset_launches()
    q, k, v = (t.requires_grad_() for t in _port(arrays, dtype))
    out = port_flash.flash_attention(q, k, v)
    torch.square(out.float()).sum().backward()
    with torch.no_grad():
        out, lse = port_flash.flash_attention(q, k, v, with_lse=True)
        g = torch.ones_like(out)
        delta = port_flash.bwd_delta(out, g)
        port_flash.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale=32 ** -0.5)
        port_flash.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale=32 ** -0.5)
    assert q.grad is not None and q.grad.dtype == dtype
    assert port_flash.BWD_DQ_LAUNCHES == port_flash.BWD_DKV_LAUNCHES == port_flash.LAUNCHES == 0
    for tally in (port_flash.BWD_DQ_VARIANT_LAUNCHES, port_flash.BWD_DKV_VARIANT_LAUNCHES,
                  port_flash.VARIANT_LAUNCHES):
        assert tally == {port_flash.TENSOR_CORE: 0, port_flash.CUDA_CORE: 0}


def _bwd_f64(q, k, v, g, lse, delta, scale, rounded=True):
    """dq, dk and dv in float64 from the same lse and delta, with p rounded to
    the dO dtype before dV and ds to the k and q dtypes before dQ and dK
    (through f32, as the plain version casts its f32 values); ``rounded``
    False skips the roundings."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    p = torch.exp(s - lse.double()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g.double(), v.double())
    ds = p * (dp - delta.double()[..., None])

    def cast(x, dtype):
        return x.to(torch.float32).to(dtype).double() if rounded else x

    dq = torch.einsum("bhqk,bkhd->bqhd", cast(ds, k.dtype), k.double()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", cast(ds, q.dtype), q.double()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", cast(p, g.dtype), g.double())
    return dq, dk, dv


@pytest.mark.parametrize("b,lq,lk,h,d", [(2, 40, 200, 2, 32), (1, 130, 70, 2, 64)])
@pytest.mark.parametrize("output", ["dq", "dk", "dv"])
def test_bwd_references_match_float64_with_bf16_casts(b, lq, lk, h, d, output):
    """The plain dq and dk/dv against a float64 twin that rounds p and ds to
    bf16 at the same points: they agree to f32 rounding, row by row (an
    output row of each B, L, H). The cast under test is bf16 and every other
    operand f32, so each output stays f32: ds is cast to the k dtype for dq
    (bf16 k), p to the dO dtype for dv (bf16 dO), ds to the q dtype for dk
    (bf16 q). A p or ds within f32 rounding of a bf16 boundary rounds either
    way, so a few rows may differ by more, never by more than 1e-3; without
    the roundings most rows move by more than 1e-6. This is the plain
    versions' own error that the card's bf16 limits sit above."""
    q, k, v = _port(_qkv(b, lq, lk, h, d, seed=43))
    g = torch.from_numpy(np.random.default_rng(44).standard_normal(q.shape).astype(np.float32))
    out, lse = port_flash.flash_attention_reference(q, k, v, with_lse=True)
    delta = port_flash.bwd_delta(out, g)
    bf16 = {"dq": "k", "dv": "g", "dk": "q"}[output]
    operands = {"q": q, "k": k, "v": v, "g": g}
    operands[bf16] = operands[bf16].bfloat16()
    q, k, v, g = operands["q"], operands["k"], operands["v"], operands["g"]
    scale = d ** -0.5
    if output == "dq":
        got = port_flash.flash_bwd_dq_reference(q, k, v, g, lse, delta, scale=scale)
    else:
        got = port_flash.flash_bwd_dkv_reference(q, k, v, g, lse, delta, scale=scale)
        got = got[0] if output == "dk" else got[1]
    assert got.dtype == torch.float32
    index = ("dq", "dk", "dv").index(output)
    want = _bwd_f64(q, k, v, g, lse, delta, scale)[index]
    unrounded = _bwd_f64(q, k, v, g, lse, delta, scale, rounded=False)[index]

    def rows_within(x, tol):
        err = (got.double() - x).abs() - tol * (1 + x.abs())
        return (err <= 0).all(dim=-1).double().mean().item()

    assert rows_within(want, 1e-6) >= 0.9
    assert rows_within(want, 1e-3) == 1.0
    assert rows_within(unrounded, 1e-6) < 0.5
