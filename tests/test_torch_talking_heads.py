"""The port's talking-heads attention (sav_tpu_torch.ops.talking_heads) against
sav_tpu's, on the CPU.

Both sides take the same numpy inputs. On CPU tensors the port's wrappers run
their plain versions (the arithmetic of csrc/talking_heads.cu and
csrc/talking_heads_bwd.cu); sav_tpu's Pallas kernels run in interpret mode,
as tests/test_flash_attention.py runs them. Tolerances are theirs: f32
forward 5e-5, f32 gradients atol 5e-5 / rtol 5e-4, bf16 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import talking_heads as jax_th
from sav_tpu_torch.models.layers import SelfAttentionBlock
from sav_tpu_torch.ops import talking_heads as th

torch.set_num_threads(2)


def _inputs(b, l, h, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3))
    # Orthogonal mixing kernels, as TalkingHeadsBlock initialises them.
    w_pre, w_post = (np.linalg.qr(rng.standard_normal((h, h)))[0].astype(np.float32)
                     for _ in range(2))
    g = rng.standard_normal((b, l, h, d)).astype(np.float32)
    return q, k, v, w_pre, w_post, g


def _torch(arrays, dtype=torch.float32):
    q, k, v, w_pre, w_post = (torch.from_numpy(a) for a in arrays[:5])
    return q.to(dtype), k.to(dtype), v.to(dtype), w_pre, w_post


def _jax_grads(arrays, dtype, block_q):
    q, k, v, w_pre, w_post, g = (jnp.asarray(a) for a in arrays)
    q, k, v, g = (x.astype(dtype) for x in (q, k, v, g))

    def loss(q, k, v, wp, wq):
        out = jax_th.flash_talking_heads_attention(q, k, v, wp, wq, block_q=block_q)
        return jnp.sum(out.astype(jnp.float32) * g.astype(jnp.float32))

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(q, k, v, w_pre, w_post)


# (B, L, H, D) and the Pallas kernel's block_q: the CaiT-XXS trunk shape, and
# a small ragged shape over several q blocks.
SHAPES = [((2, 196, 4, 48), 256), ((2, 40, 3, 16), 16)]


@pytest.mark.parametrize("shape,block_q", SHAPES, ids=["cait-xxs", "ragged-multiblock"])
def test_plain_forward_matches_pallas_kernel(shape, block_q):
    arrays = _inputs(*shape)
    ref = jax_th.flash_talking_heads_attention(*map(jnp.asarray, arrays[:5]), block_q=block_q)
    got = th.flash_talking_heads_attention(*_torch(arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("shape,block_q", SHAPES, ids=["cait-xxs", "ragged-multiblock"])
def test_grads_match_jax_grad_of_pallas_kernel(shape, block_q):
    arrays = _inputs(*shape, seed=1)
    want = _jax_grads(arrays, jnp.float32, block_q)
    inputs = [t.requires_grad_() for t in _torch(arrays)]
    out = th.flash_talking_heads_attention(*inputs)
    got = torch.autograd.grad(out, inputs, torch.from_numpy(arrays[5]))
    for name, a, b in zip(("dq", "dk", "dv", "dw_pre", "dw_post"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=5e-4, err_msg=name)


def test_bf16_forward_and_grads_match_pallas_kernel():
    arrays = _inputs(2, 40, 3, 16, seed=2)
    q, k, v, w_pre, w_post = (jnp.asarray(a) for a in arrays[:5])
    ref = jax_th.flash_talking_heads_attention(
        q.astype(jnp.bfloat16), k.astype(jnp.bfloat16), v.astype(jnp.bfloat16),
        w_pre, w_post, block_q=16,
    )
    inputs = [t.requires_grad_() for t in _torch(arrays, torch.bfloat16)]
    out = th.flash_talking_heads_attention(*inputs)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().detach().numpy(), np.asarray(ref, np.float32),
                               atol=3e-2, rtol=3e-2)
    want = _jax_grads(arrays, jnp.bfloat16, 16)
    got = torch.autograd.grad(out, inputs, torch.from_numpy(arrays[5]).bfloat16())
    assert [t.dtype for t in got] == [torch.bfloat16] * 3 + [torch.float32] * 2
    for name, a, b in zip(("dq", "dk", "dv", "dw_pre", "dw_post"), got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=3e-2, rtol=3e-2, err_msg=name)


def test_dense_path_matches_sav_tpu_dense_reference():
    """The ``xla`` path (dense_talking_heads) against sav_tpu's dense
    reference, f32 and bf16 (q scaled in its own dtype, f32 logits, mixes
    and softmax)."""
    arrays = _inputs(2, 17, 4, 16, seed=3)
    for jdtype, tdtype, tol in ((jnp.float32, torch.float32, 2e-5), (jnp.bfloat16, torch.bfloat16, 3e-2)):
        q, k, v, w_pre, w_post = (jnp.asarray(a) for a in arrays[:5])
        ref = jax_th._th_dense_reference(q.astype(jdtype), k.astype(jdtype), v.astype(jdtype),
                                         w_pre, w_post, 16 ** -0.5)
        got = th.dense_talking_heads(*_torch(arrays, tdtype))
        assert got.dtype == tdtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(2, 40, 3, 16), (1, 33, 8, 8)])
def test_plain_backward_matches_autograd_of_plain_forward(shape):
    arrays = _inputs(*shape, seed=4)
    inputs = [t.requires_grad_() for t in _torch(arrays)]
    g = torch.from_numpy(arrays[5])
    want = torch.autograd.grad(th.talking_heads_reference(*inputs), inputs, g)
    got = th.talking_heads_bwd_reference(*[t.detach() for t in inputs], g)
    for name, a, b in zip(("dq", "dk", "dv", "dw_pre", "dw_post"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)


def test_wrappers_run_their_plain_versions_on_cpu_tensors():
    arrays = _inputs(2, 20, 2, 8, seed=5)
    q, k, v, w_pre, w_post = _torch(arrays)
    g = torch.from_numpy(arrays[5])
    assert torch.equal(th.flash_talking_heads_attention(q, k, v, w_pre, w_post),
                       th.talking_heads_reference(q, k, v, w_pre, w_post))
    for a, b in zip(th.talking_heads_bwd(q, k, v, w_pre, w_post, g),
                    th.talking_heads_bwd_reference(q, k, v, w_pre, w_post, g)):
        assert torch.equal(a, b)
    assert th.LAUNCHES == 0 and th.BWD_LAUNCHES == 0  # the plain versions launch nothing


def test_backward_outside_its_band_is_the_dense_recompute():
    """H=16 at L=196 fits the forward but not the backward: the autograd
    Function then differentiates the dense path, as ``_th_bwd`` does."""
    assert th.fused_eligible(16, 196, 48) and not th.fused_bwd_eligible(16, 196, 196, 48)
    arrays = _inputs(1, 196, 16, 48, seed=6)
    inputs = [t.requires_grad_() for t in _torch(arrays)]
    g = torch.from_numpy(arrays[5])
    got = torch.autograd.grad(th.flash_talking_heads_attention(*inputs), inputs, g)
    dense = [t.detach().clone().requires_grad_() for t in inputs]
    want = torch.autograd.grad(th.dense_talking_heads(*dense), dense, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="backward kernel"):
        th.talking_heads_bwd(*[t.detach() for t in inputs], g)


@pytest.mark.parametrize(
    "heads,kv_len,dim,itemsize,fwd,bwd",
    [
        (4, 196, 48, 2, True, True),  # CaiT-XXS at 224², bf16
        (4, 196, 48, 4, True, True),  # ... in f32
        (6, 196, 48, 2, True, True),  # CaiT-XS
        (8, 196, 48, 2, True, True),  # CaiT-S
        (8, 196, 48, 4, True, True),
        (16, 196, 48, 2, True, False),  # CaiT-M: forward only
        (16, 50, 48, 2, True, False),  # ... the backward is not built for 16 heads at all
        (2, 16, 16, 2, True, True),  # the small CaiT of these tests
        (5, 196, 48, 2, False, False),  # a head count the kernels are not built for
        (1, 196, 48, 2, False, False),
        (4, 196, 52, 2, False, False),  # head dim not a multiple of 8
        (4, 196, 136, 2, False, False),  # head dim past 128
        (4, 2000, 48, 2, False, False),  # kv past shared memory
    ],
)
def test_band_rules(heads, kv_len, dim, itemsize, fwd, bwd):
    assert th.fused_eligible(heads, kv_len, dim, itemsize=itemsize) is fwd
    assert th.fused_bwd_eligible(heads, kv_len, kv_len, dim, itemsize=itemsize) is bwd
    if fwd:
        assert th.th_smem_bytes(kv_len, heads, dim, itemsize, th.th_rows(kv_len, heads, dim, itemsize)) <= th.SMEM_LIMIT


def test_ineligible_shapes_raise():
    q = torch.zeros(1, 2000, 4, 48)
    w = torch.eye(4)
    with pytest.raises(ValueError, match="shared"):
        th.flash_talking_heads_attention(q, q, q, w, w)
    with pytest.raises(ValueError, match=r"\[H, H\]"):
        th._weights(torch.eye(3), w, 4)
    with pytest.raises(ValueError, match="mismatched"):
        th.flash_talking_heads_attention(q, q[:, :, :2], q, w, w)


def test_dispatch_rule():
    resolve = th.resolve_talking_heads_backend
    for requested in (None, "auto", "fused", "pallas"):
        assert resolve(4, 196, 48, requested=requested) == "fused"
    assert resolve(4, 196, 48, requested="xla") == "xla"
    assert resolve(4, 2000, 48) == "xla"  # auto outside the band: the dense path
    assert resolve(4, 2000, 48, requested="fused") == "fused"  # ... and 'fused' raises later
    with pytest.raises(ValueError, match="unknown"):
        resolve(4, 196, 48, requested="flash")


@pytest.mark.parametrize("backend,route", [(None, "kernel"), ("fused", "kernel"),
                                           ("pallas", "kernel"), ("xla", "dense")])
def test_attention_block_takes_the_route_of_its_backend(monkeypatch, backend, route):
    calls = []
    for name, tag in (("flash_talking_heads_attention", "kernel"), ("dense_talking_heads", "dense")):
        real = getattr(th, name)
        monkeypatch.setattr(th, name, lambda *a, _r=real, _t=tag, **kw: calls.append(_t) or _r(*a, **kw))
    block = SelfAttentionBlock(32, 4, talking_heads=True, backend=backend)
    block.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 10, 32, generator=torch.Generator().manual_seed(1))
    block(x).sum().backward()
    assert calls == [route]
    assert block.pre_softmax.kernel.grad is not None and block.post_softmax.kernel.grad is not None


@pytest.mark.parametrize(
    "heads,dim,itemsize,variant",
    [
        (4, 48, 2, th.TENSOR_CORE),  # CaiT-XXS in bf16: the main path
        (6, 48, 2, th.TENSOR_CORE),  # CaiT-XS
        (8, 48, 2, th.TENSOR_CORE),  # CaiT-S
        (2, 16, 2, th.TENSOR_CORE),  # the small CaiT of these tests
        (3, 32, 2, th.TENSOR_CORE),
        (4, 40, 2, th.TENSOR_CORE),  # padded to 48 in the tiles
        (4, 48, 4, th.CUDA_CORE),  # f32 stays exact on the CUDA cores
        (8, 48, 4, th.CUDA_CORE),
        (16, 48, 2, th.CUDA_CORE),  # CaiT-M: outside the tensor-core head counts
        (4, 56, 2, th.CUDA_CORE),  # head dims past 48
        (4, 128, 2, th.CUDA_CORE),
    ],
)
def test_variant_rule_by_dtype_heads_and_dim(heads, dim, itemsize, variant):
    # One rule for both directions: in bf16 inside the band the forward and
    # the backward's dq and dk/dv kernels run on the tensor cores.
    assert th.th_variant(heads, dim, itemsize) == variant


def test_variant_rule_rejects_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        th.th_variant(4, 48, 8)


# The tensor-core blocks at CaiT-XXS's shape (H=4, D=48), as the header of
# csrc/talking_heads.cu and csrc/talking_heads_bwd.cu states them: heads a
# warp accumulates, warps, rows owned, rows streamed, shared-memory bytes,
# and blocks an SM's shared memory holds.
CAIT_XXS_BLOCKS = {
    "fwd": (4, 4, 64, 32, 86144, 2),
    "bwd_dq": (4, 4, 64, 32, 114816, 2),
    "bwd_dkv": (2, 4, 32, 32, 88192, 2),
}


@pytest.mark.parametrize("kind", th.MMA_KINDS)
def test_tensor_core_blocks_at_cait_xxs_mirror_the_c_sources(kind):
    ho, warps, rows, tile, smem, per_sm = CAIT_XXS_BLOCKS[kind]
    assert th.th_mma_heads_per_warp(kind, 4, 48) == ho
    assert th.th_mma_block(kind, 4, 48) == {"warps": warps, "rows": rows, "tile": tile}
    assert th.th_mma_smem_bytes(kind, 4, 48) == smem
    assert th.th_mma_blocks_per_sm(kind, 4, 48) == per_sm
    # Two blocks an SM is what the design relies on (launch bounds of 2).
    assert 2 * (smem + th.SMEM_PER_BLOCK_RESERVED) <= th.SMEM_PER_SM


@pytest.mark.parametrize("heads", th.MMA_HEADS)
@pytest.mark.parametrize("dim", [16, 32, 40, 48])
def test_tensor_core_layout_rules(heads, dim):
    """Every tensor-core block: the warp's heads divide the head count, a
    block is whole row groups of H / HO warps (4 warps where that divides
    4), it fits shared memory, and its live values stay in budget."""
    dk = -(-dim // 16) * 16
    for kind in th.MMA_KINDS:
        ho = th.th_mma_heads_per_warp(kind, heads, dim)
        groups = heads // ho
        block = th.th_mma_block(kind, heads, dim)
        assert heads % ho == 0
        assert block["warps"] % groups == 0 and block["rows"] == 16 * (block["warps"] // groups)
        assert block["warps"] == (4 if 4 % groups == 0 else groups)
        assert block["tile"] == (32 if heads <= 4 else 16)
        assert th.th_mma_smem_bytes(kind, heads, dim) + th.SMEM_PER_BLOCK_RESERVED <= th.SMEM_LIMIT
        assert th._mma_live_floats(kind, heads, ho, dk) <= th._MMA_LIVE_BUDGET[kind]
        if ho < heads:  # the next larger divisor would not fit
            larger = min(d for d in range(ho + 1, heads + 1) if heads % d == 0)
            assert th._mma_live_floats(kind, heads, larger, dk) > th._MMA_LIVE_BUDGET[kind]


def test_cait_m_backward_stays_outside_the_tensor_core_band():
    """CaiT-M's 16 heads of 48: the dq kernel would hold 256 live f32 values
    a thread at one head a warp (scores and dP' of 16 heads, 128; lse and
    delta, 64; dQ, dS and its dW rows, 64), over its budget of 240 of the
    255 registers a thread may have, so bf16 at 16 heads keeps the
    CUDA-core forward and, past that kernel's shared memory at L=196, the
    dense recompute for the backward."""
    assert th._mma_live_floats("bwd_dq", 16, 1, 48) == 256 > th._MMA_LIVE_BUDGET["bwd_dq"]
    assert 16 not in th.MMA_HEADS
    assert th.th_variant(16, 48, 2) == th.CUDA_CORE
    assert not th.fused_bwd_eligible(16, 196, 196, 48, itemsize=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrappers_count_no_launch_in_any_tally(dtype):
    arrays = _inputs(2, 20, 4, 16, seed=7)
    q, k, v, w_pre, w_post = _torch(arrays, dtype)
    g = torch.from_numpy(arrays[5]).to(dtype)
    th.reset_launches()
    th.flash_talking_heads_attention(q, k, v, w_pre, w_post)
    th.talking_heads_bwd(q, k, v, w_pre, w_post, g)
    inputs = [t.requires_grad_() for t in (q, k, v, w_pre, w_post)]
    torch.autograd.grad(th.flash_talking_heads_attention(*inputs), inputs, g)
    assert th.LAUNCHES == th.BWD_LAUNCHES == th.BWD_DKV_LAUNCHES == 0
    for tally in (th.VARIANT_LAUNCHES, th.BWD_VARIANT_LAUNCHES, th.BWD_DKV_VARIANT_LAUNCHES):
        assert tally == {th.TENSOR_CORE: 0, th.CUDA_CORE: 0}


def _th_bwd_f64(q, k, v, w_pre, w_post, g, scale, rounded=True):
    """dq, dk, dv, dW_pre and dW_post in float64, p' rounded (through f32)
    to the query dtype before dV and dS to the key dtype before dQ and dK,
    as the plain backward casts them; dW from the unrounded values.
    ``rounded`` False skips the roundings."""
    qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
    wp, wq = w_pre.double(), w_post.double()

    def cast(x, dtype):
        return x.to(torch.float32).to(dtype).double() if rounded else x

    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    p = torch.softmax(torch.einsum("hi,bhqk->biqk", wp, s), dim=-1)
    post = torch.einsum("hi,bhqk->biqk", wq, p)
    dpost = torch.einsum("bqid,bkid->biqk", gd, vd)
    dv = torch.einsum("biqk,bqid->bkid", cast(post, q.dtype), gd)
    dp = torch.einsum("hi,biqk->bhqk", wq, dpost)
    dsm = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    ds = cast(torch.einsum("hi,biqk->bhqk", wp, dsm), k.dtype)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kd) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, qd) * scale, dv,
            torch.einsum("bhqk,biqk->hi", s, dsm), torch.einsum("bhqk,biqk->hi", p, dpost))


@pytest.mark.parametrize("output", ["dq", "dv", "dw_pre", "dw_post"])
def test_bwd_reference_matches_float64_with_bf16_casts(output):
    """The plain backward against a float64 twin that rounds p' and dS to
    bf16 at the same points: they agree to f32 rounding, row by row. The
    cast under test is bf16 and every other operand f32, so the output
    stays f32: dS is cast to the k dtype before dq (bf16 k), p' to the
    query dtype before dv (bf16 q, and dO cast to it). dW_pre and dW_post
    follow no rounding (bf16 k). A p' or dS within f32 rounding of a bf16
    boundary rounds either way, so a few rows of dq and dv may differ by
    more, never by more than 1e-3; without the roundings most rows move by
    more than 1e-6. This is the plain version's own error that the card's
    bf16 limits sit above."""
    arrays = _inputs(2, 40, 3, 16, seed=8)
    q, k, v, w_pre, w_post = _torch(arrays)
    g = torch.from_numpy(arrays[5])
    bf16 = "q" if output == "dv" else "k"
    if bf16 == "q":
        q = q.bfloat16()
        g = g.bfloat16()  # the plain backward casts dO to the query dtype
    else:
        k = k.bfloat16()
    index = ("dq", "dk", "dv", "dw_pre", "dw_post").index(output)
    got = th.talking_heads_bwd_reference(q, k, v, w_pre, w_post, g)[index]
    assert got.dtype == torch.float32
    want = _th_bwd_f64(q, k, v, w_pre, w_post, g, 16 ** -0.5)[index]

    def rows_within(x, tol):
        err = (got.double() - x).abs() - tol * (1 + x.abs())
        return (err <= 0).all(dim=-1).double().mean().item()

    if output.startswith("dw"):
        # No rounding in the chain: every entry agrees to a few f32 ulps of
        # the sums over B·L·L products.
        assert rows_within(want, 1e-5) == 1.0
        return
    unrounded = _th_bwd_f64(q, k, v, w_pre, w_post, g, 16 ** -0.5, rounded=False)[index]
    assert rows_within(want, 1e-6) >= 0.9
    assert rows_within(want, 1e-3) == 1.0
    assert rows_within(unrounded, 1e-6) < 0.5


@pytest.mark.parametrize("shape", [(2, 40, 3, 16), (1, 33, 8, 8)])
def test_tensor_core_kernels_plain_versions_match_autograd_of_plain_forward(shape):
    """The dq kernel's plain version (dq, dW_pre, dW_post and each row's lse
    and delta) and the dk/dv kernel's, fed that lse and delta, give the
    gradients of the plain forward; delta is rowsum(p ⊙ dP) of the mixed
    heads, not the flash backward's rowsum(dO ⊙ O)."""
    arrays = _inputs(*shape, seed=9)
    q, k, v, w_pre, w_post = _torch(arrays)
    g = torch.from_numpy(arrays[5])
    dq, dw_pre, dw_post, lse, delta = th.talking_heads_bwd_dq_reference(q, k, v, w_pre, w_post, g)
    dk, dv = th.talking_heads_bwd_dkv_reference(q, k, v, w_pre, w_post, g, lse, delta)
    b, length, heads, _ = shape
    assert lse.shape == delta.shape == (b, heads, length)
    inputs = [t.clone().requires_grad_() for t in (q, k, v, w_pre, w_post)]
    out = th.talking_heads_reference(*inputs)
    want = torch.autograd.grad(out, inputs, g)
    for got, ref in zip((dq, dk, dv, dw_pre, dw_post), want):
        torch.testing.assert_close(got, ref, atol=5e-5, rtol=5e-4)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * shape[-1] ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(th._mix(w_pre, s), dim=-1))
    flash_delta = (g * out.detach()).sum(dim=-1).transpose(1, 2)
    assert not torch.allclose(delta, flash_delta, atol=1e-3)
