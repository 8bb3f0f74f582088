"""The port's BoTNet relative-position attention (the rel part of
sav_tpu_torch.ops.flash_attention) against sav_tpu's, on the CPU.

On CPU tensors the port's wrappers run their plain versions
(``rel_attention_reference``, ``rel_bwd_dq_reference``,
``rel_bwd_dkv_reference``), so these tests hold the kernels' arithmetic
against sav_tpu's Pallas kernels ``_rel_kernel``, ``_rel_bwd_dq_kernel`` and
``_rel_bwd_dkv_kernel`` in interpret mode, from the same numpy inputs, at
tiny shapes. The CUDA kernels themselves are checked against the same plain
versions on the card by ``chip_smoke.py``. Tolerances are
tests/test_botnet_kernel.py's: f32 forward 2e-5, gradients 1e-4 / 5e-4,
bf16 3e-2. About 45 s in one process.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu_torch.ops import attention as port_attention
from sav_tpu_torch.ops import flash_attention as port_flash

# sav_tpu.ops re-exports a function named flash_attention over the module.
jax_flash = importlib.import_module("sav_tpu.ops.flash_attention")

torch.set_num_threads(2)

F32_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=5e-4)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)

# (b, height, width, heads, d): the JAX tests' grids, and BoTNet's 14×14 with
# several of the port's 64-row tiles (L = 196).
GRIDS = {
    "7x9": (2, 7, 9, 3, 16),
    "5x6": (1, 5, 6, 2, 8),
    "2x130": (1, 2, 130, 1, 8),
    "14x14": (1, 14, 14, 2, 16),
}


def _inputs(b, height, width, heads, d, seed=0):
    """q, k, v and the two tables, as tests/test_botnet_kernel.py draws them."""
    rng = np.random.default_rng(seed)
    length = height * width
    q, k, v = (rng.standard_normal((b, length, heads, d)).astype(np.float32) for _ in range(3))
    rel_h = (rng.standard_normal((2 * height - 1, d)) * 0.3).astype(np.float32)
    rel_w = (rng.standard_normal((2 * width - 1, d)) * 0.3).astype(np.float32)
    return q, k, v, rel_h, rel_w


def _compact(q, rel_h, rel_w, height, width):
    """f32 rw_abs/rh_abs from q scaled by d^-0.5, as flash_botnet_attention
    forms them (numpy in, numpy out, through sav_tpu's helper)."""
    qs = q * q.shape[-1] ** -0.5
    cw = np.einsum("blhd,rd->bhlr", qs, rel_w)
    ch = np.einsum("blhd,rd->bhlr", qs, rel_h)
    rw, rh = jax_flash.compact_to_absolute(jnp.asarray(cw), jnp.asarray(ch), height, width)
    return np.asarray(rw), np.asarray(rh)


def _blocks(height, width):
    """The JAX side at 64-row blocks wherever L > 64, so that its cross-tile
    path runs too."""
    return (64, 64) if height * width > 64 else (256, 256)


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(np.array(a)).to(dtype) for a in arrays]


@pytest.mark.parametrize("grid", list(GRIDS))
def test_plain_forward_and_lse_match_pallas_kernel(grid):
    b, height, width, heads, d = GRIDS[grid]
    q, k, v, rel_h, rel_w = _inputs(*GRIDS[grid])
    rw, rh = _compact(q, rel_h, rel_w, height, width)
    scale = d ** -0.5
    out, lse = jax_flash._rel_forward(*map(jnp.asarray, (q, k, v, rw, rh)), height, width, scale,
                                      *_blocks(height, width), None, with_lse=True)
    length = height * width
    want_lse = np.asarray(lse)[:, :length, 0].reshape(b, heads, length)
    got, got_lse = port_flash.rel_attention(*_t((q, k, v, rw, rh)), scale=scale, with_lse=True)
    assert got.shape == (b, length, heads, d) and got_lse.shape == (b, heads, length)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, **F32_TOL)


@pytest.mark.parametrize("grid", ["7x9", "14x14"])
def test_plain_backward_matches_pallas_kernels(grid):
    """dq, d_rw, d_rh (``_rel_bwd_dq_kernel``) and dk, dv
    (``_rel_bwd_dkv_kernel``) from the same forward output, lse and dO."""
    b, height, width, heads, d = GRIDS[grid]
    q, k, v, rel_h, rel_w = _inputs(*GRIDS[grid], seed=1)
    rw, rh = _compact(q, rel_h, rel_w, height, width)
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    scale = d ** -0.5
    blocks = _blocks(height, width)
    jq, jk, jv, jrw, jrh, jg = map(jnp.asarray, (q, k, v, rw, rh, g))
    out, lse = jax_flash._rel_forward(jq, jk, jv, jrw, jrh, height, width, scale, *blocks, None,
                                      with_lse=True)
    want = jax_flash._rel_backward_pallas(jq, jk, jv, jrw, jrh, out, lse, jg, height, width, scale,
                                          *blocks, None)
    tq, tk, tv, trw, trh, tg = _t((q, k, v, rw, rh, g))
    tout, tlse = port_flash.rel_attention(tq, tk, tv, trw, trh, scale=scale, with_lse=True)
    delta = port_flash.bwd_delta(tout, tg)
    operands = (tq, tk, tv, trw, trh, tg, tlse, delta)
    dq, d_rw, d_rh = port_flash.rel_attention_bwd_dq(*operands, scale=scale)
    dk, dv = port_flash.rel_attention_bwd_dkv(*operands, scale=scale)
    assert d_rw.shape == trw.shape and d_rh.shape == trh.shape and d_rw.dtype == torch.float32
    for name, got, ref in zip(("dq", "dk", "dv", "d_rw", "d_rh"), (dq, dk, dv, d_rw, d_rh), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("grid", ["5x6", "14x14"])
def test_grads_of_all_five_inputs_match_jax_grad(grid):
    """flash_botnet_attention, differentiated in q, k, v and both tables:
    the kernels' backward plus autograd of the compact einsum, against
    ``jax.grad`` of sav_tpu's (its blocked Pallas backward)."""
    b, height, width, heads, d = GRIDS[grid]
    arrays = _inputs(*GRIDS[grid], seed=3)
    blocks = dict(zip(("block_q", "block_kv"), _blocks(height, width)))

    def loss(*args):
        return jnp.sum(jnp.square(jax_flash.flash_botnet_attention(*args, height, width, **blocks)))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    inputs = [t.requires_grad_() for t in _t(arrays)]
    port_flash.reset_launches()
    torch.square(port_flash.flash_botnet_attention(*inputs, height, width)).sum().backward()
    assert port_flash.REL_LAUNCHES == port_flash.REL_BWD_DQ_LAUNCHES == 0
    for name, t, ref in zip(("dq", "dk", "dv", "d_rel_h", "d_rel_w"), inputs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **GRAD_TOL, err_msg=name)


def test_bf16_forward_matches_pallas_kernel_and_grads_keep_dtypes():
    q, k, v, rel_h, rel_w = _inputs(*GRIDS["7x9"], seed=4)
    ref = jax_flash.flash_botnet_attention(*(jnp.asarray(a, jnp.bfloat16) for a in
                                             (q, k, v, rel_h, rel_w)), 7, 9)
    inputs = [t.requires_grad_() for t in _t((q, k, v, rel_h, rel_w), torch.bfloat16)]
    out = port_flash.flash_botnet_attention(*inputs, 7, 9)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32),
                               **BF16_TOL)
    torch.square(out.float()).sum().backward()
    for t in inputs:
        assert t.grad.dtype == torch.bfloat16 and torch.isfinite(t.grad.float()).all()


def test_bf16_cast_points():
    """The compact logits take q scaled in its own dtype (the scale itself
    rounded to it), then widened to f32, times the f32 tables; the content
    logits scale the f32 product (``flash_botnet_attention:1119-1121``)."""
    q, k, v, rel_h, rel_w = _t(_inputs(*GRIDS["5x6"], seed=5), torch.bfloat16)
    scale = 8 ** -0.5
    qs = (q * torch.tensor(scale, dtype=torch.bfloat16)).float()
    assert not torch.equal(qs, q.float() * scale)  # the bf16 rounding is visible
    rw, rh = port_flash.compact_to_absolute(
        torch.einsum("blhd,rd->bhlr", qs, rel_w.float()),
        torch.einsum("blhd,rd->bhlr", qs, rel_h.float()), 5, 6)
    want = port_flash.rel_attention_reference(q, k, v, rw, rh, scale=scale)
    assert torch.equal(port_flash.flash_botnet_attention(q, k, v, rel_h, rel_w, 5, 6), want)
    # One kv tile: the forward rounds like the flash forward with the bias.
    bias = port_flash.expand_relative_bias(rw, rh, 5, 6)
    assert torch.equal(want, port_flash.flash_attention_reference(q, k, v, bias, scale=scale))


@pytest.mark.parametrize("b,height,width,heads,d", [(2, 3, 5, 2, 8), (1, 9, 9, 1, 16)])
def test_plain_backward_is_the_derivative_of_the_plain_forward(b, height, width, heads, d):
    """d_rw and d_rh are ds summed over the key columns that share kw or
    kh: the plain dq/dk/dv/d_rw/d_rh equal autograd of the plain forward
    (the second grid spans two kv tiles)."""
    rng = np.random.default_rng(6)
    length = height * width
    q, k, v, g = _t([rng.standard_normal((b, length, heads, d)).astype(np.float32)
                     for _ in range(4)])
    rw, rh = _t([rng.standard_normal((b, heads, length, n)).astype(np.float32)
                 for n in (width, height)])
    inputs = [t.requires_grad_() for t in (q, k, v, rw, rh)]
    out, lse = port_flash.rel_attention_reference(*inputs, scale=0.3, with_lse=True)
    want = torch.autograd.grad(out, inputs, g)
    operands = (*(t.detach() for t in inputs), g, lse.detach(),
                port_flash.bwd_delta(out.detach(), g))
    dq, d_rw, d_rh = port_flash.rel_bwd_dq_reference(*operands, scale=0.3)
    dk, dv = port_flash.rel_bwd_dkv_reference(*operands, scale=0.3)
    for name, got, ref in zip(("dq", "dk", "dv", "d_rw", "d_rh"), (dq, dk, dv, d_rw, d_rh), want):
        torch.testing.assert_close(got, ref, **F32_TOL, msg=name)


def test_wrappers_run_plain_versions_on_cpu_and_count_no_launch():
    q, k, v, rel_h, rel_w = _inputs(*GRIDS["7x9"], seed=7)
    rw, rh = _compact(q, rel_h, rel_w, 7, 9)
    tq, tk, tv, trw, trh = _t((q, k, v, rw, rh))
    port_flash.reset_launches()
    out, lse = port_flash.rel_attention(tq, tk, tv, trw, trh, scale=0.25, with_lse=True)
    g = torch.ones_like(out)
    operands = (tq, tk, tv, trw, trh, g, lse, port_flash.bwd_delta(out, g))
    got = (*port_flash.rel_attention_bwd_dq(*operands, scale=0.25),
           *port_flash.rel_attention_bwd_dkv(*operands, scale=0.25))
    want = (*port_flash.rel_bwd_dq_reference(*operands, scale=0.25),
            *port_flash.rel_bwd_dkv_reference(*operands, scale=0.25))
    assert (port_flash.REL_LAUNCHES, port_flash.REL_BWD_DQ_LAUNCHES,
            port_flash.REL_BWD_DKV_LAUNCHES) == (0, 0, 0)
    assert all(torch.equal(a, r) for a, r in zip(got, want))
    with pytest.raises(ValueError, match="height\\*width"):
        port_flash.rel_attention(tq, tk, tv, trw[..., :8], trh, scale=0.25)


def test_band_and_shared_memory_rule():
    """The flash tiles plus 64 rows of rw/rh (and, in dq, their gradient
    accumulators): BoTNet's grids, the JAX tests' grids and the asymmetric
    2×130 fit; at head dim 128 the band ends at W + Hg = 156."""
    assert port_flash.rel_smem_bytes(128, 14, 14) == {
        "fwd": 118784 + 7168, "bwd_dq": 152576 + 14336, "bwd_dkv": 170496 + 7168}
    for dim, height, width in ((128, 14, 14), (128, 7, 7), (16, 7, 9), (8, 5, 6), (8, 2, 130),
                               (128, 2, 130), (128, 78, 78), (64, 142, 142)):
        assert port_flash.rel_eligible(dim, height, width), (dim, height, width)
    assert not port_flash.rel_eligible(128, 78, 79)
    assert not port_flash.rel_eligible(64, 142, 143)
    assert not port_flash.rel_eligible(60, 7, 7)  # not a multiple of 8
    q, k, v, rw, rh = _t([np.zeros((1, 49, 1, 60), np.float32)] * 3
                         + [np.zeros((1, 1, 49, 7), np.float32)] * 2)
    with pytest.raises(ValueError, match="relative-position kernels"):
        port_flash.rel_attention(q, k, v, rw, rh, scale=1.0)


def test_dispatch_takes_the_relative_kernels_at_every_length():
    """``auto`` and ``pallas`` take the relative-position kernels at every L
    (sav_tpu's ``auto`` waits for L ≥ 256 on a TPU, a v5e measurement the
    port does not carry over); ``xla`` is the dense path; another backend
    raises."""
    resolve = port_attention.resolve_relative_backend
    for height in (2, 7, 14, 16):
        assert resolve(height, height, 128) == "pallas"
        assert resolve(height, height, 128, requested="pallas") == "pallas"
        assert resolve(height, height, 128, requested="xla") == "xla"
    with pytest.raises(ValueError, match="unknown attention backend"):
        resolve(7, 7, 128, requested="fused")
    with pytest.raises(NotImplementedError, match="band"):
        resolve(7, 7, 60)
    assert resolve(7, 7, 60, requested="xla") == "xla"


def _backward_nodes(tensor) -> set:
    """Names of the autograd nodes ``tensor`` was computed through."""
    seen, stack, names = set(), [tensor.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        stack.extend(fn for fn, _ in node.next_functions)
    return names


@pytest.mark.parametrize("backend,kernels", [(None, True), ("pallas", True), ("xla", False)])
def test_botmhsa_takes_the_kernel_family_or_the_dense_path(backend, kernels):
    """BoTMHSA at ``auto``/``pallas`` differentiates through the relative-
    position kernels' Function; at ``xla`` through the dense bias and softmax."""
    from sav_tpu_torch.models.layers import BoTMHSA

    block = BoTMHSA(16, 2, 3, 5, backend=backend)
    block.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 3, 5, generator=torch.Generator().manual_seed(1), requires_grad=True)
    names = _backward_nodes(block(x))
    assert ("RelFlashAttentionFunctionBackward" in names) == kernels
    assert ("SoftmaxBackward0" in names) == (not kernels)


def test_forward_variant_rule():
    """bf16 runs the relative-position forward on the tensor cores, f32 on
    the CUDA cores (no TF32); another itemsize is refused. The wrapper
    tallies each launch under its variant, and the CPU plain path under
    none; the tensor-core block is 128 query rows where L outgrows one kv
    tile, 64 where it does not."""
    tc, cc = port_flash.TENSOR_CORE, port_flash.CUDA_CORE
    assert port_flash.rel_fwd_variant(2) == tc
    assert port_flash.rel_fwd_variant(4) == cc
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        port_flash.rel_fwd_variant(8)
    assert [port_flash.rel_mma_rows(n) for n in (30, 49, 64, 65, 196)] == [64, 64, 64, 128, 128]
    q, k, v, rel_h, rel_w = _inputs(*GRIDS["5x6"], seed=8)
    rw, rh = _compact(q, rel_h, rel_w, 5, 6)
    tq, tk, tv = _t((q, k, v), torch.bfloat16)
    trw, trh = _t((rw, rh))
    port_flash.reset_launches()
    port_flash.rel_attention(tq, tk, tv, trw, trh, scale=0.3, with_lse=True)
    assert port_flash.REL_LAUNCHES == 0
    assert port_flash.REL_VARIANT_LAUNCHES == {tc: 0, cc: 0}


@pytest.mark.parametrize("height,width", [(14, 14), (7, 7)])
def test_tensor_core_forward_keeps_botnet_grids_in_the_band(height, width):
    """BoTNet-T3's stage-4 grids at 4 heads of 128 stay eligible in bf16,
    where every block is a tensor-core one: the forward's (a bf16 q tile of
    rel_mma_rows rows, two stages of 64-row bf16 K/V tiles, the q tile's f32
    rw/rh rows and two tiles' key coordinates), dq's (64 bf16 dO rows, two
    stages of K/V, the q tile's f32 rw/rh rows and accumulators, two tiles'
    key coordinates) and dk/dv's (64 bf16 K and V rows, two stages of 32-row
    q/dO tiles, of their lse/delta and of their rw/rh rows)."""
    rows = port_flash.rel_mma_rows(height * width)
    rel = height + width
    bf16 = port_flash.rel_smem_bytes(128, height, width, 2)
    assert bf16["fwd"] == (rows + 256) * 136 * 2 + rows * rel * 4 + 512
    assert bf16["bwd_dq"] == (64 + 256) * 136 * 2 + 2 * 64 * rel * 4 + 512
    assert bf16["bwd_dkv"] == (128 + 128) * 136 * 2 + 128 * 4 + 2 * 32 * rel * 4
    assert max(bf16.values()) <= port_flash.SMEM_LIMIT
    assert port_flash.rel_eligible(128, height, width, 2)
    # The bf16 blocks never set the band: at its edges the f32 dq block is
    # larger than every one of them.
    for dim, h, w in ((128, 78, 78), (64, 142, 142), (8, 2, 130), (8, 198, 198)):
        sizes = port_flash.rel_smem_bytes(dim, h, w, 2)
        assert max(sizes.values()) <= port_flash.rel_smem_bytes(dim, h, w)["bwd_dq"], (dim, h, w)


def test_backward_variant_rule():
    """bf16 runs the relative-position dq and dk/dv on the tensor cores, f32
    on the CUDA cores (no TF32), as the forward; any other itemsize raises."""
    assert port_flash.rel_bwd_variant(2) == port_flash.TENSOR_CORE
    assert port_flash.rel_bwd_variant(4) == port_flash.CUDA_CORE
    for itemsize in (1, 8):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            port_flash.rel_bwd_variant(itemsize)


@pytest.mark.parametrize("height,width,dq,dkv", [(14, 14, 101888, 77312),
                                                 (7, 7, 94720, 73728)])
def test_bf16_backward_blocks_hold_two_an_sm_at_botnet_grids(height, width, dq, dkv):
    """The tensor-core dq and dk/dv blocks at BoTNet-T3's grids (head dim
    128), in bytes; two of each fit an SM (233,472 bytes, 1 KB of it
    reserved per block), as for the flash backward's bf16 blocks."""
    sizes = port_flash.rel_smem_bytes(128, height, width, 2)
    assert (sizes["bwd_dq"], sizes["bwd_dkv"]) == (dq, dkv)
    assert max(dq, dkv) <= 233472 // 2 - 1024


@pytest.mark.parametrize("dim,height,width", [(128, 14, 14), (128, 7, 7), (16, 7, 9), (8, 5, 6),
                                              (8, 2, 130), (128, 2, 130), (128, 78, 78),
                                              (64, 142, 142)])
def test_bf16_band_takes_every_f32_case(dim, height, width):
    """Every grid of test_band_and_shared_memory_rule that the f32 kernels
    take, the bf16 ones take too."""
    assert port_flash.rel_eligible(dim, height, width)
    assert port_flash.rel_eligible(dim, height, width, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_wrappers_on_cpu_count_no_launch_in_any_tally(dtype):
    """On CPU tensors dq and dk/dv (directly and through autograd) run their
    plain versions and add to no counter and no tally by variant."""
    q, k, v, rel_h, rel_w = _t(_inputs(*GRIDS["5x6"], seed=9), dtype)
    port_flash.reset_launches()
    inputs = [t.requires_grad_() for t in (q, k, v, rel_h, rel_w)]
    out = port_flash.flash_botnet_attention(*inputs, 5, 6)
    torch.square(out.float()).sum().backward()
    rw, rh = _t(_compact(*(t.detach().float().numpy() for t in (q, rel_h, rel_w)), 5, 6))
    with torch.no_grad():
        out, lse = port_flash.rel_attention(q, k, v, rw, rh, scale=0.3, with_lse=True)
        g = torch.ones_like(out)
        operands = (q, k, v, rw, rh, g, lse, port_flash.bwd_delta(out, g))
        port_flash.rel_attention_bwd_dq(*operands, scale=0.3)
        port_flash.rel_attention_bwd_dkv(*operands, scale=0.3)
    assert q.grad is not None and q.grad.dtype == dtype
    assert (port_flash.REL_LAUNCHES, port_flash.REL_BWD_DQ_LAUNCHES,
            port_flash.REL_BWD_DKV_LAUNCHES) == (0, 0, 0)
    for tally in (port_flash.REL_BWD_DQ_VARIANT_LAUNCHES, port_flash.REL_BWD_DKV_VARIANT_LAUNCHES,
                  port_flash.REL_VARIANT_LAUNCHES):
        assert tally == {port_flash.TENSOR_CORE: 0, port_flash.CUDA_CORE: 0}


def _rel_ds_f64(q, k, v, rw, rh, g, lse, delta, scale):
    """p and ds in float64 ``[B, H, L, L]`` from the same lse and delta, the
    relative bias added after the scale."""
    b, heads, length, _ = rw.shape
    bias = (rh.double()[..., :, None] + rw.double()[..., None, :]).reshape(b, heads, length, length)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale + bias
    p = torch.exp(s - lse.double()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g.double(), v.double())
    return p, p * (dp - delta.double()[..., None])


def _grid_sums(ds, height, width):
    """``(d_rw, d_rh)``: ds summed over the key columns that share kw, kh."""
    grid = ds.reshape(*ds.shape[:3], height, width)
    return grid.sum(-2), grid.sum(-1)


def _rel_bwd_f64(q, k, v, rw, rh, g, lse, delta, scale, rounded=True):
    """dq, dk, dv, d_rw and d_rh in float64, with p rounded to the dO dtype
    before dV and ds to the k and q dtypes before dQ and dK (through f32, as
    the plain version casts its f32 values); d_rw/d_rh sum the unrounded
    ds. ``rounded`` False skips the roundings."""
    p, ds = _rel_ds_f64(q, k, v, rw, rh, g, lse, delta, scale)

    def cast(x, dtype):
        return x.to(torch.float32).to(dtype).double() if rounded else x

    dq = torch.einsum("bhqk,bkhd->bqhd", cast(ds, k.dtype), k.double()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", cast(ds, q.dtype), q.double()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", cast(p, g.dtype), g.double())
    return (dq, dk, dv, *_grid_sums(ds, rh.shape[-1], rw.shape[-1]))


@pytest.mark.parametrize("height,width", [(7, 7), (9, 11)])
@pytest.mark.parametrize("output", ["dq", "dk", "dv", "d_rw", "d_rh"])
def test_bwd_references_match_float64_with_bf16_casts(height, width, output):
    """The plain dq/d_rw/d_rh and dk/dv against a float64 twin that rounds p
    and ds to bf16 at the same points and sums d_rw/d_rh from the unrounded
    ds: they agree to f32 rounding, row by row (an output row of each B, L,
    H). The cast under test is bf16 and every other operand f32, so each
    output stays f32: ds is cast to the k dtype for dq (bf16 k), p to the dO
    dtype for dv (bf16 dO), ds to the q dtype for dk (bf16 q); d_rw/d_rh run
    with the bf16 k of dq and follow no rounding. A p or ds within f32
    rounding of a bf16 boundary rounds either way, so a few rows of dq, dk
    and dv may differ by more, never by more than 1e-3; without the
    roundings most rows move by more than 1e-6, and d_rw/d_rh summed from
    the rounded ds move too. This is the plain versions' own error that the
    card's bf16 limits sit above."""
    b, heads, d = 2, 2, 32
    length = height * width
    rng = np.random.default_rng(45)
    q, k, v, g = _t([rng.standard_normal((b, length, heads, d)).astype(np.float32)
                     for _ in range(4)])
    rw, rh = _t([rng.standard_normal((b, heads, length, n)).astype(np.float32)
                 for n in (width, height)])
    scale = d ** -0.5
    out, lse = port_flash.rel_attention_reference(q, k, v, rw, rh, scale=scale, with_lse=True)
    delta = port_flash.bwd_delta(out, g)
    bf16 = {"dq": "k", "dv": "g", "dk": "q", "d_rw": "k", "d_rh": "k"}[output]
    operands = {"q": q, "k": k, "v": v, "g": g}
    operands[bf16] = operands[bf16].bfloat16()
    q, k, v, g = operands["q"], operands["k"], operands["v"], operands["g"]
    args = (q, k, v, rw, rh, g, lse, delta)
    index = ("dq", "dk", "dv", "d_rw", "d_rh").index(output)
    if output in ("dk", "dv"):
        got = port_flash.rel_bwd_dkv_reference(*args, scale=scale)[index - 1]
    else:
        got = port_flash.rel_bwd_dq_reference(*args, scale=scale)[(0, 3, 4).index(index)]
    assert got.dtype == torch.float32
    want = _rel_bwd_f64(*args, scale)[index]

    def rows_within(x, tol):
        err = (got.double() - x).abs() - tol * (1 + x.abs())
        return (err <= 0).all(dim=-1).double().mean().item()

    if output in ("d_rw", "d_rh"):
        # No rounding in the chain: every row agrees to a few f32 ulps (the
        # sums cancel); sums of the ds rounded to bf16 (dq's operand) lie
        # 1e-4 and more away.
        assert rows_within(want, 2e-6) == 1.0
        _, ds = _rel_ds_f64(*args, scale)
        of_rounded = _grid_sums(ds.float().bfloat16().double(), height, width)[index - 3]
        assert rows_within(of_rounded, 1e-5) < 0.1
        return
    unrounded = _rel_bwd_f64(*args, scale, rounded=False)[index]
    assert rows_within(want, 1e-6) >= 0.9
    assert rows_within(want, 1e-3) == 1.0
    assert rows_within(unrounded, 1e-6) < 0.5


def _rel_online_softmax_f64(q, k, v, rw, rh, height, width, scale, block_kv):
    """The online softmax in float64 over tiles of ``block_kv`` key columns,
    the relative bias ``rh[q, kh] + rw[q, kw]`` added after the scale, p
    rounded to bf16 (the value dtype) before PV and the division by l last."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    b, heads, length, _ = rw.shape
    bias = (rh.double()[..., :, None] + rw.double()[..., None, :]).reshape(
        b, heads, length, height * width)
    s = s + bias
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


@pytest.mark.parametrize("height,width", [(7, 7), (14, 14)])
def test_reference_at_the_kernel_kv_tile_matches_float64(height, width):
    """The plain version the card holds the tensor-core forward against, at
    the kernel's kv tile (BLOCK, passed explicitly), is the online softmax at
    that tile with the relative bias: against a float64 twin (f32 q and k,
    bf16 v, so the cast of p is the only bf16 rounding) at 7×7 (one partial
    tile) and 14×14 (four tiles, the last partial) its lse agrees to 1e-6 and
    its rows agree to 1e-6, but for the rare p that sits within f32 rounding
    of a bf16 rounding boundary and rounds the other way (one bf16 ulp of
    that p, at most 1e-3 here). At 14×14 a tile of another size rounds p
    elsewhere and moves most rows by more than 1e-6."""
    b, heads, d = 2, 2, 32
    rng = np.random.default_rng(34)
    length = height * width
    q, k, v = _t([rng.standard_normal((b, length, heads, d)).astype(np.float32)
                  for _ in range(3)])
    v = v.bfloat16()
    rw, rh = _t([rng.standard_normal((b, heads, length, n)).astype(np.float32)
                 for n in (width, height)])
    scale = d ** -0.5
    out, lse = port_flash.rel_attention_reference(q, k, v, rw, rh, scale=scale,
                                                  block_kv=port_flash.BLOCK, with_lse=True)
    want, want_lse = _rel_online_softmax_f64(q, k, v, rw, rh, height, width, scale,
                                             port_flash.BLOCK)

    def rows_within(a, tol):
        return ((out.double() - a).abs().amax(-1) <= tol).double().mean().item()

    torch.testing.assert_close(lse.double(), want_lse, atol=1e-6, rtol=1e-6)
    assert rows_within(want, 1e-6) >= 0.9
    assert rows_within(want, 1e-3) == 1.0
    if length > port_flash.BLOCK:
        other, _ = _rel_online_softmax_f64(q, k, v, rw, rh, height, width, scale, 100)
        assert rows_within(other, 1e-6) < 0.5
