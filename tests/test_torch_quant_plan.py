"""The plans of the int8 arm's kernels (sav_tpu_torch.ops.quant) and the
serving dot's K-major codes, on the CPU.

Q2 (``csrc/int8_gemm.cu``) cuts K into slices of whole k-tiles where the
output tiles alone leave SMs idle (:func:`gemm_plan`); Q1's column path
(``csrc/int8_quant.cu``) reads its input once where a strip of columns fits
in a cluster's shared memory (:func:`quant_cols_plan`). Both plans are
plain Python that the wrappers hand to the kernels, so their invariants are
held here at DeiT-S's shapes (and TNT-S's inner one). The serving dot holds
the raw projections' codes K-major, copied once outside the replay; that
copy must follow a ``load_state_dict``, checked against sav_tpu's serving
dot on the new codes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sav_tpu.ops.quant as jq
import sav_tpu_torch.ops.quant as tq
from sav_tpu_torch.interop import params_from_flax

torch.set_num_threads(2)

SERVE_ROWS, TRAIN_ROWS = 32 * 197, 256 * 197
# DeiT-S's products (M, K, N): the serve and QAT forward, dx, and dw over
# the 50,432 rows of a batch of 256.
FORWARD = {
    "serve qkv": (SERVE_ROWS, 384, 1152), "serve fc2": (SERVE_ROWS, 1536, 384),
    "serve head": (32, 384, 1000), "serve bucket 1 fc2": (197, 1536, 384),
    "train qkv": (TRAIN_ROWS, 384, 1152), "train to_out": (TRAIN_ROWS, 384, 384),
    "train fc1": (TRAIN_ROWS, 384, 1536), "train fc2": (TRAIN_ROWS, 1536, 384),
    "train head": (256, 384, 1000), "dx head": (256, 1000, 384),
    "dw head": (1000, 256, 384),
}
DW = {"dw qkv": (384, TRAIN_ROWS, 1152), "dw to_out": (384, TRAIN_ROWS, 384),
      "dw fc1": (1536, TRAIN_ROWS, 384), "dw fc2": (384, TRAIN_ROWS, 1536)}
# The chip check's split-K edges: K not a multiple of S × the k-tile, M = 1
# over the whole batch, a ragged product.
EDGES = {"M=1": (1, TRAIN_ROWS, 8), "ragged": (130, 10_013, 77), "K=24": (37, 24, 100)}


def _tiles(m, n):
    return -(-m // tq.GEMM_TILE_M) * -(-n // tq.GEMM_TILE_N)


@pytest.mark.parametrize("shape", [*FORWARD.values(), *DW.values(), *EDGES.values()],
                         ids=[*FORWARD, *DW, *EDGES])
def test_gemm_slices_cover_k_in_whole_k_tiles(shape):
    m, k, n = shape
    splits = tq.gemm_plan(m, n, k)
    slices = tq.gemm_slices(k, splits)
    ktiles = -(-k // tq.GEMM_TILE_K)
    assert len(slices) == splits >= 1
    assert slices[0][0] == 0 and slices[-1][1] == ktiles
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))  # no gap, no overlap
    assert all(hi > lo for lo, hi in slices)  # no empty slice
    if splits > 1:
        assert min(hi - lo for lo, hi in slices) >= tq.GEMM_MIN_SLICE_KTILES
        assert _tiles(m, n) * splits <= 2 * tq.H100_SMS


@pytest.mark.parametrize("name", list(FORWARD))
def test_gemm_plan_keeps_k_whole_at_deit_s_forward_shapes(name):
    m, k, n = FORWARD[name]
    assert tq.gemm_plan(m, n, k) == 1


@pytest.mark.parametrize("name", list(DW))
def test_gemm_plan_splits_deit_s_dw_products_over_every_sm(name):
    m, k, n = DW[name]
    splits = tq.gemm_plan(m, n, k)
    assert splits > 1
    assert _tiles(m, n) < tq.H100_SMS  # the tiles alone leave SMs idle
    assert _tiles(m, n) * splits >= tq.H100_SMS


def test_gemm_plan_edges():
    # One slice shorter than the others: the ragged product's 79 k-tiles.
    slices = tq.gemm_slices(10_013, tq.gemm_plan(130, 77, 10_013))
    assert len({hi - lo for lo, hi in slices}) == 2
    assert 10_013 % (len(slices) * tq.GEMM_TILE_K) != 0
    assert tq.gemm_plan(1, 8, TRAIN_ROWS) > 1
    # Fewer SMs split further, more split less; a short K is never cut.
    assert tq.gemm_plan(384, 1152, TRAIN_ROWS, sms=66) <= tq.gemm_plan(384, 1152, TRAIN_ROWS)
    short = (2 * tq.GEMM_MIN_SLICE_KTILES - 1) * tq.GEMM_TILE_K
    assert tq.gemm_plan(384, 1152, short) == 1 < tq.gemm_plan(384, 1152, short + 1)


# DeiT-S's column quantizes (T, R, C), bf16: the QKV weight, fc2's weight
# per in-channel, x and the cotangents over the batch's rows.
COLS_DEIT = {"qkv w": (1, 384, 1152), "fc2 w in-channel": (1, 384, 1536),
             "x": (1, TRAIN_ROWS, 384), "g qkv": (3, TRAIN_ROWS, 384),
             "g fc1": (1, TRAIN_ROWS, 1536), "serve-sized x": (1, SERVE_ROWS, 384)}
# TNT-S's inner FF at its micro-batch of 256: 256 · 196 · 16 pixel rows.
TNT_INNER = (1, 256 * 196 * 16, 24)


@pytest.mark.parametrize("name", list(COLS_DEIT))
def test_quant_cols_plan_reads_deit_s_once(name):
    t, rows, cols = COLS_DEIT[name]
    plan = tq.quant_cols_plan(t, rows, cols, 2)
    assert plan is not None
    cluster, per_block = plan
    ldc = -(-rows // 16) * 16
    assert cluster in (1, 2, 4, 8, 16) and per_block % tq.QUANT_TILE_ROWS == 0
    assert cluster * per_block >= ldc > (cluster - 1) * per_block
    assert per_block * tq.QUANT_STRIP * 2 <= tq.QUANT_STRIP_BYTES_MAX


def test_quant_cols_plan_takes_two_passes_at_tnt_s_inner_shape():
    assert tq.quant_cols_plan(*TNT_INNER, 2) is None
    # The crossover by rows, at the largest cluster: rows of 16 columns.
    for itemsize in (2, 4):
        per_block = tq.QUANT_STRIP_BYTES_MAX // (tq.QUANT_STRIP * itemsize)
        most = tq.QUANT_CLUSTER_MAX * (per_block // 32 * 32)
        assert tq.quant_cols_plan(1, most, 384, itemsize) is not None
        assert tq.quant_cols_plan(1, most + 1, 384, itemsize) is None


@pytest.mark.parametrize("name", ["x", "g qkv", "g fc1"])
def test_quant_cols_plan_pairs_blocks_on_an_sm_over_the_batch(name):
    # Two blocks share an SM, so one's loads run under the other's quantize.
    t, rows, cols = COLS_DEIT[name]
    cluster, per_block = tq.quant_cols_plan(t, rows, cols, 2)
    assert per_block * tq.QUANT_STRIP * 2 <= tq.QUANT_STRIP_BYTES_PAIR
    assert 2 * (per_block * tq.QUANT_STRIP * 2 + 1_024 + 9_344) <= 233_472


def test_serving_codes_follow_load_state_dict():
    """The raw projections' K-major copy is made once and refreshed in place
    by ``load_state_dict``; after it the port serves the new codes as
    sav_tpu's serving dot does."""
    from test_torch_quant import _serving_variables, _vit_case

    case = _vit_case()
    model = case.port_model("int8_serve")
    model.load_state_dict(params_from_flax(_serving_variables(case)), strict=True)
    model.eval()
    images = torch.from_numpy(case.images)
    block = model.encoder.blocks[0].attn
    with torch.no_grad():
        before = model(images)
    name = "to_out"
    held = block._kmajor_codes[name][1]
    # Other codes: the first block's to_out negated.
    state = model.state_dict()
    key = next(k for k in state if k.endswith(f"blocks.0.attn.{name}"))
    state[key] = -state[key]
    model.load_state_dict(state, strict=True)
    codes = getattr(block, name)
    k = held.shape[1]
    assert block._kmajor_codes[name][1] is held  # refreshed in place
    assert torch.equal(held, codes.reshape(k, -1).t())
    with torch.no_grad():
        after = model(images)
    assert not torch.equal(before, after)
    fresh = case.port_model("int8_serve")
    fresh.load_state_dict(state, strict=True)
    with torch.no_grad():
        assert torch.equal(fresh.eval()(images), after)
    # The dot itself against sav_tpu's on the new codes.
    x = np.random.default_rng(4).standard_normal((5, k)).astype(np.float32)
    scale = getattr(block, tq.scale_name(name))
    ref = jq.int8_serve_dot(jnp.asarray(x), jnp.asarray(codes.numpy().reshape(k, -1)),
                            jnp.asarray(scale.numpy().reshape(-1)), 1)
    block_x = torch.from_numpy(x)
    out = tq.project(block, name, block_x.reshape(5, *codes.shape[:2]), 2)
    np.testing.assert_allclose(out.numpy().reshape(5, -1), np.asarray(ref), rtol=1e-6, atol=0)
    # An in-place write outside load_state_dict is seen at the next call.
    with torch.no_grad():
        codes.neg_()
    tq.project(block, name, block_x.reshape(5, *codes.shape[:2]), 2)
    assert torch.equal(block._kmajor_codes[name][1], codes.reshape(k, -1).t())
