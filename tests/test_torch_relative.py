"""The port's relative-position logits (sav_tpu_torch.ops.relative and the
compact helpers of sav_tpu_torch.ops.flash_attention) against sav_tpu's, on
the CPU, from the same numpy inputs. Tolerance 2e-5, as
tests/test_botnet_kernel.py's (:55). About 3 s in one process.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import relative as jax_relative
from sav_tpu_torch.ops import flash_attention as port_flash
from sav_tpu_torch.ops import relative as port_relative

# sav_tpu.ops re-exports a function named flash_attention over the module.
jax_flash = importlib.import_module("sav_tpu.ops.flash_attention")

TOL = dict(atol=2e-5, rtol=2e-5)


def _randn(*shape, seed=0, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


@pytest.mark.parametrize("length", [1, 2, 7, 14])
def test_rel_to_abs_matches_sav_tpu(length):
    x = _randn(2, 3, length, 2 * length - 1, seed=length)
    want = np.asarray(jax_relative.rel_to_abs(jnp.asarray(x)))
    got = port_relative.rel_to_abs(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, length, length)
    np.testing.assert_array_equal(got, want)
    # out[i, j] = x[i, j - i + L - 1]
    i, j = np.meshgrid(np.arange(length), np.arange(length), indexing="ij")
    np.testing.assert_array_equal(got, x[..., i, j - i + length - 1])
    with pytest.raises(ValueError, match="last dim"):
        port_relative.rel_to_abs(torch.zeros(1, length, 2 * length))


@pytest.mark.parametrize("height,width", [(7, 9), (4, 4), (2, 13)])
def test_relative_logits_2d_matches_sav_tpu(height, width):
    q = _randn(2, 3, height, width, 8, seed=1)
    rel_h = _randn(2 * height - 1, 8, seed=2, std=0.3)
    rel_w = _randn(2 * width - 1, 8, seed=3, std=0.3)
    want = np.asarray(jax_relative.relative_logits_2d(*map(jnp.asarray, (q, rel_h, rel_w))))
    got = port_relative.relative_logits_2d(*map(torch.from_numpy, (q, rel_h, rel_w)))
    assert got.dtype == torch.float32 and got.shape == (2, 3, height, width, height, width)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_relative_logits_2d_takes_bf16_operands_into_an_f32_product():
    """``preferred_element_type=f32``: bf16 q and tables, f32 logits."""
    q = torch.from_numpy(_randn(1, 2, 3, 5, 16, seed=4)).bfloat16()
    rel_h = torch.from_numpy(_randn(5, 16, seed=5)).bfloat16()
    rel_w = torch.from_numpy(_randn(9, 16, seed=6)).bfloat16()
    got = port_relative.relative_logits_2d(q, rel_h, rel_w)
    want = jax_relative.relative_logits_2d(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, rel_h, rel_w)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("height,width", [(7, 9), (14, 14), (2, 130)])
def test_compact_to_absolute_and_expand_match_sav_tpu(height, width):
    b, heads, length = 2, 3, height * width
    cw = _randn(b, heads, length, 2 * width - 1, seed=7)
    ch = _randn(b, heads, length, 2 * height - 1, seed=8)
    want_w, want_h = jax_flash.compact_to_absolute(jnp.asarray(cw), jnp.asarray(ch), height, width)
    got_w, got_h = port_flash.compact_to_absolute(torch.from_numpy(cw), torch.from_numpy(ch),
                                                  height, width)
    assert got_w.shape == (b, heads, length, width) and got_h.shape == (b, heads, length, height)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    want = jax_flash.expand_relative_bias(want_w, want_h, height, width)
    got = port_flash.expand_relative_bias(got_w, got_h, height, width)
    assert got.shape == (b, heads, length, length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_compact_path_equals_the_dense_bias():
    """The kernels' bias (compact logits, absolute, expanded) equals the dense
    path's ``relative_logits_2d`` on the same scaled query."""
    b, heads, height, width, d = 2, 3, 7, 9, 16
    qs = torch.from_numpy(_randn(b, height * width, heads, d, seed=9))
    rel_h = torch.from_numpy(_randn(2 * height - 1, d, seed=10, std=0.3))
    rel_w = torch.from_numpy(_randn(2 * width - 1, d, seed=11, std=0.3))
    cw = torch.einsum("blhd,rd->bhlr", qs, rel_w)
    ch = torch.einsum("blhd,rd->bhlr", qs, rel_h)
    got = port_flash.expand_relative_bias(
        *port_flash.compact_to_absolute(cw, ch, height, width), height, width)
    q_grid = qs.reshape(b, height, width, heads, d).permute(0, 3, 1, 2, 4)
    want = port_relative.relative_logits_2d(q_grid, rel_h, rel_w).reshape(
        b, heads, height * width, height * width)
    torch.testing.assert_close(got, want, **TOL)
