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
