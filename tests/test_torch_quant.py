"""The port's int8 arm (sav_tpu_torch.ops.quant) against sav_tpu's
(sav_tpu.ops.quant), on the CPU, where each kernel wrapper runs its plain
version.

The same numpy inputs go to both sides; the stochastic rounding of the
backward gets the same draws (``jax.random.uniform``'s, handed to the port
as its noise source). In f32 the codes, the scales, the int32 products and
the gradients are bit-equal: the port repeats sav_tpu's f32 operations in
its order. :func:`quant_family_parity` is the family check the family
test files call: the small model of each family at the QAT and the serving
arm, in f32 and bf16, logits within 0.1 × the logits' scale (sav_tpu's
own int8 gate, ``tests/test_quant.py``) and with the same top-1 on every
row whose first two classes sav_tpu separates by more than twice the
largest logit difference (a closer pair may swap under a difference the
gate allows: CvT's in bf16, 2 % of the scale, swapped one row), and the
share of the activation codes (the int8 inputs of every quantized dot) that
differ from sav_tpu's, printed. That end-to-end share is not what is held
under 0.1 %: one code that flips where an upstream float op rounded apart
moves every later activation by a quantization step, and with it ~2 % of
the later codes (CvT in f32: one flip in stage 2's depthwise conv output;
in bf16 the attention cores round apart everywhere, ~22 %; the port's
float bf16 tests hold logits to 3e-2). What is held, at every dot, is the
share of codes that differ when the port quantizes sav_tpu's own
activation: 0. The small DeiT (``test_torch_vit.py``) is bit-equal end to end
in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sav_tpu.ops.quant as jq
import sav_tpu_torch.ops.quant as tq
from sav_tpu.models import create_model as jax_create_model
from sav_tpu_torch.interop import params_from_flax
from sav_tpu_torch.models import create_model

torch.set_num_threads(2)

# sav_tpu's parity gate of the int8 arm (tests/test_quant.py).
LOGIT_SHARE = 0.1
# Activation codes the port may quantize otherwise than sav_tpu from the
# same activation (it quantizes none otherwise).
CODE_SHARE = 1e-3
# f32 block outputs and gradients whose attention core rounds apart.
TOL = 1e-5


def _noise_from(u: dict):
    """A noise source that hands the port the arrays of ``u`` by kind."""
    return lambda shape, kind: torch.from_numpy(np.array(u[kind])).reshape(shape)


# ------------------------------------------------------------ functions


@pytest.mark.parametrize("axes", [(2,), (0,), (1, 2), (0, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_channelwise_matches_sav_tpu(axes, dtype):
    """Codes and scales bit-equal for every choice of contracted axes, on f32
    and bf16 inputs (both quantize the f32 value)."""
    x = np.random.default_rng(0).standard_normal((4, 5, 24)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    q, s = jq.quantize_channelwise(jx, axes)
    tqv, ts = tq.quantize_channelwise(torch.from_numpy(np.asarray(jx.astype(jnp.float32)))
                                      .to(getattr(torch, dtype)), axes)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))


def test_quantize_stochastic_matches_sav_tpu_with_its_draws():
    x = np.random.default_rng(1).standard_normal((6, 40)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    q, s = jq.quantize_stochastic(jnp.asarray(x), (1,), key)
    u = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    tqv, ts = tq.quantize_stochastic(torch.from_numpy(x), (1,), torch.from_numpy(u))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    # The column layout (the dw operand) with the same draws.
    codes, scales = tq.quantize_cols_t(torch.from_numpy(x), torch.from_numpy(u))
    q0, s0 = jq.quantize_stochastic(jnp.asarray(x), (0,), key)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(q0).T)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(s0)[0])


def test_ties_round_half_to_even_and_zero_channels_get_scale_one():
    """``jnp.round`` and the port both round exact .5 ties to even; a row
    whose amax is 127 has scale 1.0 exactly, so its halves are ties. An
    all-zero channel gets scale 1.0 and codes 0."""
    row = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0]], np.float32)
    zero = np.zeros((1, 8), np.float32)
    a = np.concatenate([row, zero])
    q, s = tq.quantize_rows(torch.from_numpy(a))
    np.testing.assert_array_equal(q[0].numpy(), [0, 2, 2, 0, -2, -2, 126, 127])
    np.testing.assert_array_equal(s.numpy(), [1.0, 1.0])
    assert not q[1].any()
    jqv, js = jq.quantize_channelwise(jnp.asarray(a), (1,))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[:, 0])


def test_int8_gemm_reference_is_exact_and_orders_the_scales():
    """The int32 sum is exact at K = 4096 (Mixer-L's widest: 127² · 4096 <
    2³¹) and its f32 conversion rounds to nearest above 2²⁴; the scales
    multiply in the stated order; ``split`` lays out the QKV slices."""
    k = 4096
    qa = torch.full((2, k), 127, dtype=torch.int8)
    qa[1, :3] = -127
    qb = torch.full((3, k), 127, dtype=torch.int8)
    sa = torch.tensor([0.1, 0.3])
    sb = torch.tensor([0.7, 1.1, 0.9])
    out = tq.int8_gemm(qa, qb, sa, sb)
    acc = np.array([[127 * 127 * k], [127 * 127 * (k - 6)]], np.int64)
    want = (acc.astype(np.float32) * sa.numpy()[:, None]) * sb.numpy()[None, :]
    np.testing.assert_array_equal(out.numpy(), want)
    other = tq.int8_gemm(qa, qb, sa, sb, scale_b_first=True)
    np.testing.assert_array_equal(
        other.numpy(), (acc.astype(np.float32) * sb.numpy()[None, :]) * sa.numpy()[:, None])
    assert not np.array_equal(out.numpy(), other.numpy())  # the order is seen
    q6 = torch.randint(-127, 128, (6, 32), generator=torch.Generator().manual_seed(0),
                       dtype=torch.int8)
    s6 = torch.rand(6)
    flat = tq.int8_gemm(q6[:2], q6, s6[:2], s6, torch.bfloat16)
    split = tq.int8_gemm(q6[:2], q6, s6[:2], s6, torch.bfloat16, split=2)
    assert split.shape == (3, 2, 2)
    np.testing.assert_array_equal(split.float().numpy(),
                                  flat.float().view(2, 3, 2).transpose(0, 1).numpy())


@pytest.mark.parametrize("n_contract", [1, 2])
def test_int8_ste_dot_and_its_gradients_are_bit_equal_to_sav_tpus(n_contract):
    """Forward, dx and dw bit-equal in f32 with sav_tpu's own draws."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 5, 6, 8)).astype(np.float32)
    w_shape = (8, 12) if n_contract == 1 else (6, 8, 12)
    w = (rng.standard_normal(w_shape) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    y = jq.int8_ste_dot(jnp.asarray(x), jnp.asarray(w), key, n_contract)
    g = rng.standard_normal(y.shape).astype(np.float32)

    def f(x, w):
        return (jq.int8_ste_dot(x, w, key, n_contract) * g).sum()

    dx, dw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    k_dx, k_dw = jax.random.split(key)
    u = {"dx": jax.random.uniform(k_dx, g.shape, jnp.float32),
         "dw": jax.random.uniform(k_dw, g.shape, jnp.float32)}
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    ty = tq.int8_ste_dot(tx, tw, n_contract, noise=_noise_from(u))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(y))
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(dx))
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(dw))


def test_int8_ste_dot_in_bf16_matches_sav_tpu():
    """bf16 operands: the output, dx and dw round from the same f32 values
    (bf16 out of the product, sav_tpu's ``astype`` of each)."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((10, 16)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((16, 24)) * 0.1, jnp.bfloat16)
    key = jax.random.PRNGKey(9)
    y = jq.int8_ste_dot(x, w, key, 1)
    g = jnp.asarray(rng.standard_normal(y.shape), jnp.bfloat16)
    dx, dw = jax.vjp(lambda a, b: jq.int8_ste_dot(a, b, key, 1), x, w)[1](g)
    k_dx, k_dw = jax.random.split(key)
    u = {"dx": jax.random.uniform(k_dx, g.shape, jnp.float32),
         "dw": jax.random.uniform(k_dw, g.shape, jnp.float32)}

    def port(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16()

    tx, tw = port(x).requires_grad_(), port(w).requires_grad_()
    ty = tq.int8_ste_dot(tx, tw, 1, noise=_noise_from(u))
    assert ty.dtype == torch.bfloat16
    ty.backward(port(g))
    for got, want in ((ty.detach(), y), (tx.grad, dx), (tw.grad, dw)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_int8_serve_dot_matches_sav_tpu():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 7, 8)).astype(np.float32)
    w = rng.standard_normal((8, 2, 5)).astype(np.float32)
    qw, sw = jq.quantize_channelwise(jnp.asarray(w), (0,))
    ref = jq.int8_serve_dot(jnp.asarray(x), qw, sw.reshape(2, 5), 1)
    out = tq.int8_serve_dot(torch.from_numpy(x), torch.from_numpy(np.asarray(qw)),
                            torch.from_numpy(np.asarray(sw).reshape(2, 5)), 1)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=0)


# ------------------------------------------------------------ the QKV block


def _fixed_draws(numel: int, kind: str) -> np.ndarray:
    """Draws that depend only on the element count and the kind: what both
    sides take where their draw order differs (per module, per slice)."""
    seed = numel * 2 + (kind == "dw")
    return np.random.default_rng(seed).random(numel, dtype=np.float32)


def _patch_sav_tpu_draws(monkeypatch):
    """sav_tpu's stochastic rounding with :func:`_fixed_draws`: the kind is
    read off the axes, as ``_ste_bwd`` passes them (dx reduces the trailing
    axes, dw the leading ones)."""
    def quantize_stochastic(a, contract_axes, key):
        del key
        axes = tuple(contract_axes)
        kind = "dw" if axes and axes[0] == 0 else "dx"
        a = a.astype(jnp.float32)
        amax = jnp.max(jnp.abs(a), axis=axes, keepdims=True)
        scale = jnp.where(amax > 0.0, amax / jq.INT8_AMAX, 1.0)
        u = jnp.asarray(_fixed_draws(a.size, kind).reshape(a.shape))
        q = jnp.clip(jnp.floor(a / scale + u), -jq.INT8_AMAX, jq.INT8_AMAX)
        return q.astype(jnp.int8), scale

    monkeypatch.setattr(jq, "quantize_stochastic", quantize_stochastic)


def _port_fixed_draws(shape, kind):
    return torch.from_numpy(_fixed_draws(int(np.prod(shape)), kind)).reshape(shape)


# ------------------------------------------------------------ families


def _dedupe(records: list, key=lambda r: r) -> list:
    """Consecutive records with equal codes once: sav_tpu quantizes the QKV
    input once per slice, the port once for the three."""
    out = []
    for r in records:
        last = key(out[-1]) if out else None
        if last is None or last.shape != key(r).shape or not np.array_equal(last, key(r)):
            out.append(r)
    return out


def _record_jax_codes(monkeypatch, quant: str) -> list:
    """sav_tpu's quantize calls, in order, as ``(input, axes, codes)``:
    ``quantize_channelwise`` quantizes the activation of each dot and then
    (QAT) its weight. Run op by op (``jax.disable_jit``): under ``jit``
    XLA fuses the quantize into the op before it, whose output is then not
    rounded to bf16 first, and sav_tpu's own codes move off the values
    recorded here (1.6 % in bf16 at the small DeiT)."""
    calls = []
    orig = jq.quantize_channelwise

    def record(a, axes):
        q, s = orig(a, axes)
        calls.append((np.asarray(a), tuple(axes), np.asarray(q).reshape(-1)))
        return q, s

    monkeypatch.setattr(jq, "quantize_channelwise", record)
    return calls


def _record_port_codes(monkeypatch) -> list:
    calls = []
    for name in ("quantize_rows", "quantize_cols_t"):
        orig = getattr(tq, name)

        def record(a, noise=None, _orig=orig):
            q, s = _orig(a, noise)
            calls.append(q.numpy().reshape(-1))
            return q, s

        monkeypatch.setattr(tq, name, record)
    return calls


def _activations(calls: list, quant: str, key=lambda r: r) -> list:
    """The activations' records: in QAT every dot quantizes its activation,
    then its weight; serving only the activation."""
    return _dedupe(calls[0::2] if quant == "int8" else calls, key)


@dataclasses.dataclass
class FamilyCase:
    """One family's small model on both sides: ``jax_model(quant, dtype)``
    builds sav_tpu's, ``port_model(quant)`` the port's (f32 parameters);
    ``variables`` is sav_tpu's float tree (``{"params": ...}``, with
    ``"batch_stats"`` for a BatchNorm family); ``images`` the NHWC input."""

    jax_model: callable
    port_model: callable
    variables: dict
    images: np.ndarray


def _serving_variables(case: FamilyCase) -> dict:
    """sav_tpu's serving tree of the case: its quantize_params of the float
    params against the int8_serve model's template."""
    model = case.jax_model("int8_serve", jnp.float32)
    template = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, *case.images.shape[1:])), is_training=False)
    )["params"]
    served = dict(case.variables)
    served["params"] = jax.tree.map(np.asarray, jq.quantize_params(case.variables["params"],
                                                                  template))
    return served


def quant_family_parity(case: FamilyCase, quant: str, dtype: str, monkeypatch) -> dict:
    """The port's small model at ``quant`` (``"int8"`` or ``"int8_serve"``)
    and ``dtype`` against sav_tpu's on the same tree and images, in eval
    mode. The serving state is the port's :func:`quantize_params` of the
    float state, and equals the conversion of sav_tpu's serving tree
    (bit-equal). Returns the logit and code figures, after asserting the
    gates."""
    variables = _serving_variables(case) if quant == "int8_serve" else case.variables
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    model = case.port_model(quant)
    if quant == "int8_serve":
        float_model = case.port_model(None)
        float_model.load_state_dict(params_from_flax(case.variables), strict=True)
        state = tq.quantize_params(float_model.state_dict(), model.state_dict())
        converted = params_from_flax(variables)
        assert set(state) == set(converted)
        for key, value in state.items():
            assert value.dtype == converted[key].dtype, key
            np.testing.assert_array_equal(value.numpy(), converted[key].numpy(), err_msg=key)
    else:
        state = params_from_flax(variables)
    model.load_state_dict(state, strict=True)
    model.eval()
    jax_model = case.jax_model(quant, jdtype)
    with monkeypatch.context() as patch, jax.disable_jit():
        jax_calls = _record_jax_codes(patch, quant)
        ref = np.asarray(jax_model.apply(variables, jnp.asarray(case.images, jdtype),
                                         is_training=False), np.float32)
    with monkeypatch.context() as patch, torch.no_grad():
        port_calls = _record_port_codes(patch)
        out = model(torch.from_numpy(case.images).to(getattr(torch, dtype))).float().numpy()
    theirs = _activations(jax_calls, quant, key=lambda r: r[2])
    ours = _activations(port_calls, quant)
    assert [c.size for c in ours] == [r[2].size for r in theirs]
    differ = sum(int((a != r[2]).sum()) for a, r in zip(ours, theirs))
    total = sum(a.size for a in ours)
    # The port's quantizer on sav_tpu's own activations: bit-equal codes.
    same_input = 0
    for a, axes, q in theirs:
        codes, _ = tq.quantize_channelwise(
            torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype)), axes)
        same_input += int((codes.numpy().reshape(-1) != q).sum())
    scale = float(np.abs(ref).max())
    dlogit = float(np.abs(out - ref).max())
    # Top-1 is held on every row whose first two classes sav_tpu separates by
    # more than twice the largest logit difference: a closer pair may swap
    # under any difference the logit gate allows.
    top2 = np.sort(ref, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * dlogit
    figures = {"codes_differ": differ, "codes": total, "share": differ / total,
               "codes_differ_same_input": same_input, "share_same_input": same_input / total,
               "max_abs_dlogit": dlogit, "logit_scale": scale,
               "top1_rows_held": int(decided.sum()), "rows": len(ref)}
    print(f"{quant} {dtype}: {figures}")
    assert scale > 0.1  # a random head: the check is not vacuous
    np.testing.assert_array_equal(out.argmax(-1)[decided], ref.argmax(-1)[decided])
    assert figures["max_abs_dlogit"] <= LOGIT_SHARE * scale, figures
    assert figures["share_same_input"] < CODE_SHARE, figures
    return figures


def family_case(name: str, overrides: dict, variables: dict, image_size: int,
                images: int = 3) -> FamilyCase:
    """The registry's ``name`` with ``overrides`` at ``image_size`` and 10
    classes on both sides, on the dense attention paths (``backend="xla"``:
    the two frameworks' dense cores agree to the last f32 bit at these
    sizes), and ``images`` seeded NHWC images."""

    def jax_model(quant, dtype):
        return jax_create_model(name, num_classes=10, dtype=dtype, backend="xla", quant=quant,
                                **overrides)

    def port_model(quant):
        return create_model(name, num_classes=10, image_size=image_size, backend="xla",
                            quant=quant, **overrides)

    x = np.random.default_rng(3).standard_normal((images, image_size, image_size, 3))
    return FamilyCase(jax_model, port_model, variables, x.astype(np.float32))


def _vit_case() -> FamilyCase:
    from test_torch_vit import SMALL, small_flax_params

    return family_case("vit_ti_patch16", SMALL, {"params": small_flax_params()}, 32)
