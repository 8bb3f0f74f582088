"""Per-step compute cost model and the peak it is measured against (the
port's own copy of what ``sav_tpu/obs/costs.py`` gives ``bench.py``).

Two counts, each of a forward's matmul and convolution FLOPs; a train step
is 3× its forward (the backward does about twice the forward's matmul
work); norms, biases, softmax and pooling are left out, a few percent.

- ViT, CaiT and BoTNet: :func:`analytic_train_step_cost` walks a parameter
  tree as ``sav_tpu`` does: matmul kernels cost ``2 * tokens *
  prod(shape)``, each attention core adds its parameter-free QKᵀ and AV
  products (``4 * B * L² * H * Dh``), all at one trunk length. The tree is
  the flax tree ``sav_tpu`` walks, with its names, so the two give the same
  FLOPs: the port's parameters reach it through
  :func:`~sav_tpu_torch.interop.flax_from_params` (:func:`model_params_tree`).
  A ViT with routed experts departs from ``sav_tpu`` in its MoE blocks
  alone: each expert's matrices are charged for its ``capacity`` slots of
  each batch row (``E · C`` slots a row), not for every token, and the
  router for every token.
- CvT, CeiT, TNT and MLP-Mixer, whose modules run at different token
  counts, have a count of their own (:data:`FAMILY_COUNTS`), which walks
  the port's modules in forward order with each one's own token count:
  a dense layer ``2 · tokens · in · out``; an attention block its Q
  projection over the queries, K and V over the keys, the output over the
  queries and its core ``4 · B · H · q_len · kv_len · Dh`` (CvT's
  conv-projected K/V, CeiT's class attention); a convolution ``2 · out
  pixels · k² · C_in / groups · C_out`` (CvT's and CeiT's stems and
  embeddings, their depthwise convs, TNT's pixel embedding); TNT's inner
  blocks over 16 tokens × ``B · P`` slices; Mixer's token-mixing MLP
  across the channels, contracting over the tokens.

There is no XLA cost analysis on this side; the analytic total is the
number. ``tests/test_torch_costs.py`` holds each family's forward count
against ``torch.utils.flop_counter.FlopCounterMode`` over the dense path.

:func:`resolve_peak_flops` gives the peak MFU divides by: an explicit
override, the card's row in
:data:`~sav_tpu_torch.utils.flops.PEAK_FLOPS_PER_CARD`, or on the CPU a
fixed fake peak so that the accounting runs in tests (labelled
``cpu-fake`` wherever it surfaces: never a measurement).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from sav_tpu_torch.utils.flops import PEAK_SOURCE, per_card_peak_flops

# The CPU's stand-in peak: obviously not a CPU's rate, stable across hosts.
CPU_FAKE_PEAK_FLOPS = 1.0e12

# Forward + backward over forward matmul FLOPs.
TRAIN_STEP_MULTIPLIER = 3.0

COMP_PATCH_EMBED = "patch_embed"
COMP_ATTN_PROJ = "attention_proj"
COMP_ATTN_QKAV = "attention_qkav"
COMP_FFN = "ffn"
COMP_HEAD = "head"
COMP_OTHER = "other"

_ATTN_MARKERS = (
    "attention", "attn", "to_qkv", "to_out", "to_q", "to_kv",
    "query", "key", "value",
)
_FFN_MARKERS = ("ffblock", "feedforward", "mlp", "fc1", "fc2", "moeff")
_PATCH_MARKERS = ("patchembed", "patch_embed", "stem", "conv_stem")
_QKV_KERNEL_MARKERS = ("to_qkv", "to_q", "query")

# interop's family names, by the port's model class.
_FAMILIES = ("ViT", "CaiT", "BoTNet", "TNT", "CeiT", "CvT", "MLPMixer")


def resolve_peak_flops(override: Optional[float] = None,
                       device: Optional[torch.device] = None, *,
                       dtype: str = "bfloat16") -> tuple:
    """``(peak FLOP/s of one card, source)``: ``override`` when given
    (``"override"``), the card's row of the peak table for ``dtype``
    (``"device-table: <card>, <source>"``), the CPU's fake peak
    (``"cpu-fake"``), or ``(None, "unknown")`` for a card the table does
    not know: MFU is then not reported rather than wrong."""
    if override:
        return float(override), "override"
    device = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if device.type == "cpu":
        return CPU_FAKE_PEAK_FLOPS, "cpu-fake"
    name = torch.cuda.get_device_name(device)
    peak = per_card_peak_flops(name, dtype)
    if peak is None:
        return None, "unknown"
    return peak, f"device-table: {name}, {dtype}, {PEAK_SOURCE}"


@dataclasses.dataclass
class StepCost:
    """One train step's analytic cost on one card: ``flops`` (forward and
    backward), a floor on ``bytes_accessed`` (parameters three times, the
    batch once), and the share of the forward FLOPs of each component
    (``attribution``) and of each top-level parameter group (``groups``)."""

    flops: float
    bytes_accessed: float
    source: str
    attribution: dict
    groups: dict
    num_tokens: int
    per_device_batch: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_params_tree(model: torch.nn.Module) -> dict:
    """The flax ``params`` tree of a port model (any family of
    :data:`_FAMILIES`), as nested dicts of f32 numpy arrays under ``sav_tpu``'s names."""
    from sav_tpu_torch.interop import flax_from_params

    family = type(model).__name__
    if family not in _FAMILIES:
        raise ValueError(f"no parameter rules for a {family}; families: {_FAMILIES}")
    return flax_from_params(model.state_dict(), family)["params"]


def _leaves(tree: Any, path: tuple = ()) -> list:
    """``[(path, leaf)]`` of nested dicts in sorted key order, as
    ``jax.tree_util.tree_flatten_with_path`` walks them."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key], path + (key,))]
    return [(path, tree)]


def _leaf_info(path: tuple, leaf) -> tuple:
    """(joined lowercase path, top group, shape, itemsize) of a leaf."""
    try:
        itemsize = np.dtype(leaf.dtype).itemsize
    except TypeError:
        itemsize = leaf.element_size() if torch.is_tensor(leaf) else 4
    group = next((str(k) for k in path if str(k)), "params")
    return "/".join(str(k) for k in path).lower(), group, tuple(leaf.shape), itemsize


def infer_num_tokens(params: Any, image_size: int) -> int:
    """The trunk's sequence length: a learned ``pos_embed`` table
    ``(1, L, D)`` states it; else the patch-embed kernel ``(ph, pw, C, D)``
    gives the patch grid (+1 with a top-level ``cls``); else a 16-pixel
    patch grid plus one."""
    leaves = _leaves(params)
    has_cls = any("cls" in _leaf_info(p, l)[0].split("/")[0] for p, l in leaves)
    for path, leaf in leaves:
        joined, _, shape, _ = _leaf_info(path, leaf)
        if "pos_embed" in joined and len(shape) == 3 and shape[0] == 1:
            return int(shape[1])
    for path, leaf in leaves:
        joined, group, shape, _ = _leaf_info(path, leaf)
        if len(shape) == 4 and any(m in group.lower() for m in _PATCH_MARKERS):
            ph, pw = int(shape[0]), int(shape[1])
            if ph > 0 and pw > 0:
                grid = max(image_size // ph, 1) * max(image_size // pw, 1)
                return grid + (1 if has_cls else 0)
    return max(image_size // 16, 1) ** 2 + 1


def _component_of(joined: str, group: str, shape: tuple) -> str:
    top = group.lower()
    if top == "head" or top.startswith("head"):
        return COMP_HEAD
    if any(m in top for m in _PATCH_MARKERS) or (len(shape) == 4 and "embed" in top):
        return COMP_PATCH_EMBED
    if any(m in joined for m in _ATTN_MARKERS):
        return COMP_ATTN_PROJ
    if any(m in joined for m in _FFN_MARKERS):
        return COMP_FFN
    return COMP_OTHER


def _step_cost(by_comp: dict, by_group: dict, param_bytes: float, *, batch_size: int,
               image_size: int, num_tokens: int, n_devices: int, training: bool) -> StepCost:
    """A :class:`StepCost` from a forward's FLOPs by component and group."""
    mult = TRAIN_STEP_MULTIPLIER if training else 1.0
    forward = sum(by_comp.values())
    total = forward * mult
    n = max(int(n_devices), 1)
    b = float(batch_size)
    attribution = {k: (v / forward if forward else 0.0) for k, v in sorted(by_comp.items())}
    groups = {k: (v / forward if forward else 0.0) for k, v in sorted(by_group.items())}
    batch_bytes = b * image_size * image_size * 3 * 4 / n
    return StepCost(
        flops=total / n,
        bytes_accessed=3.0 * param_bytes + batch_bytes,
        source="analytic",
        attribution=attribution,
        groups=groups,
        num_tokens=num_tokens,
        per_device_batch=b / n,
    )


def _is_moe(joined: str) -> bool:
    return "moeffblock" in joined


def analytic_train_step_cost(params: Any, *, batch_size: int, image_size: int,
                             n_devices: int = 1, training: bool = True,
                             moe_slots: Optional[int] = None) -> StepCost:
    """Analytic FLOPs and a bytes floor of one train step over ``params``
    (a flax-named tree, :func:`model_params_tree`) at global
    ``batch_size``, divided over ``n_devices``: ``sav_tpu``'s
    ``analytic_train_step_cost``, but where ``moe_slots`` (each expert's
    capacity per batch row) is given, an MoE block's expert matrices are
    charged for ``batch_size · moe_slots`` rows each and its biases not at
    all."""
    leaves = _leaves(params)
    num_tokens = infer_num_tokens(params, image_size)
    b = float(batch_size)
    by_comp: dict = {}
    by_group: dict = {}
    param_bytes = 0.0
    attn_seen: set = set()
    for path, leaf in leaves:
        joined, group, shape, itemsize = _leaf_info(path, leaf)
        size = float(np.prod(shape)) if shape else 1.0
        param_bytes += size * itemsize
        comp = _component_of(joined, group, shape)
        if len(shape) >= 2 and shape[0] != 1:
            # A matmul kernel (leading-dim-1 tables are added, not
            # contracted); the head sees one pooled token per image.
            tokens = b if comp == COMP_HEAD else b * num_tokens
            if moe_slots is not None and _is_moe(joined) and "experts_" in joined:
                # Each expert runs its capacity's slots of every batch row;
                # the expert biases are added, not contracted.
                tokens = 0.0 if "experts_b" in joined else b * moe_slots
            flops = 2.0 * tokens * size
            by_comp[comp] = by_comp.get(comp, 0.0) + flops
            by_group[group] = by_group.get(group, 0.0) + flops
        if any(m in joined for m in _QKV_KERNEL_MARKERS) and len(shape) >= 2:
            # One attention core per qkv/query kernel: QKᵀ and AV cost
            # 2 * B * L² * (H * Dh) each, H * Dh the kernel's trailing dims.
            module = joined.rsplit("/", 1)[0]
            if module not in attn_seen:
                attn_seen.add(module)
                hd = float(shape[-1]) * (float(shape[-2]) if len(shape) >= 3 else 1.0)
                qkav = 4.0 * b * float(num_tokens) ** 2 * hd
                by_comp[COMP_ATTN_QKAV] = by_comp.get(COMP_ATTN_QKAV, 0.0) + qkav
                by_group[group] = by_group.get(group, 0.0) + qkav
    return _step_cost(by_comp, by_group, param_bytes, batch_size=batch_size,
                      image_size=image_size, num_tokens=num_tokens, n_devices=n_devices,
                      training=training)


# ------------------------------------------------- the per-family counts


class _Tally:
    """A forward's FLOPs by component and by top-level module."""

    def __init__(self):
        self.by_comp: dict = {}
        self.by_group: dict = {}

    def add(self, group: str, comp: str, flops: float) -> None:
        self.by_comp[comp] = self.by_comp.get(comp, 0.0) + float(flops)
        self.by_group[group] = self.by_group.get(group, 0.0) + float(flops)

    def dense(self, group: str, comp: str, layer: torch.nn.Linear, tokens: float) -> None:
        self.add(group, comp, 2.0 * tokens * layer.in_features * layer.out_features)

    def ff(self, group: str, block, tokens: float) -> None:
        """An FFBlock (fc1, fc2) over ``tokens`` rows."""
        self.dense(group, COMP_FFN, block.fc1, tokens)
        self.dense(group, COMP_FFN, block.fc2, tokens)

    def conv(self, group: str, comp: str, conv: torch.nn.Conv2d, images: float,
             out_hw: tuple) -> None:
        kh, kw = conv.kernel_size
        self.add(group, comp, 2.0 * images * out_hw[0] * out_hw[1] * kh * kw
                 * conv.in_channels / conv.groups * conv.out_channels)

    def depthwise(self, group: str, comp: str, dw, images: float, out_hw: tuple) -> None:
        channels, _, kh, kw = dw.weight.shape
        self.add(group, comp, 2.0 * images * out_hw[0] * out_hw[1] * kh * kw * channels)

    def core(self, group: str, b: float, heads: int, head_ch: int, q_len: float,
             kv_len: float, talking_heads: bool) -> None:
        """QKᵀ and AV, and the talking heads' two [H, H] mixes of the logits."""
        self.add(group, COMP_ATTN_QKAV, 4.0 * b * heads * q_len * kv_len * head_ch)
        if talking_heads:
            self.add(group, COMP_ATTN_QKAV, 2 * 2.0 * b * q_len * kv_len * heads * heads)

    def attention(self, group: str, attn, b: float, q_len: float, kv_len: float) -> None:
        """An AttentionBlock: Q over the queries, K and V over the keys, the
        output merge over the queries, and the core."""
        h, d = attn.num_heads, attn.head_ch
        d_in = (attn.to_qkv if attn.fused_qkv else attn.to_q).shape[0]
        d_out = attn.to_out.shape[-1]
        self.add(group, COMP_ATTN_PROJ, 2.0 * b * (q_len + 2 * kv_len) * d_in * h * d
                 + 2.0 * b * q_len * h * d * d_out)
        self.core(group, b, h, d, q_len, kv_len, attn.talking_heads)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _count_cvt(model, b: float, image_size: int, tally: _Tally) -> int:
    h = w = image_size
    tokens = 0
    for s, stage in enumerate(model.stages):
        group = f"stages_{s}"
        conv = stage.embed.proj
        h, w = _ceil_div(h, conv.stride[0]), _ceil_div(w, conv.stride[1])
        tally.conv(group, COMP_PATCH_EMBED, conv, b, (h, w))
        cls = 1 if stage.insert_cls else 0
        tokens = h * w + cls
        for block in stage.blocks:
            attn = block.attn
            heads, head_ch = attn.num_heads, attn.head_ch
            lengths = []
            for proj in (attn.to_q, attn.to_k, attn.to_v):
                out_hw = (_ceil_div(h, proj.depthwise.stride), _ceil_div(w, proj.depthwise.stride))
                tally.depthwise(group, COMP_ATTN_PROJ, proj.depthwise, b, out_hw)
                n = out_hw[0] * out_hw[1] + cls
                tally.add(group, COMP_ATTN_PROJ, 2.0 * b * n * proj.pointwise.shape[0]
                          * heads * head_ch)
                lengths.append(n)
            tally.core(group, b, heads, head_ch, lengths[0], lengths[1], attn.talking_heads)
            tally.add(group, COMP_ATTN_PROJ, 2.0 * b * lengths[0] * heads * head_ch
                      * attn.to_out.shape[-1])
            tally.ff(group, block.ff, b * tokens)
    tally.dense("head", COMP_HEAD, model.head, b)
    return tokens


def _count_ceit(model, b: float, image_size: int, tally: _Tally) -> int:
    stem = model.stem
    side = _ceil_div(image_size, stem.stem_conv.stride[0])
    tally.conv("stem", COMP_PATCH_EMBED, stem.stem_conv, b, (side, side))
    side = _ceil_div(side, 2)  # the 3×3/2 max pool
    ph, pw = stem.patch_embed.patch_shape
    grid = (side // ph, side // pw)
    tally.conv("stem", COMP_PATCH_EMBED, stem.patch_embed.proj, b, grid)
    patches = grid[0] * grid[1]
    tokens = 1 + patches
    for i, block in enumerate(model.blocks):
        group = f"blocks_{i}"
        tally.attention(group, block.attn, b, tokens, tokens)
        leff = block.leff
        tally.dense(group, COMP_FFN, leff.expand, b * patches)
        tally.depthwise(group, COMP_FFN, leff.dwconv, b, grid)
        tally.dense(group, COMP_FFN, leff.project, b * patches)
    # The class attention: the last CLS token over every block's.
    tally.attention("lca", model.lca, b, 1, len(model.blocks))
    tally.dense("head", COMP_HEAD, model.head, b)
    return tokens


def _count_tnt(model, b: float, image_size: int, tally: _Tally) -> int:
    ph, pw = model.patch_embed.patch_shape
    patches = (image_size // ph) * (image_size // pw)
    conv = model.pixel_embed.proj
    inner_hw = (_ceil_div(ph, conv.stride[0]), _ceil_div(pw, conv.stride[1]))
    inner = inner_hw[0] * inner_hw[1]
    slices = b * patches  # the pixel stream folds the patches into the batch
    tally.conv("pixel_embed", COMP_PATCH_EMBED, conv, slices, inner_hw)
    tally.conv("patch_embed", COMP_PATCH_EMBED, model.patch_embed.proj, b, (image_size // ph,
                                                                           image_size // pw))
    tokens = 1 + patches
    for i, block in enumerate(model.blocks):
        group = f"blocks_{i}"
        tally.attention(group, block.inner_attn, slices, inner, inner)
        tally.ff(group, block.inner_ff, slices * inner)
        tally.dense(group, COMP_OTHER, block.inner2outer.proj, slices)
        tally.attention(group, block.outer_attn, b, tokens, tokens)
        tally.ff(group, block.outer_ff, b * tokens)
    tally.dense("head", COMP_HEAD, model.head, b)
    return tokens


def _count_mixer(model, b: float, image_size: int, tally: _Tally) -> int:
    ph, pw = model.patch_embed.patch_shape
    grid = (image_size // ph, image_size // pw)
    tally.conv("patch_embed", COMP_PATCH_EMBED, model.patch_embed.proj, b, grid)
    tokens = grid[0] * grid[1]
    for i, block in enumerate(model.blocks):
        group = f"blocks_{i}"
        # Token mixing: one row per (image, channel), contracting the tokens.
        tally.ff(group, block.token_mixing, b * block.channel_mixing.fc1.in_features)
        tally.ff(group, block.channel_mixing, b * tokens)
    tally.dense("head", COMP_HEAD, model.head, b)
    return tokens


# The families that run modules at different token counts, each with its
# count: ``count(model, batch, image_size, tally) -> trunk tokens``.
FAMILY_COUNTS = {"CvT": _count_cvt, "CeiT": _count_ceit, "TNT": _count_tnt,
                 "MLPMixer": _count_mixer}


# The components whose dots the int8 arm quantizes (the patch embedding and
# the attention core stay in the compute dtype).
INT8_COMPONENTS = (COMP_ATTN_PROJ, COMP_FFN, COMP_HEAD)


def int8_flops_share(cost: StepCost) -> float:
    """The share of a step's FLOPs in the components whose dots the int8
    arm runs in int8 (projections, FFs, head): an upper bound where a float
    dense layer counts among them (the MoE experts, TNT's fold)."""
    return sum(cost.attribution.get(c, 0.0) for c in INT8_COMPONENTS)


def _moe_slots(model: torch.nn.Module, num_tokens: int) -> Optional[int]:
    """Each expert's capacity per batch row of ``model``'s MoE blocks (None
    without any)."""
    from sav_tpu_torch.models.layers.moe import MoEFFBlock

    blocks = [m for m in model.modules() if isinstance(m, MoEFFBlock)]
    if not blocks:
        return None
    slots = {block.capacity(num_tokens) for block in blocks}
    if len(slots) != 1:
        raise ValueError(f"MoE blocks of different capacities {sorted(slots)}")
    return slots.pop()


def train_step_cost(model: torch.nn.Module, *, batch_size: int, image_size: int,
                    n_devices: int = 1, training: bool = True) -> StepCost:
    """The analytic cost of one train step of a port model (any registry
    family): its family's own count (:data:`FAMILY_COUNTS`), else
    :func:`analytic_train_step_cost` of its parameter tree, with the MoE
    blocks' routed slots."""
    family = type(model).__name__
    count = FAMILY_COUNTS.get(family)
    if count is None:
        params = model_params_tree(model)
        num_tokens = infer_num_tokens(params, image_size)
        return analytic_train_step_cost(params, batch_size=batch_size, image_size=image_size,
                                        n_devices=n_devices, training=training,
                                        moe_slots=_moe_slots(model, num_tokens))
    tally = _Tally()
    num_tokens = count(model, float(batch_size), image_size, tally)
    param_bytes = float(sum(p.numel() * p.element_size() for p in model.parameters()))
    return _step_cost(tally.by_comp, tally.by_group, param_bytes, batch_size=batch_size,
                      image_size=image_size, num_tokens=num_tokens, n_devices=n_devices,
                      training=training)
