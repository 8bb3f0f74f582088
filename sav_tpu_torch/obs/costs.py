"""Per-step compute cost model and the peak it is measured against (the
port's own copy of what ``sav_tpu/obs/costs.py`` gives ``bench.py``).

:func:`analytic_train_step_cost` walks a parameter tree: matmul kernels
cost ``2 * tokens * prod(shape)`` forward FLOPs, each attention core adds
its parameter-free QKᵀ and AV products (``4 * B * L² * H * Dh``), and a
train step is 3× its forward (the backward does about twice the forward's
matmul work); norms, biases and softmax are left out, a few percent on ViT
shapes. The tree is the flax tree ``sav_tpu`` walks, with its names, so the
two models give the same FLOPs: the port's parameters reach it through
:func:`~sav_tpu_torch.interop.flax_from_params` (:func:`model_params_tree`).
There is no XLA cost analysis on this side; the analytic total is the
number.

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
# Families whose step the analytic cost would count wrong (ROADMAP queue
# A10), each with why:
_NO_ANALYTIC_COST = {
    # It takes one trunk length from the patch embedding; CeiT's conv stem
    # and CvT's three stages of other lengths do not fit it.
    "CeiT": "its conv stem's token count is not the patch embedding's",
    "CvT": "its three stages run at lengths other than the patch embedding's",
    # infer_num_tokens takes the first pos_embed table in sorted key order,
    # inner_pos_embed (L = 16): the whole trunk would count at 16 tokens.
    "TNT": "sav_tpu's count takes the inner position table's 16 tokens as the trunk's length",
    # The token-mixing kernel (196, hidden) runs across the 768 channels,
    # not over 196 tokens: the count would be 3.9x low at Mixer-B/16.
    "MLPMixer": "sav_tpu's count runs the token-mixing kernels over the tokens, not across "
                "the channels",
}


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


def analytic_train_step_cost(params: Any, *, batch_size: int, image_size: int,
                             n_devices: int = 1, training: bool = True) -> StepCost:
    """Analytic FLOPs and a bytes floor of one train step over ``params``
    (a flax-named tree, :func:`model_params_tree`) at global
    ``batch_size``, divided over ``n_devices``: ``sav_tpu``'s
    ``analytic_train_step_cost``."""
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
    mult = TRAIN_STEP_MULTIPLIER if training else 1.0
    total = sum(by_comp.values()) * mult
    n = max(int(n_devices), 1)
    forward = total / mult
    attribution = {k: (v / forward if total else 0.0) for k, v in sorted(by_comp.items())}
    groups = {k: (v / forward if total else 0.0) for k, v in sorted(by_group.items())}
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


# A ViT with routed experts: sav_tpu's count charges every expert matrix for
# every token (2·tokens·E·D·H), where each expert runs only its capacity's
# slots: at E = 8, k = 2 and 62 slots over 197 tokens, ~3.2x the routed work.
_MOE_REFUSAL = ("its MoE blocks would be charged every expert for every token, not the "
                "routed slots")


def analytic_cost_refusal(model: torch.nn.Module) -> Optional[str]:
    """Why :func:`train_step_cost` refuses ``model`` (CeiT, CvT, TNT,
    MLP-Mixer, and a ViT with ``moe_num_experts``: it would count their
    step wrong), naming ROADMAP A10; None where it counts it."""
    family = type(model).__name__
    if family == "ViT" and getattr(model, "moe_num_experts", None):
        reason = _MOE_REFUSAL
    elif family in _NO_ANALYTIC_COST:
        reason = _NO_ANALYTIC_COST[family]
    else:
        return None
    return f"no analytic step cost for {family} yet: {reason} (ROADMAP queue A10)"


def has_analytic_cost(model: torch.nn.Module) -> bool:
    """True where :func:`train_step_cost` counts ``model``'s step."""
    return analytic_cost_refusal(model) is None


def train_step_cost(model: torch.nn.Module, *, batch_size: int, image_size: int,
                    n_devices: int = 1, training: bool = True) -> StepCost:
    """:func:`analytic_train_step_cost` of a port model's parameters; raises
    ``NotImplementedError`` with :func:`analytic_cost_refusal`'s reason
    where :func:`has_analytic_cost` is False."""
    if not has_analytic_cost(model):
        raise NotImplementedError(analytic_cost_refusal(model))
    return analytic_train_step_cost(model_params_tree(model), batch_size=batch_size,
                                    image_size=image_size, n_devices=n_devices,
                                    training=training)
