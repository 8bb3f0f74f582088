"""Numerics checks on the host (the port's counterpart of
``find_nonfinite`` and ``assert_all_finite`` in ``sav_tpu/utils/debug.py``),
used by the trainer's ``debug_nans`` mode on each step's metrics.

The float tensors of a tree reach the host in one copy per device (flattened
and concatenated there first), so checking a step's metrics costs one small
copy, which waits for the step.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaves(tree: Any, path: str = ""):
    """``(path, leaf)`` of every leaf of nested dicts (by sorted key, as
    JAX flattens them), lists and tuples, the path's parts joined by ``/``
    as ``sav_tpu`` names them."""
    if isinstance(tree, dict):
        for key, value in sorted(tree.items()):
            yield from _leaves(value, f"{path}/{key}" if path else str(key))
    elif isinstance(tree, (list, tuple)):
        for index, value in enumerate(tree):
            yield from _leaves(value, f"{path}/{index}" if path else str(index))
    else:
        yield path, tree


def find_nonfinite(tree: Any) -> list:
    """Paths of the floating-point leaves (tensors, arrays, floats) that hold
    a NaN or an Inf, in the tree's order."""
    bad = set()
    leaves = list(_leaves(tree))
    on_device: dict = {}
    for path, leaf in leaves:
        if torch.is_tensor(leaf):
            if leaf.is_floating_point():
                on_device.setdefault(leaf.device, []).append((path, leaf.detach()))
            continue
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad.add(path)
    for tensors in on_device.values():
        flat = torch.cat([t.reshape(-1).float() for _, t in tensors]).cpu().numpy()
        finite = np.isfinite(flat)
        offset = 0
        for path, tensor in tensors:
            if not finite[offset:offset + tensor.numel()].all():
                bad.add(path)
            offset += tensor.numel()
    return [path for path, _ in leaves if path in bad]


def assert_all_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the leaves that are not finite."""
    bad = find_nonfinite(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
