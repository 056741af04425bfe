"""Leafwise helpers over the port's dataclasses of tensors.

The port keeps solver state, problem parameters and scaled problems as
dataclasses whose tensor fields all carry the same leading batch dimension.
These helpers map a function over those tensor fields, recursing into
fields that are themselves dataclasses (other fields, such as a problem
object, pass through unchanged); ``tree_flatten`` / ``tree_unflatten`` turn
such a dataclass into its named tensor leaves and back (what a saved program
takes and returns); ``to_numpy`` brings one leaf to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def tree_map(fn, obj, *others):
    """New dataclass of obj's type with fn(leaf, *other_leaves) per tensor field."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        vs = [getattr(o, f.name) for o in others]
        if isinstance(v, torch.Tensor):
            out[f.name] = fn(v, *vs)
        elif dataclasses.is_dataclass(v):
            out[f.name] = tree_map(fn, v, *vs)
        else:
            out[f.name] = v
    return dataclasses.replace(obj, **out)


def _bcast(mask, leaf):
    return mask.reshape(mask.shape + (1,) * (leaf.dim() - mask.dim()))


def tree_where(mask, a, b):
    """Per-lane select: mask (B,) picks a's rows where true, else b's."""
    return tree_map(lambda x, y: torch.where(_bcast(mask, x), x, y), a, b)


def tree_stack(objs):
    """Stack a list of like dataclasses along a new leading axis."""
    return tree_map(lambda *ls: torch.stack(ls), objs[0], *objs[1:])


def tree_cat(objs):
    """Concatenate a list of like dataclasses along their batch axis."""
    return tree_map(lambda *ls: torch.cat(ls), objs[0], *objs[1:])


def tree_flatten(obj, prefix: str = "") -> list:
    """[(dotted field path, tensor)] of every tensor field of obj, depth first
    in field order (the order :func:`tree_unflatten` reads them back)."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append((prefix + f.name, v))
        elif dataclasses.is_dataclass(v):
            out += tree_flatten(v, f"{prefix}{f.name}.")
    return out


def tree_unflatten(template, leaves):
    """A dataclass like ``template`` whose tensor fields are taken in order
    from the iterable ``leaves`` (other fields are template's)."""
    leaves = iter(leaves)

    def build(obj):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                out[f.name] = next(leaves)
            elif dataclasses.is_dataclass(v):
                out[f.name] = build(v)
        return dataclasses.replace(obj, **out)

    return build(template)


def to_numpy(t) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
