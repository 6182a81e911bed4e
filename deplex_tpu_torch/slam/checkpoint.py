"""Checkpoint / resume of SLAM state (map, trajectory, keyframes) as npz.

Port of the npz form of ``deplex_tpu.slam.checkpoint``, in its layout:
``leaf_i`` for the i-th leaf in the reference package's tree-flatten order
(dict keys sorted, NamedTuple fields in order, None holds no leaf), ``n``
the leaf count and ``treedef`` the structure's text as uint8 bytes. Loading
takes the structure from an example state, as there, so a file written by
either package loads in the other.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, leaves: list) -> str:
    """Append tree's leaves (as numpy) to `leaves`; return its structure text."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}" for k in keys) + "}"
    if _is_namedtuple(tree):
        inner = ", ".join(_flatten(v, leaves) for v in tree)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{inner}])"
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    leaves.append(np.asarray(tree))
    return "*"


def _unflatten(example, leaves):
    """Rebuild example's structure from an iterator of leaves."""
    if example is None:
        return None
    if isinstance(example, dict):
        return {k: _unflatten(example[k], leaves) for k in sorted(example)}
    if _is_namedtuple(example):
        return type(example)(*(_unflatten(v, leaves) for v in example))
    return next(leaves)


def save_checkpoint(path: str, state: dict) -> None:
    """state: a dict of arrays, tensors and NamedTuples of them; written to
    path.npz."""
    leaves: list = []
    treedef = f"PyTreeDef({_flatten(state, leaves)})"
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(str(path) + ".npz", treedef=np.frombuffer(treedef.encode(), dtype=np.uint8),
             n=len(leaves), **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})


def load_checkpoint(path: str, example_state: dict):
    """Restore a checkpoint saved by save_checkpoint (of either package);
    example_state gives the structure. Leaves come back as numpy arrays."""
    with np.load(str(path) + ".npz") as npz:
        flat = [npz[f"leaf_{i}"] for i in range(int(npz["n"]))]
    expected: list = []
    _flatten(example_state, expected)
    if len(expected) != len(flat):
        raise ValueError(f"checkpoint {path}.npz holds {len(flat)} leaves, "
                         f"the example state {len(expected)}")
    return _unflatten(example_state, iter(flat))
