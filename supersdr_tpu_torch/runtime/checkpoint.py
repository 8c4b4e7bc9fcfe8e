"""Checkpoint / resume for streaming state (the reference's
`runtime/checkpoint.py`).

The stream state (chain/PFB carries, AGC levels, NCO phase) is a
structure of NamedTuples of tensors, so long captures can be processed
resumably: checkpoint every N chunks, crash, reload, and continue
sample-exactly.

Format: the reference's, a single .npz with the structure's leaves as
`leaf_{i}` and a `_meta` JSON (`n_leaves`, `treedef`, the caller's meta).
The leaves are in `jax.tree.flatten`'s order: NamedTuple fields and tuple
or list items in order, dict items by sorted key, and `None` fields
skipped. The port's states have the reference's field names in the
reference's order, so a checkpoint written by either package resumes in
the other. `treedef` is this package's own description of the structure;
loading reads only `n_leaves` and the leaves, as the reference's does.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _walk(node, leaf) -> tuple[object, str]:
    """(node rebuilt with `leaf` applied to every array leaf in flatten
    order, a description of its structure)."""
    if node is None:
        return None, "None"
    if _is_namedtuple(node):
        parts = [_walk(getattr(node, f), leaf) for f in node._fields]
        desc = ", ".join(f"{f}={d}" for f, (_, d) in zip(node._fields, parts))
        return type(node)(*(v for v, _ in parts)), \
            f"{type(node).__name__}({desc})"
    if isinstance(node, (tuple, list)):
        parts = [_walk(v, leaf) for v in node]
        desc = ", ".join(d for _, d in parts)
        return type(node)(v for v, _ in parts), \
            (f"({desc})" if isinstance(node, tuple) else f"[{desc}]")
    if isinstance(node, dict):
        keys = sorted(node)
        parts = {k: _walk(node[k], leaf) for k in keys}
        desc = ", ".join(f"{k!r}: {parts[k][1]}" for k in keys)
        return {k: parts[k][0] for k in keys}, f"{{{desc}}}"
    return leaf(node), "*"


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(state) -> tuple[list[np.ndarray], str]:
    leaves: list[np.ndarray] = []
    _, treedef = _walk(state, lambda v: leaves.append(_to_numpy(v)))
    return leaves, treedef


def save_state(path: str | Path, state, meta: dict | None = None) -> None:
    """Persist any structure of tensors (ChainState, WidebandState, …)."""
    leaves, treedef = _flatten(state)
    arrays = {f"leaf_{i}": l for i, l in enumerate(leaves)}
    arrays["_meta"] = np.frombuffer(
        json.dumps({"treedef": treedef, "n_leaves": len(leaves),
                    **(meta or {})}).encode(), dtype=np.uint8)
    np.savez(str(path), **arrays)


def load_state(path: str | Path, like):
    """Restore into the structure of `like` (a template state built by the
    matching init_state). Each leaf's shape is validated, its dtype cast to
    the template leaf's, and it is put on the template leaf's device."""
    with np.load(str(path)) as data:
        meta = json.loads(bytes(data["_meta"]).decode())
        leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    t_leaves: list = []
    _walk(like, t_leaves.append)
    if len(leaves) != len(t_leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template {len(t_leaves)}")
    it = iter(leaves)

    def restore(want):
        got = next(it)
        shape = tuple(getattr(want, "shape", ()))
        if tuple(got.shape) != shape:
            raise ValueError(f"leaf shape {got.shape} != template {shape}")
        if isinstance(want, torch.Tensor):
            # np.array keeps a 0-d leaf 0-d (ascontiguousarray would not)
            return torch.from_numpy(np.array(got)).to(dtype=want.dtype,
                                                      device=want.device)
        return np.asarray(got).astype(np.asarray(want).dtype)
    return _walk(like, restore)[0]


def checkpoint_meta(path: str | Path) -> dict:
    with np.load(str(path)) as data:
        return json.loads(bytes(data["_meta"]).decode())
