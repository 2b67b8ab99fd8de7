"""Checkpoint / resume: whole-engine state save and restore (port of
``tpu_paxos/checkpoint.py``).

An engine state is one tree of tensors (``core.sim.SimState`` with its
nested subtrees, ``membership.engine.MemberState``), so a checkpoint is a
flat array dump and resume is exact: the round function is pure in (seed,
round), so a resumed run continues as the uninterrupted one does.

The file layout is the JAX package's: one ``.npz`` with ``leaf_{i}`` in
depth-first NamedTuple field order and a ``tpu_paxos_meta`` JSON entry
stamped with :data:`FORMAT`, so a checkpoint written by either package
restores in the other.  The tree structure is not serialized: the caller
supplies a structurally identical example (``like``), which also refuses
a mismatched geometry.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_META = "tpu_paxos_meta"

# Checkpoint format version, as in the JAX package ("v2" = the
# post-qsums/commit_wait SimState era, acks int8).
FORMAT = "tpu-paxos-ckpt-v2"

_NP_DTYPE = {
    torch.bool: np.dtype(np.bool_),
    torch.int8: np.dtype(np.int8),
    torch.uint8: np.dtype(np.uint8),
    torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64),
}


def _leaves(tree) -> list:
    """Depth-first leaves in NamedTuple field order (None holds none)."""
    if tree is None:
        return []
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        return [tree]
    return [leaf for child in tree for leaf in _leaves(child)]


def _unflatten(like, it):
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(next(it), copy=True)).to(like.device)
    return type(like)(*[_unflatten(child, it) for child in like])


def _host(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save(path: str, state, meta: dict | None = None) -> None:
    """Write a state tree (plus optional JSON-able metadata) to one
    ``.npz`` file, atomically."""
    payload = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(_leaves(state))}
    payload[_META] = np.frombuffer(
        json.dumps({"format": FORMAT, **(meta or {})}).encode(), dtype=np.uint8
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)  # no torn checkpoints


def restore(path: str, like):
    """Rebuild the tree saved at ``path`` with ``like``'s structure, each
    leaf on the device of ``like``'s.  Returns ``(state, meta)``.  Shapes
    and dtypes must match ``like``'s leaves exactly: a mismatch means the
    checkpoint belongs to a different config and is refused."""
    ref_leaves = _leaves(like)
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META]).decode()) if _META in z.files else {}
        fmt = meta.get("format")
        # a format mismatch is named first: a file from another format
        # era usually trips the structural checks too
        fmt_note = (
            ""
            if fmt == FORMAT
            else (
                f" (checkpoint format {fmt!r} != current {FORMAT!r}"
                if fmt
                else f" (unversioned pre-{FORMAT!r} checkpoint"
            )
            + " — the file predates or postdates this build's state "
            "layout)"
        )
        n = len([k for k in z.files if k.startswith("leaf_")])
        if n != len(ref_leaves):
            raise ValueError(
                f"checkpoint has {n} leaves, expected {len(ref_leaves)} — "
                f"wrong config or engine for this checkpoint{fmt_note}"
            )
        leaves = []
        for i, ref in enumerate(ref_leaves):
            arr = z[f"leaf_{i}"]
            if isinstance(ref, torch.Tensor):
                dtype, shape = _NP_DTYPE[ref.dtype], tuple(ref.shape)
            else:
                dtype, shape = np.asarray(ref).dtype, np.shape(ref)
            if arr.shape != shape or arr.dtype != dtype:
                raise ValueError(
                    f"checkpoint leaf {i} is {arr.dtype}{list(arr.shape)}, "
                    f"expected {dtype}{list(shape)} — wrong "
                    f"config{fmt_note}"
                )
            leaves.append(arr)
    return _unflatten(like, iter(leaves)), meta
