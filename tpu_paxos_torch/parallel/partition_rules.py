"""The committed partition-rule table (a copy of
``tpu_paxos/parallel/partition_rules.py``'s), and the two functions the
port's sharded engines lay their state out with.

A rule maps a regex over a leaf's tree path (``<family>/<field>/<field>``)
to a dims template; the first matching rule wins, and rank-0 and
single-element leaves need none.  Dims language:

- ``REP``: replicated, every rank holds the whole leaf;
- a tuple with one entry per dimension, each ``None`` (unsplit) or
  ``LANE`` (split over the mesh's ranks, in rank order); a trailing
  ``...`` leaves any remaining dims unsplit, and without it the tuple's
  length must equal the leaf's rank.

JAX builds ``PartitionSpec`` trees from the table; the port has no
compiler to hand them to, so the same rules drive :func:`split_tree`
(rank ``r``'s slice of a global tree: ``LANE`` dims cut into ``size``
equal blocks, ``REP`` leaves copied, the per-shard queue leaves
``sim/prop/(pend|gate|head|tail)`` cut on their leading shard axis) and
:func:`gather_tree` (the slices back into the global tree); the lane
tile's ``fleet/``, ``member/`` and ``serve/`` rows split and gather a
fleet's lane-leading trees (NamedTuples, plain tuples and None, numpy or
tensor leaves) the same way.  A leaf no
rule matches raises by its path, as JAX's ``PartitionRuleError`` does.
Pure stdlib and numpy/torch slicing: the table is data.
"""

from __future__ import annotations

import re

import numpy as np

#: Dim sentinel: split this dimension over the mesh's ranks.
LANE = "lane"

#: Dims sentinel: fully replicated at any rank.
REP = "replicated"

#: The committed table: (path regex, dims), first match wins.
RULES: tuple = (
    # ---- fast: parallel/sharded.py FastState ([A, I] SoA) ----------
    (r"^fast/(promised|max_seen)$", REP),
    (r"^fast/(acc_ballot|acc_vid|learned)$", (None, LANE)),
    # ---- sim: parallel/sharded_sim.py global SimState --------------
    (r"^sim/acc/(promised|max_seen)$", REP),
    (r"^sim/acc/(acc_ballot|acc_vid)$", (None, LANE)),
    (r"^sim/learned$", (None, LANE)),
    (r"^sim/prop/(adopted_b|adopted_v|cur_batch|own_assign|commit_vid)$",
     (None, LANE)),
    (r"^sim/prop/(acks|commit_acked)$", (None, None, LANE)),
    # per-shard private queues: leading axis = shard
    (r"^sim/prop/(pend|gate)$", (LANE, None, None)),
    (r"^sim/prop/(head|tail)$", (LANE, None)),
    # [P]/[P, A] proposer control plane: replicated
    (r"^sim/prop/", REP),
    (r"^sim/net/", REP),  # network calendars: replicated
    (r"^sim/met/chosen_(vid|round|ballot)$", (LANE,)),
    (r"^sim/met/msgs$", REP),
    (r"^sim/(crashed|qsums)$", REP),
    # ---- lane-stacked fleets: the leading lane axis tiles the mesh ----
    (r"^fleet/", (LANE, ...)),
    (r"^member/", (LANE, ...)),
    (r"^serve/", (LANE, ...)),
)


class PartitionRuleError(ValueError):
    """A state leaf no committed rule matches (named by tree path), or a
    matched rule whose rank disagrees with the leaf."""


def _key_part(key) -> str:
    """One pytree path key as a path segment (JAX's path keys carry
    ``name``, ``idx`` or ``key``; the port's walk passes field names)."""
    if isinstance(key, str):
        return key
    for attr in ("name", "idx", "key"):
        v = getattr(key, attr, None)
        if v is not None:
            return str(v)
    return str(key)


def leaf_path(family: str, path) -> str:
    """``family/part/part`` path string for one flattened leaf."""
    return "/".join([family, *(_key_part(k) for k in path)])


def is_trivial(leaf) -> bool:
    """Rank-0 / single-element leaves need no rule: they replicate
    wherever they live."""
    shape = tuple(getattr(leaf, "shape", ()))
    if not shape:
        return True
    n = 1
    for d in shape:
        n *= int(d)
    return n == 1


def match_path(path: str):
    """First matching rule for a leaf path -> ``(index, dims)`` or
    ``None``."""
    for idx, (pat, dims) in enumerate(RULES):
        if re.search(pat, path):
            return idx, dims
    return None


def rank_problem(dims, ndim: int) -> str | None:
    """Why ``dims`` cannot lay out a rank-``ndim`` leaf (None = fine)."""
    if dims == REP:
        return None
    fixed = [d for d in dims if d is not Ellipsis]
    open_rank = len(fixed) != len(dims)
    if open_rank:
        if ndim < len(fixed):
            return (
                f"rule wants rank >= {len(fixed)} "
                f"(dims {dims!r}), leaf has rank {ndim}"
            )
        return None
    if ndim != len(dims):
        return (
            f"rule pins rank {len(dims)} (dims {dims!r}), leaf has "
            f"rank {ndim} — the rule drifted from the state layout"
        )
    return None


def dims_of(path: str, leaf, slice_of_global: bool = False):
    """The dims template for one global leaf (``REP`` for trivial
    leaves); raises :class:`PartitionRuleError` by path where no rule
    fits.  ``slice_of_global=True`` judges one rank's slice instead: its
    rule decides first, since a slice of a split leaf may hold one
    element."""
    if is_trivial(leaf) and not slice_of_global:
        return REP
    hit = match_path(path)
    if hit is None and is_trivial(leaf):
        return REP
    if hit is None:
        raise PartitionRuleError(
            f"no committed partition rule matches leaf {path} "
            f"(shape {tuple(leaf.shape)}) — add a rule to "
            "parallel/partition_rules.py (SH301: an unruled leaf "
            "would silently replicate)"
        )
    idx, dims = hit
    problem = rank_problem(dims, len(leaf.shape))
    if problem:
        raise PartitionRuleError(
            f"partition rule {RULES[idx][0]!r} matched leaf {path} "
            f"but {problem}"
        )
    return dims


def _lane_axes(dims) -> list[int]:
    if dims == REP:
        return []
    return [k for k, d in enumerate(dims) if d == LANE]


def _is_tree(node) -> bool:
    return isinstance(node, tuple)


def _map(family: str, fn, trees, path=()):
    """``fn(path_string, leaves)`` over the leaves of parallel trees of
    one kind (NamedTuples by field name, plain tuples by index; None
    stays None); returns a tree of the results."""
    head = trees[0]
    if head is None:
        return None
    if _is_tree(head):
        fields = getattr(head, "_fields", None) or [str(k) for k in range(len(head))]
        parts = [_map(family, fn, [t[k] for t in trees], path + (f,))
                 for k, f in enumerate(fields)]
        return type(head)(*parts) if hasattr(head, "_fields") else tuple(parts)
    return fn(leaf_path(family, path), trees)


def map_leaves(fn, tree):
    """``fn`` over every leaf of a tree of NamedTuples, tuples and None."""
    return _map("", lambda _path, leaves: fn(leaves[0]), [tree])


def split_tree(family: str, tree, size: int, rank: int):
    """Rank ``rank``'s slice of a global tree (numpy or torch leaves): each
    ``LANE`` dim cut into ``size`` equal blocks (a leaf's length there must
    divide), ``REP`` leaves as they are (shared, not copied)."""
    def one(path, leaves):
        leaf = leaves[0]
        for ax in _lane_axes(dims_of(path, leaf)):
            n = int(leaf.shape[ax])
            if n % size:
                raise PartitionRuleError(
                    f"leaf {path} has {n} entries on its split axis {ax}, "
                    f"which do not divide over {size} ranks"
                )
            step = n // size
            index = [slice(None)] * len(leaf.shape)
            index[ax] = slice(rank * step, (rank + 1) * step)
            leaf = leaf[tuple(index)]
        return leaf

    return _map(family, one, [tree])


def gather_tree(family: str, trees, device=None):
    """The global tree from every rank's slice (in rank order): ``LANE``
    dims concatenated (tensor leaves on ``device``, default the first
    rank's; numpy leaves on the host), ``REP`` leaves taken from rank
    0."""
    import torch

    def one(path, leaves):
        leaf = leaves[0]
        axes = _lane_axes(dims_of(path, leaf, slice_of_global=len(leaves) > 1))
        if not axes:
            return leaf
        if len(axes) != 1:
            raise PartitionRuleError(f"leaf {path} splits {len(axes)} axes; one is gathered")
        if isinstance(leaf, torch.Tensor):
            dev = leaf.device if device is None else device
            return torch.cat([x.to(dev) for x in leaves], dim=axes[0])
        return np.concatenate([np.asarray(x) for x in leaves], axis=axes[0])

    return _map(family, one, list(trees))


def leaves(family: str, tree):
    """``(path, leaf)`` for every leaf of a tree of NamedTuples, tuples
    and None (None skipped), paths as :func:`split_tree` names them."""
    out = []

    def one(path, ls):
        out.append((path, ls[0]))

    _map(family, one, [tree])
    return out


def coverage(trees: dict) -> dict:
    """SH301 over ``{entry: (family, tree)}``: every non-trivial leaf must
    match a rule whose rank fits it.  Returns ``{"leaves", "rules",
    "unmatched": [{entry, path, shape}], "rank": [{entry, path, rule,
    detail}], "stale_rules": [{index, rule}]}``; a stale rule matches no
    leaf of any tree (meaningful only when ``trees`` is every family)."""
    used: set[int] = set()
    unmatched, rank = [], []
    n_leaves = 0
    for entry in sorted(trees):
        family, tree = trees[entry]
        for path, leaf in leaves(family, tree):
            n_leaves += 1
            hit = match_path(path)
            if hit is None:
                if not is_trivial(leaf):
                    unmatched.append({"entry": entry, "path": path,
                                      "shape": list(getattr(leaf, "shape", ()))})
                continue
            idx, dims = hit
            used.add(idx)
            problem = rank_problem(dims, len(getattr(leaf, "shape", ())))
            if problem and not is_trivial(leaf):
                rank.append({"entry": entry, "path": path, "rule": RULES[idx][0],
                             "detail": problem})
    stale = [{"index": i, "rule": pat} for i, (pat, _d) in enumerate(RULES) if i not in used]
    return {"leaves": n_leaves, "rules": len(RULES), "unmatched": unmatched, "rank": rank,
            "stale_rules": stale}


def leaf_bytes(leaf) -> int:
    """Bytes of one numpy or torch leaf."""
    if hasattr(leaf, "nbytes"):
        return int(leaf.nbytes)
    return int(leaf.numel() * leaf.element_size())


def rank_bytes(family: str, tree, size: int) -> list[int]:
    """Each rank's summed leaf bytes of ``tree`` split over ``size`` ranks
    (replicated leaves count whole on every rank)."""
    return [sum(leaf_bytes(x) for _p, x in leaves(family, split_tree(family, tree, size, r)))
            for r in range(size)]
