"""Sum-tree for proportional prioritized sampling (Schaul et al. 2016).

The tree backs the Ape-X replay memory: leaves hold priorities ``p_k^alpha``
and internal nodes hold subtree sums, so sampling a key with probability
``p_k^alpha / sum_j p_j^alpha`` is a root-to-leaf descent.

Layout: for ``capacity`` C (power of two) the tree is a flat ``(2*C,)``
float32 tensor. Node 1 is the root, node ``i`` has children ``2i`` and
``2i+1``; leaf ``k`` lives at index ``C + k``. Index 0 is unused.

Every write (:func:`update`, :func:`write`, :func:`write_rebuild`) changes
the tree **in place** and returns it: the replay owns one tree for its whole
life, as the JAX package's donated buffers do.

The two hot ops have hand-written CUDA kernels
(``repro_torch.kernels.sumtree_update`` and ``sumtree_sample``), with the
plain functions here as their oracles. The process-wide backend switch
(:func:`set_backend`) picks between them for :func:`write` and
:func:`sample_with_mass`, and for the replay ingest and the n-step fold:

* ``"cuda"`` (the default) — the kernels' wrappers, which launch the kernel
  for a CUDA tensor and run the plain version for a CPU tensor;
* ``"torch"`` — the plain functions on any device.

Every internal node is recomputed as ``left + right`` (never patched with
a delta), so the incremental write is bit-identical to a full
:func:`rebuild` on any tree that satisfies the sum invariant.
"""

from __future__ import annotations

import torch

__all__ = [
    "init", "capacity", "depth", "total", "leaves", "write", "write_rebuild",
    "update", "rebuild", "sample", "sample_with_mass", "sample_two_gather",
    "stratified_uniforms", "sample_stratified", "backend", "set_backend",
    "last_writer_lanes", "normalize_index", "repair_ancestors",
]

_BACKENDS = ("cuda", "torch")
_backend = "cuda"


def backend() -> str:
    """The backend of the kernelized ops: ``"cuda"`` or ``"torch"``."""
    return _backend


def set_backend(name: str | None) -> None:
    """Select the hot-op backend (``None`` restores the default, ``"cuda"``)."""
    global _backend
    if name is not None and name not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS} or None, got {name!r}")
    _backend = name or "cuda"


def _check_capacity(cap: int) -> None:
    if cap < 2 or (cap & (cap - 1)) != 0:
        raise ValueError(f"sum-tree capacity must be a power of two >= 2, got {cap}")


def init(cap: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Return an empty tree of leaf capacity ``cap``."""
    _check_capacity(cap)
    return torch.zeros((2 * cap,), dtype=dtype, device=device)


def capacity(tree: torch.Tensor) -> int:
    return tree.shape[0] // 2


def depth(tree: torch.Tensor) -> int:
    """Number of edges from root to leaf == log2(capacity)."""
    return capacity(tree).bit_length() - 1


def total(tree: torch.Tensor) -> torch.Tensor:
    """Total priority mass (root value), a 0-d tensor on the tree's device."""
    return tree[1]


def leaves(tree: torch.Tensor) -> torch.Tensor:
    """A view of the ``(C,)`` leaf level."""
    return tree[capacity(tree):]


def rebuild(leaf_values: torch.Tensor) -> torch.Tensor:
    """Build a new full tree from a ``(C,)`` leaf vector (C power of two)."""
    (cap,) = leaf_values.shape
    _check_capacity(cap)
    tree = torch.empty((2 * cap,), dtype=leaf_values.dtype, device=leaf_values.device)
    tree[0] = 0
    tree[cap:] = leaf_values
    n = cap
    while n > 1:
        level = tree[n:2 * n]
        tree[n // 2:n] = level[0::2] + level[1::2]
        n //= 2
    return tree


def normalize_index(idx: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Numpy-style scatter index rules: ids in [-C, -1] wrap, any other id
    outside [0, C) drops. Returns (clipped slot, in-range mask), int64."""
    idx = idx.to(torch.int64)
    norm = torch.where(idx < 0, idx + cap, idx)
    return norm.clamp(0, cap - 1), (norm >= 0) & (norm < cap)


def last_writer_lanes(slot: torch.Tensor, eligible: torch.Tensor) -> torch.Tensor:
    """Lane ids that win their slot under last-writer-wins: for each slot,
    the highest eligible lane. A stable sort groups each slot's lanes in
    lane order, so the last of each run is its winner."""
    lanes = torch.nonzero(eligible).flatten()
    s = slot[lanes]
    order = torch.argsort(s, stable=True)
    s = s[order]
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[:-1] != s[1:]
    return lanes[order[last]]


def repair_ancestors(tree: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Recompute every ancestor of the given clipped slots as left + right,
    level by level (in place). Lanes sharing a node write the identical
    value, so duplicate stores are benign."""
    node = slot + capacity(tree)
    for _ in range(depth(tree)):
        node = node >> 1
        tree[node] = tree[2 * node] + tree[2 * node + 1]
    return tree


def update(tree: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Incremental batched write (in place): O(B * log C) instead of
    :func:`rebuild`'s O(C).

    Leaves are set last-writer-wins under duplicate ids; then every lane's
    ancestors, dropped lanes' clipped nodes included, are recomputed as
    ``tree[2p] + tree[2p + 1]``.
    """
    cap = capacity(tree)
    slot, ok = normalize_index(idx, cap)
    win = last_writer_lanes(slot, ok)
    tree[slot[win] + cap] = values.to(tree.dtype)[win]
    return repair_ancestors(tree, slot)


def write_rebuild(tree: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Set ``leaves[idx] = values`` via a full O(C) level-rebuild (in place);
    the oracle of the incremental paths."""
    cap = capacity(tree)
    slot, ok = normalize_index(idx, cap)
    win = last_writer_lanes(slot, ok)
    new_leaves = leaves(tree).clone()
    new_leaves[slot[win]] = values.to(tree.dtype)[win]
    tree.copy_(rebuild(new_leaves))
    return tree


def write(tree: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Set ``leaves[idx] = values`` and restore the sum invariant, in place,
    through the backend's path (kernel or plain :func:`update`)."""
    if _backend == "torch":
        return update(tree, idx, values)
    from repro_torch.kernels.sumtree_update.ops import sumtree_update
    return sumtree_update(tree, idx, values)


def sample(tree: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Batched descent: map mass offsets ``u in [0, total)`` to leaf ids.

    The walk goes left when ``u < mass(left child)``, else subtracts the
    left mass and goes right (inverse-CDF sampling).
    """
    cap = capacity(tree)
    node = torch.ones(u.shape, dtype=torch.int64, device=u.device)
    u = u.to(tree.dtype)
    for _ in range(depth(tree)):
        left = node * 2
        left_mass = tree[left]
        go_left = u < left_mass
        node = torch.where(go_left, left, left + 1)
        u = torch.where(go_left, u, u - left_mass)
    return (node - cap).clamp(0, cap - 1).to(torch.int32)


def sample_two_gather(tree: torch.Tensor, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain :func:`sample` followed by a leaf gather."""
    idx = sample(tree, u)
    return idx, leaves(tree)[idx.long()]


def sample_with_mass(tree: torch.Tensor, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Leaf ids *and* their masses ``p^alpha`` through the backend's path;
    the mass is bitwise ``leaves(tree)[idx]`` on every backend."""
    if _backend == "torch":
        return sample_two_gather(tree, u)
    from repro_torch.kernels.sumtree_sample.ops import sumtree_sample_with_mass
    return sumtree_sample_with_mass(tree, u)


def stratified_uniforms(generator: torch.Generator | None, batch: int,
                        total_mass: torch.Tensor,
                        jitter: torch.Tensor | None = None) -> torch.Tensor:
    """Paper-faithful stratified offsets: one uniform per equal-mass stratum.
    ``jitter`` ((batch,) in [0, 1)) replaces the draw from ``generator``."""
    device = total_mass.device
    if jitter is None:
        jitter = torch.rand((batch,), generator=generator, device=device)
    jitter = jitter.to(device=device, dtype=torch.float32)
    u = (torch.arange(batch, dtype=torch.float32, device=device) + jitter) * (total_mass / batch)
    # guard the last stratum against fp overshoot of the root mass
    return torch.minimum(u, total_mass * (1.0 - 1e-6))


def sample_stratified(tree: torch.Tensor, generator: torch.Generator | None,
                      batch: int, jitter: torch.Tensor | None = None) -> torch.Tensor:
    """Sample ``batch`` leaf ids with stratified proportional prioritization."""
    u = stratified_uniforms(generator, batch, total(tree), jitter)
    return sample(tree, u)
