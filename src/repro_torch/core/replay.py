"""Prioritized replay memory (the Ape-X replay server) on one device.

Logically one centralized memory (paper §3). Storage is a dict of
``(C, ...)`` tensors plus a sum tree over the ``p^alpha`` leaves.

**In place.** Every add, priority write-back and eviction updates the
storage tensors and the tree in place and returns a new ``ReplayState``
that holds the same tensors. This stands in for the JAX package's
``donate_argnums``: the replay state is never copied per call (a 2M-slot
replay holds about 300 MB). Callers treat the state passed in as consumed.

The bookkeeping scalars (``write_pos``, ``size``, ``total_added``) are host
integers, so the FIFO cursor arithmetic and the eviction schedule cost no
device-to-host sync.

Eviction strategies (both from the paper):
  * ``evict_fifo`` — Atari (§4.1): adds are always permitted (soft limit);
    periodically the excess above the soft capacity is removed en masse in
    FIFO order.
  * ``evict_prioritized`` — DPG (Appendix D): victims are sampled with
    probability proportional to ``p^alpha_evict`` (alpha_evict = -0.4).

Both add modes funnel into one ingest contract — packed items, slot
indices, an ``applied`` lane mask — dispatched like the sum-tree hot ops:
the fused CUDA kernel (``repro_torch.kernels.replay_ingest``) on the
``"cuda"`` backend, the unfused chain (:func:`ingest_unfused`) on
``"torch"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import priority as prio
from repro_torch.core import sumtree


class ReplayState(NamedTuple):
    storage: dict             # dict of (C, ...) tensors
    tree: torch.Tensor        # (2*C,) sum-tree over p^alpha leaves
    write_pos: int            # FIFO circular pointer
    size: int                 # live items
    total_added: int          # lifetime adds (for diagnostics)


class SampleBatch(NamedTuple):
    indices: torch.Tensor     # (B,) int32 slot ids
    items: dict               # dict of (B, ...) tensors
    is_weights: torch.Tensor  # (B,) max-normalized importance weights
    leaf_mass: torch.Tensor   # (B,) p^alpha of each sampled slot
    total_mass: torch.Tensor  # 0-d, total priority mass
    size: int                 # live-item count at sample time


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """Static replay configuration."""

    capacity: int                      # physical slots (power of 2)
    soft_capacity: int | None = None   # logical limit (FIFO mode); default 7/8 phys
    alpha: float = prio.PRIORITY_EXPONENT
    beta: float = prio.IS_EXPONENT
    evict_alpha: float = prio.EVICT_EXPONENT
    min_fill: int = 128                # learner waits for this many items

    def __post_init__(self):
        if self.capacity & (self.capacity - 1):
            raise ValueError("replay capacity must be a power of two")

    @property
    def soft_cap(self) -> int:
        return self.soft_capacity if self.soft_capacity is not None else (self.capacity // 8) * 7


def init(cfg: ReplayConfig, item_example: dict, device=None) -> ReplayState:
    """Empty replay; ``item_example`` maps each field to one item's tensor."""
    storage = {k: torch.zeros((cfg.capacity,) + tuple(a.shape), dtype=a.dtype, device=device)
               for k, a in item_example.items()}
    return ReplayState(storage=storage, tree=sumtree.init(cfg.capacity, device),
                       write_pos=0, size=0, total_added=0)


def ingest_unfused(cfg: ReplayConfig, state: ReplayState, items: dict,
                   priorities: torch.Tensor, idx: torch.Tensor,
                   applied: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """The unfused ingest chain: leaf init, per-buffer storage scatter and
    the sum-tree write, each a separate step (in place).

    Gather-then-scatter throughout: masked (``~applied``) lanes re-write
    their slot's *original* leaf and row, so they are no-ops except under
    duplicate slots, where last-writer-wins applies. Out-of-range lanes
    (``add_alloc``'s overflow id ``C``) drop from every scatter.
    """
    cap = cfg.capacity
    slot, ok = sumtree.normalize_index(idx, cap)
    win = sumtree.last_writer_lanes(slot, ok)
    applied = applied.to(torch.bool)
    leaf = torch.where(applied, prio.to_leaf(priorities.to(torch.float32), cfg.alpha),
                       sumtree.leaves(state.tree)[slot])
    for key, buf in state.storage.items():
        x = items[key].to(buf.dtype)
        mask = applied.reshape((-1,) + (1,) * (x.dim() - 1))
        rows = torch.where(mask, x, buf[slot])
        buf[slot[win]] = rows[win]
    tree = sumtree.write(state.tree, idx, leaf)
    return state.storage, tree


def _ingest(cfg: ReplayConfig, state: ReplayState, items: dict,
            priorities: torch.Tensor, idx: torch.Tensor,
            applied: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """One ingest: priority init + storage scatter + tree repair, in place,
    through the backend's path (fused kernel or :func:`ingest_unfused`)."""
    if sumtree.backend() == "torch":
        return ingest_unfused(cfg, state, items, priorities, idx, applied)
    from repro_torch.kernels.replay_ingest.ops import replay_ingest
    tree, storage = replay_ingest(state.tree, state.storage, idx, priorities,
                                  applied, items, alpha=cfg.alpha)
    return storage, tree


def add_fifo(cfg: ReplayConfig, state: ReplayState, items: dict,
             priorities: torch.Tensor, valid: torch.Tensor | None = None) -> ReplayState:
    """Batched circular add with actor-computed initial priorities (Alg. 1
    l.10-11). Adding is always permitted (soft limit): when the physical
    buffer is full the oldest slots are overwritten. ``valid`` masks out
    lanes that must not consume a slot; counting them costs one sync."""
    (batch,) = priorities.shape
    dev = priorities.device
    offs = torch.arange(batch, dtype=torch.int64, device=dev)
    if valid is None:
        n_valid = batch
        applied = torch.ones((batch,), dtype=torch.bool, device=dev)
    else:
        # Pack valid lanes first so invalid ones don't consume slots: a
        # stable argsort of ~valid keeps the valid lanes' order.
        order = torch.argsort((~valid).to(torch.uint8), stable=True)
        items = {k: x[order] for k, x in items.items()}
        priorities = priorities[order]
        n_valid = int(valid.sum())                       # sync: host cursor
        applied = offs < n_valid
    idx = ((state.write_pos + offs) % cfg.capacity).to(torch.int32)
    storage, tree = _ingest(cfg, state, items, priorities, idx, applied)
    return ReplayState(storage=storage, tree=tree,
                       write_pos=(state.write_pos + n_valid) % cfg.capacity,
                       size=min(state.size + n_valid, cfg.capacity),
                       total_added=state.total_added + n_valid)


def free_slot_idx(live: torch.Tensor, batch: int) -> torch.Tensor:
    """First ``batch`` free slots via masked-cumsum compaction, in index
    order. Lanes beyond the free-slot count keep the out-of-range id ``C``,
    so their downstream scatters drop instead of aliasing a real slot."""
    (cap,) = live.shape
    free = ~live
    rank = torch.cumsum(free.to(torch.int64), 0) - 1
    slot = torch.arange(cap, dtype=torch.int32, device=live.device)
    keep = free & (rank < batch)
    out = torch.full((batch,), cap, dtype=torch.int32, device=live.device)
    out[rank[keep]] = slot[keep]
    return out


def add_alloc(cfg: ReplayConfig, state: ReplayState, items: dict,
              priorities: torch.Tensor, valid: torch.Tensor | None = None) -> ReplayState:
    """Add into *free* slots (leaf mass == 0) — DPG mode, paired with
    prioritized eviction. Overflow lanes beyond the free-slot count are
    dropped rather than spilling into live slots. Costs two syncs (the
    free-slot count and the stored count)."""
    (batch,) = priorities.shape
    dev = priorities.device
    if valid is None:
        valid = torch.ones((batch,), dtype=torch.bool, device=dev)
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    items = {k: x[order] for k, x in items.items()}
    priorities = priorities[order]
    valid = valid[order]

    live = sumtree.leaves(state.tree) > 0
    idx = free_slot_idx(live, batch)
    num_free = int((~live).sum())                        # sync
    offs = torch.arange(batch, dtype=torch.int64, device=dev)
    applied = valid & (offs < num_free)
    storage, tree = _ingest(cfg, state, items, priorities, idx, applied)
    n_new = int(applied.sum())                           # sync
    return ReplayState(storage=storage, tree=tree, write_pos=state.write_pos,
                       size=min(state.size + n_new, cfg.capacity),
                       total_added=state.total_added + n_new)


def sample(cfg: ReplayConfig, state: ReplayState, generator: torch.Generator | None,
           batch: int, jitter: torch.Tensor | None = None) -> SampleBatch:
    """Stratified proportional sampling + IS weights (Alg. 2 l.4; Appendix F).
    ``jitter`` replaces the stratified draw (see ``sumtree.stratified_uniforms``).
    No sync: the total mass stays on the device."""
    total = sumtree.total(state.tree)
    u = sumtree.stratified_uniforms(generator, batch, total, jitter)
    idx, leaf = sumtree.sample_with_mass(state.tree, u)
    rows = idx.long()
    items = {k: buf[rows] for k, buf in state.storage.items()}
    w = prio.importance_weights(leaf, total, state.size, cfg.beta)
    return SampleBatch(idx, items, w, leaf, total, state.size)


def set_priorities(cfg: ReplayConfig, state: ReplayState, idx: torch.Tensor,
                   priorities: torch.Tensor) -> ReplayState:
    """Learner writes back fresh |TD| priorities (Alg. 2 l.8), in place.

    Dead slots (leaf mass 0) stay dead: a write-back may arrive after an
    eviction freed a sampled slot, and resurrecting it would break the
    ``size`` == live-leaf-count invariant.
    """
    old = sumtree.leaves(state.tree)[idx.long()]
    new_leaf = prio.to_leaf(priorities, cfg.alpha)
    tree = sumtree.write(state.tree, idx, torch.where(old > 0, new_leaf, 0.0))
    return state._replace(tree=tree)


def evict_fifo(cfg: ReplayConfig, state: ReplayState) -> ReplayState:
    """Remove the excess above the soft capacity en masse, oldest first
    (§4.1). A slot dies iff its FIFO age ``(slot - oldest) mod C`` is below
    the excess; the tree is rebuilt from the masked leaves. With no excess
    the rebuild would reproduce the tree bit for bit (every write keeps the
    sum invariant), so it is skipped."""
    excess = max(state.size - cfg.soft_cap, 0)
    if excess == 0:
        return state
    oldest = (state.write_pos - state.size) % cfg.capacity
    slot = torch.arange(cfg.capacity, dtype=torch.int64, device=state.tree.device)
    kill = (slot - oldest) % cfg.capacity < excess
    new_leaves = torch.where(kill, 0.0, sumtree.leaves(state.tree))
    state.tree.copy_(sumtree.rebuild(new_leaves))
    return state._replace(size=state.size - excess)


def evict_prioritized(cfg: ReplayConfig, state: ReplayState,
                      generator: torch.Generator | None, num: int,
                      jitter: torch.Tensor | None = None) -> ReplayState:
    """Sample ``num`` victims with probability ∝ p^alpha_evict and free them
    (in place). Leaves hold p^alpha_sample, so the eviction mass is
    leaf^(alpha_evict / alpha_sample) on live slots. Sampling is with
    replacement (duplicates evict once). Costs one sync (the freed count)."""
    leaves = sumtree.leaves(state.tree)
    live = leaves > 0
    ratio = cfg.evict_alpha / cfg.alpha
    evict_mass = torch.where(live, torch.pow(torch.clamp(leaves, min=1e-30), ratio), 0.0)
    etree = sumtree.rebuild(evict_mass)
    victims = sumtree.sample_stratified(etree, generator, num, jitter)
    mark = torch.zeros((cfg.capacity,), dtype=torch.bool, device=leaves.device)
    mark[victims.long()] = True
    freed = int((mark & live).sum())                     # sync
    tree = sumtree.write(state.tree, victims,
                         torch.zeros((num,), dtype=leaves.dtype, device=leaves.device))
    return state._replace(tree=tree, size=max(state.size - freed, 0))


def can_sample(cfg: ReplayConfig, state: ReplayState) -> bool:
    """Learner gate: wait for min_fill items (paper: 50000 transitions).
    Reading the root mass is the one sync, and only once min_fill is met."""
    return state.size >= cfg.min_fill and bool(sumtree.total(state.tree) > 0)
