"""Global importance-sampling weight math, held once for every path.

The learner corrects prioritized sampling with ``w_i = (N * P(i))^-beta /
max_j w_j`` against the *global* sampling distribution. With equal
per-shard sample quotas, ``P(i) = leaf_i / (shard_total(i) * num_shards)``,
so the correction needs the global item count ``N`` and the global max
weight. ``merged_is_weights`` takes both over host-stacked per-shard
sub-samples; ``repro_torch.core.priority.importance_weights`` is the
single-shard case. (The mesh-collective form waits for the multi-shard
port.)
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class LearnerBatch(NamedTuple):
    """The learner-plane sample contract: everything a learner consumes.

    ``indices`` are global ``(shard, slot)`` keys, so a priority write-back
    of any subset or order of them routes to the owning shards unchanged.
    """

    indices: torch.Tensor     # (B,) global (shard, slot) keys
    items: Any                # dict of (B, ...) tensors
    is_weights: torch.Tensor  # (B,) globally max-normalized IS weights


def raw_weights(leaf_mass: torch.Tensor, scaled_total: torch.Tensor,
                num_items, beta: float) -> torch.Tensor:
    """Unnormalized ``(N * P(i))^-beta`` for leaves with mass ``leaf_mass``.

    ``scaled_total`` is the owning shard's total mass times the number of
    shards; ``num_items`` (a Python int or a tensor) is the global live
    item count N.
    """
    p = leaf_mass / torch.clamp(torch.as_tensor(scaled_total), min=1e-30)
    if isinstance(num_items, torch.Tensor):
        n = torch.clamp(num_items.to(torch.float32), min=1.0)
    else:  # a host count stays a scalar operand: no host-to-device copy
        n = max(float(num_items), 1.0)
    return torch.pow(n * torch.clamp(p, min=1e-30), -beta)


def max_normalize(w: torch.Tensor, w_max: torch.Tensor | None = None) -> torch.Tensor:
    """Divide by the (global) max weight so corrections only scale down."""
    if w_max is None:
        w_max = torch.max(w)
    return w / torch.clamp(w_max, min=1e-30)


def merged_is_weights(leaf_mass: torch.Tensor, total_mass: torch.Tensor,
                      sizes: torch.Tensor, beta: float) -> torch.Tensor:
    """IS weights for host-merged per-shard sub-samples: ``leaf_mass`` is
    ``(S, b)``, ``total_mass`` and ``sizes`` are ``(S,)``; returns ``(S, b)``."""
    num_shards = leaf_mass.shape[0]
    n_global = torch.sum(sizes)
    w = raw_weights(leaf_mass, (total_mass * num_shards)[:, None], n_global, beta)
    return max_normalize(w)
