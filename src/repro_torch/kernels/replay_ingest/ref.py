"""Plain PyTorch version of the fused replay ingest kernel.

The same function as ``csrc/replay_ingest.cu``, written with tensor ops:
elect each slot's last writer among the in-range lanes (masked lanes
included), let the applied winners write their rows and ``to_leaf`` leaves,
then repair the ancestors of every lane's clipped slot. A masked winner
would write its slot's old row and leaf, so it writes nothing, and it still
shadows earlier applied lanes on that slot, as in the reference scatter.
"""

from __future__ import annotations

import torch

from repro_torch.core import priority as prio
from repro_torch.core import sumtree


def replay_ingest_ref(tree: torch.Tensor, storage: dict, idx: torch.Tensor,
                      priorities: torch.Tensor, applied: torch.Tensor,
                      items: dict, *, alpha: float = prio.PRIORITY_EXPONENT):
    """Ingest in place; returns ``(tree, storage)``."""
    cap = sumtree.capacity(tree)
    slot, ok = sumtree.normalize_index(idx, cap)
    win = sumtree.last_writer_lanes(slot, ok)
    win = win[applied.to(torch.bool)[win]]
    dst = slot[win]
    for key, buf in storage.items():
        buf[dst] = items[key][win].to(buf.dtype)
    tree[dst + cap] = prio.to_leaf(priorities.to(torch.float32)[win], alpha)
    sumtree.repair_ancestors(tree, slot)
    return tree, storage
