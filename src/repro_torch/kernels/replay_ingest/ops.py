"""Wrapper of the fused replay ingest kernel (``csrc/replay_ingest.cu``).

For a CUDA tree it launches the kernel on PyTorch's current stream,
updating the tree and every storage buffer in place; for a CPU tree it runs
the plain version (``ref.py``). Each buffer goes to the kernel as a
``(C, row_bytes)`` uint8 view and each item as ``(B, row_bytes)`` bytes, so
one copy path serves every dtype. ``launches`` counts kernel launches and
nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.priority import PRIORITY_EXPONENT
from repro_torch.kernels import _build
from repro_torch.kernels.replay_ingest.ref import replay_ingest_ref

launches = 0
MAX_BUFFERS = 8  # kMaxBufs in csrc/replay_ingest.cu


def replay_ingest(tree: torch.Tensor, storage: dict, idx: torch.Tensor,
                  priorities: torch.Tensor, applied: torch.Tensor, items: dict,
                  *, alpha: float = PRIORITY_EXPONENT):
    """tree (2C,), storage dict of (C, ...), idx (B,) slot ids, priorities
    (B,) raw |TD|, applied (B,) lane mask, items dict of (B, ...) ->
    ``(tree, storage)``, both updated in place."""
    global launches
    if tree.device.type == "cpu":
        return replay_ingest_ref(tree, storage, idx, priorities, applied, items,
                                 alpha=alpha)
    if tree.device.type != "cuda":
        raise ValueError(f"replay_ingest: unsupported device {tree.device}")
    dev = tree.device
    two_c = tree.shape[0]
    cap = two_c // 2
    idx = idx.to(torch.int32).contiguous()
    (B,) = idx.shape
    priorities = priorities.to(torch.float32).contiguous()
    applied = applied.to(torch.uint8).contiguous()
    _build.check_tensor("replay_ingest tree", tree, torch.float32, dev, (two_c,))
    _build.check_tensor("replay_ingest idx", idx, torch.int32, dev, (B,))
    _build.check_tensor("replay_ingest priorities", priorities, torch.float32, dev, (B,))
    _build.check_tensor("replay_ingest applied", applied, torch.uint8, dev, (B,))
    if len(storage) > MAX_BUFFERS:
        raise ValueError(f"replay_ingest: at most {MAX_BUFFERS} storage buffers")
    if storage.keys() != items.keys():
        raise ValueError("replay_ingest: items must have the storage's keys")
    bufs, rows = [], []
    for key, buf in storage.items():
        if buf.shape[0] != cap:
            raise ValueError(f"replay_ingest: buffer {key!r} has {buf.shape[0]} rows, not {cap}")
        _build.check_tensor(f"replay_ingest buffer {key!r}", buf, buf.dtype, dev)
        item = items[key].to(device=dev, dtype=buf.dtype).contiguous()
        _build.check_tensor(f"replay_ingest item {key!r}", item, buf.dtype, dev,
                            (B,) + tuple(buf.shape[1:]))
        bufs.append(buf.reshape(cap, -1).view(torch.uint8))
        rows.append(item.reshape(B, -1).view(torch.uint8))
    n = len(bufs)
    buf_ptrs = (ctypes.c_void_p * n)(*[b.data_ptr() for b in bufs])
    item_ptrs = (ctypes.c_void_p * n)(*[r.data_ptr() for r in rows])
    row_bytes = (ctypes.c_longlong * n)(*[b.shape[1] for b in bufs])
    winner = torch.empty((cap,), dtype=torch.int32, device=dev)
    fn = _build.launcher("replay_ingest")
    rc = fn(tree.data_ptr(), cap.bit_length() - 1, idx.data_ptr(),
            priorities.data_ptr(), applied.data_ptr(), B, alpha, n,
            buf_ptrs, item_ptrs, row_bytes, winner.data_ptr(), _build.stream_of(tree))
    _build.check_launch("replay_ingest", rc)
    launches += 1
    return tree, storage
