"""Wrapper of the sum-tree update kernel (``csrc/sumtree_update.cu``).

For a CUDA tree it launches the kernel, in place, on PyTorch's current
stream; for a CPU tree it runs the plain version (``ref.py``). ``launches``
counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sumtree_update.ref import sumtree_update_ref

launches = 0


def sumtree_update(tree: torch.Tensor, idx: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """tree (2C,) f32, idx (B,) leaf ids, values (B,) -> the same tree,
    updated in place (last writer wins; ids in [-C, -1] wrap, other ids
    outside [0, C) drop)."""
    global launches
    if tree.device.type == "cpu":
        return sumtree_update_ref(tree, idx, values)
    if tree.device.type != "cuda":
        raise ValueError(f"sumtree_update: unsupported device {tree.device}")
    two_c = tree.shape[0]
    cap = two_c // 2
    idx = idx.to(torch.int32).contiguous()
    values = values.to(torch.float32).contiguous()
    (B,) = idx.shape
    _build.check_tensor("sumtree_update tree", tree, torch.float32, tree.device, (two_c,))
    _build.check_tensor("sumtree_update idx", idx, torch.int32, tree.device, (B,))
    _build.check_tensor("sumtree_update values", values, torch.float32, tree.device, (B,))
    winner = torch.empty((cap,), dtype=torch.int32, device=tree.device)
    fn = _build.launcher("sumtree_update")
    rc = fn(tree.data_ptr(), cap.bit_length() - 1, idx.data_ptr(),
            values.data_ptr(), B, winner.data_ptr(), _build.stream_of(tree))
    _build.check_launch("sumtree_update", rc)
    launches += 1
    return tree
