"""Wrapper of the sum-tree descent kernel (``csrc/sumtree_sample.cu``).

For a CUDA tree it launches the kernel on PyTorch's current stream; for a
CPU tree it runs the plain version (``ref.py``). ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sumtree_sample.ref import sumtree_sample_with_mass_ref

launches = 0


def sumtree_sample_with_mass(tree: torch.Tensor, u: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """tree (2C,) f32, u (B,) in [0, total) -> ((B,) int32 leaf ids,
    (B,) f32 leaf masses, bitwise ``tree[C + idx]``)."""
    global launches
    if tree.device.type == "cpu":
        return sumtree_sample_with_mass_ref(tree, u)
    if tree.device.type != "cuda":
        raise ValueError(f"sumtree_sample: unsupported device {tree.device}")
    two_c = tree.shape[0]
    u = u.to(torch.float32).contiguous()
    (B,) = u.shape
    _build.check_tensor("sumtree_sample tree", tree, torch.float32, tree.device, (two_c,))
    _build.check_tensor("sumtree_sample u", u, torch.float32, tree.device, (B,))
    idx = torch.empty((B,), dtype=torch.int32, device=tree.device)
    mass = torch.empty((B,), dtype=torch.float32, device=tree.device)
    fn = _build.launcher("sumtree_sample")
    rc = fn(tree.data_ptr(), (two_c // 2).bit_length() - 1, u.data_ptr(), B,
            idx.data_ptr(), mass.data_ptr(), _build.stream_of(tree))
    _build.check_launch("sumtree_sample", rc)
    launches += 1
    return idx, mass


def sumtree_sample(tree: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """tree (2C,), u (B,) in [0, total) -> (B,) int32 leaf ids."""
    return sumtree_sample_with_mass(tree, u)[0]
