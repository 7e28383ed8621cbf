"""Wrapper of the Triton n-step return kernel (``kernel.py``).

For CUDA tensors it launches the kernel on PyTorch's current stream; for
CPU tensors it runs the plain version (``ref.py``). ``launches`` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.nstep_return.kernel import compiled
from repro_torch.kernels.nstep_return.ref import nstep_return_ref

launches = 0
BLOCK_L, BLOCK_W = 16, 64


def nstep_return(reward: torch.Tensor, discount: torch.Tensor,
                 n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(lanes, T) rewards/discounts -> (returns, discount_n) of (lanes, T-n+1)."""
    global launches
    if reward.device.type == "cpu":
        return nstep_return_ref(reward, discount, n)
    if reward.device.type != "cuda":
        raise ValueError(f"nstep_return: unsupported device {reward.device}")
    lanes, T = reward.shape
    if T < n:
        raise ValueError(f"trajectory length {T} < n-step horizon {n}")
    W = T - n + 1
    dev = reward.device
    _build.check_tensor("nstep_return reward", reward, torch.float32, dev, (lanes, T))
    _build.check_tensor("nstep_return discount", discount, torch.float32, dev, (lanes, T))
    returns = torch.empty((lanes, W), dtype=torch.float32, device=dev)
    disc = torch.empty((lanes, W), dtype=torch.float32, device=dev)
    grid = (-(-lanes // BLOCK_L), -(-W // BLOCK_W))
    with torch.cuda.device(dev):
        compiled()[grid](reward, discount, returns, disc, lanes, T, W,
                         N=n, BLOCK_L=BLOCK_L, BLOCK_W=BLOCK_W, num_warps=4)
    launches += 1
    return returns, disc
