"""The dueling Q-network of Ape-X DQN, in PyTorch.

The paper uses "the same network as in the Dueling DDQN agent" (Wang et al.
2016): a Nature-CNN torso (conv 32x8x8/4, 64x4x4/2, 64x3x3/1) + value and
advantage streams. An MLP torso serves vector observations (ChainWorld).

Parameters are nested dicts of tensors in the JAX package's layout, so its
parameters load straight in (``repro_torch.core.params_from_jax``): a dense
``w`` is ``(d_in, d_out)`` and applied as ``x @ w + b``; a conv ``w`` is
HWIO and its activations NHWC. The DPG actor and critic come with the DPG
slice of the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F


def _uniform_init(generator, shape, scale, device):
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return (2.0 * u - 1.0) * scale


def dense_init(generator, d_in: int, d_out: int, device=None) -> dict:
    scale = math.sqrt(6.0 / (d_in + d_out))  # glorot uniform
    return {"w": _uniform_init(generator, (d_in, d_out), scale, device),
            "b": torch.zeros((d_out,), dtype=torch.float32, device=device)}


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def conv_init(generator, h: int, w: int, c_in: int, c_out: int, device=None) -> dict:
    scale = math.sqrt(2.0 / (h * w * c_in))  # he
    return {"w": scale * torch.randn((h, w, c_in, c_out), generator=generator,
                                     device=device, dtype=torch.float32),
            "b": torch.zeros((c_out,), dtype=torch.float32, device=device)}


def conv(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """VALID convolution of NHWC ``x`` with an HWIO kernel; NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + p["b"]


def _prep_obs(obs: torch.Tensor) -> torch.Tensor:
    if obs.dtype == torch.uint8:
        return obs.to(torch.float32) / 255.0
    return obs.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class DuelingDQN:
    """Dueling Q-network; conv torso for image obs, MLP torso for vectors."""

    num_actions: int
    torso: str = "mlp"               # "mlp" | "nature_cnn"
    mlp_hidden: tuple[int, ...] = (256, 256)
    head_hidden: int = 512

    def init(self, generator: torch.Generator | None, obs_example: torch.Tensor,
             device=None) -> Any:
        x = _prep_obs(obs_example[None] if obs_example.dim() in (1, 3) else obs_example)
        x = x.to(device)
        p: dict[str, Any] = {}
        if self.torso == "nature_cnn":
            p["c1"] = conv_init(generator, 8, 8, x.shape[-1], 32, device)
            p["c2"] = conv_init(generator, 4, 4, 32, 64, device)
            p["c3"] = conv_init(generator, 3, 3, 64, 64, device)
            feat = self._cnn(p, x).shape[-1]
        else:
            feat = x.shape[-1]
            for i, h in enumerate(self.mlp_hidden):
                p[f"fc{i}"] = dense_init(generator, feat, h, device)
                feat = h
        p["val1"] = dense_init(generator, feat, self.head_hidden, device)
        p["val2"] = dense_init(generator, self.head_hidden, 1, device)
        p["adv1"] = dense_init(generator, feat, self.head_hidden, device)
        p["adv2"] = dense_init(generator, self.head_hidden, self.num_actions, device)
        return p

    @staticmethod
    def _cnn(params: Any, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(conv(params["c1"], x, 4))
        x = torch.relu(conv(params["c2"], x, 2))
        x = torch.relu(conv(params["c3"], x, 1))
        return x.reshape(x.shape[0], -1)

    def apply(self, params: Any, obs: torch.Tensor) -> torch.Tensor:
        """obs (B, ...) -> q-values (B, num_actions)."""
        x = _prep_obs(obs)
        if self.torso == "nature_cnn":
            x = self._cnn(params, x)
        else:
            i = 0
            while f"fc{i}" in params:
                x = torch.relu(dense(params[f"fc{i}"], x))
                i += 1
        v = dense(params["val2"], torch.relu(dense(params["val1"], x)))   # (B, 1)
        a = dense(params["adv2"], torch.relu(dense(params["adv1"], x)))   # (B, A)
        return v + a - a.mean(dim=-1, keepdim=True)
