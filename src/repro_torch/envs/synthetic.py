"""Vectorized synthetic environments on tensors (the device-resident actor loop).

* :class:`ChainWorld` — discrete, sparse-reward exploration chain (the Atari
  stand-in). Reaching the far end pays +1; a distractor action pays a tiny
  immediate reward, so greedy policies plateau — the setting where the
  paper's eps-ladder + prioritization shine (§5).

Every lane steps at once. Randomness comes from an explicit
``torch.Generator``, or from draws handed in (``slip_u``, ``slip_action``),
so a test can replay the JAX package's draws. ``PointMass`` comes with the
DPG slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class StepOut(NamedTuple):
    obs: torch.Tensor       # (lanes, ...)
    reward: torch.Tensor    # (lanes,) f32
    discount: torch.Tensor  # (lanes,) f32: gamma at this step, 0 = terminal


class ChainState(NamedTuple):
    pos: torch.Tensor       # (lanes,) int32 in [0, length)
    t: torch.Tensor         # (lanes,) int32 step counter


@dataclasses.dataclass(frozen=True)
class ChainWorld:
    length: int = 16
    max_steps: int = 64
    gamma: float = 0.99
    slip_prob: float = 0.05        # action slips to a random one
    distractor_reward: float = 0.01

    num_actions: int = 4           # 0: left, 1: right, 2: noop, 3: distractor

    obs_dtype = torch.uint8

    @property
    def obs_shape(self) -> tuple[int, ...]:
        return (self.length + 2,)

    def _obs(self, state: ChainState) -> torch.Tensor:
        cells = torch.arange(self.length, device=state.pos.device)
        onehot = (cells[None, :] == state.pos[:, None]).to(torch.uint8) * 255
        time = (state.t * (255 // self.max_steps)).to(torch.uint8)
        full = torch.full_like(time, 255)
        return torch.cat([onehot, time[:, None], full[:, None]], dim=1)

    def reset(self, lanes: int, device=None) -> tuple[ChainState, torch.Tensor]:
        zeros = torch.zeros((lanes,), dtype=torch.int32, device=device)
        state = ChainState(pos=zeros, t=zeros.clone())
        return state, self._obs(state)

    def step(self, state: ChainState, action: torch.Tensor,
             generator: torch.Generator | None = None,
             slip_u: torch.Tensor | None = None,
             slip_action: torch.Tensor | None = None) -> tuple[ChainState, StepOut]:
        """One step of every lane. ``slip_u`` ((lanes,) in [0, 1)) and
        ``slip_action`` ((lanes,) ints in [0, num_actions)) replace the draws
        from ``generator``."""
        lanes, dev = action.shape[0], action.device
        if slip_u is None:
            slip_u = torch.rand((lanes,), generator=generator, device=dev)
        if slip_action is None:
            slip_action = torch.randint(0, self.num_actions, (lanes,),
                                        generator=generator, device=dev)
        action = torch.where(slip_u.to(dev) < self.slip_prob,
                             slip_action.to(device=dev, dtype=action.dtype), action)
        delta = torch.where(action == 0, -1, torch.where(action == 1, 1, 0))
        pos = torch.clamp(state.pos + delta, 0, self.length - 1).to(torch.int32)
        t = state.t + 1
        reached = pos == self.length - 1
        terminal = reached | (t >= self.max_steps)
        reward = (reached.to(torch.float32)
                  + (action == 3).to(torch.float32) * self.distractor_reward)
        discount = torch.where(terminal, 0.0, self.gamma).to(torch.float32)
        # auto-reset
        zero = torch.zeros_like(pos)
        next_state = ChainState(pos=torch.where(terminal, zero, pos),
                                t=torch.where(terminal, zero, t))
        return next_state, StepOut(self._obs(next_state), reward, discount)


def batch_reset(env, lanes: int, device=None):
    """Vectorized reset over actor lanes."""
    return env.reset(lanes, device)


def batch_step(env, states, actions, generator=None, **draws):
    """Vectorized step over actor lanes; ``draws`` go to ``env.step``."""
    return env.step(states, actions, generator, **draws)
