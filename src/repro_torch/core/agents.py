"""Agent plug-in of Ape-X DQN behind the JAX package's agent protocol:

  init(generator, obs_example, device) -> params
  act(params, generator, obs, eps, explore_u=None, random_action=None)
      -> (action, act_aux)   # aux buffers the Q-values evaluated while acting
  initial_priorities(first_aux, action, returns, discount_n, last_aux)
  update(params, target_params, opt_state, optimizer, items, is_weights)
      -> (params, opt_state, new_priorities, metrics)

The gradient comes from ``torch.autograd`` over the network. The DPG agent
comes with the DPG slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import actor as actor_lib
from repro_torch.core import learner as learner_lib
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models.qnetworks import DuelingDQN
from repro_torch.optim import optimizers as optim


@dataclasses.dataclass(frozen=True)
class DQNAgent:
    """Double-Q + n-step + dueling (paper §3.1, Appendix C)."""

    net: DuelingDQN
    grad_clip: float = 40.0

    def init(self, generator, obs_example: torch.Tensor, device=None) -> Any:
        return self.net.init(generator, obs_example, device)

    def act(self, params: Any, generator, obs: torch.Tensor, eps: torch.Tensor,
            explore_u: torch.Tensor | None = None,
            random_action: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        q = self.net.apply(params, obs)                       # (lanes, A)
        a = actor_lib.egreedy_action(generator, q, eps, explore_u, random_action)
        return a, {"q": q}

    def initial_priorities(self, first_aux, action, returns, discount_n, last_aux):
        return actor_lib.initial_priorities_dqn(
            first_aux["q"], action, returns, discount_n, last_aux["q"])

    def update(self, params, target_params, opt_state, optimizer, items, is_weights):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        out = learner_lib.dqn_loss(
            p, target_params, self.net.apply, items["obs"], items["action"],
            items["returns"], items["discount_n"], items["next_obs"], is_weights)
        leaves = tree_leaves(p)
        grad_leaves = iter(torch.autograd.grad(out.loss, leaves))
        grads = tree_map(lambda _: next(grad_leaves), p)
        grads = optim.clip_by_global_norm(grads, self.grad_clip)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optim.apply_updates(params, updates)
        metrics = {"loss": out.loss.detach(), **out.aux}
        return params, opt_state, out.new_priorities, metrics
