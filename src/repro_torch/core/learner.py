"""Learning rule of Ape-X DQN (§3.1): double Q-learning with an n-step
bootstrap; the dueling head lives in the network.

The loss takes max-normalized importance weights from the replay sample and
returns the fresh |TD| priorities the learner writes back (Alg. 2 l.5-8).
The DPG and sequence losses come with later slices of the port.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class LossOut(NamedTuple):
    loss: torch.Tensor            # scalar
    new_priorities: torch.Tensor  # (B,)
    aux: dict


def dqn_loss(params: Any, target_params: Any,
             apply_fn: Callable[[Any, torch.Tensor], torch.Tensor],
             obs: torch.Tensor, action: torch.Tensor, returns: torch.Tensor,
             discount_n: torch.Tensor, next_obs: torch.Tensor,
             is_weights: torch.Tensor) -> LossOut:
    """l(theta) = 1/2 (G_t - q(S_t, A_t, theta))^2 with
    G_t = R_{t:t+n} + gamma^n q(S_{t+n}, argmax_a q(S_{t+n}, a, theta), theta^-).
    """
    q = apply_fn(params, obs)                                      # (B, A)
    q_sa = torch.gather(q, -1, action.long()[:, None])[:, 0]
    with torch.no_grad():
        a_star = torch.argmax(apply_fn(params, next_obs), dim=-1)
        q_next_target = apply_fn(target_params, next_obs)
        bootstrap = torch.gather(q_next_target, -1, a_star[:, None])[:, 0]
    g = returns + discount_n * bootstrap
    td = g - q_sa
    loss = 0.5 * torch.mean(is_weights * torch.square(td))
    td_abs = torch.abs(td.detach())
    return LossOut(loss, td_abs, {"mean_q": q_sa.detach().mean(),
                                  "mean_abs_td": td_abs.mean()})
