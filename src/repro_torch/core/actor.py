"""Acting: exploration policies and actor-side initial priorities (Alg. 1).

The Ape-X actor computes *initial priorities online* from the Q-values it
already evaluated while acting (paper §3, Appendix F), not max-priority as
in Schaul et al. 2016. Everything here is vectorized over actor lanes.
Each function that draws randomness takes its draws as optional arguments,
so a test can hand in the JAX package's draws.
"""

from __future__ import annotations

import torch

from repro_torch.core import priority as prio


def egreedy_action(generator: torch.Generator | None, qvals: torch.Tensor,
                   epsilon: torch.Tensor, explore_u: torch.Tensor | None = None,
                   random_action: torch.Tensor | None = None) -> torch.Tensor:
    """Per-lane epsilon-greedy over (lanes, num_actions) Q-values.

    ``epsilon`` is (lanes,) — each lane is one "actor" of the paper's
    ladder. ``explore_u`` ((lanes,) in [0, 1)) and ``random_action``
    ((lanes,) ints) replace the draws from ``generator``. The greedy action
    is the first maximum, as ``jnp.argmax`` picks it.
    """
    lanes, num_actions = qvals.shape
    dev = qvals.device
    greedy = torch.argmax(qvals, dim=-1)
    if random_action is None:
        random_action = torch.randint(0, num_actions, (lanes,), generator=generator,
                                      device=dev)
    if explore_u is None:
        explore_u = torch.rand((lanes,), generator=generator, device=dev)
    explore = explore_u.to(dev) < epsilon
    return torch.where(explore, random_action.to(device=dev, dtype=greedy.dtype),
                       greedy).to(torch.int32)


def gaussian_action(generator: torch.Generator | None, mean_action: torch.Tensor,
                    sigma: float = 0.3, low: float = -1.0, high: float = 1.0,
                    noise: torch.Tensor | None = None) -> torch.Tensor:
    """DPG exploration (Appendix D): N(0, sigma) noise per action dim,
    clipped. ``noise`` (standard normal, ``mean_action``'s shape) replaces
    the draw from ``generator``."""
    if noise is None:
        noise = torch.randn(mean_action.shape, generator=generator,
                            device=mean_action.device, dtype=mean_action.dtype)
    return torch.clamp(mean_action + sigma * noise.to(mean_action), low, high)


def initial_priorities_dqn(q_first: torch.Tensor, action: torch.Tensor,
                           returns: torch.Tensor, discount_n: torch.Tensor,
                           q_last: torch.Tensor) -> torch.Tensor:
    """|n-step TD| from the actor's buffered Q-values (Appendix F).

    ``q_first`` (B, A) is q(S_t, *) from acting time, ``q_last`` (B, A) is
    q(S_{t+n}, *); the bootstrap is greedy w.r.t. the actor's own copy.
    """
    q_sa = torch.gather(q_first, -1, action.long()[:, None])[:, 0]
    bootstrap = q_last.max(dim=-1).values
    return torch.abs(prio.td_error_nstep(q_sa, returns, discount_n, bootstrap))


def initial_priorities_dpg(q_sa_first: torch.Tensor, returns: torch.Tensor,
                           discount_n: torch.Tensor,
                           q_boot_last: torch.Tensor) -> torch.Tensor:
    """|n-step TD| as given by the (stale) critic (Appendix D)."""
    return torch.abs(prio.td_error_nstep(q_sa_first, returns, discount_n, q_boot_last))
