"""Priority, importance-sampling and exploration-ladder math (Ape-X §3/§4.1).

- priorities are |TD error| (proportional variant, Schaul et al. 2016);
- the replay stores ``(|delta| + eps)^alpha`` in sum-tree leaves (alpha=0.6);
- sampled batches are corrected with importance weights
  ``w_i = (N * P(i))^-beta / max_j w_j`` (beta=0.4);
- actor ``i`` of ``N`` explores with ``eps_i = eps^(1 + i/(N-1) * ladder_alpha)``
  (eps=0.4, ladder_alpha=7), constant through training.
"""

from __future__ import annotations

import torch

from repro_torch.core import sampling

# Paper defaults (§4.1, Appendix C/D).
PRIORITY_EXPONENT = 0.6       # alpha_sample
IS_EXPONENT = 0.4             # beta
EVICT_EXPONENT = -0.4         # alpha_evict (Ape-X DPG, Appendix D)
EPSILON_BASE = 0.4            # eps
EPSILON_ALPHA = 7.0           # ladder alpha
MIN_PRIORITY = 1e-4           # numerical floor so no transition starves


def to_leaf(priority: torch.Tensor, alpha: float = PRIORITY_EXPONENT) -> torch.Tensor:
    """Map raw priority |delta| to the sum-tree leaf value p^alpha."""
    return torch.pow(torch.clamp(torch.abs(priority), min=MIN_PRIORITY), alpha)


def importance_weights(leaf_values: torch.Tensor, total_mass: torch.Tensor,
                       num_items, beta: float = IS_EXPONENT) -> torch.Tensor:
    """Max-normalized IS weights for a sampled batch; the single-shard case
    of :mod:`repro_torch.core.sampling`'s formula."""
    w = sampling.raw_weights(leaf_values, total_mass, num_items, beta)
    return sampling.max_normalize(w)


def epsilon_ladder(num_actors: int, base: float = EPSILON_BASE,
                   alpha: float = EPSILON_ALPHA, device=None) -> torch.Tensor:
    """eps_i = base^(1 + i/(N-1)*alpha) for i in [0, N)."""
    # built with fills, not copied from the host, so acting never waits on a copy
    base_t = torch.full((num_actors,), base, dtype=torch.float32, device=device)
    if num_actors == 1:
        return base_t
    i = torch.arange(num_actors, dtype=torch.float32, device=device)
    return torch.pow(base_t, 1.0 + i / (num_actors - 1) * alpha)


def fixed_epsilon_set(num_actors: int, values=(0.5, 0.4, 0.3, 0.2, 0.1, 0.01),
                      device=None) -> torch.Tensor:
    """Appendix B ablation: a small fixed set of eps values tiled across actors."""
    vals = torch.tensor(values, dtype=torch.float32, device=device)
    return vals[torch.arange(num_actors, device=device) % len(values)]


def td_error_nstep(q_sa: torch.Tensor, returns: torch.Tensor,
                   discount_n: torch.Tensor, bootstrap: torch.Tensor) -> torch.Tensor:
    """n-step TD error  delta = R_{t:t+n} + gamma^n * bootstrap - Q(S_t, A_t)."""
    return returns + discount_n * bootstrap - q_sa
