"""Optimizers, gradient clipping and target-network machinery, by hand.

The paper uses Centered RMSProp (lr 0.00025/4, decay 0.95, eps 1.5e-7, no
momentum, grad-norm clip 40) for Ape-X DQN (Appendix C) and Adam (lr 1e-4)
for Ape-X DPG (Appendix D).

The API is the JAX package's: ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``, applied with
:func:`apply_updates`, all over nested dicts of tensors. Every function
returns new tensors and mutates none. ``centered_rmsprop`` keeps ``eps``
*inside* the square root, as the JAX package does; ``torch.optim.RMSprop``
adds it outside, so it is not a substitute.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree: Any) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads: Any, max_norm: float) -> Any:
    """Paper Appendix C: gradient norms are clipped to 40."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


# ---------------------------------------------------------------------------
# Centered RMSProp (Appendix C).
# ---------------------------------------------------------------------------

class RMSPropState(NamedTuple):
    mean_sq: Any
    mean: Any


def centered_rmsprop(learning_rate: float = 0.00025 / 4, decay: float = 0.95,
                     eps: float = 1.5e-7) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return RMSPropState(mean_sq=z, mean=tree_map(torch.clone, z))

    def update(grads, state, params=None):
        del params
        g32 = tree_map(lambda g: g.to(torch.float32), grads)
        mean_sq = tree_map(lambda ms, g: decay * ms + (1 - decay) * g * g,
                           state.mean_sq, g32)
        mean = tree_map(lambda m, g: decay * m + (1 - decay) * g, state.mean, g32)
        updates = tree_map(
            lambda g, ms, m: -learning_rate * g / torch.sqrt(ms - m * m + eps),
            g32, mean_sq, mean)
        return updates, RMSPropState(mean_sq, mean)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adam / AdamW.
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adam(learning_rate: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        device = tree_leaves(params)[0].device
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                         mu=z, nu=tree_map(torch.clone, z))

    def update(grads, state, params=None):
        step = state.step + 1
        g32 = tree_map(lambda g: g.to(torch.float32), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, g32)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, g32)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

        def upd(m, v, p):
            u = -learning_rate * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                u = u - learning_rate * weight_decay * p.to(torch.float32)
            return u

        if weight_decay and params is not None:
            updates = tree_map(upd, mu, nu, params)
        else:
            updates = tree_map(lambda m, v: upd(m, v, None), mu, nu)
        return updates, AdamState(step, mu, nu)

    return Optimizer(init, update)


def adamw(learning_rate: float = 3e-4, weight_decay: float = 0.1, **kw) -> Optimizer:
    return adam(learning_rate=learning_rate, weight_decay=weight_decay, **kw)


# ---------------------------------------------------------------------------
# Target networks (Appendix C: copy every 2500 batches; Appendix D: 100).
# ---------------------------------------------------------------------------

def periodic_target_update(params: Any, target_params: Any, step: int,
                           period: int) -> Any:
    """Hard copy every ``period`` learner steps, identity otherwise. ``step``
    is a host integer, so the branch is taken on the host."""
    if step % period == 0:
        return tree_map(lambda p, t: p.detach().to(t.dtype).clone(), params, target_params)
    return target_params
