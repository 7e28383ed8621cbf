"""n-step transition construction (Ape-X Appendix F, "Adding Data").

Two equivalent implementations:

* :class:`Ring` — the paper's streaming circular buffer of the last ``n+1``
  step records per actor lane; each env step emits (at most) one valid
  transition.
* :func:`from_trajectory` — bulk construction over a finished rollout chunk,
  one pass over ``(lanes, T)`` rewards and discounts. The act phase runs it
  through the Triton kernel ``repro_torch.kernels.nstep_return``; this is
  that kernel's plain version.

Both truncate multi-step returns at episode boundaries via the discount
product (a terminal step carries ``discount == 0``, zeroing every later
reward in the window and the bootstrap term).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.tree import tree_map


class Ring(NamedTuple):
    """Circular buffer of the last ``n+1`` per-lane step records.

    ``record`` is a dict of tensors shaped ``(lanes, n+1, ...)`` — typically
    {obs, action, qvals} so initial priorities reuse the actor's buffered
    Q-values instead of recomputing them. ``ptr`` and ``count`` are host
    integers.
    """

    record: Any             # dict of (lanes, n+1, ...) tensors
    reward: torch.Tensor    # (lanes, n+1)  R_{t+1} stored with step t
    discount: torch.Tensor  # (lanes, n+1)  gamma_{t+1}, 0 at terminal
    ptr: int                # next write slot
    count: int              # total pushes


class Transition(NamedTuple):
    """One n-step transition: (S_t, A_t, R_{t:t+n}, gamma^n, S_{t+n})."""

    first: Any                # record at time t        (dict, (lanes, ...))
    last: Any                 # record at time t+n      (dict, (lanes, ...))
    returns: torch.Tensor     # (lanes,) n-step discounted return
    discount_n: torch.Tensor  # (lanes,) product of n discounts
    valid: torch.Tensor       # (lanes,) bool — ring warm (broadcast scalar)


def ring_init(record_example: Any, n: int, lanes: int, device=None) -> Ring:
    """Empty ring; ``record_example`` gives per-lane shapes as ``(1, ...)``."""
    rec = tree_map(
        lambda a: torch.zeros((lanes, n + 1) + tuple(a.shape[1:]), dtype=a.dtype,
                              device=device),
        record_example)
    return Ring(record=rec,
                reward=torch.zeros((lanes, n + 1), dtype=torch.float32, device=device),
                discount=torch.zeros((lanes, n + 1), dtype=torch.float32, device=device),
                ptr=0, count=0)


def ring_push(ring: Ring, record: Any, reward: torch.Tensor,
              discount: torch.Tensor, n: int) -> tuple[Ring, Transition]:
    """Push step ``t``'s record; emit the transition for step ``t-n`` if warm.

    After the push the ring holds steps ``t-n .. t``; the oldest slot (the
    next write position) is step ``t-n`` and the slot just written is step
    ``t``. Returns a new ring; the old one is left as it was.
    """
    cap = n + 1
    slot = ring.ptr % cap

    def put(buf, x):
        out = buf.clone()
        out[:, slot] = x
        return out

    new_ring = Ring(tree_map(put, ring.record, record), put(ring.reward, reward),
                    put(ring.discount, discount), (ring.ptr + 1) % cap, ring.count + 1)
    oldest = new_ring.ptr % cap  # slot of step t-n
    returns = torch.zeros(reward.shape, dtype=torch.float32, device=reward.device)
    disc = torch.ones(reward.shape, dtype=torch.float32, device=reward.device)
    for k in range(n):
        s = (oldest + k) % cap
        returns = returns + disc * new_ring.reward[:, s]
        disc = disc * new_ring.discount[:, s]
    first = tree_map(lambda buf: buf[:, oldest], new_ring.record)
    last = tree_map(lambda buf: buf[:, slot], new_ring.record)
    valid = torch.full(reward.shape, new_ring.count >= cap, dtype=torch.bool,
                       device=reward.device)
    return new_ring, Transition(first, last, returns, disc, valid)


def from_trajectory(reward: torch.Tensor, discount: torch.Tensor,
                    n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Bulk n-step returns over a rollout.

    Args:
      reward:   (lanes, T) with reward[t] = R_{t+1}.
      discount: (lanes, T) with discount[t] = gamma_{t+1} (0 at terminal).
      n:        bootstrap horizon.

    Returns:
      returns:    (lanes, T-n+1) with returns[t]  = sum_{k<n} R_{t+k+1} prod_{j<k} gamma
      discount_n: (lanes, T-n+1) with discount_n[t] = prod_{k<n} gamma_{t+k+1}
    """
    lanes, T = reward.shape
    if T < n:
        raise ValueError(f"trajectory length {T} < n-step horizon {n}")
    W = T - n + 1
    returns = torch.zeros((lanes, W), dtype=torch.float32, device=reward.device)
    disc = torch.ones((lanes, W), dtype=torch.float32, device=reward.device)
    for k in range(n):
        returns = returns + disc * reward[:, k:k + W]
        disc = disc * discount[:, k:k + W]
    return returns, disc
