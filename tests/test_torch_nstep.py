"""Parity of the port's n-step construction with the JAX package.

``from_trajectory`` and the n-step kernel's plain version against JAX
``nstep.from_trajectory`` and the interpret-mode Pallas kernel, within
``ATOL`` (a multiply-add may be fused on one side and not the other);
``ring_push`` step by step against JAX ``ring_push``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nstep as jnstep
from repro.kernels.nstep_return.kernel import nstep_return_pallas
from repro_torch.core import nstep as tnstep
from repro_torch.kernels.nstep_return import ops as nstep_ops

ATOL = 1e-6


def _trajectory(seed, lanes, T):
    rng = np.random.default_rng(seed)
    reward = rng.random((lanes, T)).astype(np.float32)
    discount = np.where(rng.random((lanes, T)) < 0.15, 0.0, 0.99).astype(np.float32)
    return reward, discount


@pytest.mark.parametrize("lanes,T,n", [(5, 3, 3), (7, 20, 3), (3, 9, 1), (9, 16, 5)])
def test_from_trajectory_and_kernel_ref_match_jax(lanes, T, n):
    reward, discount = _trajectory(lanes * T + n, lanes, T)
    want = jnstep.from_trajectory(jnp.asarray(reward), jnp.asarray(discount), n)
    pallas = nstep_return_pallas(jnp.asarray(reward), jnp.asarray(discount), n,
                                 interpret=True)
    r, d = torch.from_numpy(reward), torch.from_numpy(discount)
    for got in (tnstep.from_trajectory(r, d, n), nstep_ops.nstep_return(r, d, n)):
        for g, w, p in zip(got, want, pallas):
            assert g.shape == (lanes, T - n + 1)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=0, atol=ATOL)


def test_from_trajectory_rejects_short_rollouts():
    r = torch.zeros((2, 2))
    with pytest.raises(ValueError):
        tnstep.from_trajectory(r, r, 3)
    with pytest.raises(ValueError):
        nstep_ops.nstep_return(r, r, 3)


def test_ring_push_matches_jax():
    lanes, n, steps = 4, 3, 9
    rng = np.random.default_rng(1)
    example = {"obs": np.zeros((1, 2), np.float32), "action": np.zeros((1,), np.int32)}
    jring = jnstep.ring_init({k: jnp.asarray(v) for k, v in example.items()}, n, lanes)
    tring = tnstep.ring_init({k: torch.from_numpy(v) for k, v in example.items()}, n, lanes)
    for t in range(steps):
        rec = {"obs": rng.standard_normal((lanes, 2)).astype(np.float32),
               "action": rng.integers(0, 4, lanes).astype(np.int32)}
        reward = rng.random(lanes).astype(np.float32)
        discount = np.where(rng.random(lanes) < 0.2, 0.0, 0.99).astype(np.float32)
        jring, jtr = jnstep.ring_push(jring, {k: jnp.asarray(v) for k, v in rec.items()},
                                      jnp.asarray(reward), jnp.asarray(discount), n)
        tring, ttr = tnstep.ring_push(tring, {k: torch.from_numpy(v) for k, v in rec.items()},
                                      torch.from_numpy(reward), torch.from_numpy(discount), n)
        assert (tring.ptr, tring.count) == (int(jring.ptr), int(jring.count))
        np.testing.assert_array_equal(ttr.valid.numpy(), np.asarray(jtr.valid))
        np.testing.assert_allclose(ttr.returns.numpy(), np.asarray(jtr.returns), atol=ATOL)
        np.testing.assert_allclose(ttr.discount_n.numpy(), np.asarray(jtr.discount_n),
                                   atol=ATOL)
        for part in ("first", "last"):
            for k in rec:
                np.testing.assert_array_equal(getattr(ttr, part)[k].numpy(),
                                              np.asarray(getattr(jtr, part)[k]))
