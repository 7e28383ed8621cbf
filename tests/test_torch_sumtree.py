"""Parity of the port's sum tree, priority and IS math with the JAX package.

The same numpy inputs go through the JAX function, its interpret-mode Pallas
kernel where there is one, and the port. Trees must agree bit for bit
(every internal node is the same fp32 ``left + right``); sampled ids and
masses exactly; ``pow`` results within a stated ulp or relative bound.
"""

import jax.numpy as jnp
import jax.random
import numpy as np
import pytest
import torch

from repro.core import priority as jprio
from repro.core import sampling as jsamp
from repro.core import sumtree as jst
from repro.kernels.sumtree_sample.kernel import sumtree_sample_pallas
from repro.kernels.sumtree_update.kernel import sumtree_update_pallas
from repro_torch.core import priority as tprio
from repro_torch.core import sampling as tsamp
from repro_torch.core import sumtree as tst
from repro_torch.kernels.sumtree_sample import ops as sample_ops
from repro_torch.kernels.sumtree_update import ops as update_ops

# pow/exp results (to_leaf, IS weights, the eps ladder): the port's and
# XLA's CPU pow may round differently by an ulp or two.
POW_RTOL = 1e-6


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _random_tree(rng, cap, zero_frac=0.2) -> np.ndarray:
    leaves = rng.random(cap).astype(np.float32) + np.float32(1e-3)
    leaves[rng.random(cap) < zero_frac] = 0
    return np.array(jst.rebuild(jnp.asarray(leaves)))


def _update_inputs(seed, cap, B):
    rng = np.random.default_rng(seed)
    tree = _random_tree(rng, cap)
    idx = rng.integers(-cap - 3, 2 * cap + 3, B).astype(np.int32)
    specials = np.array([cap, 2 * cap, -cap, -1, -cap - 1, 0], np.int32)
    idx[:min(B, 6)] = specials[:min(B, 6)]
    if B > 9:
        idx[7:10] = idx[6]                                   # duplicate writers
    return tree, idx, rng.random(B).astype(np.float32)


@pytest.mark.parametrize("cap,B,seed", [(2, 5, 0), (64, 40, 1), (128, 300, 2)])
def test_update_bitwise_vs_jax_and_pallas(cap, B, seed):
    tree, idx, vals = _update_inputs(seed, cap, B)
    want = jst.update(jnp.asarray(tree), jnp.asarray(idx), jnp.asarray(vals))
    pallas = sumtree_update_pallas(jnp.asarray(tree), jnp.asarray(idx),
                                   jnp.asarray(vals), interpret=True)
    got = tst.update(torch.from_numpy(tree.copy()), torch.from_numpy(idx),
                     torch.from_numpy(vals))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(pallas))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_write_and_wrapper_match_update_on_cpu(backend):
    tree, idx, vals = _update_inputs(3, 64, 50)
    want = tst.update(torch.from_numpy(tree.copy()), torch.from_numpy(idx),
                      torch.from_numpy(vals))
    tst.set_backend(backend)
    try:
        got = tst.write(torch.from_numpy(tree.copy()), torch.from_numpy(idx),
                        torch.from_numpy(vals))
    finally:
        tst.set_backend(None)
    wrapped = update_ops.sumtree_update(torch.from_numpy(tree.copy()),
                                        torch.from_numpy(idx), torch.from_numpy(vals))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(wrapped), _bits(want))


def test_update_is_in_place():
    tree, idx, vals = _update_inputs(4, 32, 10)
    t = torch.from_numpy(tree.copy())
    out = tst.update(t, torch.from_numpy(idx), torch.from_numpy(vals))
    assert out.data_ptr() == t.data_ptr()


def test_rebuild_and_write_rebuild_bitwise():
    tree, idx, vals = _update_inputs(5, 64, 70)
    leaves = tree[64:]
    np.testing.assert_array_equal(_bits(tst.rebuild(torch.from_numpy(leaves.copy()))),
                                  _bits(jst.rebuild(jnp.asarray(leaves))))
    want = jst.write_rebuild(jnp.asarray(tree), jnp.asarray(idx), jnp.asarray(vals))
    got = tst.write_rebuild(torch.from_numpy(tree.copy()), torch.from_numpy(idx),
                            torch.from_numpy(vals))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("cap,B,seed", [(64, 100, 0), (256, 64, 1)])
def test_sample_with_mass_exact_vs_jax_and_pallas(cap, B, seed):
    rng = np.random.default_rng(seed)
    tree = _random_tree(rng, cap, zero_frac=0.3)
    total = tree[1]
    prefix = np.cumsum(tree[cap:], dtype=np.float32)
    u = (rng.random(B) * total).astype(np.float32)
    u[:8] = np.concatenate([prefix[:5], [0.0, total * np.float32(1 - 1e-6), total]])
    want_idx, want_mass = jst.sample_two_gather(jnp.asarray(tree), jnp.asarray(u))
    p_idx, p_mass = sumtree_sample_pallas(jnp.asarray(tree), jnp.asarray(u),
                                          interpret=True)
    for fn in (tst.sample_with_mass, sample_ops.sumtree_sample_with_mass,
               tst.sample_two_gather):
        idx, mass = fn(torch.from_numpy(tree), torch.from_numpy(u))
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(p_idx))
        np.testing.assert_array_equal(_bits(mass), _bits(want_mass))
        np.testing.assert_array_equal(_bits(mass), _bits(p_mass))


def test_stratified_uniforms_with_injected_jitter():
    rng = np.random.default_rng(6)
    tree = _random_tree(rng, 128)
    key = jax.random.key(3)
    want = jst.stratified_uniforms(key, 32, jnp.asarray(tree)[1])
    jitter = np.asarray(jax.random.uniform(key, (32,)))
    t = torch.from_numpy(tree)
    got = tst.stratified_uniforms(None, 32, tst.total(t), torch.from_numpy(jitter))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    want_ids = jst.sample_stratified(jnp.asarray(tree), key, 32)
    got_ids = tst.sample_stratified(t, None, 32, torch.from_numpy(jitter))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))


def test_set_backend_rejects_unknown_names():
    with pytest.raises(ValueError):
        tst.set_backend("pallas")
    assert tst.backend() == "cuda"


def test_priority_math_matches_jax():
    rng = np.random.default_rng(7)
    p = (rng.standard_normal(200) * 3).astype(np.float32)
    p[:3] = [0.0, 1e-6, -1e-4]
    np.testing.assert_allclose(tprio.to_leaf(torch.from_numpy(p)).numpy(),
                               np.asarray(jprio.to_leaf(jnp.asarray(p))), rtol=POW_RTOL)
    for n in (1, 5, 360):
        np.testing.assert_allclose(tprio.epsilon_ladder(n).numpy(),
                                   np.asarray(jprio.epsilon_ladder(n)), rtol=POW_RTOL)
    np.testing.assert_array_equal(tprio.fixed_epsilon_set(9).numpy(),
                                  np.asarray(jprio.fixed_epsilon_set(9)))
    q, r, d, b = (rng.standard_normal(16).astype(np.float32) for _ in range(4))
    np.testing.assert_allclose(
        tprio.td_error_nstep(*map(torch.from_numpy, (q, r, d, b))).numpy(),
        np.asarray(jprio.td_error_nstep(*map(jnp.asarray, (q, r, d, b)))), rtol=1e-6)


def test_importance_weights_match_jax():
    rng = np.random.default_rng(8)
    leaf = (rng.random(64) + 0.01).astype(np.float32)
    total = np.float32(leaf.sum() * 3)
    want = jprio.importance_weights(jnp.asarray(leaf), jnp.asarray(total),
                                    jnp.asarray(1000, jnp.int32), 0.4)
    got = tprio.importance_weights(torch.from_numpy(leaf), torch.tensor(total), 1000, 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=POW_RTOL)
    leaf2 = (rng.random((3, 16)) + 0.01).astype(np.float32)
    totals = (leaf2.sum(1) * 2).astype(np.float32)
    sizes = np.array([100, 50, 7], np.int32)
    want = jsamp.merged_is_weights(jnp.asarray(leaf2), jnp.asarray(totals),
                                   jnp.asarray(sizes), 0.4)
    got = tsamp.merged_is_weights(torch.from_numpy(leaf2), torch.from_numpy(totals),
                                  torch.from_numpy(sizes), 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=POW_RTOL)
    batch = tsamp.LearnerBatch(torch.arange(3), {}, torch.ones(3))
    assert batch._fields == jsamp.LearnerBatch._fields
