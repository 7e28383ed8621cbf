"""Parity of the port's replay memory and fused ingest with the JAX package.

Storage, slot ids and cursors must agree exactly. Leaves come from ``pow``
(``to_leaf``), so they agree within ``LEAF_ULPS``; the tree must then be
exactly the sum tree of its own leaves (its internal nodes are the same
fp32 ``left + right`` as the reference's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import replay as jrep
from repro.core import sumtree as jst
from repro.kernels.replay_ingest.ref import replay_ingest_ref as jax_ingest_ref
from repro_torch.core import replay as trep
from repro_torch.core import sumtree as tst
from repro_torch.kernels.replay_ingest import ops as ingest_ops
from repro_torch.kernels.replay_ingest.ref import replay_ingest_ref

LEAF_ULPS = 2
OBS = 5


def _leaves_close(got: torch.Tensor, want) -> None:
    g = got.numpy().view(np.int32).astype(np.int64)
    w = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    assert np.abs(g - w).max(initial=0) <= LEAF_ULPS


def _tree_consistent(tree: torch.Tensor) -> None:
    """The tree is exactly the reference's sum tree of its own leaves."""
    np.testing.assert_array_equal(
        tree.numpy().view(np.uint32),
        np.asarray(jst.rebuild(jnp.asarray(tst.leaves(tree).numpy()))).view(np.uint32))


def _items(rng, n):
    return {"obs": rng.integers(0, 256, (n, OBS), dtype=np.uint8),
            "action": rng.integers(0, 4, n).astype(np.int32),
            "returns": rng.standard_normal(n).astype(np.float32),
            "discount_n": rng.random(n).astype(np.float32),
            "next_obs": rng.integers(0, 256, (n, OBS), dtype=np.uint8)}


def _to_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _state_close(got: trep.ReplayState, want: jrep.ReplayState) -> None:
    for k, buf in got.storage.items():
        np.testing.assert_array_equal(buf.numpy(), np.asarray(want.storage[k]), err_msg=k)
    _leaves_close(tst.leaves(got.tree), jst.leaves(want.tree))
    _tree_consistent(got.tree)
    assert (got.write_pos, got.size, got.total_added) == (
        int(want.write_pos), int(want.size), int(want.total_added))


def _ingest_case(seed, cap, B, idx, applied):
    rng = np.random.default_rng(seed)
    leaves = (rng.random(cap) + 0.01).astype(np.float32)
    leaves[rng.random(cap) < 0.2] = 0
    tree = np.asarray(jst.rebuild(jnp.asarray(leaves)))
    storage, items = _items(rng, cap), _items(rng, B)
    prio = (rng.standard_normal(B) * 2).astype(np.float32)
    prio[:2] = [0.0, 1e-7]
    return tree, storage, items, prio, np.asarray(idx, np.int32), np.asarray(applied, bool)


def _check_ingest(tree, storage, items, prio, idx, applied):
    """Plain ingest, its wrapper, and the unfused chain against the JAX
    package's three-dispatch ingest and its unfused chain (xla backend)."""
    cap = tree.shape[0] // 2
    want_tree, want_storage = jax_ingest_ref(
        jnp.asarray(tree), {k: jnp.asarray(v) for k, v in storage.items()},
        jnp.asarray(idx), jnp.asarray(prio), jnp.asarray(applied),
        {k: jnp.asarray(v) for k, v in items.items()})
    jst.set_backend("xla")
    try:
        cfg = jrep.ReplayConfig(capacity=cap)
        jstate = jrep.ReplayState({k: jnp.asarray(v) for k, v in storage.items()},
                                  jnp.asarray(tree), 0, 0, 0)
        unf_storage, unf_tree = jrep.ingest_unfused(
            cfg, jstate, {k: jnp.asarray(v) for k, v in items.items()},
            jnp.asarray(prio), jnp.asarray(idx), jnp.asarray(applied))
    finally:
        jst.set_backend(None)
    for want_t, want_s in ((want_tree, want_storage), (unf_tree, unf_storage)):
        runs = {
            "ref": replay_ingest_ref(torch.from_numpy(tree.copy()), _to_torch(storage),
                                     torch.from_numpy(idx), torch.from_numpy(prio),
                                     torch.from_numpy(applied), _to_torch(items)),
            "wrapper": ingest_ops.replay_ingest(
                torch.from_numpy(tree.copy()), _to_torch(storage), torch.from_numpy(idx),
                torch.from_numpy(prio), torch.from_numpy(applied), _to_torch(items)),
        }
        tcfg = trep.ReplayConfig(capacity=cap)
        tstate = trep.ReplayState(_to_torch(storage), torch.from_numpy(tree.copy()), 0, 0, 0)
        s, t = trep.ingest_unfused(tcfg, tstate, _to_torch(items), torch.from_numpy(prio),
                                   torch.from_numpy(idx), torch.from_numpy(applied))
        runs["unfused"] = (t, s)
        for name, (got_tree, got_storage) in runs.items():
            for k in storage:
                np.testing.assert_array_equal(got_storage[k].numpy(), np.asarray(want_s[k]),
                                              err_msg=f"{name}: {k}")
            _leaves_close(tst.leaves(got_tree), jst.leaves(want_t))
            _tree_consistent(got_tree)


def test_ingest_duplicates_masked_winners_and_out_of_range():
    cap, B = 32, 24
    idx = [cap, 2 * cap, -cap - 1, -1, -cap, 7, 7, 7, 3, 3] + list(range(10, 24))
    applied = [True] * B
    applied[7] = False      # a masked lane wins slot 7 over two applied lanes
    applied[8] = False      # a masked lane shadowed by a later applied lane
    _check_ingest(*_ingest_case(0, cap, B, idx, applied))


@settings(max_examples=15, deadline=None, derandomize=True)
@given(idx=st.lists(st.integers(-40, 70), min_size=20, max_size=20),
       applied=st.lists(st.booleans(), min_size=20, max_size=20))
def test_ingest_property(idx, applied):
    _check_ingest(*_ingest_case(1, 32, 20, idx, applied))


def test_free_slot_idx_matches_jax():
    rng = np.random.default_rng(2)
    live = rng.random(64) < 0.8
    for batch in (3, 20):
        np.testing.assert_array_equal(
            trep.free_slot_idx(torch.from_numpy(live), batch).numpy(),
            np.asarray(jrep.free_slot_idx(jnp.asarray(live), batch)))


def test_replay_script_matches_jax():
    """add_fifo (with a valid mask) / sample / set_priorities / wrap-around /
    evict_fifo / add_alloc / evict_prioritized, state compared after each."""
    rng = np.random.default_rng(3)
    cap = 64
    jcfg = jrep.ReplayConfig(capacity=cap, soft_capacity=40, min_fill=8)
    tcfg = trep.ReplayConfig(capacity=cap, soft_capacity=40, min_fill=8)
    example = {k: v[0] for k, v in _items(rng, 1).items()}
    js = jrep.init(jcfg, {k: jnp.asarray(v) for k, v in example.items()})
    ts = trep.init(tcfg, _to_torch(example))
    assert not trep.can_sample(tcfg, ts) and not bool(jrep.can_sample(jcfg, js))

    def both_add(add_j, add_t, n, valid=None):
        nonlocal js, ts
        items, prio = _items(rng, n), (rng.standard_normal(n) * 2).astype(np.float32)
        js = add_j(jcfg, js, {k: jnp.asarray(v) for k, v in items.items()},
                   jnp.asarray(prio), None if valid is None else jnp.asarray(valid))
        ts = add_t(tcfg, ts, _to_torch(items), torch.from_numpy(prio),
                   None if valid is None else torch.from_numpy(valid))
        _state_close(ts, js)

    both_add(jrep.add_fifo, trep.add_fifo, 24)
    both_add(jrep.add_fifo, trep.add_fifo, 30, rng.random(30) < 0.8)
    assert trep.can_sample(tcfg, ts) and bool(jrep.can_sample(jcfg, js))

    key = jax.random.key(5)
    jb = jrep.sample(jcfg, js, key, 16)
    jitter = torch.from_numpy(np.array(jax.random.uniform(key, (16,))))
    tb = trep.sample(tcfg, ts, None, 16, jitter)
    np.testing.assert_array_equal(tb.indices.numpy(), np.asarray(jb.indices))
    for k in tb.items:
        np.testing.assert_array_equal(tb.items[k].numpy(), np.asarray(jb.items[k]))
    np.testing.assert_allclose(tb.is_weights.numpy(), np.asarray(jb.is_weights), rtol=1e-5)
    assert tb.size == int(jb.size)

    new = (rng.standard_normal(16) * 3).astype(np.float32)
    js = jrep.set_priorities(jcfg, js, jb.indices, jnp.asarray(new))
    ts = trep.set_priorities(tcfg, ts, tb.indices, torch.from_numpy(new))
    _state_close(ts, js)

    both_add(jrep.add_fifo, trep.add_fifo, 20)          # wraps past slot 63
    js, ts = jrep.evict_fifo(jcfg, js), trep.evict_fifo(tcfg, ts)
    _state_close(ts, js)
    assert ts.size == 40
    both_add(jrep.add_alloc, trep.add_alloc, 30)        # 24 free slots: 6 dropped

    key = jax.random.key(6)
    js = jrep.evict_prioritized(jcfg, js, key, 8)
    ts = trep.evict_prioritized(tcfg, ts, None, 8,
                                torch.from_numpy(np.array(jax.random.uniform(key, (8,)))))
    _state_close(ts, js)


@pytest.mark.parametrize("n", [0, 10])
def test_set_priorities_keeps_dead_slots_dead(n):
    cap = 16
    tcfg = trep.ReplayConfig(capacity=cap, min_fill=1)
    ts = trep.init(tcfg, {"x": torch.zeros((), dtype=torch.float32)})
    ts = trep.add_fifo(tcfg, ts, {"x": torch.arange(n, dtype=torch.float32)},
                       torch.ones(n))
    idx = torch.tensor([0, 5, 12, 15], dtype=torch.int32)
    ts = trep.set_priorities(tcfg, ts, idx, torch.full((4,), 2.0))
    live = tst.leaves(ts.tree) > 0
    assert int(live.sum()) == ts.size == n


def test_cpu_wrappers_take_the_plain_version_and_count_no_launch():
    from repro_torch import kernels
    from repro_torch.kernels.nstep_return.ops import nstep_return
    from repro_torch.kernels.sumtree_sample.ops import sumtree_sample_with_mass
    from repro_torch.kernels.sumtree_update.ops import sumtree_update

    kernels.reset_launch_counts()
    tree = tst.rebuild(torch.rand(16))
    sumtree_update(tree, torch.tensor([1, 3], dtype=torch.int32), torch.ones(2))
    sumtree_sample_with_mass(tree, torch.tensor([0.5]))
    ingest_ops.replay_ingest(tree, {"x": torch.zeros(16)}, torch.tensor([2]),
                             torch.ones(1), torch.ones(1, dtype=torch.bool),
                             {"x": torch.ones(1)})
    nstep_return(torch.rand(2, 5), torch.rand(2, 5), 3)
    assert kernels.launch_counts() == {name: 0 for name in kernels.OPS}
