"""Parity of the port's learner and actor math and its phases with the JAX
package, under injected draws and after ``params_from_jax``.

Network outputs, losses, priorities and updated parameters agree within
``RTOL``/``ATOL`` (fp32; the two frameworks sum matrix products in other
orders). Integer outputs — actions, env positions, stored obs — exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import actor as jactor
from repro.core import apex as japex
from repro.core import replay as jrep
from repro.core.agents import DQNAgent as JAgent
from repro.envs.synthetic import ChainWorld as JChain, batch_reset as jreset
from repro.models.qnetworks import DuelingDQN as JNet
from repro.optim import optimizers as joptim
from repro.runtime import phases as jphases
from repro_torch.core import actor as tactor
from repro_torch.core import apex as tapex
from repro_torch.core import params_from_jax
from repro_torch.core import replay as trep
from repro_torch.core import sumtree as tst
from repro_torch.core.agents import DQNAgent as TAgent
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.envs.synthetic import ChainState, ChainWorld as TChain
from repro_torch.models.qnetworks import DuelingDQN as TNet
from repro_torch.optim import optimizers as toptim
from repro_torch.runtime import phases as tphases

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _full_fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rtol=RTOL, atol=ATOL):
    """Leafwise allclose of a port tree against a JAX tree, matched by key."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            close(got[k], want[k], rtol, atol)
    elif isinstance(want, tuple):
        for g, w in zip(got, want, strict=True):
            close(g, w, rtol, atol)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def make_pair(slip=0.05, eps_base=0.4, **kw):
    """The same tiny Ape-X DQN configuration on both sides."""
    common = dict(lanes_per_shard=4, num_shards=1, rollout_len=8, n_step=3,
                  batch_size=16, learner_steps_per_iter=1, param_sync_period=2,
                  target_update_period=3, evict_interval=4, eps_base=eps_base,
                  eps_alpha=7.0)
    common.update(kw)
    net = dict(num_actions=4, mlp_hidden=(16,), head_hidden=16)
    jside = (japex.ApexConfig(replay=jrep.ReplayConfig(capacity=128, min_fill=32), **common),
             JChain(length=6, max_steps=16, slip_prob=slip), JAgent(net=JNet(**net)))
    tside = (tapex.ApexConfig(replay=trep.ReplayConfig(capacity=128, min_fill=32), **common),
             TChain(length=6, max_steps=16, slip_prob=slip), TAgent(net=TNet(**net)))
    return jside, tside


def jax_act_draws(cfg, env, actor_rng, env_rngs) -> tphases.ActDraws:
    """The draws the JAX act phase makes from ``actor_rng`` (ε-greedy) and
    the lanes' env keys (slips), in the port's ``ActDraws`` layout."""
    _, rollout_rng, _ = jax.random.split(actor_rng, 3)
    lanes, A = cfg.lanes_per_shard, env.num_actions
    out = {f: [] for f in tphases.ActDraws._fields}
    for step_rng in jax.random.split(rollout_rng, cfg.rollout_len):
        explore_rng, action_rng = jax.random.split(step_rng)
        out["random_action"].append(jax.random.randint(action_rng, (lanes,), 0, A))
        out["explore_u"].append(jax.random.uniform(explore_rng, (lanes,)))
        keys = jax.vmap(lambda k: jax.random.split(k, 4))(env_rngs)
        out["slip_u"].append(jax.vmap(jax.random.uniform)(keys[:, 1]))
        out["slip_action"].append(
            jax.vmap(lambda k: jax.random.randint(k, (), 0, A))(keys[:, 2]))
        env_rngs = keys[:, 0]
    return tphases.ActDraws(**{f: t(jnp.stack(v)) for f, v in out.items()})


def random_items(rng, n, obs_len):
    return {"obs": rng.integers(0, 256, (n, obs_len), dtype=np.uint8),
            "action": rng.integers(0, 4, n).astype(np.int32),
            "returns": rng.standard_normal(n).astype(np.float32),
            "discount_n": rng.random(n).astype(np.float32),
            "next_obs": rng.integers(0, 256, (n, obs_len), dtype=np.uint8)}


# ---------------------------------------------------------------------------
# Networks and optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("torso,obs_shape,dtype", [
    ("mlp", (10,), np.uint8), ("nature_cnn", (36, 36, 3), np.float32)])
def test_dueling_dqn_matches_jax(torso, obs_shape, dtype):
    kw = dict(num_actions=5, torso=torso, mlp_hidden=(32, 16), head_hidden=24)
    rng = np.random.default_rng(0)
    obs = (rng.random((6,) + obs_shape) * 255).astype(dtype)
    jnet, tnet = JNet(**kw), TNet(**kw)
    params = jnet.init(jax.random.key(0), jnp.asarray(obs[:1]))
    own = tnet.init(torch.Generator().manual_seed(0), t(obs[:1]))
    assert jax.tree.map(np.shape, params) == tree_map(lambda x: tuple(x.shape), own)
    got = tnet.apply(params_from_jax(params, device="cpu"), t(obs))
    close(got, jnet.apply(params, jnp.asarray(obs)))


def _grad_tree(rng, like):
    return jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32), like)


@pytest.mark.parametrize("name", ["centered_rmsprop", "adam", "adamw"])
def test_optimizers_match_jax(name):
    rng = np.random.default_rng(1)
    params = {"a": {"w": jnp.asarray(rng.standard_normal((3, 4)), jnp.float32)},
              "b": jnp.asarray(rng.standard_normal(5), jnp.float32)}
    jopt, topt = getattr(joptim, name)(1e-2), getattr(toptim, name)(1e-2)
    jstate, tparams = jopt.init(params), params_from_jax(params, device="cpu")
    tstate = params_from_jax(jstate, device="cpu")
    assert type(tstate).__name__ == type(jstate).__name__
    for _ in range(3):
        grads = _grad_tree(rng, params)
        tgrads = params_from_jax(grads, device="cpu")
        grads, tgrads = joptim.clip_by_global_norm(grads, 2.0), toptim.clip_by_global_norm(tgrads, 2.0)
        close(tgrads, grads, rtol=1e-6, atol=1e-7)
        ju, jstate = jopt.update(grads, jstate, params)
        tu, tstate = topt.update(tgrads, tstate, tparams)
        params, tparams = joptim.apply_updates(params, ju), toptim.apply_updates(tparams, tu)
        close(tparams, params, rtol=1e-5, atol=1e-7)
        close(tstate, jstate, rtol=1e-5, atol=1e-7)


def test_periodic_target_update_is_a_host_branch():
    p = {"w": torch.ones(3)}
    target = {"w": torch.zeros(3)}
    assert toptim.periodic_target_update(p, target, 4, 3) is target
    synced = toptim.periodic_target_update(p, target, 6, 3)
    assert torch.equal(synced["w"], p["w"]) and synced["w"] is not p["w"]


def test_actor_math_matches_jax_under_injected_draws():
    rng = np.random.default_rng(2)
    key = jax.random.key(9)
    mean = np.tanh(rng.standard_normal((6, 2))).astype(np.float32)
    noise = np.array(jax.random.normal(key, (6, 2), jnp.float32))
    close(tactor.gaussian_action(None, t(mean), 0.3, noise=t(noise)),
          jactor.gaussian_action(key, jnp.asarray(mean), 0.3), rtol=1e-6, atol=1e-7)
    q_first, q_last = (rng.standard_normal((8, 4)).astype(np.float32) for _ in range(2))
    action = rng.integers(0, 4, 8).astype(np.int32)
    ret, disc = rng.standard_normal(8).astype(np.float32), rng.random(8).astype(np.float32)
    close(tactor.initial_priorities_dqn(t(q_first), t(action), t(ret), t(disc), t(q_last)),
          jactor.initial_priorities_dqn(*map(jnp.asarray, (q_first, action, ret, disc, q_last))),
          rtol=1e-6, atol=1e-7)
    close(tactor.initial_priorities_dpg(t(q_first[:, 0]), t(ret), t(disc), t(q_last[:, 0])),
          jactor.initial_priorities_dpg(*map(jnp.asarray, (q_first[:, 0], ret, disc,
                                                           q_last[:, 0]))),
          rtol=1e-6, atol=1e-7)
    q = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 1.0, 2.0]], np.float32)   # ties
    eps = np.array([0.0, 0.0], np.float32)
    got = tactor.egreedy_action(None, t(q), t(eps), torch.ones(2), torch.zeros(2))
    want = jactor.egreedy_action(key, jnp.asarray(q), jnp.asarray(eps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))   # first maximum


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def test_act_phase_matches_jax_under_injected_draws():
    (jcfg, jenv, jagent), (tcfg, tenv, tagent) = make_pair(rollout_len=20)
    env_state, obs = jreset(jenv, jax.random.key(0), jcfg.lanes_per_shard)
    params = jagent.init(jax.random.key(1), obs[:1])
    aslice = jphases.ActorSlice(env_state, obs, jnp.zeros(4, jnp.float32),
                                jax.random.key(2), jnp.zeros((), jnp.int32))
    j_slice, j_block, j_m = jphases.act_phase(jcfg, jenv, jagent, params, aslice, 0)

    draws = jax_act_draws(jcfg, jenv, aslice.rng, env_state.rng)
    tslice = tphases.ActorSlice(ChainState(t(env_state.pos), t(env_state.t)), t(obs),
                                torch.zeros(4), None, 0)
    t_slice, t_block, t_m = tphases.act_phase(
        tcfg, tenv, tagent, params_from_jax(params, device="cpu"), tslice, 0, draws)

    for k in ("obs", "next_obs", "action"):
        np.testing.assert_array_equal(t_block.items[k].numpy(), np.asarray(j_block.items[k]))
    for k in ("returns", "discount_n"):
        np.testing.assert_allclose(t_block.items[k].numpy(), np.asarray(j_block.items[k]),
                                   rtol=0, atol=1e-6)
    close(t_block.priorities, j_block.priorities)
    np.testing.assert_array_equal(t_slice.env_state.pos.numpy(), np.asarray(j_slice.env_state.pos))
    np.testing.assert_array_equal(t_slice.env_state.t.numpy(), np.asarray(j_slice.env_state.t))
    np.testing.assert_array_equal(t_slice.obs.numpy(), np.asarray(j_slice.obs))
    close(t_slice.ep_return, j_slice.ep_return, atol=1e-6)
    assert t_slice.frames == int(j_slice.frames)
    assert int(t_m["episodes"]) == int(j_m["episodes"]) > 0
    np.testing.assert_allclose(float(t_m["mean_ep_return"]), float(j_m["mean_ep_return"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(t_m["mean_initial_priority"]),
                               float(j_m["mean_initial_priority"]), rtol=RTOL)


def test_learn_phase_matches_jax_through_target_sync():
    (jcfg, _, jagent), (tcfg, _, tagent) = make_pair()
    rng = np.random.default_rng(3)
    params = jagent.init(jax.random.key(4), jnp.zeros((1, 8), jnp.uint8))
    target = jax.tree.map(lambda x: x * 0.9, params)
    jopt, topt = joptim.centered_rmsprop(1e-3), toptim.centered_rmsprop(1e-3)
    jl = jphases.LearnerSlice(params, target, jopt.init(params), jnp.asarray(1, jnp.int32))
    tl = tphases.LearnerSlice(params_from_jax(params, device="cpu"),
                              params_from_jax(target, device="cpu"),
                              params_from_jax(jopt.init(params), device="cpu"), 1)
    for step in range(2):                       # steps 2 and 3; the target syncs at 3
        items = random_items(rng, 16, 8)
        w = (rng.random(16) * 0.9 + 0.1).astype(np.float32)
        jl, jp, jm = jphases.learn_phase(jcfg, jagent, jopt, jl,
                                         {k: jnp.asarray(v) for k, v in items.items()},
                                         jnp.asarray(w))
        tl, tp, tm = tphases.learn_phase(tcfg, tagent, topt, tl,
                                         {k: t(v) for k, v in items.items()}, t(w))
        assert tl.learner_step == int(jl.learner_step) == step + 2
        close(tp, jp)
        for k in ("loss", "mean_q", "mean_abs_td"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL, atol=1e-7)
        close(tl.params, jl.params)
        close(tl.opt_state, jl.opt_state, atol=1e-7)
        close(tl.target_params, jl.target_params)
    for a, b in zip(tree_leaves(tl.target_params), tree_leaves(tl.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("learner_step", [3, 4])
def test_priority_writeback_matches_jax(learner_step):
    (jcfg, _, _), (tcfg, _, _) = make_pair()
    rng = np.random.default_rng(5)
    items = random_items(rng, 120, 8)
    prio = rng.random(120).astype(np.float32)
    js = jrep.init(jcfg.replay, {k: jnp.asarray(v[0]) for k, v in items.items()})
    js = jrep.add_fifo(jcfg.replay, js, {k: jnp.asarray(v) for k, v in items.items()},
                       jnp.asarray(prio))
    ts = trep.ReplayState({k: t(v) for k, v in js.storage.items()}, t(js.tree),
                          int(js.write_pos), int(js.size), int(js.total_added))
    idx = rng.integers(0, 120, 16).astype(np.int32)
    new = (rng.standard_normal(16) * 2).astype(np.float32)
    js = jphases.priority_writeback(jcfg, js, jnp.asarray(idx), jnp.asarray(new),
                                    jnp.asarray(learner_step), jax.random.key(0))
    ts = tphases.priority_writeback(tcfg, ts, t(idx), t(new), learner_step)
    assert ts.size == int(js.size) == (112 if learner_step == 4 else 120)
    np.testing.assert_allclose(tst.leaves(ts.tree).numpy(), np.asarray(js.tree[128:]),
                               rtol=1e-6)
    np.testing.assert_array_equal(ts.tree.numpy(), tst.rebuild(tst.leaves(ts.tree)).numpy())


@pytest.mark.parametrize("shard_id", [0, 2])
def test_lane_epsilons_match_jax(shard_id):
    (jcfg, _, _), (tcfg, _, _) = make_pair(num_shards=3)
    close(tphases.lane_epsilons(tcfg, shard_id),
          jphases.lane_epsilons(jcfg, jnp.asarray(shard_id)), rtol=1e-6, atol=0)
