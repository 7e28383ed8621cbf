"""The port's slice as a whole against the JAX package, and its entry points.

A tiny configuration runs the JAX ``train_iteration`` and the port's side by
side from one state (``init_state_from_jax``). Acting is deterministic
(``eps_base=0``, ``slip_prob=0``) and the learner's stratified jitter is the
JAX draw, handed in. Cursors, stored obs and actions must agree exactly;
float state within ``RTOL``/``ATOL`` (fp32 drift through several learner
steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apex as japex
from repro.optim import optimizers as joptim
from repro_torch.core import apex as tapex
from repro_torch.core import init_state_from_jax, params_from_jax
from repro_torch.core import sumtree as tst
from repro_torch.launch import profile as tprofile
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizers as toptim
from test_torch_phases import close, make_pair

RTOL, ATOL = 1e-4, 1e-5


def jax_learner_jitter(cfg, rng):
    """The stratified jitters the JAX learner phase of this iteration draws,
    given the state's key before the iteration."""
    rng, _, _ = jax.random.split(rng, 3)                 # the act phase's split
    _, sub = jax.random.split(rng)
    return [torch.from_numpy(np.array(jax.random.uniform(jax.random.split(k)[0],
                                                         (cfg.batch_size,))))
            for k in jax.random.split(sub, cfg.learner_steps_per_iter)]


def test_train_iterations_match_jax():
    (jcfg, jenv, jagent), (tcfg, tenv, tagent) = make_pair(
        slip=0.0, eps_base=0.0, learner_steps_per_iter=2)
    jopt, topt = joptim.centered_rmsprop(1e-3), toptim.centered_rmsprop(1e-3)
    jinit, jstep = japex.make_train_fn(jcfg, jenv, jagent, jopt)
    js = jinit(jax.random.key(0))
    ts = init_state_from_jax(js, device="cpu")
    learned = 0
    for it in range(7):
        jitter = jax_learner_jitter(jcfg, js.rng)
        js, jm = jstep(js)
        ts, tm = tapex.train_iteration(tcfg, tenv, tagent, topt, ts, jitter=jitter)
        rep, jrep_ = ts.replay, js.replay
        assert (ts.iteration, ts.learner_step, ts.frames) == (
            int(js.iteration), int(js.learner_step), int(js.frames))
        assert (rep.write_pos, rep.size, rep.total_added) == (
            int(jrep_.write_pos), int(jrep_.size), int(jrep_.total_added))
        for k in ("obs", "next_obs", "action"):
            np.testing.assert_array_equal(rep.storage[k].numpy(), np.asarray(jrep_.storage[k]))
        close(rep.storage["returns"], jrep_.storage["returns"], rtol=0, atol=1e-6)
        close(tst.leaves(rep.tree), jrep_.tree[128:], rtol=RTOL, atol=1e-7)
        np.testing.assert_array_equal(ts.env_state.pos.numpy(), np.asarray(js.env_state.pos))
        close(ts.params, js.params, RTOL, ATOL)
        close(ts.target_params, js.target_params, RTOL, ATOL)
        assert tm["updated"] == float(jm["updated"])
        for k in ("loss", "mean_q", "mean_abs_td", "mean_initial_priority"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL, atol=1e-7)
        assert tm["replay_size"] == float(jm["replay_size"])
        learned += int(tm["updated"])
    # the run reached the learner, FIFO wrap-around and an eviction
    assert learned == 6 and ts.replay.total_added > 128 and ts.replay.size == 112


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, _, _), (tcfg, tenv, tagent) = make_pair()
    opt = toptim.centered_rmsprop()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapex.make_train_fn(tcfg, tenv, tagent, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--iterations", "1"])
    with pytest.raises(NotImplementedError):
        tapex.make_train_fn(tcfg, tenv, tagent, opt, mesh=object(), device="cpu")


def test_train_cli_runs_reduced_preset_on_cpu(capsys):
    ttrain.main(["--device", "cpu", "--iterations", "3", "--log-every", "1"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 3
    assert '"iter": 3' in lines[-1] and '"learner_step": 6' in lines[-1]


def test_phase_spans_split_the_traced_iteration():
    _, (tcfg, tenv, tagent) = make_pair(learner_steps_per_iter=2)
    init_fn, step_fn = tapex.make_train_fn(tcfg, tenv, tagent, toptim.centered_rmsprop(),
                                           device="cpu")
    state = init_fn(0)
    for _ in range(2):                                  # 2 x 24 transitions: min-fill
        state, _ = step_fn(state)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            state, m = step_fn(state)
    assert m["updated"] == 1.0
    phases = tprofile.phase_breakdown(prof, 3)
    assert {k: p["calls"] for k, p in phases.items()} == {
        "apex/act": 1, "apex/add": 1, "apex/sample": 2, "apex/learn": 2,
        "apex/writeback": 2}
    assert all(p["host_ms"] > 0 and p["device_ms"] == 0 for p in phases.values())


def test_init_state_from_jax_keeps_the_replay_and_params():
    (jcfg, jenv, jagent), _ = make_pair()
    js = japex.init_state(jcfg, jenv, jagent, joptim.centered_rmsprop(),
                          jax.random.key(1))
    ts = init_state_from_jax(js, device="cpu")
    close(ts.params, js.params, 0, 0)
    close(ts.opt_state, js.opt_state, 0, 0)
    assert ts.replay.tree.shape == (256,) and ts.replay.size == 0
    assert ts.replay.storage["obs"].dtype == torch.uint8
    assert ts.obs.shape == tuple(jnp.shape(js.obs))
