"""The Ape-X loop on one device: lockstep actor/learner alternation.

Paper architecture (Fig. 1): many actors feed a shared prioritized replay; a
single learner samples, updates, and writes back priorities; actors refresh
parameters periodically. Here, on one card:

* Actor lanes — a vector of environments steps at once, each lane with its
  own ε from the ladder; the lane vector plays the role of the paper's N
  actors.
* Staleness — actors act with a parameter copy refreshed every
  ``param_sync_period`` iterations, making the off-policy gap explicit.
* Alternation — acting and learning run bulk-synchronously;
  ``learner_steps_per_iter`` and ``rollout_len`` set the generate : consume
  ratio.

The phase bodies live in ``repro_torch.runtime.phases``. The JAX package's
``lax.cond`` branches (min-fill gate, eviction interval, target and actor
param sync) are host-side branches here. Device-to-host syncs per learner
step: one, the root-mass read of ``replay.can_sample`` (none before
min-fill is reached). The iteration, step and frame counters and the
replay's cursors are host integers. The multi-shard mesh path waits for a
later slice of the port.

Each phase runs inside a ``torch.profiler.record_function`` span named in
``PHASE_SPANS``, so a trace of ``train_iteration`` splits its host and
device time by phase (``repro_torch.launch.profile``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import torch
from torch.profiler import record_function

from repro_torch.core import device as device_lib
from repro_torch.core import priority as prio, replay as replay_lib
from repro_torch.core.tree import tree_map
from repro_torch.envs.synthetic import batch_reset
from repro_torch.runtime import phases


@dataclasses.dataclass(frozen=True)
class ApexConfig:
    replay: replay_lib.ReplayConfig
    lanes_per_shard: int = 32          # vectorized envs per shard
    num_shards: int = 1                # data-axis size (for the global ladder)
    rollout_len: int = 16              # T env steps per actor phase
    n_step: int = 3                    # paper: n = 3
    batch_size: int = 64               # learner batch per shard
    learner_steps_per_iter: int = 1
    param_sync_period: int = 1         # iterations between actor param refresh
    target_update_period: int = 100    # learner steps (paper Atari: 2500)
    evict_interval: int = 100          # learner steps between evictions (paper: 100)
    evict_num: int = 0                 # victims per prioritized eviction (DPG mode)
    eviction: str = "fifo"             # "fifo" | "prioritized"
    eps_base: float = prio.EPSILON_BASE
    eps_alpha: float = prio.EPSILON_ALPHA

    @property
    def num_actors(self) -> int:
        return self.lanes_per_shard * self.num_shards

    @property
    def window(self) -> int:
        return self.rollout_len - self.n_step + 1


class ApexState(NamedTuple):
    params: Any
    target_params: Any
    opt_state: Any
    actor_params: Any          # the stale copy actors act with
    iteration: int
    learner_step: int
    replay: replay_lib.ReplayState
    env_state: Any             # (lanes, ...)
    obs: torch.Tensor          # (lanes, ...)
    ep_return: torch.Tensor    # (lanes,) running episode return
    rng: torch.Generator       # every draw of the loop comes from here
    frames: int                # env steps


METRIC_KEYS = ("loss", "mean_q", "mean_abs_td")
PHASE_SPANS = ("apex/act", "apex/add", "apex/sample", "apex/learn", "apex/writeback")


def init_state(cfg: ApexConfig, env, agent, optimizer, seed: int = 0,
               device="cuda") -> ApexState:
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    env_state, obs = batch_reset(env, cfg.lanes_per_shard, dev)
    params = agent.init(gen, obs[:1], dev)
    return ApexState(
        params=params,
        target_params=tree_map(torch.clone, params),
        opt_state=optimizer.init(params),
        actor_params=tree_map(torch.clone, params),
        iteration=0, learner_step=0,
        replay=replay_lib.init(cfg.replay, phases.item_example(env, obs), dev),
        env_state=env_state, obs=obs,
        ep_return=torch.zeros((cfg.lanes_per_shard,), dtype=torch.float32, device=dev),
        rng=gen, frames=0)


def actor_phase(cfg: ApexConfig, env, agent, state: ApexState, shard_id: int = 0,
                draws: phases.ActDraws | None = None) -> tuple[ApexState, dict]:
    """Roll out, build n-step transitions and initial priorities, add them
    to the replay (Alg. 1, vectorized)."""
    aslice = phases.ActorSlice(env_state=state.env_state, obs=state.obs,
                               ep_return=state.ep_return, generator=state.rng,
                               frames=state.frames)
    with record_function("apex/act"):
        aslice, block, metrics = phases.act_phase(cfg, env, agent, state.actor_params,
                                                  aslice, shard_id, draws)
    with record_function("apex/add"):
        replay = phases.replay_add(cfg, state.replay, block)
    return state._replace(replay=replay, env_state=aslice.env_state, obs=aslice.obs,
                          ep_return=aslice.ep_return, frames=aslice.frames), metrics


def learner_phase(cfg: ApexConfig, agent, optimizer, state: ApexState,
                  jitter: Sequence[torch.Tensor] | None = None
                  ) -> tuple[ApexState, dict]:
    """Sample prioritized batches, apply the off-policy update, write back
    fresh priorities, periodically update the target net and evict (Alg. 2).
    ``jitter[i]`` replaces learner step i's stratified draw."""
    rcfg = cfg.replay
    dev = state.obs.device
    zero = {k: torch.zeros((), dtype=torch.float32, device=dev) for k in METRIC_KEYS}
    metrics = {**zero, "updated": 0.0}
    for i in range(cfg.learner_steps_per_iter):
        if not replay_lib.can_sample(rcfg, state.replay):   # sync: root mass
            metrics = {**zero, "updated": 0.0}
            continue
        with record_function("apex/sample"):
            batch = replay_lib.sample(rcfg, state.replay, state.rng, cfg.batch_size,
                                      None if jitter is None else jitter[i])
        lslice = phases.LearnerSlice(params=state.params,
                                     target_params=state.target_params,
                                     opt_state=state.opt_state,
                                     learner_step=state.learner_step)
        with record_function("apex/learn"):
            lslice, new_prios, step_metrics = phases.learn_phase(
                cfg, agent, optimizer, lslice, batch.items, batch.is_weights)
        with record_function("apex/writeback"):
            rep = phases.priority_writeback(cfg, state.replay, batch.indices, new_prios,
                                            lslice.learner_step, state.rng)
        state = state._replace(params=lslice.params, opt_state=lslice.opt_state,
                               target_params=lslice.target_params, replay=rep,
                               learner_step=lslice.learner_step)
        metrics = {**step_metrics, "updated": 1.0}
    return state, metrics


def train_iteration(cfg: ApexConfig, env, agent, optimizer, state: ApexState,
                    shard_id: int = 0, act_draws: phases.ActDraws | None = None,
                    jitter: Sequence[torch.Tensor] | None = None
                    ) -> tuple[ApexState, dict]:
    """One lockstep iteration: actor param refresh (a host branch), act,
    add, then ``learner_steps_per_iter`` learner steps."""
    if state.iteration % cfg.param_sync_period == 0:
        # params are never mutated in place, so sharing them is a copy
        state = state._replace(actor_params=state.params)
    state, actor_metrics = actor_phase(cfg, env, agent, state, shard_id, act_draws)
    state, learner_metrics = learner_phase(cfg, agent, optimizer, state, jitter)
    state = state._replace(iteration=state.iteration + 1)
    return state, {**actor_metrics, **learner_metrics,
                   "replay_size": float(state.replay.size),
                   "frames": float(state.frames)}


def make_train_fn(cfg: ApexConfig, env, agent, optimizer, mesh=None,
                  device="cuda"):
    """Build ``(init_fn(seed), step_fn(state))`` for one device.

    Runs on the card unless ``device="cpu"`` is passed; with no card and no
    such request it raises. The mesh path is not ported yet.
    """
    if mesh is not None:
        raise NotImplementedError("the multi-shard mesh path is not ported yet")
    dev = device_lib.resolve(device)

    def init_fn(seed: int = 0) -> ApexState:
        return init_state(cfg, env, agent, optimizer, seed, dev)

    def step_fn(state: ApexState) -> tuple[ApexState, dict]:
        return train_iteration(cfg, env, agent, optimizer, state)

    return init_fn, step_fn
