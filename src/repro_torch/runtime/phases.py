"""Per-phase functions of the Ape-X iteration, composed by ``core/apex.py``.

* ``act_phase``          — roll out T env steps per lane and emit a
                           ``TransitionBlock`` (items + actor-side initial
                           priorities). Touches no replay state.
* ``replay_add``         — insert a block into the replay (FIFO or
                           alloc-into-free-slots, per config).
* ``learn_phase``        — one prioritized update from an already-sampled
                           batch: loss/grads, optimizer step, periodic target
                           sync. Returns fresh priorities.
* ``priority_writeback`` — write learner priorities back into the replay
                           and run the periodic eviction policy.

The JAX package's ``lax.cond`` branches (eviction interval, target sync)
are host-side Python branches here, on host-integer step counts, so they
cost no device-to-host sync.

``cfg`` everywhere is an ``apex.ApexConfig`` (accessed structurally to
avoid an import cycle with ``repro_torch.core.apex``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import priority as prio, replay as replay_lib, sumtree
from repro_torch.core.nstep import from_trajectory
from repro_torch.envs.synthetic import batch_step
from repro_torch.optim import optimizers as optim


class ActorSlice(NamedTuple):
    """Per-actor mutable state."""
    env_state: Any
    obs: torch.Tensor           # (lanes, ...)
    ep_return: torch.Tensor     # (lanes,) running episode return
    generator: torch.Generator | None
    frames: int                 # env steps taken by this slice


class ActDraws(NamedTuple):
    """The random draws of one act phase, each ``(T, lanes)``: the ε-greedy
    coin and random action, and the env's slip coin and slip action. A
    test hands in the JAX package's draws; ``None`` draws from the
    generator."""
    explore_u: torch.Tensor
    random_action: torch.Tensor
    slip_u: torch.Tensor
    slip_action: torch.Tensor


class TransitionBlock(NamedTuple):
    """A flat block of n-step transitions plus actor-computed priorities."""
    items: dict                 # dict of (B, ...) tensors
    priorities: torch.Tensor    # (B,)


class LearnerSlice(NamedTuple):
    """Learner-owned state: online/target params, optimizer, step count."""
    params: Any
    target_params: Any
    opt_state: Any
    learner_step: int


def lane_epsilons(cfg, shard_id: int = 0, device=None) -> torch.Tensor:
    """This shard's slice of the global exploration ladder (paper §3)."""
    table = prio.epsilon_ladder(cfg.num_actors, cfg.eps_base, cfg.eps_alpha, device)
    start = shard_id * cfg.lanes_per_shard
    return table[start:start + cfg.lanes_per_shard]


def item_example(env, obs: torch.Tensor) -> dict:
    """Replay item layout: the paper stores both endpoint states per
    transition ("costs more RAM, but simplifies the code" — Appendix F)."""
    ob = obs[0]
    dev = obs.device
    return {"obs": ob,
            "action": torch.zeros((), dtype=torch.int32, device=dev),
            "returns": torch.zeros((), dtype=torch.float32, device=dev),
            "discount_n": torch.zeros((), dtype=torch.float32, device=dev),
            "next_obs": ob}


def nstep_fold(reward: torch.Tensor, discount: torch.Tensor, n: int):
    """The act phase's n-step fold through the backend's path: the Triton
    kernel's wrapper, or the plain ``from_trajectory``."""
    if sumtree.backend() == "torch":
        return from_trajectory(reward, discount, n)
    from repro_torch.kernels.nstep_return.ops import nstep_return
    return nstep_return(reward, discount, n)


# ---------------------------------------------------------------------------
# Act phase
# ---------------------------------------------------------------------------

@torch.no_grad()
def act_phase(cfg, env, agent, actor_params: Any, aslice: ActorSlice,
              shard_id: int = 0, draws: ActDraws | None = None,
              ) -> tuple[ActorSlice, TransitionBlock, dict]:
    """Roll out T steps per lane, build n-step transitions from the
    trajectory and compute initial priorities from the buffered Q-values
    (Alg. 1, vectorized). No sync: everything stays on the device."""
    dev = aslice.obs.device
    gen = aslice.generator
    eps = lane_epsilons(cfg, shard_id, dev)
    env_state, obs, ep_ret = aslice.env_state, aslice.obs, aslice.ep_return
    obs_t, act_t, q_t, rew_t, disc_t, done_ret = [], [], [], [], [], []
    for t in range(cfg.rollout_len):
        d = {} if draws is None else {f: x[t] for f, x in draws._asdict().items()}
        a, aux = agent.act(actor_params, gen, obs, eps, d.get("explore_u"),
                           d.get("random_action"))
        env_state, out = batch_step(env, env_state, a, gen, slip_u=d.get("slip_u"),
                                    slip_action=d.get("slip_action"))
        done = out.discount == 0.0
        done_ret.append(torch.where(done, ep_ret + out.reward, torch.nan))
        ep_ret = torch.where(done, 0.0, ep_ret + out.reward)
        obs_t.append(obs)
        act_t.append(a)
        q_t.append(aux["q"])
        rew_t.append(out.reward)
        disc_t.append(out.discount)
        obs = out.obs
    # Bootstrap Q at the final state S_T (one extra policy eval).
    _, last_aux = agent.act(actor_params, gen, obs, eps)

    n, W = cfg.n_step, cfg.window
    # lane-major (lanes, T, ...)
    reward = torch.stack(rew_t, dim=1)
    discount = torch.stack(disc_t, dim=1)
    returns, discount_n = nstep_fold(reward, discount, n)
    full_obs = torch.stack(obs_t + [obs], dim=1)               # (lanes, T+1, ...)
    full_q = torch.stack(q_t + [last_aux["q"]], dim=1)         # (lanes, T+1, A)
    action_w = torch.stack(act_t, dim=1)[:, :W]

    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))  # noqa: E731
    priorities = agent.initial_priorities(
        {"q": flat(full_q[:, :W])}, flat(action_w), flat(returns),
        flat(discount_n), {"q": flat(full_q[:, n:])})
    items = {"obs": flat(full_obs[:, :W]), "action": flat(action_w),
             "returns": flat(returns), "discount_n": flat(discount_n),
             "next_obs": flat(full_obs[:, n:])}

    completed = torch.stack(done_ret, dim=1)
    n_done = torch.sum(~torch.isnan(completed))
    mean_ep_return = torch.where(
        n_done > 0, torch.nansum(completed) / torch.clamp(n_done, min=1), torch.nan)
    metrics = {"mean_ep_return": mean_ep_return, "episodes": n_done,
               "mean_initial_priority": priorities.mean()}
    aslice = ActorSlice(env_state=env_state, obs=obs, ep_return=ep_ret, generator=gen,
                        frames=aslice.frames + cfg.lanes_per_shard * cfg.rollout_len)
    return aslice, TransitionBlock(items, priorities), metrics


def replay_add(cfg, replay_state: replay_lib.ReplayState,
               block: TransitionBlock) -> replay_lib.ReplayState:
    """Insert a transition block into the replay (Alg. 1 l.10-11): circular
    FIFO for the Atari regime, alloc-into-free slots for the DPG regime."""
    add = replay_lib.add_fifo if cfg.eviction == "fifo" else replay_lib.add_alloc
    return add(cfg.replay, replay_state, block.items, block.priorities)


# ---------------------------------------------------------------------------
# Learn phase
# ---------------------------------------------------------------------------

def learn_phase(cfg, agent, optimizer, lslice: LearnerSlice, items: dict,
                weights: torch.Tensor) -> tuple[LearnerSlice, torch.Tensor, dict]:
    """One prioritized update from an already-sampled batch (Alg. 2 l.5-7):
    loss/grads, optimizer step, periodic target sync (a host branch).
    Returns the fresh |TD| priorities for write-back."""
    params, opt_state, new_prios, metrics = agent.update(
        lslice.params, lslice.target_params, lslice.opt_state, optimizer,
        items, weights)
    step = lslice.learner_step + 1
    target = optim.periodic_target_update(params, lslice.target_params, step,
                                          cfg.target_update_period)
    return (LearnerSlice(params=params, target_params=target, opt_state=opt_state,
                         learner_step=step), new_prios, metrics)


def priority_writeback(cfg, replay_state: replay_lib.ReplayState,
                       indices: torch.Tensor, priorities: torch.Tensor,
                       learner_step: int, generator: torch.Generator | None = None,
                       ) -> replay_lib.ReplayState:
    """Write fresh learner priorities back (Alg. 2 l.8) and run the periodic
    eviction policy (paper: every 100 learning steps) as a host branch.
    ``learner_step`` is the post-update step count."""
    rcfg = cfg.replay
    rep = replay_lib.set_priorities(rcfg, replay_state, indices, priorities)
    if learner_step % cfg.evict_interval != 0:
        return rep
    if cfg.eviction == "fifo":
        return replay_lib.evict_fifo(rcfg, rep)
    if rep.size > rcfg.soft_cap:
        return replay_lib.evict_prioritized(rcfg, rep, generator,
                                            cfg.evict_num or cfg.batch_size)
    return rep
