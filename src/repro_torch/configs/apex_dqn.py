"""Ape-X DQN — the paper's own configuration (§4.1, Appendix C), plus a
small reduced preset for tests and quick runs.

Paper values (full): 360 actors, eps-ladder eps=0.4/alpha=7, n=3, batch 512,
replay soft cap 2e6 with FIFO en-masse eviction every 100 learner steps,
min-fill 50000, centered RMSProp lr 0.00025/4, grad clip 40, target copy
every 2500 batches.

The port runs one shard on one card, so ``full()`` defaults to
``num_shards=1``: the whole 2,097,152-slot replay (one tree of 2^22 f32),
batch 512 and 360 actor lanes. Obs stay raw uint8 (the obs codec is not
ported yet).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import apex, replay as replay_lib
from repro_torch.core.agents import DQNAgent
from repro_torch.envs.synthetic import ChainWorld
from repro_torch.models.qnetworks import DuelingDQN
from repro_torch.optim import optimizers as optim


@dataclasses.dataclass(frozen=True)
class ApexDQNPreset:
    apex: apex.ApexConfig
    env: ChainWorld
    agent: DQNAgent
    learning_rate: float = 0.00025 / 4

    def make_optimizer(self):
        return optim.centered_rmsprop(self.learning_rate, decay=0.95, eps=1.5e-7)


def full(num_shards: int = 1) -> ApexDQNPreset:
    """Paper-scale geometry (replay = 2^21 slots / shards, batch 512)."""
    env = ChainWorld(length=64, max_steps=512)
    agent = DQNAgent(net=DuelingDQN(num_actions=env.num_actions,
                                    mlp_hidden=(512, 512), head_hidden=512),
                     grad_clip=40.0)
    cap = 2_097_152 // num_shards  # soft 2e6 global
    cfg = apex.ApexConfig(
        replay=replay_lib.ReplayConfig(
            capacity=cap, soft_capacity=int(cap * 0.95),
            alpha=0.6, beta=0.4, min_fill=50_000 // num_shards),
        lanes_per_shard=max(1, 360 // num_shards), num_shards=num_shards,
        rollout_len=64, n_step=3, batch_size=512 // num_shards,
        learner_steps_per_iter=2, param_sync_period=1,
        target_update_period=2500, evict_interval=100,
        eps_base=0.4, eps_alpha=7.0)
    return ApexDQNPreset(apex=cfg, env=env, agent=agent)


def reduced(num_shards: int = 1) -> ApexDQNPreset:
    """Small preset: same structure, small everything."""
    env = ChainWorld(length=8, max_steps=32)
    agent = DQNAgent(net=DuelingDQN(num_actions=env.num_actions,
                                    mlp_hidden=(64,), head_hidden=64),
                     grad_clip=40.0)
    cfg = apex.ApexConfig(
        replay=replay_lib.ReplayConfig(capacity=4096, min_fill=256),
        lanes_per_shard=16, num_shards=num_shards,
        rollout_len=24, n_step=3, batch_size=64,
        learner_steps_per_iter=2, param_sync_period=2,
        target_update_period=100, evict_interval=50,
        eps_base=0.4, eps_alpha=7.0)
    return ApexDQNPreset(apex=cfg, env=env, agent=agent, learning_rate=1e-3)
