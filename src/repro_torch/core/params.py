"""Carry weights and whole training states across from the JAX package.

The JAX package's parameter and optimizer-state pytrees are nested dicts,
tuples and NamedTuples of arrays, as ``jax.tree.map(np.asarray, ...)``
gives them; the port keeps the same layout, so the conversion is leafwise
(the transformer's stacked layer dict included). Only numpy is used to read
the arrays: nothing here imports JAX. A bfloat16 leaf (numpy dtype
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) is carried bit
for bit through its uint16 view.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import device as device_lib
from repro_torch.optim import optimizers as optim

# The JAX package's NamedTuple containers, by class name, and their ports.
_PORT_TYPES = {"RMSPropState": optim.RMSPropState, "AdamState": optim.AdamState}


def params_from_jax(tree: Any, device="cuda") -> Any:
    """Convert a JAX parameter or optimizer-state pytree (numpy or JAX array
    leaves) into the port's tensors on ``device``."""
    dev = device_lib.resolve(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            vals = [conv(v) for v in x]
            port = _PORT_TYPES.get(type(x).__name__)
            return port(*vals) if port is not None else tuple(vals)
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _tensor(np.array(x, copy=True)).to(dev)

    return conv(tree)


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def init_state_from_jax(jax_state: Any, device="cuda", seed: int = 0):
    """The port's ``ApexState`` built from a single-shard JAX ``ApexState``:
    params, target, optimizer state, actor params, replay (storage, tree and
    cursors), env positions, obs, episode returns and counters. JAX PRNG
    keys have no port; the port's generator is seeded with ``seed``."""
    from repro_torch.core import apex, replay as replay_lib
    from repro_torch.envs.synthetic import ChainState

    dev = device_lib.resolve(device)
    conv = lambda t: params_from_jax(t, dev)  # noqa: E731
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rep = jax_state.replay
    env = jax_state.env_state
    return apex.ApexState(
        params=conv(jax_state.params),
        target_params=conv(jax_state.target_params),
        opt_state=conv(jax_state.opt_state),
        actor_params=conv(jax_state.actor_params),
        iteration=int(np.asarray(jax_state.iteration)),
        learner_step=int(np.asarray(jax_state.learner_step)),
        replay=replay_lib.ReplayState(
            storage=conv(dict(rep.storage)), tree=conv(rep.tree),
            write_pos=int(np.asarray(rep.write_pos)), size=int(np.asarray(rep.size)),
            total_added=int(np.asarray(rep.total_added))),
        env_state=ChainState(*(conv(getattr(env, f)) for f in ChainState._fields)),
        obs=conv(jax_state.obs),
        ep_return=conv(jax_state.ep_return),
        rng=gen,
        frames=int(np.asarray(jax_state.frames)))
