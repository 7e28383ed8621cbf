"""The Ape-X system in PyTorch: replay, sum tree, n-step, actor, learner and
the lockstep trainer. :func:`params_from_jax` and :func:`init_state_from_jax`
carry weights and whole states across from the JAX package."""

from repro_torch.core.params import init_state_from_jax, params_from_jax  # noqa: F401
