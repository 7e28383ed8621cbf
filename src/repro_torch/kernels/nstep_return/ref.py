"""Plain PyTorch version of the n-step return kernel: the sliding-window
fold from ``repro_torch.core.nstep``."""

from repro_torch.core.nstep import from_trajectory as nstep_return_ref  # noqa: F401
