from repro_torch.kernels.nstep_return import ops, ref  # noqa: F401
