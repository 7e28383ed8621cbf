from repro_torch.kernels.sumtree_update import ops, ref  # noqa: F401
