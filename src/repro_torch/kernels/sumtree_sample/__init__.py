from repro_torch.kernels.sumtree_sample import ops, ref  # noqa: F401
