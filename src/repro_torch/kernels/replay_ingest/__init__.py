from repro_torch.kernels.replay_ingest import ops, ref  # noqa: F401
