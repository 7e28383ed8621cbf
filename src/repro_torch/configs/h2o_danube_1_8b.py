"""h2o-danube-1.8b — dense decoder, llama+mistral mix with sliding-window
attention [arXiv:2401.16818]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, vocab_size=32000,
    sliding_window=4096, rope_theta=10000.0,
    act="swiglu", norm="rmsnorm",
    source="arXiv:2401.16818 (H2O-Danube-1.8B)",
)
