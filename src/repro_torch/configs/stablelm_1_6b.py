"""stablelm-1.6b — dense decoder with 25% partial rotary
[hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352,
    rope_pct=0.25, rope_theta=10000.0,
    act="swiglu", norm="layernorm",
    source="hf:stabilityai/stablelm-2-1_6b",
)
