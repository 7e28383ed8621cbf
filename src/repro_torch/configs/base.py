"""Config schema of the port: architectures, input shapes and the
smoke-reduction rule, as in the JAX package's ``configs/base.py``.

Each architecture the port serves gets a ``configs/<id>.py`` exporting
``CONFIG`` (the exact published spec, source cited). The four benchmark
input shapes are global:

  train_4k     seq 4096   global_batch 256   training step
  prefill_32k  seq 32768  global_batch 32    inference prefill / actor scoring
  decode_32k   seq 32768  global_batch 128   one-token decode vs KV cache
  long_500k    seq 524288 global_batch 1     long-context decode (sub-quadratic archs)

The ``mla``, ``moe`` and ``ssm`` fields stay in the schema; the port's
``transformer.init`` refuses a config that sets them until their slice.
The JAX package's fields for its compiler and mesh (``remat``,
``scan_layers``, ``attn_unroll``, ``attn_p_bf16``, ``mixer_head_shard``,
``act_sharding``) and for the VLM input (``prefix_len``) have no port yet.
The port's attention default is ``"flash"``, the hand-written kernel (its
plain version on a CPU tensor); the JAX package's default is ``"einsum"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.layers import MLAConfig, MoEConfig
from repro_torch.models.ssm import SSMConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    source: str = ""                 # paper / model-card citation

    mixer: str = "attn"              # attn | mla | mamba2 | rwkv6
    mlp: str = "dense"               # dense | moe | rwkv_cm
    act: str = "swiglu"
    norm: str = "rmsnorm"
    rope_theta: float = 1e4
    rope_pct: float = 1.0
    sliding_window: int | None = None
    causal: bool = True
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    shared_attn_every: int = 0       # zamba2: shared attention block cadence
    input_mode: str = "tokens"       # tokens | embeddings | mixed
    tie_embeddings: bool = False

    dtype: str = "bfloat16"          # activation dtype
    param_dtype: str = "bfloat16"
    attn_impl: str = "flash"         # flash (pallas, pallas_interpret) | einsum | chunked
    attn_chunk: int = 512
    swa_ring_cache: bool = False     # sliding-window archs: decode KV cache
                                     # is a ring of `sliding_window` slots
                                     # instead of the full sequence (O(w)
                                     # memory; prefill must fit the window)

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def p_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid or sliding-window attention."""
        return (self.mixer in ("mamba2", "rwkv6")
                or self.sliding_window is not None)

    @property
    def encoder_only(self) -> bool:
        return not self.causal

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant of the same family (<=2 layers, d_model<=512,
        <=4 experts), float32, runnable on CPU; the same shapes as the JAX
        package's ``reduced()``."""
        head_dim = max(32, d_model // max(self.n_heads, 1))
        n_heads = min(self.n_heads, max(2, d_model // head_dim))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        if n_heads % n_kv:
            n_kv = 1
        changes: dict[str, Any] = dict(
            n_layers=n_layers, d_model=d_model,
            n_heads=n_heads, n_kv_heads=n_kv, head_dim=d_model // n_heads,
            d_ff=2 * d_model, vocab_size=vocab,
            dtype="float32", param_dtype="float32",
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_expert=d_model,
                num_shared=min(self.moe.num_shared, 1), capacity_factor=4.0)
        if self.mla is not None:
            changes["mla"] = MLAConfig(q_lora=64, kv_lora=32, rope_head_dim=16,
                                       nope_head_dim=32, v_head_dim=32)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, headdim=32)
        if self.sliding_window is not None:
            changes["sliding_window"] = 32
        if self.shared_attn_every:
            changes["shared_attn_every"] = 1
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Which (arch, shape) pairs run, with the reason for a skip."""
    if shape.kind == "decode" and cfg.encoder_only:
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full attention: 500k decode requires sub-quadratic attention"
    return True, ""
