"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Only the architectures whose every module the port has are registered: the
dense GQA family. Asking for another architecture of the JAX package raises
and names the slice of the port that brings it.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
}

# The JAX package's other architectures, and the slice that ports each.
_LATER = {
    "deepseek-v2-236b": "the MLA and MoE slice",
    "phi3.5-moe-42b-a6.6b": "the MLA and MoE slice",
    "rwkv6-1.6b": "the SSM mixer slice",
    "zamba2-2.7b": "the SSM mixer slice",
    "hubert-xlarge": "the encoder and VLM input-mode slice",
    "internvl2-2b": "the encoder and VLM input-mode slice",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _LATER:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: it comes with {_LATER[arch_id]} "
            f"(ROADMAP queue 1, item 8); ported: {ARCH_IDS}")
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG
