"""State-space mixer configuration (Mamba2 / RWKV6).

Only the config dataclass is here, so that ``ModelConfig`` keeps its
``ssm`` field; the mixers themselves come with a later slice of the port.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    headdim: int = 64
    conv_width: int = 4
    expand: int = 2
    ngroups: int = 1
    chunk: int = 64        # SSD block length for the chunked (matmul) path

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def nheads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim
