"""Plain PyTorch version of the flash-attention kernel (materialized softmax)."""

from __future__ import annotations

import torch

from repro_torch.models.layers import attention_einsum


def flash_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0,
                        scale=None):
    """q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D/Dv) -> (B,Hq,Sq,Dv), through the
    materialized-scores ``attention_einsum`` (which takes (B,S,H,D); this
    keeps the kernel's (B,H,S,D)).

    A query row that sees no key at all gives 0, as the kernel does (its
    denominator is floored at 1e-30); ``attention_einsum`` alone would
    average V over the masked keys there. No other row is touched."""
    Sq, Sk = q.shape[2], k.shape[2]
    out = attention_einsum(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           causal=causal, window=window, q_offset=q_offset,
                           scale=scale)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= q_pos >= k_pos
    if window is not None:
        ok &= q_pos - k_pos < window
    seen = ok.any(dim=1)[None, :, None, None]
    return torch.where(seen, out, out.new_zeros(())).transpose(1, 2)
