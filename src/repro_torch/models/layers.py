"""Transformer building blocks of the port, dense GQA family — PyTorch,
parameterized by nested dicts in the JAX package's layout.

Conventions (as in the JAX package's ``models/layers.py``)
===========================================================
* Activations compute in ``cfg.act_dtype`` (bf16 at full width); softmax and
  norms in f32. Parameters are stored in ``cfg.p_dtype``.
* Attention tensors are (batch, seq, heads, head_dim); GQA never materializes
  repeated KV heads (query heads are grouped against shared KV).
* Attention implementations behind one flag:
    - ``einsum``  : materialized scores; decode (Sq==1) and small tests.
    - ``chunked`` : online-softmax loop over KV blocks, bounded memory; the
                    oracle of the flash kernel's backward.
    - ``flash``   : the hand-written Hopper kernel
                    (``repro_torch.kernels.flash_attention``), its plain
                    version for a CPU tensor. The JAX names ``pallas`` and
                    ``pallas_interpret`` map onto it.
* A decode cache is updated in place (the JAX package returns a new array);
  the functions still return it, so the call shape is the same.
* MLA and MoE come with a later slice; their config dataclasses are here so
  that ``ModelConfig`` keeps its fields.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal_init(generator: torch.Generator, shape, std: float, dtype,
                device=None) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return (std * x).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def norm_init(kind: str, d: int, dtype, device=None) -> dict:
    return (rmsnorm_init(d, dtype, device) if kind == "rmsnorm"
            else layernorm_init(d, dtype, device))


def apply_norm(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# ---------------------------------------------------------------------------
# Rotary position embeddings (with partial-rotary support, e.g. StableLM 25%)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, rope_pct: float, theta: float,
                     device=None) -> torch.Tensor:
    rot_dim = int(head_dim * rope_pct) // 2 * 2
    exponents = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                             device=device) / max(rot_dim, 1)
    return 1.0 / (theta ** exponents)  # (rot_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S) or (S,); rotates the first len(freqs)*2 dims."""
    rot = freqs.shape[0] * 2
    if rot == 0:
        return x
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # (B, S, rot/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Attention core (GQA, causal, sliding window) — einsum & chunked paths
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int | None, k_valid_len) -> torch.Tensor:
    """Additive f32 bias from position constraints.

    q_pos (Sq,) or (B, Sq); k_pos (Sk,) or (B, Sk) — batched forms support
    per-row decode positions (continuous batching) and ring-buffer caches
    whose slots hold per-row absolute positions. ``k_valid_len`` is None,
    an int, a 0-d tensor or a (B,) tensor. Returns (Sq, Sk) or
    (B, 1, 1, Sq, Sk).
    """
    batched = q_pos.ndim == 2 or k_pos.ndim == 2
    if batched:
        qp = (q_pos if q_pos.ndim == 2 else q_pos[None, :])[:, :, None]
        kp = (k_pos if k_pos.ndim == 2 else k_pos[None, :])[:, None, :]
    else:
        qp = q_pos[:, None]
        kp = k_pos[None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                    device=kp.device)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= qp - kp < window
    if k_valid_len is not None:
        kv = k_valid_len
        if batched and isinstance(kv, torch.Tensor) and kv.ndim == 1:
            kv = kv[:, None, None]
        ok &= kp < kv
    bias = torch.where(ok, 0.0, NEG_INF).float()
    if batched:                                    # broadcast over (h, g)
        bias = bias[:, None, None, :, :]
    return bias


def _positions(offset, n: int, device) -> torch.Tensor:
    """``offset + arange(n)``; ``offset`` is an int or a tensor ((), or
    (B, 1) for per-row decode positions)."""
    return offset + torch.arange(n, device=device)


def attention_einsum(q, k, v, *, causal=True, window=None, q_offset=0,
                     k_valid_len=None, scale=None, k_positions=None):
    """q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) -> (B,Sq,Hq,D). Materialized scores.

    ``k_positions`` overrides the implicit 0..Sk-1 key positions — used by
    ring-buffer (sliding-window) caches whose slots hold non-contiguous
    absolute positions.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    q_pos = _positions(q_offset, Sq, q.device)
    k_pos = torch.arange(Sk, device=q.device) if k_positions is None else k_positions
    s = s + _mask_bias(q_pos, k_pos, causal, window, k_valid_len)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def attention_chunked(q, k, v, *, causal=True, window=None, q_offset=0,
                      k_valid_len=None, scale=None, chunk=512):
    """Online-softmax over KV chunks: O(Sq * chunk) live scores.

    Matches ``attention_einsum`` (it is the oracle of the flash kernel's
    backward). Fully-masked chunks still execute.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    nchunks = -(-Sk // chunk)
    pad = nchunks * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = (q.float() * scale).reshape(B, Sq, Hkv, g, D)
    q_pos = _positions(q_offset, Sq, q.device)
    valid = Sk if k_valid_len is None else k_valid_len

    m = torch.full((B, Hkv, g, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, g, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, g, Sq, Dv), dtype=torch.float32, device=q.device)
    for c in range(nchunks):
        kb = k[:, c * chunk:(c + 1) * chunk]
        vb = v[:, c * chunk:(c + 1) * chunk]
        k_pos = c * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb.float())
        s = s + _mask_bias(q_pos, k_pos, causal, window, valid)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vb.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]        # (B,Hkv,g,Sq,Dv)
    out = out.movedim(3, 1).reshape(B, Sq, Hq, Dv)
    return out.to(q.dtype)


def attention(q, k, v, *, impl="flash", **kw):
    if impl == "einsum" or q.shape[1] == 1:
        kw.pop("chunk", None)
        return attention_einsum(q, k, v, **kw)
    if impl == "chunked":
        return attention_chunked(q, k, v, **kw)
    if impl in ("flash", "pallas", "pallas_interpret"):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        q_offset = kw.get("q_offset", 0)
        if isinstance(q_offset, torch.Tensor):
            raise TypeError("flash attention takes q_offset as a Python int "
                            "(a device value would need a host sync)")
        # k_valid_len is not passed: the kernel masks keys past the valid
        # length by causality, as the JAX package's Pallas dispatch does.
        return fa_ops.flash_attention(
            q, k, v, causal=kw.get("causal", True), window=kw.get("window"),
            q_offset=int(q_offset), scale=kw.get("scale"))
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# GQA attention block (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------

def gqa_init(generator, cfg, dtype, device=None) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std = d ** -0.5
    return {
        "wq": normal_init(generator, (d, hq * dh), std, dtype, device),
        "wk": normal_init(generator, (d, hkv * dh), std, dtype, device),
        "wv": normal_init(generator, (d, hkv * dh), std, dtype, device),
        "wo": normal_init(generator, (hq * dh, d), (hq * dh) ** -0.5, dtype, device),
    }


def gqa_apply(p, cfg, x, *, positions, kv_cache=None, cache_len=None,
              impl="flash", causal=True, start: int | None = None):
    """x (B,S,d). With kv_cache=(k,v) of (B,Smax,Hkv,Dh): write at positions
    (in place), attend against the cache (prefill/decode); else
    self-attention. ``start`` is the host offset (``positions[0]``) of a
    write that shares one position across rows."""
    B, S, d = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    freqs = rope_frequencies(dh, cfg.rope_pct, cfg.rope_theta, device=x.device)
    q = (x @ p["wq"]).reshape(B, S, hq, dh)
    k = (x @ p["wk"]).reshape(B, S, hkv, dh)
    v = (x @ p["wv"]).reshape(B, S, hkv, dh)
    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)

    if kv_cache is None:
        out = attention(q, k, v, impl=impl, causal=causal,
                        window=cfg.sliding_window, chunk=cfg.attn_chunk)
        new_cache = None
    elif (cfg.swa_ring_cache and cfg.sliding_window is not None and S == 1
          and kv_cache[0].shape[1] <= cfg.sliding_window):
        # ring-buffer SWA cache: W slots, slot = pos % W; keys carry their
        # absolute positions for masking (unwritten slots pushed out of the
        # window). O(window) memory instead of O(seq_len).
        ck, cv = kv_cache
        W = ck.shape[1]
        win = cfg.sliding_window
        pv = (positions[:, 0] if positions.ndim == 2
              else positions.reshape(-1)[0].expand(B))
        rows = torch.arange(B, device=x.device)
        slot = pv % W
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
        r = torch.arange(W, device=x.device)
        abs_k = pv[:, None] - ((pv[:, None] - r[None, :]) % W)   # (B, W)
        abs_k = torch.where(abs_k < 0, -2 * win, abs_k)           # warmup slots
        out = attention_einsum(q, ck, cv, causal=causal, window=win,
                               q_offset=pv[:, None], k_positions=abs_k)
        new_cache = (ck, cv)
    elif positions.ndim == 2 and S == 1:
        # per-row decode positions (continuous batching): scatter one token
        # into each row's slot, mask each row by its own valid length
        ck, cv = kv_cache
        rows = torch.arange(B, device=x.device)
        pos_vec = positions[:, 0]
        ck[rows, pos_vec] = k[:, 0].to(ck.dtype)
        cv[rows, pos_vec] = v[:, 0].to(cv.dtype)
        valid = cache_len if cache_len is not None else pos_vec + 1
        out = attention_einsum(q, ck, cv, causal=causal,
                               window=cfg.sliding_window,
                               q_offset=positions, k_valid_len=valid)
        new_cache = (ck, cv)
    else:
        ck, cv = kv_cache
        ck[:, start:start + S] = k.to(ck.dtype)
        cv[:, start:start + S] = v.to(cv.dtype)
        valid = cache_len if cache_len is not None else start + S
        out = attention(q, ck, cv, impl=impl, causal=causal,
                        window=cfg.sliding_window, q_offset=start,
                        k_valid_len=valid, chunk=cfg.attn_chunk)
        new_cache = (ck, cv)
    y = out.reshape(B, S, hq * dh) @ p["wo"]
    return y, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(generator, d: int, ff: int, act: str, dtype, device=None) -> dict:
    std = d ** -0.5
    p = {"w_up": normal_init(generator, (d, ff), std, dtype, device),
         "w_down": normal_init(generator, (ff, d), ff ** -0.5, dtype, device)}
    if act == "swiglu":
        p["w_gate"] = normal_init(generator, (d, ff), std, dtype, device)
    return p


def mlp_apply(p, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


# ---------------------------------------------------------------------------
# Config dataclasses of the MLA and MoE layers (the layers come later)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0            # always-active experts (DeepSeek-V2: 2)
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    dispatch_groups: int = 1       # >1: shard-local dispatch
