"""Transformer assembly of the port, dense GQA family (``mixer == "attn"``,
``mlp == "dense"``): llama3.2-1b, granite-3-8b, h2o-danube-1.8b (sliding
window) and stablelm-1.6b (partial rotary, LayerNorm).

Entry points, as in the JAX package's ``models/transformer.py``:
  * :func:`apply`         — full-sequence logits (actor-side scoring)
  * :func:`prefill`       — apply + populate the decode cache
  * :func:`prefill_chunk` — one chunk of a prompt at a host offset
  * :func:`decode_step`   — one token against a ``max_len`` cache

Parameters keep the JAX layout: nested dicts whose layer leaves are stacked
on axis 0, so weights carry across leafwise (``core.params_from_jax``).
The layer stack is a Python loop over that axis (the JAX package scans).
The cache is updated in place and returned. Prefill offsets are host
integers, so the flash kernel gets its ``q_offset`` without a device read.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import device as device_lib
from repro_torch.models import layers as ll


def _check_supported(cfg) -> None:
    if cfg.mixer != "attn" or cfg.mlp != "dense" or cfg.mla or cfg.moe or cfg.ssm:
        raise NotImplementedError(
            f"{cfg.arch_id}: mixer={cfg.mixer!r}, mlp={cfg.mlp!r} is not ported yet "
            "(MLA, MoE and SSM come with later slices, ROADMAP queue 1, item 8)")
    if cfg.shared_attn_every or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.arch_id}: shared attention and input_mode={cfg.input_mode!r} "
            "are not ported yet")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _layer_init(generator, cfg, device) -> dict:
    dtype = cfg.p_dtype
    return {"pre_ln": ll.norm_init(cfg.norm, cfg.d_model, dtype, device),
            "post_ln": ll.norm_init(cfg.norm, cfg.d_model, dtype, device),
            "mixer": ll.gqa_init(generator, cfg, dtype, device),
            "mlp": ll.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, dtype, device)}


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters from ``generator`` (which must live on ``device``)."""
    _check_supported(cfg)
    dev = device_lib.resolve(device)
    dtype = cfg.p_dtype
    params: dict[str, Any] = {"embed": {"w": ll.normal_init(
        generator, (cfg.vocab_size, cfg.d_model), 0.02, dtype, dev)}}
    params["layers"] = _stack([_layer_init(generator, cfg, dev)
                               for _ in range(cfg.n_layers)])
    params["final_ln"] = ll.norm_init(cfg.norm, cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        params["head"] = {"w": ll.normal_init(
            generator, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5, dtype, dev)}
    return params


def param_count(params: Any) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device="cuda") -> dict:
    """Stacked-over-layers KV cache (L, B, S, Hkv, Dh), or a ring of
    ``sliding_window`` slots with ``swa_ring_cache``."""
    _check_supported(cfg)
    dev = device_lib.resolve(device)
    s_alloc = max_len
    if cfg.swa_ring_cache and cfg.sliding_window is not None:
        s_alloc = min(max_len, cfg.sliding_window)   # O(window) ring
    kv = (cfg.n_layers, batch, s_alloc, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=cfg.act_dtype, device=dev),
            "v": torch.zeros(kv, dtype=cfg.act_dtype, device=dev)}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _block(cfg, lp, x, positions, lcache, cache_len, impl, start):
    """One transformer block; writes its layer's cache in place."""
    kv = None if lcache is None else (lcache["k"], lcache["v"])
    h = ll.apply_norm(cfg.norm, lp["pre_ln"], x)
    y, _ = ll.gqa_apply(lp["mixer"], cfg, h, positions=positions, kv_cache=kv,
                        cache_len=cache_len, impl=impl, causal=cfg.causal,
                        start=start)
    x = x + y
    h = ll.apply_norm(cfg.norm, lp["post_ln"], x)
    return x + ll.mlp_apply(lp["mlp"], h, cfg.act)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _forward(cfg, params, x, positions, cache=None, cache_len=None, impl=None,
             start: int | None = None):
    """Layer stack; each layer's cache slice is a view, written in place.
    Returns (hidden, cache)."""
    impl = impl or cfg.attn_impl
    for i in range(cfg.n_layers):
        lcache = None if cache is None else _layer(cache, i)
        x = _block(cfg, _layer(params["layers"], i), x, positions, lcache,
                   cache_len, impl, start)
    return x, cache


def _embed_inputs(cfg, params, tokens):
    return params["embed"]["w"][tokens.long()].to(cfg.act_dtype)


def _head(cfg, params, x):
    """Float32 logits: the product of the norm's output and the (tied)
    embedding, accumulated and returned in f32 (the JAX package's
    ``preferred_element_type=f32``)."""
    ln = ll.apply_norm(cfg.norm, params["final_ln"], x)
    w = params["embed"]["w"].T if cfg.tie_embeddings else params["head"]["w"]
    return ln.float() @ w.to(ln.dtype).float()


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def apply(params, tokens, *, cfg, impl=None):
    """Full-sequence logits (actor-side priority scoring)."""
    x = _embed_inputs(cfg, params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _forward(cfg, params, x, positions, impl=impl)
    return _head(cfg, params, x)


def prefill(params, tokens, *, cfg, cache, impl=None):
    """Populate the decode cache with a prompt; returns (logits, cache)."""
    x = _embed_inputs(cfg, params, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    x, cache = _forward(cfg, params, x, positions, cache=cache, cache_len=S,
                        impl=impl, start=0)
    return _head(cfg, params, x), cache


def prefill_chunk(params, tokens, start: int, *, cfg, cache, impl=None,
                  with_logits: bool = True):
    """Chunked prefill: write ``tokens`` (B, C) into the cache segment at
    the host offset ``start`` (one shared start across rows). Positions are
    ``start + arange(C)`` and the valid length after the chunk is
    ``start + C``, so a prompt split into chunks reproduces :func:`prefill`
    of the concatenation. Returns (logits, cache); ``with_logits=False``
    skips the head and returns (None, cache), for a caller that only fills
    the cache (under ``jax.jit`` the JAX package's unused logits are
    dropped by the compiler; eager PyTorch would compute them)."""
    start = int(start)
    x = _embed_inputs(cfg, params, tokens)
    S = x.shape[1]
    positions = start + torch.arange(S, device=x.device)
    x, cache = _forward(cfg, params, x, positions, cache=cache,
                        cache_len=start + S, impl=impl, start=start)
    return (_head(cfg, params, x) if with_logits else None), cache


def decode_step(params, token, pos, *, cfg, cache, impl=None):
    """One-token step: token (B, 1); pos is either a scalar (an int, or a
    0-d tensor: all rows at the same position) or a (B,) tensor of per-row
    positions (continuous batching — rows decode at independent offsets)."""
    x = _embed_inputs(cfg, params, token)
    dev = x.device
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        pos = pos.to(device=dev, dtype=torch.int64)
        positions, start = pos[:, None], None          # (B, 1) per-row
    else:
        start = int(pos)
        positions = torch.full((1,), start, dtype=torch.int64, device=dev)
        pos = start
    x, cache = _forward(cfg, params, x, positions, cache=cache,
                        cache_len=pos + 1, impl=impl, start=start)
    return _head(cfg, params, x), cache
