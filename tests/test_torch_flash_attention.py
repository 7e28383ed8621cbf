"""Parity of the port's flash attention with the JAX package.

The port's ``flash_attention`` (its plain version, on CPU tensors) against
the JAX kernel run in interpret mode, over the JAX suite's ``FLASH_CASES``
in f32 and cases with D != Dv, a longer cache, and rows that see no key;
the port's ``attention_einsum`` / ``attention_chunked`` against JAX's; the
autograd backward against ``jax.vjp`` of the same call. Tolerance ``TOL``
(f32, as ``tests/test_kernels.py``): sums are taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import layers as tlayers
from test_kernels import FLASH_CASES

TOL = 2e-5

EXTRA_CASES = [
    # B, Sq, Sk, Hq, Hkv, D, Dv, causal, window, off
    (1, 100, 300, 4, 2, 192, 128, True, None, 150),   # MLA shape, longer cache
    (1, 70, 130, 4, 4, 64, 32, True, None, 60),        # D != Dv, Sk > Sq
    (1, 64, 64, 2, 1, 64, 64, True, 16, 200),          # every row sees no key
]


def _qkv(seed, B, Sq, Sk, Hq, Hkv, D, Dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, Dv)).astype(np.float32))


def _port(q, k, v, **kw):
    return ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw).numpy()


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_matches_jax_kernel(case):
    B, Sq, Sk, Hq, Hkv, D, causal, window, off, bq, bk = case
    q, k, v = _qkv(Sq + Sk + off, B, Sq, Sk, Hq, Hkv, D, D)
    kw = dict(causal=causal, window=window, q_offset=off, block_q=bq, block_k=bk)
    want = jops.flash_attention(q, k, v, interpret=True, **kw)
    np.testing.assert_allclose(_port(q, k, v, **kw), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", EXTRA_CASES, ids=str)
def test_flash_matches_jax_kernel_other_shapes(case):
    B, Sq, Sk, Hq, Hkv, D, Dv, causal, window, off = case
    q, k, v = _qkv(Sq * Sk, B, Sq, Sk, Hq, Hkv, D, Dv)
    kw = dict(causal=causal, window=window, q_offset=off, block_q=64, block_k=64)
    want = np.asarray(jops.flash_attention(q, k, v, interpret=True, **kw))
    got = _port(q, k, v, **kw)
    assert got.shape == (B, Sq, Hq, Dv)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if window is not None and off - (Sk - 1) >= window:
        assert not got.any()            # no visible key: 0, as the kernel gives


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, window=5, q_offset=3, k_valid_len=11),
    dict(causal=False, k_valid_len=7),
    dict(causal=True, q_offset="rows", k_valid_len="rows"),
], ids=["causal", "window-offset-valid", "encoder-valid", "per-row"])
def test_attention_einsum_and_chunked_match_jax(kw):
    B, Sq, Sk, Hq, Hkv, D = 2, 9, 14, 4, 2, 32
    q, k, v = _qkv(7, B, Sq, Sk, Hq, Hkv, D, D)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("q_offset") == "rows":     # per-row offsets and valid lengths
        offs, valid = np.array([[0], [5]]), np.array([9, 14])
        jkw.update(q_offset=jnp.asarray(offs), k_valid_len=jnp.asarray(valid))
        tkw.update(q_offset=torch.from_numpy(offs), k_valid_len=torch.from_numpy(valid))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = np.asarray(jlayers.attention_einsum(q, k, v, **jkw))
    got = tlayers.attention_einsum(tq, tk, tv, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if kw.get("q_offset") != "rows":
        want = np.asarray(jlayers.attention_chunked(q, k, v, chunk=4, **jkw))
        got = tlayers.attention_chunked(tq, tk, tv, chunk=4, **tkw)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_ring_positions_in_einsum_match_jax():
    B, W, Hq, Hkv, D = 2, 8, 2, 1, 32
    q, k, v = _qkv(3, B, 1, W, Hq, Hkv, D, D)
    pos = np.array([11, 4])
    abs_k = pos[:, None] - ((pos[:, None] - np.arange(W)[None]) % W)
    abs_k = np.where(abs_k < 0, -2 * W, abs_k)
    want = jlayers.attention_einsum(q, k, v, window=W, q_offset=jnp.asarray(pos[:, None]),
                                    k_positions=jnp.asarray(abs_k))
    got = tlayers.attention_einsum(*map(torch.from_numpy, (q, k, v)), window=W,
                                   q_offset=torch.from_numpy(pos[:, None]),
                                   k_positions=torch.from_numpy(abs_k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_flash_backward_matches_jax_vjp():
    B, Sq, Sk, Hq, Hkv, D, off, window = 1, 40, 56, 4, 2, 32, 16, 24
    q, k, v = _qkv(11, B, Sq, Sk, Hq, Hkv, D, D)
    g = np.random.default_rng(12).standard_normal((B, Sq, Hq, D)).astype(np.float32)
    kw = dict(causal=True, window=window, q_offset=off, block_q=16, block_k=16)
    _, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(q, k, v, interpret=True, **kw),
                     q, k, v)
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ops.flash_attention(tq, tk, tv, **kw).backward(torch.from_numpy(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_plain_version_matches_jax_ref_in_the_kernel_layout():
    q, k, v = _qkv(5, 1, 12, 20, 4, 2, 32, 32)
    bhsd = [np.swapaxes(x, 1, 2) for x in (q, k, v)]
    want = jref.flash_attention_ref(*bhsd, window=6, q_offset=8)
    got = ref.flash_attention_ref(*map(torch.from_numpy, bhsd), window=6, q_offset=8)
    assert got.shape == (1, 4, 12, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_dispatch_takes_host_offsets_only():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 4, 8, 2, 1, 32, 32))
    with pytest.raises(TypeError):
        tlayers.attention(q, k, v, impl="flash", q_offset=torch.tensor(4))
    for impl in ("flash", "pallas", "pallas_interpret"):
        out = tlayers.attention(q, k, v, impl=impl, q_offset=4)
        assert torch.equal(out, tlayers.attention(q, k, v, impl="flash", q_offset=4))
    assert ops.supported(192, 128) and ops.supported(80, 32) and not ops.supported(96, 96)
