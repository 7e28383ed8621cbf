"""Parity of the port's dense-GQA transformer with the JAX package.

For each ported architecture at its ``reduced()`` size (f32), the JAX
parameters are carried across with ``params_from_jax`` and both packages
run on the same numpy tokens:

* ``apply(impl="flash")`` against JAX ``apply(impl="einsum")``, and for
  llama3.2-1b against JAX ``apply(impl="pallas_interpret")``, the kernel;
* ``prefill`` into a cache longer than the prompt, ``prefill_chunk`` and
  ``decode_step`` (scalar and per-row positions; the ring cache of
  h2o-danube-1.8b with ``swa_ring_cache=True``) against JAX
  ``impl="chunked"``: JAX's Pallas prefill cannot take a traced cache
  offset (ROADMAP queue 3), so the kernel's own oracle stands in;
* ``score_step`` priorities against JAX's.

Tolerance ``TOL`` (f32): the port and XLA sum in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro_torch.core import params_from_jax
from repro_torch.launch import steps as tsteps
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttf

TOL = 1e-5
ARCHS = ["llama3.2-1b", "granite-3-8b", "h2o-danube-1.8b", "stablelm-1.6b"]


def make_pair(arch, **changes):
    jcfg = dataclasses.replace(jregistry.get_config(arch).reduced(), **changes)
    tcfg = dataclasses.replace(tregistry.get_config(arch).reduced(), **changes)
    jparams = jtf.init(jcfg, jax.random.key(0))
    return jcfg, jparams, tcfg, params_from_jax(jparams, device="cpu")


def jax_decode(cfg):
    return jax.jit(lambda p, tok, pos, c: jtf.decode_step(p, tok, pos, cfg=cfg, cache=c))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), rtol=tol, atol=tol)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def test_registry_and_reduced_shapes_match_jax():
    assert set(tregistry.ARCH_IDS) == set(ARCHS)
    for arch in ARCHS:
        j, t = jregistry.get_config(arch), tregistry.get_config(arch)
        for full_j, full_t in ((j, t), (j.reduced(), t.reduced())):
            for f in dataclasses.fields(full_t):
                if f.name != "attn_impl":
                    assert getattr(full_t, f.name) == getattr(full_j, f.name), (arch, f.name)
    for arch in set(jregistry.ARCH_IDS) - set(ARCHS):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            tregistry.get_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_jax(arch):
    jcfg, jp, tcfg, tp = make_pair(arch)
    toks = _tokens(jcfg, (2, 24))
    got = ttf.apply(tp, torch.from_numpy(toks), cfg=tcfg, impl="flash")
    assert got.dtype == torch.float32 and got.shape == (2, 24, jcfg.vocab_size)
    want = jtf.apply(jp, jnp.asarray(toks), cfg=jcfg, impl="einsum")
    close(got, want)
    close(ttf.apply(tp, torch.from_numpy(toks), cfg=tcfg, impl="chunked"), want)
    if arch == "llama3.2-1b":
        close(got, jtf.apply(jp, jnp.asarray(toks), cfg=jcfg, impl="pallas_interpret"))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_and_decode_match_jax(arch):
    jcfg, jp, tcfg, tp = make_pair(arch)
    B, S, prompt, C = 2, 20, 9, 4
    toks = _tokens(jcfg, (B, S), seed=1)
    tt = torch.from_numpy(toks)
    jdecode = jax_decode(jcfg)
    jc, tc = jtf.init_cache(jcfg, B, S), ttf.init_cache(tcfg, B, S, device="cpu")
    jl, jc = jtf.prefill(jp, jnp.asarray(toks[:, :prompt]), cfg=jcfg, cache=jc,
                         impl="chunked")
    tl, tc = ttf.prefill(tp, tt[:, :prompt], cfg=tcfg, cache=tc, impl="flash")
    close(tl, jl)
    for t in range(prompt, prompt + 4):                 # scalar positions
        jl, jc = jdecode(jp, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t), jc)
        tl, tc = ttf.decode_step(tp, tt[:, t:t + 1], t, cfg=tcfg, cache=tc)
        close(tl, jl)
    for name in ("k", "v"):
        close(tc[name], jc[name])

    # chunked prefill at host offsets, then per-row decode positions
    jc, tc = jtf.init_cache(jcfg, B, S), ttf.init_cache(tcfg, B, S, device="cpu")
    for start in (0, C, 2 * C):
        chunk = toks[:, start:start + C]
        jl, jc = jtf.prefill_chunk(jp, jnp.asarray(chunk), jnp.asarray(start), cfg=jcfg,
                                   cache=jc, impl="chunked")
        tl, tc = ttf.prefill_chunk(tp, torch.from_numpy(chunk), start, cfg=tcfg, cache=tc)
        close(tl, jl)
    pos = np.array([3 * C, 3 * C - 2])                  # rows at different positions
    for _ in range(4):
        tok = toks[np.arange(B), pos][:, None]
        jl, jc = jdecode(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
        tl, tc = ttf.decode_step(tp, torch.from_numpy(tok), torch.from_numpy(pos),
                                 cfg=tcfg, cache=tc)
        close(tl, jl)
        pos = pos + 1
    for name in ("k", "v"):
        close(tc[name], jc[name])


def test_ring_cache_decode_matches_jax():
    """h2o-danube-1.8b with a ring of ``sliding_window`` (32) slots, decoded
    past the window with scalar and then per-row positions."""
    jcfg, jp, tcfg, tp = make_pair("h2o-danube-1.8b", swa_ring_cache=True)
    B, prompt = 2, 9
    toks = _tokens(jcfg, (B, 48), seed=2)
    jdecode = jax_decode(jcfg)
    jc, tc = jtf.init_cache(jcfg, B, 48), ttf.init_cache(tcfg, B, 48, device="cpu")
    assert tc["k"].shape[2] == jcfg.sliding_window == 32
    jl, jc = jtf.prefill(jp, jnp.asarray(toks[:, :prompt]), cfg=jcfg, cache=jc,
                         impl="chunked")
    tl, tc = ttf.prefill(tp, torch.from_numpy(toks[:, :prompt]), cfg=tcfg, cache=tc)
    close(tl, jl)
    for t in range(prompt, 40):
        jl, jc = jdecode(jp, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t), jc)
        tl, tc = ttf.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), t, cfg=tcfg,
                                 cache=tc)
        close(tl, jl)
    pos = np.array([40, 40])
    for _ in range(3):
        tok = toks[:, pos[0]:pos[0] + 1]
        jl, jc = jdecode(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
        tl, tc = ttf.decode_step(tp, torch.from_numpy(tok), torch.from_numpy(pos),
                                 cfg=tcfg, cache=tc)
        close(tl, jl)
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_score_step_priorities_match_jax(arch):
    jcfg, jp, tcfg, tp = make_pair(arch)
    toks = _tokens(jcfg, (3, 16), seed=3)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1                                   # masked positions
    labels[2, 5:] = -1
    want = jsteps.make_score_step(jcfg)(jp, {"tokens": jnp.asarray(toks),
                                             "labels": jnp.asarray(labels)})
    got = tsteps.make_score_step(tcfg)(tp, {"tokens": torch.from_numpy(toks),
                                            "labels": torch.from_numpy(labels)})
    assert got.shape == (3,)
    close(got, want)


def test_bf16_weights_carry_across_bit_for_bit():
    jcfg = dataclasses.replace(jregistry.get_config("llama3.2-1b").reduced(),
                               dtype="bfloat16", param_dtype="bfloat16")
    tcfg = dataclasses.replace(tregistry.get_config("llama3.2-1b").reduced(),
                               dtype="bfloat16", param_dtype="bfloat16")
    jp = jtf.init(jcfg, jax.random.key(4))
    tp = params_from_jax(jp, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert jleaves
    for path, leaf in jleaves:
        got = tp
        for key in path:
            got = got[key.key]
        assert got.dtype == torch.bfloat16, path
        want = np.asarray(leaf)
        assert want.dtype.name == "bfloat16"
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    assert ttf.param_count(tp) == jtf.param_count(jp)
    toks = torch.from_numpy(_tokens(jcfg, (1, 8)))
    assert torch.isfinite(ttf.apply(tp, toks, cfg=tcfg)).all()


def test_unported_mixers_are_refused():
    cfg = dataclasses.replace(tregistry.get_config("llama3.2-1b").reduced(), mixer="mla")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ttf.init(cfg, torch.Generator(), device="cpu")
    if not torch.cuda.is_available():                  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttf.init(tregistry.get_config("llama3.2-1b").reduced(), torch.Generator())
