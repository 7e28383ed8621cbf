"""The port's serving path against the JAX package's, on the same params and
prompts (llama3.2-1b ``reduced()``, f32, weights carried across with
``params_from_jax``): the greedy decode loop of ``serve``,
``ContinuousBatcher`` and ``WaveBatcher`` must emit the same tokens, and a
hot-swap through the port's ``ParamStore`` must drain with zero drops.
Greedy tokens are compared exactly: in f32 the logits agree to ~1e-6
(``test_torch_transformer.py``), far inside the gap between the top two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro_torch.launch import serve as tserve
from repro_torch.runtime.params import ParamStore
from test_torch_transformer import make_pair


@pytest.fixture(scope="module")
def pair():
    return make_pair("llama3.2-1b")


def _prompts(cfg, n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, size=rng.randint(3, 14)) for _ in range(n)]


def test_generate_matches_jax_serve_loop(pair):
    jcfg, jp, tcfg, tp = pair
    B, P, new = 3, 11, 6
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    # the JAX package's serve loop: prefill, then serve steps
    cache = jtf.init_cache(jcfg, B, P + new)
    logits, cache = jtf.prefill(jp, jnp.asarray(prompt), cfg=jcfg, cache=cache)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    step = jax.jit(jsteps.make_serve_step(jcfg))
    want = [tok]
    for i in range(new - 1):
        tok, cache = step(jp, cache, tok, jnp.asarray(P + i))
        want.append(tok)
    got = tserve.generate(tcfg, tp, torch.from_numpy(prompt), new)
    assert got.finite and got.tokens.shape == (B, new)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(jnp.concatenate(want, 1)))


@pytest.mark.parametrize("kind,chunk", [("continuous", 4), ("wave", 4), ("continuous", 0)])
def test_batchers_match_jax(pair, kind, chunk):
    jcfg, jp, tcfg, tp = pair
    prompts = _prompts(jcfg, 7, seed=3)
    budgets = [1 + (i * 3) % 6 for i in range(7)]
    jcls, tcls = ((jserve.ContinuousBatcher, tserve.ContinuousBatcher) if kind == "continuous"
                  else (jserve.WaveBatcher, tserve.WaveBatcher))
    kw = dict(slots=3, max_len=32, max_new_tokens=6, prefill_chunk=chunk)
    jb, tb = jcls(jcfg, jp, **kw), tcls(tcfg, tp, **kw)
    want, got = jb.run(prompts, new_tokens=budgets), tb.run(prompts, new_tokens=budgets)
    assert got == want
    assert all(len(got[i]) == budgets[i] for i in range(7))
    assert tb.steps == jb.steps and tb.all_logits_finite()


def test_hot_swap_drains_in_flight_requests(pair):
    _, _, cfg, params = pair
    store = ParamStore(params)
    prompts = _prompts(cfg, 8, seed=5)
    published = []

    def churn(step):
        if step in (3, 9):          # identical params, fresh versions
            published.append(store.publish(params))

    batcher = tserve.ContinuousBatcher(cfg, params, slots=3, max_len=32, max_new_tokens=4,
                                       param_store=store, on_step=churn)
    out = batcher.run(prompts)
    assert len(out) == len(prompts)            # zero drops
    assert len(published) == 2 and batcher.swaps >= 1
    for rid in range(len(prompts)):
        assert batcher.admission_version[rid] == batcher.completion_version[rid]
    assert batcher._version == store.version
    baseline = tserve.ContinuousBatcher(cfg, params, slots=3, max_len=32, max_new_tokens=4)
    assert out == baseline.run(prompts)


def test_entry_points_on_the_cpu(capsys):
    tserve.main(["--arch", "h2o-danube-1.8b", "--device", "cpu", "--new-tokens", "3"])
    tserve.main(["--arch", "llama3.2-1b", "--device", "cpu", "--continuous",
                 "--new-tokens", "2"])
    out = capsys.readouterr().out
    assert "[serve] h2o-danube-1.8b" in out and "[serve-cb] llama3.2-1b" in out
    if not torch.cuda.is_available():          # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--arch", "llama3.2-1b"])
