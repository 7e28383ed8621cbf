"""Step functions of the port's LLM side, as in the JAX package's
``launch/steps.py``:

* ``score_step`` — the Ape-X *actor* role at prefill shape: forward the
                   batch under (stale) params and emit initial priorities
                   (Alg. 1 line 10).
* ``serve_step`` — one-token greedy decode against a cache.

The learner's ``train_step`` comes with the training slice.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models import transformer


def _per_sequence_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sequence mean NLL over the labels >= 0. The correct-class logit
    is gathered (the JAX package takes a one-hot masked sum, which exists
    for vocab sharding; the value is the same). One sequence at a time, so
    no second (B, S, vocab) tensor lives beside the logits."""
    out = []
    for lg, lb in zip(logits, labels):
        mask = (lb >= 0).float()
        lg32 = lg.float()
        logz = torch.logsumexp(lg32, dim=-1)
        correct = lg32.gather(-1, lb.clamp(min=0).long()[:, None])[:, 0]
        nll = (logz - correct) * mask
        out.append(nll.sum() / torch.clamp(mask.sum(), min=1.0))
    return torch.stack(out)


def make_score_step(cfg) -> Callable:
    def score_step(params: Any, batch: dict) -> torch.Tensor:
        logits = transformer.apply(params, batch["tokens"], cfg=cfg)
        return _per_sequence_nll(logits, batch["labels"])   # initial priorities

    return score_step


def make_serve_step(cfg) -> Callable:
    def serve_step(params: Any, cache: Any, token: torch.Tensor, pos):
        logits, cache = transformer.decode_step(params, token, pos, cfg=cfg, cache=cache)
        next_token = torch.argmax(logits[:, -1], dim=-1)
        return next_token[:, None], cache

    return serve_step
