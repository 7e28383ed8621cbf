"""Serving launcher of the port: batched greedy decode (prefill + decode-step
loop) and a slot-scheduled continuous-batching engine (per-row decode
positions: requests are admitted into free slots as earlier ones finish).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --full \
      --batch 4 --prompt-len 2048 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --continuous

Runs on the card unless ``--device cpu`` is given; ``--full`` serves the
architecture at its published width (bf16), else its ``reduced()`` form.
Prefill and prefill chunks go through the flash-attention kernel (the
config's ``attn_impl``); decode steps attend through the plain einsum path,
as in the JAX package.

The ``ContinuousBatcher`` is the JAX package's: ``slots`` batch rows each
carrying its own position, requests admitted from a deque the step a slot
frees, prompts consumed by chunked prefill (``prefill_chunk`` writes C
prompt tokens per call at a shared host offset, and the rows not in the
chunk get their cache segment back), the tail (< C tokens plus the last
prompt token) on the decode path. A prompt of length P costs
``(P-1)//C`` chunk calls and ``P - C*((P-1)//C)`` decode steps. A
``ParamStore`` publication drains: the batcher stops admitting, finishes
every in-flight request on the params it was admitted under, swaps, and
resumes, with zero requests dropped.
"""

from __future__ import annotations

import argparse
import collections
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import device as device_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import registry, transformer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ContinuousBatcher:
    """Slot-scheduled continuous batching over per-row decode positions.

    Each of ``slots`` batch rows carries its own position; finished rows are
    immediately re-filled with the next queued request. Attention rows mask
    themselves by their own valid length, so rows never see each other's
    cache; a slot admitted in a step is zeroed by one batched masked reset.

    ``param_store`` (optional) wires hot-swap: a version change drains the
    in-flight slots on their admission-time params before the swap is taken.
    ``on_step(step)`` runs after every decode step. ``all_logits_finite()``
    says whether every decode step's logits were finite (kept on the
    device, read once).
    """

    def __init__(self, cfg, params, *, slots: int, max_len: int,
                 max_new_tokens: int, param_store=None,
                 prefill_chunk: int = 8, on_step=None, impl=None):
        if cfg.encoder_only:
            raise ValueError("encoder-only arch has no decode step")
        self.cfg, self.impl = cfg, impl
        self.slots, self.max_len = slots, max_len
        self.max_new = max_new_tokens
        self.on_step = on_step
        self._store = param_store
        if param_store is not None:
            snap = param_store.get()
            self.params, self._version = snap.params, snap.version
        else:
            self.params, self._version = params, 0
        # The ring cache's S>1 write path cannot exceed the ring, so chunked
        # prefill is only safe on the full-length cache layout.
        self._chunk = (prefill_chunk
                       if prefill_chunk and prefill_chunk > 1
                       and not cfg.swa_ring_cache else 0)
        self.swaps = 0                  # drain-and-swap cycles taken
        self.steps = 0                  # decode steps issued
        self.admission_version: dict[int, int] = {}
        self.completion_version: dict[int, int] = {}
        self._finite = None

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["w"].device

    def all_logits_finite(self) -> bool:
        return self._finite is None or bool(self._finite)

    # -- cache updates -------------------------------------------------------

    @staticmethod
    def _reset(cache: dict, mask: torch.Tensor) -> None:
        """Zero the cache rows of the slots in ``mask`` (batch is axis 1)."""
        for a in cache.values():
            a[:, mask] = 0

    def _masked_chunk(self, cache: dict, toks: torch.Tensor, start: int,
                      rows: np.ndarray) -> None:
        """Prefill one chunk at ``start`` for the slots in ``rows``; the
        other slots keep their cache segment verbatim."""
        C = toks.shape[1]
        keep = torch.from_numpy(~rows).to(self.device)
        saved = {k: a[:, keep, start:start + C].clone() for k, a in cache.items()}
        transformer.prefill_chunk(self.params, toks, start, cfg=self.cfg, cache=cache,
                                  impl=self.impl, with_logits=False)
        for k, a in cache.items():
            a[:, keep, start:start + C] = saved[k]

    # -- scheduling policy ---------------------------------------------------

    def _admissible(self, active: np.ndarray) -> list[int]:
        """Slots the scheduler may fill this step (continuous: any free
        slot, immediately)."""
        return [s for s in range(self.slots) if not active[s]]

    # -- engine --------------------------------------------------------------

    def run(self, prompts: list[np.ndarray],
            new_tokens: list[int] | None = None) -> dict[int, list[int]]:
        """Serve every prompt to completion; returns request id -> emitted
        greedy tokens. ``new_tokens`` optionally caps each request's budget
        individually (a ragged stream); defaults to ``max_new_tokens``."""
        cfg, dev = self.cfg, self.device
        budgets = (list(new_tokens) if new_tokens is not None
                   else [self.max_new] * len(prompts))
        cache = transformer.init_cache(cfg, self.slots, self.max_len, device=dev)
        queue = collections.deque(enumerate(prompts))
        slot_req = [-1] * self.slots          # request id per slot
        slot_prompt: list[np.ndarray | None] = [None] * self.slots
        pos = np.zeros(self.slots, np.int64)  # next write position per slot
        emitted: dict[int, list[int]] = {}
        next_tok = np.zeros((self.slots, 1), np.int64)
        active = np.zeros(self.slots, bool)
        draining = False

        def admit():
            admitted = []
            for s in self._admissible(active):
                if not queue:
                    break
                rid, prompt = queue.popleft()
                slot_req[s], slot_prompt[s] = rid, prompt
                emitted[rid] = []
                self.admission_version[rid] = self._version
                active[s] = True
                admitted.append(s)
            if not admitted:
                return
            mask = np.zeros(self.slots, bool)
            mask[admitted] = True
            self._reset(cache, torch.from_numpy(mask).to(dev))
            C = self._chunk
            nfull = {s: ((len(slot_prompt[s]) - 1) // C if C else 0)
                     for s in admitted}
            for k in range(max(nfull.values(), default=0)):
                rows = [s for s in admitted if nfull[s] > k]
                toks = np.zeros((self.slots, C), np.int64)
                for s in rows:
                    toks[s] = slot_prompt[s][k * C:(k + 1) * C]
                cmask = np.zeros(self.slots, bool)
                cmask[rows] = True
                # Same-step admissions share chunk starts (all begin at 0),
                # so chunk k is ONE batched call at offset k*C.
                self._masked_chunk(cache, torch.from_numpy(toks).to(dev), k * C, cmask)
            for s in admitted:
                pos[s] = nfull[s] * C
                next_tok[s, 0] = slot_prompt[s][pos[s]]

        while queue or active.any():
            if self._store is not None and self._store.version != self._version:
                draining = True     # stop admitting, finish in-flight slots
            if draining and not active.any():
                snap = self._store.get()
                self.params, self._version = snap.params, snap.version
                self.swaps += 1
                draining = False
            if not draining:
                admit()
            if not active.any():
                continue            # drained (or queue raced empty)

            logits, cache = transformer.decode_step(
                self.params, torch.from_numpy(next_tok).to(dev),
                torch.from_numpy(pos).to(dev), cfg=cfg, cache=cache, impl=self.impl)
            finite = torch.isfinite(logits).all()
            self._finite = finite if self._finite is None else self._finite & finite
            greedy = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
            self.steps += 1
            for s in range(self.slots):
                if not active[s]:
                    continue
                rid, prompt = slot_req[s], slot_prompt[s]
                pos[s] += 1
                if pos[s] < len(prompt):          # prompt tail as decode
                    next_tok[s, 0] = prompt[pos[s]]
                    continue
                emitted[rid].append(int(greedy[s]))
                done = (len(emitted[rid]) >= budgets[rid]
                        or pos[s] + 1 >= self.max_len)
                if done:
                    self.completion_version[rid] = self._version
                    active[s] = False
                else:
                    next_tok[s, 0] = greedy[s]
            if self.on_step is not None:
                self.on_step(self.steps)
        return emitted


class WaveBatcher(ContinuousBatcher):
    """Wave-coalescing baseline on the same engine: admission waits for the
    batch-wide barrier (every slot free), so each wave quantizes to its
    slowest member. Chunked prefill, masked resets and the step are those
    of :class:`ContinuousBatcher`; only the scheduling differs."""

    def _admissible(self, active: np.ndarray) -> list[int]:
        if active.any():
            return []               # the barrier: no refills mid-wave
        return list(range(self.slots))


class Generation(NamedTuple):
    tokens: torch.Tensor      # (batch, new_tokens) greedy tokens
    prefill_s: float          # host seconds of the prefill, to its device end
    decode_s: float           # host seconds of the new_tokens - 1 decode steps
    finite: bool              # every prefill logit was finite


def generate(cfg, params, prompt: torch.Tensor, new_tokens: int,
             impl=None) -> Generation:
    """Greedy decode of ``prompt`` (B, P): one prefill through ``impl``,
    then ``new_tokens - 1`` serve steps against a ``P + new_tokens`` cache
    (one query row: plain attention whatever ``impl`` says)."""
    dev = prompt.device
    B, P = prompt.shape
    cache = transformer.init_cache(cfg, B, P + new_tokens, device=dev)
    serve_step = steps_lib.make_serve_step(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(params, prompt, cfg=cfg, cache=cache, impl=impl)
    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits[:, -1:], dim=-1)
    del logits
    _sync(dev)
    t1 = time.perf_counter()
    out = [tok]
    for i in range(new_tokens - 1):
        tok, cache = serve_step(params, cache, tok, P + i)
        out.append(tok)
    tokens = torch.cat(out, dim=1)
    _sync(dev)
    return Generation(tokens, t1 - t0, time.perf_counter() - t1, bool(finite))


def _model(arch: str, reduced: bool, device, seed: int):
    cfg = registry.get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cfg.encoder_only:
        raise SystemExit(f"{arch} is encoder-only: no decode step")
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return cfg, transformer.init(cfg, gen, dev), gen


def serve(arch: str, batch: int, prompt_len: int, new_tokens: int,
          reduced: bool = True, *, device="cuda", seed: int = 0,
          impl=None) -> Generation:
    """Random params and a random prompt from ``seed``, greedy decode."""
    cfg, params, gen = _model(arch, reduced, device, seed)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                           device=gen.device)
    res = generate(cfg, params, prompt, new_tokens, impl=impl)
    print(f"[serve] {arch}: {batch} seqs: prefill {batch * prompt_len} tokens in "
          f"{res.prefill_s:.3f}s ({batch * prompt_len / res.prefill_s:.1f} tok/s), "
          f"decode {batch * (new_tokens - 1)} tokens in {res.decode_s:.3f}s "
          f"({batch * (new_tokens - 1) / max(res.decode_s, 1e-9):.1f} tok/s)")
    print(f"[serve] first sequence: {res.tokens[0].tolist()}")
    return res


class ContinuousRun(NamedTuple):
    emitted: dict             # request id -> greedy tokens
    steps: int                # decode steps issued
    seconds: float            # host seconds of the run, to its device end
    finite: bool              # every decode step's logits were finite


def serve_continuous(arch: str, requests: int = 8, slots: int = 4,
                     new_tokens: int = 8, reduced: bool = True, *,
                     device="cuda", seed: int = 0, impl=None,
                     prompt_len: tuple[int, int] = (4, 12), max_len: int = 64,
                     chunk: int = 8) -> ContinuousRun:
    """Ragged requests (lengths drawn from ``[prompt_len[0], prompt_len[1])``
    with a numpy generator seeded by ``seed``) through a ContinuousBatcher."""
    cfg, params, _ = _model(arch, reduced, device, seed)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(*prompt_len))
               for _ in range(requests)]
    batcher = ContinuousBatcher(cfg, params, slots=slots, max_len=max_len,
                                max_new_tokens=new_tokens, prefill_chunk=chunk,
                                impl=impl)
    dev = batcher.device
    _sync(dev)
    t0 = time.perf_counter()
    out = batcher.run(prompts)
    _sync(dev)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    print(f"[serve-cb] {arch}: {requests} ragged requests on {slots} slots "
          f"-> {total} tokens in {dt:.2f}s ({batcher.steps} steps)")
    return ContinuousRun(out, batcher.steps, dt, batcher.all_logits_finite())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_IDS, required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching scheduler demo")
    ap.add_argument("--full", action="store_true",
                    help="the published width, bf16 (else reduced(), f32)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.continuous:
        serve_continuous(args.arch, new_tokens=args.new_tokens, reduced=not args.full,
                         device=args.device, seed=args.seed)
    else:
        serve(args.arch, args.batch, args.prompt_len, args.new_tokens,
              reduced=not args.full, device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
