#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, then:

1. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at small adversarial shapes, and times both;
2. drives the main path (the lockstep Ape-X DQN trainer,
   ``repro_torch.core.apex.make_train_fn``) at full width,
   ``configs/apex_dqn.full(num_shards=1)``, for 8 iterations, checking after
   each that the kernels launched, that the replay size and the tree's root
   agree with its leaves and that the loss is finite;
3. runs the reduced preset for 60 iterations, through FIFO wrap-around,
   eviction (every 50 learner steps) and the target sync at step 100;
4. runs one reduced iteration on the kernels and one on the plain versions
   from the same seed, and compares what comes out.

Prints a ``kernels`` JSON line, the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result; so does a machine without a
card, or a directory that holds this script and nothing else of the repo.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tree_traffic(slots: torch.Tensor, cap: int) -> tuple[int, int]:
    """(bytes, adds) a sum-tree write of these clipped slots needs: each
    touched node written once, each untouched sibling read once, one add
    per touched internal node."""
    nodes = torch.unique(slots.long() + cap)
    written, reads, adds = nodes.numel(), 0, 0
    for _ in range(cap.bit_length() - 1):
        parents = torch.unique(nodes >> 1)
        reads += 2 * parents.numel() - nodes.numel()
        written += parents.numel()
        adds += parents.numel()
        nodes = parents
    return 4 * (written + reads), adds


def random_tree(cap: int, gen: torch.Generator, zero_frac: float = 0.1) -> torch.Tensor:
    from repro_torch.core import sumtree
    leaves = torch.rand((cap,), generator=gen, device="cuda") + 1e-3
    leaves[torch.rand((cap,), generator=gen, device="cuda") < zero_frac] = 0.0
    return sumtree.rebuild(leaves)


def max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    ia, ib = a.contiguous().view(torch.int32).long(), b.contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max()) if a.numel() else 0


# ---------------------------------------------------------------------------
# Phase 1: every kernel against its plain version
# ---------------------------------------------------------------------------

def check_sumtree_update(gen) -> dict:
    from repro_torch.core import sumtree
    from repro_torch.kernels.sumtree_update import ops, ref

    worst = {"err": 0.0}

    def agree(cap, idx, values, what):
        tree = random_tree(cap, gen)
        got = ops.sumtree_update(tree.clone(), idx, values)
        want = ref.sumtree_update_ref(tree.clone(), idx, values)
        worst["err"] = max(worst["err"], float((got - want).abs().max()))
        check(torch.equal(got, want), f"sumtree_update {what}: trees differ")
        check(torch.equal(got, sumtree.rebuild(sumtree.leaves(got))),
              f"sumtree_update {what}: sum invariant broken")

    # adversarial: duplicates, ids in [-C, -1], ids C and 2C and < -C, a
    # batch that is not a multiple of the block size
    cap = 64
    idx = torch.randint(-cap, cap, (300,), generator=gen, device="cuda", dtype=torch.int32)
    idx[:6] = torch.tensor([cap, 2 * cap, -cap - 1, -1, -cap, 5], dtype=torch.int32)
    idx[6:9] = 5
    agree(cap, idx, torch.rand((300,), generator=gen, device="cuda"), "adversarial")
    agree(2, torch.tensor([0, 1, 1, -2, 2], dtype=torch.int32, device="cuda"),
          torch.rand((5,), generator=gen, device="cuda"), "capacity 2")

    # the main path: set_priorities at B=512, and the ingest's B=22,320
    cap = 1 << 21
    idx = torch.randint(0, cap, (512,), generator=gen, device="cuda", dtype=torch.int32)
    idx[100:110] = idx[0]
    values = torch.rand((512,), generator=gen, device="cuda")
    agree(cap, idx, values, "B=512")
    fifo = ((cap - 1000 + torch.arange(22_320, device="cuda")) % cap).to(torch.int32)
    agree(cap, fifo, torch.rand((22_320,), generator=gen, device="cuda"), "B=22320")

    tree = random_tree(cap, gen)
    ms = time_ms(lambda: ops.sumtree_update(tree, idx, values), 200)
    plain_ms = time_ms(lambda: ref.sumtree_update_ref(tree, idx, values), 20)
    nbytes, adds = tree_traffic(idx, cap)
    b_ms, b_by = bound_ms(nbytes + 8 * idx.numel(), adds)
    return {"max_abs_err": worst["err"], "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def check_sumtree_sample(gen) -> dict:
    from repro_torch.core import sumtree
    from repro_torch.kernels.sumtree_sample import ops, ref

    worst = {"err": 0.0}

    def agree(tree, u, what):
        idx, mass = ops.sumtree_sample_with_mass(tree, u)
        want_idx, want_mass = ref.sumtree_sample_with_mass_ref(tree, u)
        worst["err"] = max(worst["err"], float((idx - want_idx).abs().max()),
                           float((mass - want_mass).abs().max()))
        check(torch.equal(idx, want_idx), f"sumtree_sample {what}: ids differ")
        check(torch.equal(mass, want_mass), f"sumtree_sample {what}: masses differ")
        check(torch.equal(mass, sumtree.leaves(tree)[idx.long()]),
              f"sumtree_sample {what}: mass is not the leaf")

    # adversarial: offsets on exact prefix-sum boundaries, 0, past the total
    cap = 64
    tree = random_tree(cap, gen, zero_frac=0.3)
    prefix = torch.cumsum(sumtree.leaves(tree), 0)
    u = torch.cat([prefix, torch.tensor([0.0, float(tree[1]) * 2, -1.0], device="cuda"),
                   torch.rand((200,), generator=gen, device="cuda") * tree[1]])
    agree(tree, u, "adversarial")

    cap, batch = 1 << 21, 512
    tree = random_tree(cap, gen)
    u = sumtree.stratified_uniforms(gen, batch, sumtree.total(tree))
    agree(tree, u, "B=512")

    ms = time_ms(lambda: ops.sumtree_sample_with_mass(tree, u), 200)
    plain_ms = time_ms(lambda: ref.sumtree_sample_with_mass_ref(tree, u), 20)
    # nodes this run's descent reads: each level's left children, and the leaf
    node, uu, read = torch.ones((batch,), dtype=torch.int64, device="cuda"), u.clone(), 0
    for _ in range(sumtree.depth(tree)):
        left = 2 * node
        read += torch.unique(left).numel()
        lm = tree[left]
        go = uu < lm
        node, uu = torch.where(go, left, left + 1), torch.where(go, uu, uu - lm)
    read += torch.unique(node).numel()
    b_ms, b_by = bound_ms(4 * read + 12 * batch, 2 * batch * sumtree.depth(tree))
    return {"max_abs_err": worst["err"], "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def make_storage(cap: int, gen) -> dict:
    r = lambda *s: torch.rand(s, generator=gen, device="cuda")  # noqa: E731
    return {"obs": (r(cap, 66) * 255).to(torch.uint8),
            "action": (r(cap) * 4).to(torch.int32),
            "returns": r(cap), "discount_n": r(cap),
            "next_obs": (r(cap, 66) * 255).to(torch.uint8)}


def check_replay_ingest(gen) -> dict:
    from repro_torch.core import sumtree
    from repro_torch.kernels.replay_ingest import ops, ref

    worst = {"err": 0.0}

    def agree(cap, idx, prio, applied, what):
        B = idx.shape[0]
        tree, storage = random_tree(cap, gen), make_storage(cap, gen)
        items = make_storage(B, gen)
        clone = lambda s: {k: v.clone() for k, v in s.items()}  # noqa: E731
        got_tree, got = ops.replay_ingest(tree.clone(), clone(storage), idx, prio,
                                          applied, items)
        want_tree, want = ref.replay_ingest_ref(tree.clone(), clone(storage), idx, prio,
                                                applied, items)
        for k in storage:
            check(torch.equal(got[k], want[k]), f"replay_ingest {what}: storage {k} differs")
        lg, lw = sumtree.leaves(got_tree), sumtree.leaves(want_tree)
        check(max_ulp(lg, lw) <= 2, f"replay_ingest {what}: leaves differ by > 2 ulp")
        check(torch.equal(got_tree, sumtree.rebuild(lg)),
              f"replay_ingest {what}: tree is not its leaves' sums")
        worst["err"] = max(worst["err"], float((got_tree - want_tree).abs().max()))

    # adversarial: duplicate slots, masked lanes winning duplicates, earlier
    # applied lanes shadowed by them, ids in [-C, -1], C, 2C and < -C
    cap, B = 64, 300
    idx = torch.randint(-cap, cap, (B,), generator=gen, device="cuda", dtype=torch.int32)
    idx[:5] = torch.tensor([cap, 2 * cap, -cap - 1, -1, 7], dtype=torch.int32)
    idx[[10, 20, 30]] = 7                    # lane 30, masked below, wins slot 7
    applied = torch.rand((B,), generator=gen, device="cuda") < 0.7
    applied[[10, 20]], applied[30] = True, False
    prio = torch.randn((B,), generator=gen, device="cuda")
    prio[0:3] = torch.tensor([0.0, 1e-6, -2.0])
    agree(cap, idx, prio, applied, "adversarial")

    # the main path: one add_fifo block of 360 lanes x 62 = 22,320 rows,
    # wrapping past the end of the 2^21 slots
    cap, B = 1 << 21, 22_320
    idx = ((cap - 1000 + torch.arange(B, device="cuda")) % cap).to(torch.int32)
    prio = torch.rand((B,), generator=gen, device="cuda") * 2
    applied = torch.ones((B,), dtype=torch.bool, device="cuda")
    agree(cap, idx, prio, applied, "B=22320")

    tree, storage, items = random_tree(cap, gen), make_storage(cap, gen), make_storage(B, gen)
    ms = time_ms(lambda: ops.replay_ingest(tree, storage, idx, prio, applied, items), 100)
    plain_ms = time_ms(lambda: ref.replay_ingest_ref(tree, storage, idx, prio, applied,
                                                     items), 10)
    row = sum(v[0].numel() * v.element_size() for v in items.values())
    nbytes, adds = tree_traffic(idx, cap)
    b_ms, b_by = bound_ms(nbytes + B * (4 + 4 + 1) + 2 * B * row, adds)
    return {"max_abs_err": worst["err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def check_nstep_return(gen) -> dict:
    from repro_torch.kernels.nstep_return import ops, ref

    worst = 0.0
    for lanes, T, n in [(5, 3, 3), (7, 70, 3), (17, 9, 1), (360, 64, 3)]:
        reward = torch.rand((lanes, T), generator=gen, device="cuda")
        discount = torch.where(torch.rand((lanes, T), generator=gen, device="cuda") < 0.1,
                               0.0, 0.99)
        got = ops.nstep_return(reward, discount, n)
        want = ref.nstep_return_ref(reward, discount, n)
        for g, w in zip(got, want):
            check(g.shape == w.shape, f"nstep_return {lanes}x{T}: shape {g.shape}")
            err = float((g - w).abs().max())
            check(err <= 1e-6, f"nstep_return {lanes}x{T}: error {err} > 1e-6")
            worst = max(worst, err)
    ms = time_ms(lambda: ops.nstep_return(reward, discount, 3), 200)
    plain_ms = time_ms(lambda: ref.nstep_return_ref(reward, discount, 3), 200)
    W = T - 3 + 1
    b_ms, b_by = bound_ms(4 * (2 * lanes * T + 2 * lanes * W), 3 * 3 * lanes * W)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


# ---------------------------------------------------------------------------
# Phases 2-4: the main path
# ---------------------------------------------------------------------------

FULL_ITERATIONS = 8


class SteadyClock:
    """Host seconds of the trainer's iterations once its learner has run:
    each ``step_fn`` call until its device work ends, leaving out the
    iterations up to and including the first learner step (fill, autograd
    and cuBLAS start-up) and the checks between calls."""

    def __init__(self):
        self.seconds, self.iterations = 0.0, 0

    @contextlib.contextmanager
    def time(self, state):
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        if state.learner_step > 0:
            self.seconds += time.perf_counter() - t0
            self.iterations += 1

    def rate(self) -> float:
        check(self.iterations > 0, "no iteration ran after the first learner step")
        return self.iterations / self.seconds


def check_replay_consistent(state, what: str) -> None:
    from repro_torch.core import sumtree
    leaves = sumtree.leaves(state.replay.tree)
    live = int((leaves > 0).sum())
    check(live == state.replay.size, f"{what}: {live} live leaves, size {state.replay.size}")
    root, total = float(state.replay.tree[1]), float(leaves.double().sum())
    check(math.isclose(root, total, rel_tol=1e-4), f"{what}: root {root} != leaf sum {total}")


def run_full(kernels) -> tuple[dict, float]:
    from repro_torch.configs import apex_dqn
    from repro_torch.core import apex

    preset = apex_dqn.full(num_shards=1)
    cfg = preset.apex
    init_fn, step_fn = apex.make_train_fn(cfg, preset.env, preset.agent,
                                          preset.make_optimizer(), device="cuda")
    state = init_fn(0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    prev, learned, steady = kernels.launch_counts(), 0, SteadyClock()
    for it in range(FULL_ITERATIONS):
        with steady.time(state):
            state, m = step_fn(state)
        counts = kernels.launch_counts()
        grew = {k: counts[k] > prev[k] for k in counts}
        check(grew["replay_ingest"] and grew["nstep_return"],
              f"full iteration {it}: act/add kernels did not launch: {counts}")
        block = cfg.lanes_per_shard * cfg.window
        check(state.replay.size == min(block * (it + 1), cfg.replay.capacity),
              f"full iteration {it}: replay size {state.replay.size}")
        check_replay_consistent(state, f"full iteration {it}")
        if m["updated"]:
            learned += 1
            check(grew["sumtree_sample"] and grew["sumtree_update"],
                  f"full iteration {it}: learner kernels did not launch: {counts}")
            check(math.isfinite(float(m["loss"])), f"full iteration {it}: loss {m['loss']}")
        prev = counts
    counts = kernels.launch_counts()
    check(learned >= 2 and state.learner_step == 2 * learned,
          f"full: learner ran {learned} iterations, step {state.learner_step}")
    check(all(v > 0 for v in counts.values()), f"full: a kernel never launched: {counts}")
    return counts, steady.rate()


def run_reduced(kernels) -> float:
    from repro_torch.configs import apex_dqn
    from repro_torch.core import apex

    preset = apex_dqn.reduced()
    cfg = preset.apex
    init_fn, step_fn = apex.make_train_fn(cfg, preset.env, preset.agent,
                                          preset.make_optimizer(), device="cuda")
    state = init_fn(1)
    kernels.reset_launch_counts()
    evicted = synced = False
    steady = SteadyClock()
    for it in range(60):
        with steady.time(state):
            state, m = step_fn(state)
        check(math.isfinite(float(m["loss"])), f"reduced iteration {it}: loss {m['loss']}")
        if state.learner_step == cfg.evict_interval:
            check(state.replay.size == cfg.replay.soft_cap,
                  f"reduced: size {state.replay.size} after eviction")
            evicted = True
        if state.learner_step == cfg.target_update_period:
            same = all(torch.equal(state.params[k][w], state.target_params[k][w])
                       for k in state.params for w in state.params[k])
            check(same, "reduced: target params not synced at step 100")
            synced = True
    check_replay_consistent(state, "reduced")
    check(evicted and synced, f"reduced: evicted={evicted} synced={synced}")
    check(state.replay.total_added > cfg.replay.capacity, "reduced: FIFO never wrapped")
    counts = kernels.launch_counts()
    check(all(v > 0 for v in counts.values()), f"reduced: a kernel never launched: {counts}")
    return steady.rate()


def run_agreement() -> None:
    """One reduced iteration on the kernels, one on the plain versions, from
    the same seed: the generator's draws are the same on both paths."""
    from repro_torch.configs import apex_dqn
    from repro_torch.core import apex, sumtree

    preset = apex_dqn.reduced()
    out = {}
    for bk in ("cuda", "torch"):
        sumtree.set_backend(bk)
        init_fn, step_fn = apex.make_train_fn(preset.apex, preset.env, preset.agent,
                                              preset.make_optimizer(), device="cuda")
        out[bk] = step_fn(init_fn(7))
    sumtree.set_backend(None)
    (sk, mk), (sp, mp) = out["cuda"], out["torch"]
    for k in ("obs", "next_obs", "action"):
        check(torch.equal(sk.replay.storage[k], sp.replay.storage[k]), f"agreement: {k}")
    for k in ("returns", "discount_n"):
        err = float((sk.replay.storage[k] - sp.replay.storage[k]).abs().max())
        check(err <= 1e-6, f"agreement: {k} error {err}")
    check(torch.allclose(sk.replay.tree, sp.replay.tree, rtol=1e-5, atol=0),
          "agreement: trees differ beyond 1e-5")
    check(mk["updated"] == mp["updated"] == 1.0, "agreement: learner did not run")
    check(math.isclose(float(mk["loss"]), float(mp["loss"]), rel_tol=1e-4),
          f"agreement: loss {float(mk['loss'])} vs {float(mp['loss'])}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    for name, log in _build.build().items():
        print(f"[build] {name}:\n{log}", file=sys.stderr)
    print(f"[build] {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = {"sumtree_update": check_sumtree_update(gen),
               "sumtree_sample": check_sumtree_sample(gen),
               "replay_ingest": check_replay_ingest(gen),
               "nstep_return": check_nstep_return(gen)}
    print(f"[phase 1] kernels agree with their plain versions "
          f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr)

    launches, full_its = run_full(kernels)
    print(f"[phase 2] full width: {full_its:.3f} steady it/s, launches {launches}", file=sys.stderr)
    red_its = run_reduced(kernels)
    print(f"[phase 3] reduced: {red_its:.3f} steady it/s", file=sys.stderr)
    run_agreement()
    print(f"[phase 4] kernels and plain versions agree end to end "
          f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr)

    meta = {
        "sumtree_update": ("cuda", "src/repro_torch/csrc/sumtree_update.cu",
                           "src/repro/kernels/sumtree_update/kernel.py:101"),
        "sumtree_sample": ("cuda", "src/repro_torch/csrc/sumtree_sample.cu",
                           "src/repro/kernels/sumtree_sample/kernel.py:55"),
        "replay_ingest": ("cuda", "src/repro_torch/csrc/replay_ingest.cu",
                          "src/repro/kernels/replay_ingest/kernel.py:138"),
        "nstep_return": ("triton", "src/repro_torch/kernels/nstep_return/kernel.py",
                         "src/repro/kernels/nstep_return/kernel.py:37"),
    }
    rows = [{"name": name, "route": route, "source": source, "replaces": replaces,
             "launches": launches[name], **results[name], "library_ms": None}
            for name, (route, source, replaces) in meta.items()]
    print(json.dumps({"full_steady_iterations_per_s": full_its,
                      "reduced_steady_iterations_per_s": red_its,
                      "peak_memory_bytes": torch.cuda.max_memory_allocated()}))
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
