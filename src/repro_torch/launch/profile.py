"""Where the time of one lockstep Ape-X DQN iteration goes, on the card,
or (``--serve``) the time of the serving path's calls.

  PYTHONPATH=src python -m repro_torch.launch.profile [--full] [--iterations 2]
  PYTHONPATH=src python -m repro_torch.launch.profile --serve [--full]

Warms up until the learner runs, times ``--iterations`` more calls of the
trainer's own ``step_fn`` on the host clock (a synchronize after each), then
traces as many again with ``torch.profiler``. The trace splits each
iteration by the phase spans of ``core/apex.py`` (``apex.PHASE_SPANS``):
host ms is the span's wall time, device ms the time of the kernels launched
inside it. The tracer slows the host, so the device's busy share is the
traced kernel time over the untraced iteration's wall time. Prints one
JSON object.

``--serve`` does the same for llama3.2-1b (``--full``: the published
width, bf16): one prefill of 4 x 2048 tokens, decode steps of ``serve``
at batch 4, and a ``ContinuousBatcher`` run (8 slots, 8 requests of 300
tokens, chunk 256, 8 new tokens), each timed untraced and then traced:
wall ms, device kernel ms, busy share, launches and the top kernels.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import apex


def device_events(prof) -> list:
    """The traced kernels and copies on the card, without the device-side
    copies of the phase spans (which ``record_function`` adds)."""
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name not in apex.PHASE_SPANS]


def phase_breakdown(prof, iterations: int) -> dict:
    """Per-iteration host ms, device ms and calls of each phase span. Host
    ms is the span's wall time on the host; device ms the time of the
    kernels that start inside the span's window on the device timeline,
    which is how kernels launched through ``ctypes`` are counted too."""
    out = {name: {"host_ms": 0.0, "device_ms": 0.0, "calls": 0}
           for name in apex.PHASE_SPANS}
    windows = []
    for e in prof.events():
        if e.name in out and e.device_type == DeviceType.CPU:
            out[e.name]["host_ms"] += e.cpu_time_total / 1e3
            out[e.name]["calls"] += 1
        elif e.name in out:
            windows.append((e.time_range.start, e.time_range.end, e.name))
    for k in device_events(prof):
        for start, end, name in windows:
            if start <= k.time_range.start <= end:
                out[name]["device_ms"] += k.time_range.elapsed_us() / 1e3
                break
    return {name: {k: v / iterations for k, v in p.items()} for name, p in out.items()}


def top_kernels(prof, n: int = 12) -> list:
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in apex.PHASE_SPANS]
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:n]
    return [{"name": e.key[:80], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
            for e in top]


def trace_call(fn, calls: int) -> dict:
    """``fn`` run ``calls`` times untimed (warm-up), timed on the host clock,
    then traced; per-call wall ms, device kernel ms and launches."""
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / calls
    return {"calls": calls, "wall_ms": wall_ms, "device_kernel_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "device_events_per_call": len(events) / calls, "top_device_kernels": top_kernels(prof)}


def profile_serving(full: bool) -> dict:
    import numpy as np

    from repro_torch.launch import serve, steps
    from repro_torch.models import registry, transformer

    cfg = registry.get_config("llama3.2-1b")
    cfg = cfg if full else cfg.reduced()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = transformer.init(cfg, gen, "cuda")
    B, P = 4, 2048 if full else 128
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    cache = transformer.init_cache(cfg, B, P + 64, "cuda")
    out = {"prefill": trace_call(
        lambda: transformer.prefill(params, prompt, cfg=cfg, cache=cache), 2)}
    step = steps.make_serve_step(cfg)
    tok = prompt[:, -1:]
    out["serve_decode_step"] = trace_call(lambda: step(params, cache, tok, P), 8)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=300) for _ in range(8)]
    batcher = serve.ContinuousBatcher(cfg, params, slots=8, max_len=320, max_new_tokens=8,
                                      prefill_chunk=256)
    run = trace_call(lambda: batcher.run(prompts), 1)
    steps_per_run = batcher.steps // 3                     # warm-up, timed, traced
    run["decode_steps_per_run"] = steps_per_run
    run["wall_ms_per_decode_step"] = run["wall_ms"] / steps_per_run
    out["continuous_run"] = run
    return {"arch": cfg.arch_id, "full": full, "device": torch.cuda.get_device_name(0), **out}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--serve", action="store_true",
                    help="profile the LLM serving path instead of the trainer")
    args = ap.parse_args(argv)
    if args.serve:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(profile_serving(args.full)))
        return
    from repro_torch.configs import apex_dqn
    preset = apex_dqn.full() if args.full else apex_dqn.reduced()
    init_fn, step_fn = apex.make_train_fn(preset.apex, preset.env, preset.agent,
                                          preset.make_optimizer())
    state = init_fn(0)
    while True:                                          # warm up into the learner
        state, metrics = step_fn(state)
        if metrics["updated"]:
            break
    torch.cuda.synchronize()
    wall_ms = 0.0
    for _ in range(args.iterations):
        t0 = time.perf_counter()
        state, _ = step_fn(state)
        torch.cuda.synchronize()
        wall_ms += (time.perf_counter() - t0) * 1e3 / args.iterations

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iterations):
            state, _ = step_fn(state)
        torch.cuda.synchronize()
    phases = phase_breakdown(prof, args.iterations)
    events = device_events(prof)
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / args.iterations
    print(json.dumps({
        "preset": "full" if args.full else "reduced",
        "device": torch.cuda.get_device_name(0),
        "iterations": args.iterations,
        "iteration_wall_ms": wall_ms,
        "phases": phases,
        "device_kernel_ms_per_iteration": device_ms,
        "device_ms_outside_phase_spans": device_ms - sum(p["device_ms"]
                                                         for p in phases.values()),
        "device_busy_share": device_ms / wall_ms,
        "device_events_per_iteration": len(events) / args.iterations,
        "top_device_kernels": top_kernels(prof)}))


if __name__ == "__main__":
    main()
