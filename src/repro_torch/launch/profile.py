"""Where the time of one lockstep Ape-X DQN iteration goes, on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile [--full] [--iterations 2]

Warms up until the learner runs, times ``--iterations`` more calls of the
trainer's own ``step_fn`` on the host clock (a synchronize after each), then
traces as many again with ``torch.profiler``. The trace splits each
iteration by the phase spans of ``core/apex.py`` (``apex.PHASE_SPANS``):
host ms is the span's wall time, device ms the time of the kernels launched
inside it. The tracer slows the host, so the device's busy share is the
traced kernel time over the untraced iteration's wall time. Prints one
JSON object.
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--iterations", type=int, default=2)
    args = ap.parse_args(argv)
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
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in apex.PHASE_SPANS]
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
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
        "top_device_kernels": [{"name": e.key[:80], "calls": e.count,
                                "device_ms": e.self_device_time_total / 1e3}
                               for e in top]}))


if __name__ == "__main__":
    main()
