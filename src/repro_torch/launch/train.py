"""Training launcher of the port: the lockstep Ape-X DQN trainer.

  PYTHONPATH=src python -m repro_torch.launch.train --mode apex-dqn --iterations 200
  PYTHONPATH=src python -m repro_torch.launch.train --mode apex-dqn --full --iterations 20

Runs on the card; ``--device cpu`` runs the same path on the CPU with the
kernels' plain versions. The async runtime, the DPG mode and the LLM mode
come with later slices of the port.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import apex


def run_apex(preset, iterations: int, log_every: int, device="cuda", seed: int = 0):
    """Run ``iterations`` lockstep iterations; print one JSON line every
    ``log_every``. Returns the final state."""
    optimizer = preset.make_optimizer()
    init_fn, step_fn = apex.make_train_fn(preset.apex, preset.env, preset.agent,
                                          optimizer, device=device)
    state = init_fn(seed)
    t0 = time.perf_counter()
    for it in range(iterations):
        state, metrics = step_fn(state)
        if (it + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}   # sync: logging only
            dt = time.perf_counter() - t0
            print(json.dumps({
                "iter": it + 1, "frames": state.frames, "size": state.replay.size,
                "learner_step": state.learner_step, "fps": state.frames / dt,
                "ret": m["mean_ep_return"], "loss": m["loss"]}), flush=True)
    return state


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("apex-dqn",), default="apex-dqn")
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--full", action="store_true",
                    help="paper-scale preset (2^21-slot replay, 360 lanes, batch 512)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.iterations < 1:
        raise SystemExit(f"--iterations must be >= 1, got {args.iterations}")
    from repro_torch.configs import apex_dqn
    preset = apex_dqn.full() if args.full else apex_dqn.reduced()
    torch.backends.cuda.matmul.allow_tf32 = False
    run_apex(preset, args.iterations, args.log_every, args.device, args.seed)


if __name__ == "__main__":
    main()
