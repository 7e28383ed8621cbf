"""Hand-written Hopper kernels of the port, one package per TPU kernel it
replaces: ``<name>/ops.py`` (the wrapper, with its launch counter),
``<name>/ref.py`` (the plain PyTorch version) and the kernel source
(``csrc/<name>.cu`` for CUDA C++, ``<name>/kernel.py`` for Triton)."""

from repro_torch.kernels.nstep_return import ops as _nstep_ops
from repro_torch.kernels.replay_ingest import ops as _ingest_ops
from repro_torch.kernels.sumtree_sample import ops as _sample_ops
from repro_torch.kernels.sumtree_update import ops as _update_ops

OPS = {
    "sumtree_update": _update_ops,
    "sumtree_sample": _sample_ops,
    "replay_ingest": _ingest_ops,
    "nstep_return": _nstep_ops,
}


def reset_launch_counts() -> None:
    for mod in OPS.values():
        mod.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in OPS.items()}
