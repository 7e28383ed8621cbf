"""Plain PyTorch version of the descent kernel: the gather-based descent
followed by a leaf gather, from ``repro_torch.core.sumtree``. (Not the
dispatching ``sample_with_mass``, which may be the kernel itself.)"""

from repro_torch.core.sumtree import (  # noqa: F401
    sample as sumtree_sample_ref,
    sample_two_gather as sumtree_sample_with_mass_ref,
)
