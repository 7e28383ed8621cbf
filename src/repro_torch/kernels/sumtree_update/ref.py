"""Plain PyTorch version of the sum-tree update kernel: the incremental
write and the full scatter + rebuild from ``repro_torch.core.sumtree``
(both give bit-identical trees)."""

from repro_torch.core.sumtree import (  # noqa: F401
    update as sumtree_update_ref,
    write_rebuild as sumtree_write_rebuild_ref,
)
