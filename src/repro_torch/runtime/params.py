"""Versioned, lock-free parameter snapshot store.

The paper's actors "periodically request the latest network parameters"
(Alg. 1 l.2) — a one-way publish/subscribe, never a synchronization barrier.
The learner publishes an immutable ``(version, params)`` tuple; readers grab
whichever snapshot is current.

Lock-freedom relies on two facts: (a) rebinding a single attribute is atomic
in CPython, so readers always observe a complete snapshot, never a torn one;
(b) snapshots are never mutated after publication: a publisher hands over a
fresh tree, and nothing writes into a published one. Readers therefore need
no lock, and a slow reader merely acts with stale parameters.
"""

from __future__ import annotations

from typing import Any, NamedTuple


class ParamSnapshot(NamedTuple):
    version: int
    params: Any


class ParamStore:
    """Single-writer (learner) / many-reader (actors) snapshot store."""

    def __init__(self, params: Any, version: int = 0):
        # ``version`` seeds the counter when a run resumes from a snapshot:
        # readers compare versions monotonically, so a restarted learner must
        # not restart numbering from 0 or every cached pull looks fresh.
        self._snap = ParamSnapshot(version, params)

    def publish(self, params: Any) -> int:
        """Publish a new snapshot; returns its version. Single writer only —
        two concurrent publishers could skip a version number."""
        snap = ParamSnapshot(self._snap.version + 1, params)
        self._snap = snap  # atomic rebind: readers see old or new, never torn
        return snap.version

    def get(self) -> ParamSnapshot:
        """Latest snapshot (wait-free)."""
        return self._snap

    @property
    def version(self) -> int:
        return self._snap.version
