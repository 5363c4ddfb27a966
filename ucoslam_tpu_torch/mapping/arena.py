"""Host-side id-stable slot arena (numpy).

Port of `ucoslam_tpu/mapping/arena.py`: ids are slot indices that never
shift, and freed slots are reused lowest-first. The arena tracks liveness on
the host; the payloads live in the `MapState` tensors indexed by slot.
"""

from __future__ import annotations

import numpy as np


class Arena:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.active = np.zeros(capacity, bool)

    @classmethod
    def of_mask(cls, mask: np.ndarray) -> "Arena":
        """An arena whose live slots are those of a liveness mask."""
        arena = cls(len(mask))
        arena.sync_from_mask(mask)
        return arena

    def alloc(self) -> int:
        """Allocate the lowest free slot (deterministic reuse order)."""
        free = np.nonzero(~self.active)[0]
        if len(free) == 0:
            raise RuntimeError(f"arena full (capacity {self.capacity})")
        slot = int(free[0])
        self.active[slot] = True
        return slot

    def alloc_many(self, n: int) -> np.ndarray:
        free = np.nonzero(~self.active)[0]
        if len(free) < n:
            raise RuntimeError(f"arena full: want {n}, have {len(free)}")
        slots = free[:n]
        self.active[slots] = True
        return slots.astype(np.int32)

    def free(self, slots) -> None:
        self.active[np.asarray(slots, int)] = False

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def active_slots(self) -> np.ndarray:
        return np.nonzero(self.active)[0].astype(np.int32)

    def sync_from_mask(self, mask: np.ndarray) -> None:
        """Adopt a liveness mask (e.g. one loaded from a checkpoint)."""
        self.active = np.asarray(mask, bool).copy()

    def grow(self, new_capacity: int) -> None:
        """Extend capacity; existing slot ids are unchanged."""
        if new_capacity < self.capacity:
            raise ValueError(f"cannot shrink arena {self.capacity} -> {new_capacity}")
        ext = np.zeros(new_capacity, bool)
        ext[: self.capacity] = self.active
        self.active = ext
        self.capacity = new_capacity
