"""A value derived from an index's state, rebuilt only when that state moved.

An index keeps its scan shadows, ADC tables, refine rows and layouts as
:class:`DerivedCache` objects: a value, the key it was made at (a version
counter the owner bumps with every write it covers) and, optionally, a
dirty record of the store slots written since, with their running row
count.  ``get(key, build, update)`` is a hit (the stored key: one comparison
returns the value), a refresh (the record holds slots: ``update(value,
slots)`` refreshes the value in place from those unique slots, on the
device, and returns it, or answers None for a rebuild) or a rebuild (the old
value is dropped first, then ``build()`` makes the new one whole).  A record
past its row limit, or :meth:`DerivedCache.void`, makes the next miss
rebuild whole.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.stats import span

#: the key of a cache holding no value: equal to no key an owner passes
_EMPTY = object()
_NO_LOCK = _NO_SPAN = contextlib.nullcontext()


class DerivedCache:
    """``lock``: held around every ``get`` (None: the caller serializes).
    ``notes``: the notes of the span ``index.shadow`` around a (rebuild,
    refresh), or None for no span.  ``slots_device``: where a refresh gets
    its slots (a cache that is never noted rebuilds whole at every miss).
    ``builds`` counts the whole builds: a value rebuilt is a new value even
    where its tensors land at the old addresses."""

    __slots__ = ("key", "value", "builds", "_lock", "_notes", "_device",
                 "_record", "_rows")

    def __init__(self, lock=None, notes: Optional[tuple] = None,
                 slots_device: Optional[torch.device] = None):
        self.key = _EMPTY
        self.value = None
        self.builds = 0
        self._lock = _NO_LOCK if lock is None else lock
        self._notes = notes
        self._device = slots_device
        self._record: Optional[list] = None  # None: void
        self._rows = 0

    def note(self, slots: np.ndarray, limit: int) -> None:
        """Record store slots (int64, 1-D) written since the value was
        made; past ``limit`` rows in all the record is void."""
        if self._record is None:
            return
        self._record.append(slots)
        self._rows += slots.size
        if self._rows > limit:
            self._record = None

    def void(self) -> None:
        """Drop the value and the record: the next ``get`` builds whole."""
        self.key = _EMPTY
        self.value = self._record = None

    def _take(self) -> Optional[torch.Tensor]:
        """Consume the record: its unique slots on the device, or None when
        it is empty or void."""
        rec, self._record, self._rows = self._record, [], 0
        if not rec or not any(a.size for a in rec):
            return None
        return torch.as_tensor(np.unique(np.concatenate(rec)),
                               device=self._device)

    def _span(self, which: int):
        return (_NO_SPAN if self._notes is None
                else span("index.shadow", note=self._notes[which]))

    def get(self, key, build: Callable[[], object],
            update: Optional[Callable] = None):
        """The value at ``key``: kept, refreshed in place, or built whole."""
        with self._lock:
            if key == self.key:
                return self.value
            slots = self._take()
            value = None
            if slots is not None and update is not None \
                    and self.value is not None:
                with self._span(1):
                    value = update(self.value, slots)
            if value is None:
                self.key, self.value = _EMPTY, None  # free the old first
                with self._span(0):
                    value = build()
                self.builds += 1
            self.key, self.value = key, value
            return value
