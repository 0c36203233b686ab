"""A minimal reader-writer lock for the VectorDatabase facade (a copy of
``vector_db_tpu/utils/locks.py``).

Searches run concurrently; a mutation is exclusive.  In the port the store
is updated in place, so a search must never overlap a write to the tensors
it reads.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    """Writer-preferring reader-writer lock (no stdlib equivalent)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextmanager
    def read(self):
        with self._cond:
            # writer preference: don't starve mutations under heavy search
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()
