"""Thread-safe LRU used by the engine's host-side memo caches.

A copy of `rag_serving_system_tpu/utils/lru.py`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable


class LockedLRU:
    """Bounded thread-safe LRU map. capacity <= 0 disables caching entirely
    (get always misses, put is a no-op)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: Hashable) -> Any | None:
        with self._lock:
            v = self._d.get(key)
            if v is not None:
                self._d.move_to_end(key)
            return v

    def put(self, key: Hashable, value: Any) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)
