"""LRU cache (paper Sec. V-A: 'arguably the most common policy')."""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple


class LRUCache:
    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: "OrderedDict[int, None]" = OrderedDict()

    def __contains__(self, key: int) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def touch(self, key: int) -> bool:
        """Refresh recency; returns True if the key was present."""
        if key in self._d:
            self._d.move_to_end(key)
            return True
        return False

    def put(self, key: int) -> Tuple[bool, Optional[int]]:
        """Insert (or refresh).  Returns (inserted_new, evicted_key)."""
        if key in self._d:
            self._d.move_to_end(key)
            return False, None
        evicted = None
        if len(self._d) >= self.capacity:
            evicted, _ = self._d.popitem(last=False)
        self._d[key] = None
        return True, evicted

    def keys(self):
        return self._d.keys()
