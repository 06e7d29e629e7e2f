"""Host-side physical block allocation + prefetch bookkeeping for paged KV.

The in-graph side of paging (pool scatter/gather through block tables) lives
in models/attention.py; this module owns the host half: which physical slot
each logical block occupies, how many are resident, and which evicted blocks
to restore ahead of demand.

``BlockPoolAllocator`` hands out the lowest free slot first, so slot
assignment — and with it the whole eviction/restore trace — is a pure
function of the access sequence (same property the tracker's logical clock
gives eviction order).
"""

from __future__ import annotations

import heapq


class BlockPoolAllocator:
    """Fixed-budget physical slot allocator (lowest free slot first)."""

    def __init__(self, budget_blocks: int):
        if budget_blocks < 1:
            raise ValueError(f"budget_blocks must be >= 1, got {budget_blocks}")
        self.budget = budget_blocks
        self._free = list(range(budget_blocks))  # heap
        self._used: set = set()
        self.high_water = 0

    @property
    def allocated(self) -> int:
        return len(self._used)

    @property
    def free_blocks(self) -> int:
        return self.budget - len(self._used)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                f"KV block pool exhausted: budget={self.budget} blocks all "
                "resident (raise budget_blocks or evict first)"
            )
        slot = heapq.heappop(self._free)
        self._used.add(slot)
        self.high_water = max(self.high_water, len(self._used))
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._used:
            raise ValueError(f"double free of physical block {slot}")
        self._used.remove(slot)
        heapq.heappush(self._free, slot)


class PrefetchQueue:
    """Ordered queue of predicted-hot evicted blocks to restore early.

    The serving engine pushes next-in-sequence predictions after each layer
    step and drains the queue into batched restores between steps —
    "async" here is issue-ahead-of-need (restores overlap the python-side
    step loop), not a background thread; the restore dispatch itself is the
    same batched ``decompress_many`` the demand path uses.
    """

    def __init__(self, lookahead: int = 1):
        self.lookahead = lookahead
        self._pending: dict = {}  # ordered set of block keys
        self.issued = 0   # blocks restored by prefetch
        self.hits = 0     # demand accesses served from a prefetched block

    def push(self, key) -> None:
        self._pending[key] = None

    def pop_all(self) -> list:
        keys = list(self._pending)
        self._pending.clear()
        return keys

    def __len__(self):
        return len(self._pending)
