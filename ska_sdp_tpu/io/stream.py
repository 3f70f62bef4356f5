"""Background-prefetched slab streaming for out-of-core ingest.

The reference loads entire datasets into memory before imaging
(``ImageDataset.hs:36-41``); real SKA runs are multi-GB to multi-TB.
``SlabPrefetcher`` walks the visibility datasets in leading-axis slabs on a
host thread, keeping a bounded queue of slabs ahead of the device so HDF5
reads overlap device compute (SURVEY §7 hard part (e): host↔device ingest
pipelining).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple



class SlabPrefetcher:
    """Iterate (start, {name: rows}) slabs with background prefetch.

    ``readers`` maps a name to ``callable(start, count) -> ndarray`` so
    callers control the on-disk slicing (e.g. flattening a rank-3 vis
    block to the flat visibility order).
    """

    def __init__(self, readers: dict, total: int, slab: int,
                 start: int = 0, depth: int = 2):
        self.readers = readers
        self.total = total
        self.slab = slab
        self.start = start
        self._stop = threading.Event()
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for s0 in range(self.start, self.total, self.slab):
                if self._stop.is_set():
                    return
                take = min(self.slab, self.total - s0)
                slabs = {n: rd(s0, take) for n, rd in self.readers.items()}
                if not self._put((s0, slabs)):
                    return
            self._put(None)
        except Exception as e:          # surface errors on the consumer side
            self._put(e)

    def close(self) -> None:
        """Release the producer thread and its queued slabs."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __iter__(self) -> Iterator[Tuple[int, dict]]:
        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            self.close()
