"""Threaded batch prefetching (a copy of `vitadapter/data/loader.py`).

The reference trains with a multi-worker torch DataLoader; the port's loop is a
single python process, so without overlap the host-side decode/augment time
(`data_time`) adds directly to every step. `prefetch` runs the batch
iterator in worker threads and keeps a bounded queue of ready batches —
PIL/numpy release the GIL for the heavy ops, so threads are enough to hide
the pipeline behind device compute (no process pool / pickling needed).
"""

import queue
import threading
from typing import Iterator, List

import numpy as np


# bound at import: at interpreter shutdown the `queue` module globals may
# already be torn down when a prefetch generator finalizes
_EMPTY = queue.Empty


class _EndOfData:
    pass


class EpochSampler:
    """One global shuffle per epoch, consumed without replacement across all
    prefetch threads (torch DistributedSampler semantics: every sample
    appears exactly once per epoch, reshuffled with `seed + epoch`). Threads
    pull index blocks under a lock, so batch composition interleaves across
    threads but global per-epoch coverage is exact."""

    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self.seed = seed
        self.epoch = 0
        self.pos = 0
        self.perm = np.random.RandomState(seed).permutation(n)
        self.lock = threading.Lock()

    def take(self, k: int) -> List[int]:
        out: List[int] = []
        with self.lock:
            while len(out) < k:
                if self.pos >= self.n:
                    self.epoch += 1
                    self.perm = np.random.RandomState(
                        self.seed + self.epoch).permutation(self.n)
                    self.pos = 0
                out.append(int(self.perm[self.pos]))
                self.pos += 1
        return out


def prefetch(make_iter, num_threads: int = 4, buffer: int = 8,
             seed: int = 0) -> Iterator:
    """Pull batches from `num_threads` independent iterators into a bounded
    queue. `make_iter(seed)` must return an infinite batch iterator; each
    thread gets a distinct seed so the streams don't duplicate batches.

    For finite iterators use `num_threads=1` (order within a thread is
    preserved; across threads it is interleaved).
    """
    q: "queue.Queue" = queue.Queue(maxsize=buffer)
    stop = threading.Event()
    # LOCAL binding, made before the first yield: when this generator is
    # finalized at interpreter shutdown, module globals (incl. `queue` and
    # `_EMPTY`) may already be cleared — locals survive
    empty_exc = _EMPTY

    def work(tid: int):
        try:
            for item in make_iter(seed + tid):
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        finally:
            q.put(_EndOfData())

    threads = [threading.Thread(target=work, args=(t,), daemon=True)
               for t in range(num_threads)]
    for t in threads:
        t.start()

    ended = 0
    try:
        while ended < num_threads:
            item = q.get()
            if isinstance(item, _EndOfData):
                ended += 1
                continue
            yield item
    finally:
        stop.set()
        # drain so producer threads blocked on put() can observe stop
        try:
            while True:
                q.get_nowait()
        except empty_exc:
            pass
