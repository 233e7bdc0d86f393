"""Epoch sampling and threaded batch prefetching (the JAX package's
`vitadapter/data/loader.py`, keyed by step).

The reference trains with a multi-worker torch DataLoader; the port's loop
is one python process per rank, so without overlap the host-side
decode/augment time (`data_time`) adds directly to every step. `prefetch`
makes the batches of the coming steps in worker threads and hands them out
in step order: PIL/numpy release the GIL for the heavy ops, so threads are
enough to hide the pipeline behind device compute.

Step k's global batch takes positions [k*B, (k+1)*B) of the sampler's
stream (`EpochSampler.indices`), and each image's augmentation draws come
from a generator keyed by (seed, step, position) (`image_rng`), so the
batch does not depend on which thread made it, and each rank of a
data-parallel run makes its own rows of the same global batch.
"""

import collections
import concurrent.futures
import threading
from typing import Callable, Iterator, List

import numpy as np


class EpochSampler:
    """One global shuffle per epoch, consumed without replacement
    (DistributedSampler semantics: every sample appears exactly once per
    epoch, reshuffled with `seed + epoch`). `indices` reads any stretch of
    the stream without moving, so that a step's batch is the same whichever
    thread or rank asks for it; `take` walks it from position 0 as the JAX
    package's sampler does."""

    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self.seed = seed
        self.lock = threading.Lock()
        self._perms = {}
        self._next = 0

    def take(self, k: int) -> List[int]:
        with self.lock:
            start = self._next
            self._next += k
        return self.indices(start, k)

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        with self.lock:
            perm = self._perms.get(epoch)
            if perm is None:
                if len(self._perms) > 4:
                    self._perms.pop(min(self._perms))
                perm = np.random.RandomState(
                    self.seed + epoch).permutation(self.n)
                self._perms[epoch] = perm
        return perm

    def indices(self, start: int, k: int) -> List[int]:
        """Positions [start, start + k) of the stream: position p is entry
        p % n of epoch p // n's permutation."""
        return [int(self._epoch_perm(p // self.n)[p % self.n])
                for p in range(start, start + k)]


def image_rng(seed: int, step: int, position: int) -> np.random.RandomState:
    """The augmentation draws of the image at `position` of step `step`'s
    global batch."""
    return np.random.RandomState([seed, step, position])


def prefetch(make_batch: Callable[[int], dict], num_threads: int = 4,
             buffer: int = 8) -> Iterator[dict]:
    """`make_batch(step)` for steps 0, 1, ... (without end), made by
    `num_threads` worker threads up to `buffer` steps ahead and yielded in
    step order. Closing the iterator cancels the batches not started."""
    pool = concurrent.futures.ThreadPoolExecutor(num_threads)
    try:
        ahead = collections.deque(pool.submit(make_batch, k)
                                  for k in range(buffer))
        k = buffer
        while True:
            batch = ahead.popleft().result()
            ahead.append(pool.submit(make_batch, k))
            k += 1
            yield batch
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
