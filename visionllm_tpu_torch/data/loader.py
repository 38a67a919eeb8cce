"""Prefetching data loader (counterpart of `visionllm_tpu/data/loader.py`):
worker threads build batch N+1.. while the card runs step N.

Threads, not processes: the per-sample host work is numpy or the port's
native functions (the JPEG decoder, the resizer, the RLE codec), whose
ctypes calls release the GIL, so workers overlap without pickling the
dataset.

`PrefetchLoader` yields the batches in sampler order with the content of
the synchronous loop, so `num_workers` never changes what is trained on.
A sample's error is raised at its batch. At most `depth` batches are
being built or wait unconsumed. Leaving the loop early (break, an error,
closing the iterator) stops the threads and joins them.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence

_JOIN_S = 10.0


class PrefetchLoader:
    """Iterate `batch_iter`, building `collate([dataset[i] for i in
    batch])` ahead of the consumer on `num_workers` threads.

    Args:
      dataset: indexable source.
      batch_iter: iterable of index lists (a batch sampler), or a flat
        index iterable with `batch_size` (a ragged tail is dropped).
      collate: list of samples -> batch.
      num_workers: worker threads; 0 builds each batch when it is asked
        for, on the caller's thread.
      depth: batches built ahead at most (default 2 * num_workers).
    """

    def __init__(self, dataset: Any, batch_iter: Iterable,
                 collate: Callable[[List[Any]], Any], *,
                 batch_size: Optional[int] = None, num_workers: int = 2,
                 depth: Optional[int] = None):
        self.dataset = dataset
        self.batch_iter = batch_iter
        self.collate = collate
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.depth = depth or max(2, 2 * num_workers)

    def _index_batches(self) -> Iterator[List[int]]:
        if self.batch_size is None:
            for idx in self.batch_iter:
                yield list(idx)
            return
        buf: List[int] = []
        for i in self.batch_iter:
            buf.append(i)
            if len(buf) == self.batch_size:
                yield buf
                buf = []

    def _build(self, idx: Sequence[int]) -> Any:
        return self.collate([self.dataset[i] for i in idx])

    def __iter__(self) -> Iterator[Any]:
        if self.num_workers <= 0:
            for idx in self._index_batches():
                yield self._build(idx)
            return

        # the feeder hands out (seq, indices) tickets while fewer than
        # `depth` batches are in flight; workers build them; the consumer
        # reorders the results by seq
        slots = threading.Semaphore(self.depth)
        tickets: "queue.Queue" = queue.Queue()
        results: "queue.Queue" = queue.Queue()
        stop = threading.Event()

        def feeder():
            seq = 0
            try:
                for idx in self._index_batches():
                    while not slots.acquire(timeout=0.1):
                        if stop.is_set():
                            return
                    if stop.is_set():
                        return
                    tickets.put((seq, idx))
                    seq += 1
            except BaseException as e:          # noqa: BLE001
                results.put((seq, None, e))     # the sampler failed here
            finally:
                for _ in range(self.num_workers):
                    tickets.put(None)

        def worker():
            while True:
                t = tickets.get()
                if t is None or stop.is_set():
                    results.put(None)
                    return
                seq, idx = t
                try:
                    results.put((seq, self._build(idx), None))
                except BaseException as e:      # noqa: BLE001
                    results.put((seq, None, e))

        threads = [threading.Thread(target=feeder, daemon=True,
                                    name="prefetch-feeder")]
        threads += [threading.Thread(target=worker, daemon=True,
                                     name=f"prefetch-worker{i}")
                    for i in range(self.num_workers)]
        for t in threads:
            t.start()
        pending = {}
        next_seq = 0
        done = 0
        try:
            while True:
                while next_seq in pending:
                    batch, err = pending.pop(next_seq)
                    next_seq += 1
                    if err is not None:
                        raise err
                    slots.release()
                    yield batch
                if done == self.num_workers:
                    return
                r = results.get()
                if r is None:
                    done += 1
                else:
                    pending[r[0]] = r[1:]
        finally:
            stop.set()
            for _ in range(self.num_workers):
                tickets.put(None)
            for t in threads:
                t.join(_JOIN_S)
