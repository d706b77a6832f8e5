"""Host input pipeline: batching, epoch repetition and a background producer
(counterpart of the JAX package's data/pipeline.py).

The reference feeds batches through tf.data (generator → repeat → batch →
prefetch, `train.py:102-120`). Here the host side is a plain numpy batcher
run by a background thread. The JAX package's `device_prefetch` (double
buffering with `jax.device_put`) is not ported: the training CLI calls
neither it nor a counterpart, since the device feed uploads only the window
plans and the host feed's batches go up inside the step.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np


def batch_tuples(items: Sequence[tuple]) -> tuple:
    """Stack a list of example tuples into a tuple of batched arrays."""
    return tuple(np.stack([it[i] for it in items], axis=0)
                 for i in range(len(items[0])))


def batched(iterator: Iterator[tuple], batch_size: int,
            drop_remainder: bool = False) -> Iterator[tuple]:
    """Group an example iterator into batched tuples."""
    batch = []
    for item in iterator:
        batch.append(item)
        if len(batch) == batch_size:
            yield batch_tuples(batch)
            batch = []
    if batch and not drop_remainder:
        yield batch_tuples(batch)


def repeat_epochs(epoch_iterator_fn: Callable[[], Iterator], count: Optional[int] = None):
    """Chain epoch iterators `count` times (None = forever)."""
    counter = itertools.count() if count is None else range(count)
    for _ in counter:
        yield from epoch_iterator_fn()


def eval_batches(epoch_iterator_fn: Callable[[], Iterator], num_examples: int,
                 batch_size: int) -> Iterator[tuple]:
    """Reference eval batching: repeat the (deterministic) epoch twice, batch,
    and take ceil(n/B) batches so the trailing fractional batch is padded with
    examples wrapped from the start (`eval.py:131-134`). Batches keep dataset
    order, which the keyframe-interpolation pass depends on.
    """
    num_batches = int(np.ceil(num_examples / batch_size))
    it = batched(repeat_epochs(epoch_iterator_fn, count=2), batch_size, drop_remainder=True)
    return itertools.islice(it, num_batches)


def train_batches(epoch_iterator_fn: Callable[[], Iterator], batch_size: int,
                  prefetch: int = 4) -> Iterator[tuple]:
    """Infinite shuffled batches, produced by a background host thread."""
    return _threaded(batched(repeat_epochs(epoch_iterator_fn), batch_size,
                             drop_remainder=True), depth=prefetch)


class _Failure:
    def __init__(self, error: BaseException):
        self.error = error


def _threaded(iterator: Iterator, depth: int) -> Iterator:
    """Items of `iterator`, produced up to `depth` ahead by a daemon thread.
    An exception in the producer is raised again to the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except Exception as e:  # handed to the consumer, which raises it
            q.put(_Failure(e))
            return
        q.put(_END)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, _Failure):
            raise item.error
        yield item
