"""Build batches ahead of the training step on a host thread (port of
langsplat4d/data/prefetch.py).

The reference's loop is synchronous (a DataLoader with num_workers=0,
train.py:146-151): each iteration decodes its images, loads its language
ground truth and uploads them before the step starts. `prefetch` runs any
generator on a daemon thread, `depth` items ahead of the consumer, so that
work overlaps the step before it; an exception in the producer is raised
again at the consumer.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_END = object()


def prefetch(gen: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate `gen` on a daemon thread, `depth` items ahead; depth 0 is
    plain iteration."""
    if depth <= 0:
        yield from gen
        return

    q: queue.Queue = queue.Queue(maxsize=depth)

    def producer():
        try:
            for item in gen:
                q.put(("item", item))
        except BaseException as e:  # noqa: BLE001 — raised at the consumer
            q.put(("err", e))
            return
        q.put(("end", _END))

    threading.Thread(target=producer, daemon=True,
                     name="langsplat4d-torch-batch-prefetch").start()
    while True:
        tag, item = q.get()
        if tag == "end":
            return
        if tag == "err":
            raise item
        yield item
