"""Background-thread batch prefetching (a copy of
``glfusion_tpu/data/prefetch.py``).

One daemon thread runs the host loader a few batches ahead, so NIfTI decode
and resize overlap the steps the card runs.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``iterable`` on a daemon thread, ``depth`` items ahead.

    Exceptions in the producer re-raise at the consumer's next pull.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list = []

    def producer():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # re-raise on the consumer side
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item
