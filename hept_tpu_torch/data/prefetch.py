"""Background-thread batch prefetching (port of `hept_tpu/data/prefetch.py`).

A worker thread runs the host side ahead of the step: it draws packed
batches from the iterator (numpy packing) and applies `transfer` to each,
up to `depth` batches ahead. The trainer's `transfer` turns a batch into
CPU tensors in pinned memory; the host-to-device copy is then made on the
main thread (`train/trainer.py:batch_to_device`, non_blocking from pinned
memory, on the current stream, so the step that reads the batch is ordered
after it with no extra synchronisation). An exception raised in the worker
is re-raised in the consumer at the point where its batch would have come.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

_END = object()


def prefetch(iterator: Iterable, transfer: Callable | None = None,
             depth: int = 2) -> Iterator:
    """Yield the items of `iterator` in order, each passed through
    `transfer`, produced up to `depth` items ahead on a background thread.
    Closing the generator early stops the worker."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item if transfer is None else transfer(item)):
                    return
        except BaseException as e:  # noqa: BLE001 -- handed to the consumer
            put((_END, e))
            return
        put((_END, None))

    t = threading.Thread(target=worker, name="prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _END:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
        t.join(timeout=5)
