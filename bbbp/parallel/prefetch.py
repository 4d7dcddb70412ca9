"""Host→device double-buffered prefetch.

The reference's DataLoader moves each batch host→GPU synchronously inside the
step loop (reference: ...regression_opt_transformer_cnn_20250113.py:184-186).
Here featurization / batch assembly runs on host threads while the device computes
the previous batch: an iterator wrapper that keeps ``depth`` batches in flight
via non-blocking ``jax.device_put``.
"""

from __future__ import annotations

import collections
import threading
import queue
from typing import Callable, Iterable, Iterator, Optional

import jax


def prefetch_to_device(iterator: Iterable, depth: int = 2,
                       sharding=None) -> Iterator:
    """Yield device-resident items while the host stages the next ones.

    ``jax.device_put`` is async (returns immediately with futures); keeping a
    small deque of in-flight transfers overlaps H2D DMA with device compute.
    A background thread additionally overlaps host-side batch *construction*
    (e.g. RDKit-equivalent featurization) with everything else.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def producer():
        try:
            for item in iterator:
                if sharding is not None:
                    item = jax.tree.map(lambda x: jax.device_put(x, sharding), item)
                else:
                    item = jax.tree.map(jax.device_put, item)
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        yield item
