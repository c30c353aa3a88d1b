"""Host-side image-decode prefetcher for the 2D trainers — port of
tgtc/data/prefetch.py.

Whole random-crop batches are decoded on a thread pool, ``depth`` batches
ahead, so the next batch decodes while the card runs the current step.
Decoded and resized images are kept in a byte-bounded LRU cache as uint8 (a
C1 dataset re-decodes the same few files every epoch), and batches are
returned as uint8: the trainers normalize them on the device.

Determinism: batch ``i`` draws from ``default_rng([seed, i])`` and its image
``j`` from ``default_rng([seed, i, j])``, whatever the thread scheduling, so
the batches equal the JAX package's bit for bit for the same seed and files.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from collections import OrderedDict, deque
from typing import Optional, Sequence

import numpy as np

CACHE_BYTES = 512 * 1024 * 1024


class ResizeCache:
    """Decoded ``[resize, resize, 3]`` uint8 images by (path, size), least
    recently used dropped past ``max_bytes``; safe across threads."""

    def __init__(self, max_bytes: int = CACHE_BYTES):
        self.max_bytes = max_bytes
        self._items: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._size = 0
        self._lock = threading.Lock()

    def load(self, path: str, resize: int) -> np.ndarray:
        """Decode and bilinear-resize, or the cached copy (read-only)."""
        key = (path, resize)
        with self._lock:
            if key in self._items:
                self._items.move_to_end(key)
                return self._items[key]
        from PIL import Image

        img = Image.open(path).convert("RGB").resize((resize, resize), Image.BILINEAR)
        arr = np.asarray(img, np.uint8)
        arr.setflags(write=False)  # crops are views into the shared cache
        with self._lock:
            if key not in self._items:
                self._items[key] = arr
                self._size += arr.nbytes
                while self._size > self.max_bytes and len(self._items) > 1:
                    _, old = self._items.popitem(last=False)
                    self._size -= old.nbytes
        return arr


def load_crop(path: str, rng: np.random.Generator, patch: int, resize: int,
              cache: Optional[ResizeCache] = None) -> np.ndarray:
    """The reference's train transform: resize to ``resize``² (bilinear),
    then a random ``patch``² crop, as uint8."""
    arr = (cache or ResizeCache()).load(path, resize)
    y = rng.integers(0, resize - patch + 1)
    x = rng.integers(0, resize - patch + 1)
    return arr[y: y + patch, x: x + patch]


class CropBatchPrefetcher:
    """Yields ``[B, P, P, 3]`` uint8 random-crop batches, decoding ahead.

    ``depth`` batches stay in flight; ``close()`` (or leaving the ``with``
    block) stops the pool. Single consumer."""

    def __init__(self, paths: Sequence[str], batch: int, patch: int = 256, resize: int = 512,
                 seed: int = 0, depth: int = 2, workers: int = 4,
                 cache: Optional[ResizeCache] = None):
        if not paths:
            raise ValueError("no images to prefetch")
        self.paths = list(paths)
        self.batch, self.patch, self.resize = batch, patch, resize
        self.seed = seed
        self.cache = cache or ResizeCache()
        self._i = 0
        self._pool = cf.ThreadPoolExecutor(max_workers=workers)
        self._pending: deque = deque()
        for _ in range(max(1, depth)):
            self._submit()

    def _submit(self) -> None:
        i = self._i
        self._i += 1
        rng = np.random.default_rng([self.seed, i])
        idx = rng.integers(0, len(self.paths), self.batch)
        self._pending.append([
            self._pool.submit(load_crop, self.paths[k], np.random.default_rng([self.seed, i, j]),
                              self.patch, self.resize, self.cache)
            for j, k in enumerate(idx)])

    def next(self) -> np.ndarray:
        futs = self._pending.popleft()
        self._submit()
        return np.stack([f.result() for f in futs], 0)

    def close(self) -> None:
        for futs in self._pending:
            for f in futs:
                f.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
