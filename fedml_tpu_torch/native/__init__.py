"""The native host data pipeline (counterpart of the pipeline part of
``fedml_tpu/native``): :class:`HostPipeline`, a deterministic threaded
batcher over host record arrays, in C++ (``src/host_pipeline.cc``, built at
first use by ``build.py``) with a Python form of the same interface.

The library is loaded once per process; ``available()`` says whether it
is, that is whether pipelines run natively. Without a host compiler every
pipeline takes its Python form (and ``HostPipeline(native=False)`` asks
for it). A failed build raises at every load. The wire plane's crc32c and
buffer packing are not ported.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    with _lib_lock:
        if _tried:
            return _lib
        from fedml_tpu_torch.native.build import build_library

        path = build_library()      # a failed build raises, at every load
        _tried = True
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.fed_pipeline_create.restype = vp
        lib.fed_pipeline_create.argtypes = [vp, vp, i64, i64, i64, i64, ctypes.c_uint64,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.fed_pipeline_create_ordered.restype = vp
        lib.fed_pipeline_create_ordered.argtypes = [vp, vp, i64, i64, i64, i64, vp, i64, i64,
                                                    ctypes.c_int, ctypes.c_int]
        lib.fed_pipeline_next.restype = i64
        lib.fed_pipeline_next.argtypes = [vp, vp, vp]
        lib.fed_pipeline_batches_per_epoch.restype = i64
        lib.fed_pipeline_batches_per_epoch.argtypes = [vp]
        lib.fed_pipeline_destroy.restype = None
        lib.fed_pipeline_destroy.argtypes = [vp]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether pipelines run natively (the library built and loaded)."""
    return _load() is not None


class HostPipeline:
    """Deterministic threaded batcher over ``(x, y)`` record arrays: an
    endless in-order stream of batches.

    Seeded mode: each epoch is a Fisher-Yates permutation of the records
    from ``(seed, epoch)``; the last batch of an epoch may be short unless
    ``drop_last``. Explicit-order mode (``orders``, a ``[n_epochs, L]``
    int64 table): epoch e streams ``x[orders[e % n_epochs]]`` in that exact
    sequence, ``L`` records in ``ceil(L / batch_size)`` batches (``seed``
    and ``drop_last`` are ignored); entries out of range raise.

    Natively, worker threads assemble batches into a ring of ``depth``
    slots while the consumer waits on the device, without the GIL. The
    Python form (``native=False``, or when ``available()`` is false) is
    single-threaded; in explicit-order mode it streams the same batches,
    in seeded mode another (still deterministic) permutation stream.
    """

    def __init__(self, x: np.ndarray, y: Optional[np.ndarray], batch_size: int, seed: int = 0,
                 n_threads: int = 2, depth: int = 4, drop_last: bool = False,
                 orders: Optional[np.ndarray] = None, native: Optional[bool] = None):
        self.x = np.ascontiguousarray(x)
        self.y = None if y is None else np.ascontiguousarray(y)
        if self.y is not None and len(self.y) != len(self.x):
            raise ValueError("x/y length mismatch")
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.drop_last = bool(drop_last)
        n = len(self.x)
        if orders is not None:
            orders = np.ascontiguousarray(orders, np.int64)
            if orders.ndim != 2 or orders.size == 0:
                raise ValueError("orders must be a non-empty [n_epochs, L] table")
            if orders.min() < 0 or orders.max() >= n:
                raise ValueError("orders entries out of range")
            self.orders = orders
            self.batches_per_epoch = -(-orders.shape[1] // self.batch_size)
        else:
            self.orders = None
            self.batches_per_epoch = (n // self.batch_size if drop_last
                                      else -(-n // self.batch_size))
        if self.batches_per_epoch <= 0:
            raise ValueError("dataset smaller than one batch with drop_last")
        self._handle = None
        self._lib = _load() if native is not False else None
        if native and self._lib is None:
            raise RuntimeError("the native host pipeline is not available")
        if self._lib is not None:
            xb = self.x.nbytes // n
            yb = 0 if self.y is None else self.y.nbytes // n
            yp = 0 if self.y is None else self.y.ctypes.data
            if self.orders is not None:
                self._handle = self._lib.fed_pipeline_create_ordered(
                    self.x.ctypes.data, yp, n, xb, yb, self.batch_size, self.orders.ctypes.data,
                    self.orders.shape[0], self.orders.shape[1], int(n_threads), int(depth))
            else:
                self._handle = self._lib.fed_pipeline_create(
                    self.x.ctypes.data, yp, n, xb, yb, self.batch_size, self.seed,
                    int(n_threads), int(depth), int(drop_last))
            if not self._handle:
                raise RuntimeError("fed_pipeline_create refused its arguments")
        else:
            self._py_iter = self._python_stream()

    @property
    def native(self) -> bool:
        """Whether this pipeline runs natively."""
        return self._handle is not None

    def _python_stream(self):
        n = len(self.x)
        epoch = 0
        while True:
            if self.orders is not None:
                perm = self.orders[epoch % self.orders.shape[0]]
            else:
                perm = np.random.default_rng(self.seed + epoch * 1_000_003).permutation(n)
            for b in range(self.batches_per_epoch):
                ix = perm[b * self.batch_size:(b + 1) * self.batch_size]
                yield self.x[ix], None if self.y is None else self.y[ix]
            epoch += 1

    def next_batch(self) -> tuple:
        """The next ``(x, y)`` batch (``y`` None without labels)."""
        if self._lib is None:
            return next(self._py_iter)
        if self._handle is None:
            raise RuntimeError("pipeline closed")
        bx = np.empty((self.batch_size,) + self.x.shape[1:], dtype=self.x.dtype)
        by = (None if self.y is None
              else np.empty((self.batch_size,) + self.y.shape[1:], dtype=self.y.dtype))
        count = self._lib.fed_pipeline_next(self._handle, bx.ctypes.data,
                                            0 if by is None else by.ctypes.data)
        if count < 0:
            raise RuntimeError("pipeline stopped")
        if count < self.batch_size:
            bx = bx[:count]
            by = None if by is None else by[:count]
        return bx, by

    def epoch(self):
        """Exactly one epoch's batches."""
        for _ in range(self.batches_per_epoch):
            yield self.next_batch()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.fed_pipeline_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
