"""One local step as one captured CUDA graph: the port's counterpart of the
JAX package running a step only inside one compiled program
(``fedml_tpu/parallel/local.py`` scans a client's steps in one jitted
program, ``parallel/packed.py`` jits the packed round).

A :class:`CapturedStep` owns a step body's static input tensors. The
caller writes a step's batch into them and calls the step, which returns
the body's output. On CUDA tensors the first call

1. runs ``WARMUP_STEPS`` steps of the body (or the step's
   ``warmup_steps``) on a side stream, which primes
   what the body does once and may not do under capture: the kernels'
   libraries (``ops/build.py``), the BN kernels' launch plans and
   shared-memory limits (``ops/batchnorm._plan``), the grid-barrier words
   of the capturing stream (``ops/grid_barrier.barrier_words``), cuDNN's and
   cuBLAS's plans and workspaces;
2. puts back every tensor the body mutates (``state()``: parameters,
   buffers, optimizer state, gradients), so the warm-up trains nothing;
3. collects the cyclic garbage (a dead trainer's graphs) and, with the
   cyclic collector off, captures one step into a ``torch.cuda.CUDAGraph``
   with a memory pool of its own, on the same side stream, and
   instantiates it;

and every call replays that graph (``graph.replay()``, one launch on the
current stream) and returns the body's static output, which the next
replay overwrites. A failed capture or replay raises: nothing falls back to
the eager body. On CPU tensors, or built with ``capture=False``, every call
runs the body eagerly; that is the path the CPU tests take.

Background threads. A capture is in CUDA's global mode, in which another
thread's potentially unsafe call (a device or pinned allocation, a
synchronization) invalidates it, and ``torch.cuda.graph`` itself empties the
allocators' caches first. So every capture window, from entering
``torch.cuda.graph`` to leaving it, holds :data:`CAPTURE_LOCK`, and code that
makes CUDA calls on another thread while steps may be captured (the host
round pipeline's copies, ``data/pipeline.ship``) holds it around those
calls. A capture never waits for such a thread's work, only for the lock.

The body must read and write only tensors whose addresses stay fixed across
steps (the static inputs, the module's parameters and buffers, a bound
optimizer's state and gradients, other static buffers the caller owns), and
must not synchronize with the host.

Launch counters: the kernel wrappers count where the host calls them
(``ops/*.LAUNCHES``), and a replay calls no wrapper. The counts of the
warm-up and of the capture are taken back; the capture's are kept as the
step's launches and added on every replay, so the counters count the
kernels that the steps launched. ``warmup_launches`` keeps the warm-up's.
"""

from __future__ import annotations

import gc
import threading
from typing import Callable, Optional, Sequence

import torch

from fedml_tpu_torch.ops import attention, batchnorm, conv_lanes, xent

#: eager steps run before the capture (the count PyTorch's CUDA-graph
#: documentation uses)
WARMUP_STEPS = 3

#: held by every capture window and by other threads' CUDA calls that may
#: run while a step is captured (see the module note)
CAPTURE_LOCK = threading.Lock()

_COUNTERS = (batchnorm.LAUNCHES, conv_lanes.LAUNCHES, attention.LAUNCHES, xent.LAUNCHES)


def _counts() -> list[dict]:
    return [dict(c) for c in _COUNTERS]


def _set_counts(counts: list[dict]) -> None:
    for c, v in zip(_COUNTERS, counts):
        c.update(v)


def _delta(after: list[dict], before: list[dict]) -> list[dict]:
    return [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]


class CapturedStep:
    """``body(*inputs) -> output`` over static ``inputs``, captured once on
    CUDA and replayed on every call (see the module note). ``state()``
    returns every tensor the body mutates. ``warmup_steps`` eager steps run
    before the capture: one already primes every plan and library the body
    uses; a step of ~10^5 launches takes seconds eagerly."""

    def __init__(self, body: Callable, inputs: Sequence[torch.Tensor],
                 state: Callable[[], list], capture: bool = True,
                 warmup_steps: int = WARMUP_STEPS):
        self.body = body
        self.warmup_steps = warmup_steps
        self.inputs = list(inputs)
        self.state = state
        self.capture = capture
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.output = None
        self.replays = 0
        self.launches_per_step: Optional[list[dict]] = None
        self.warmup_launches: Optional[list[dict]] = None

    @property
    def captures(self) -> bool:
        """Whether calls replay a graph (CUDA inputs, capture asked for)."""
        return self.capture and self.inputs[0].is_cuda

    def __call__(self):
        if not self.captures:
            return self.body(*self.inputs)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for c, d in zip(_COUNTERS, self.launches_per_step):
            for k, v in d.items():
                c[k] += v
        self.replays += 1
        return self.output

    def _capture(self) -> None:
        dev = self.inputs[0].device
        start = _counts()
        saved = [t.detach().clone() for t in self.state()]
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(self.warmup_steps):
                self.body(*self.inputs)
            with torch.no_grad():
                for t, v in zip(self.state(), saved):
                    t.copy_(v)
        torch.cuda.current_stream(dev).wait_stream(stream)
        warm = _counts()
        # keep_graph: the captured cudaGraph_t stays readable
        # (``graph.raw_cuda_graph()``), so its kernel nodes can be inspected
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # a dead trainer's graphs sit in reference cycles (a program's body
        # holds its trainer); destroying a graph while a capture is under
        # way invalidates the capture, so the cycles go now and the cyclic
        # collector stays off until the capture ends
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with CAPTURE_LOCK, torch.cuda.graph(graph, stream=stream):
                output = self.body(*self.inputs)
        finally:
            if gc_on:
                gc.enable()
            captured = _counts()
            _set_counts(start)
        graph.instantiate()
        self.warmup_launches = _delta(warm, start)
        self.launches_per_step = _delta(captured, warm)
        self.graph, self.stream, self.output = graph, stream, output
