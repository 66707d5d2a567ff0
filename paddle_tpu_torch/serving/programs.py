"""The serving engine's step programs.

Counterpart of the JAX engine's compiled programs (``_build_steps``,
``paddle_tpu/serving/engine.py:723``): a decode program (at most two, the
greedy one and the mixed one, as JAX's static ``any_sample`` makes them),
one prefill program per length bucket, and, with the prefix cache or
chunked prefill on, one continuation program (``prefill_ext``) per
bucket and one copy-on-write program. Each is a function of no
arguments over static device buffers (``StepBuffers``), built once:

* on the card it is captured into one CUDA graph, and every call replays
  it. Before the capture the function runs once eagerly on the capture
  stream, which builds every kernel it reaches and runs their first-use
  host setup (``cudaFuncSetAttribute``, the occupancy query), as
  ``torch.cuda.graph`` requires. The engine zeroes the static buffers
  before a build, so the warm-up writes no page (no active slot, a
  prompt of length 0): a warm-up over the last step's inputs would
  write into pages that may belong to another request by now. All
  programs of an engine share one graph memory pool and one capture
  stream. A graph's outputs are static tensors that its next replay
  overwrites: the engine reads them back before it replays again. There
  is no eager route on the card: a capture or replay error raises.
* on the CPU the same function runs eagerly on every call (the caller
  asked for the CPU, and the tests run it so); ``out`` holds the last
  call's outputs, as a graph's static outputs hold its last replay's.

The capture runs with Python's cyclic garbage collector paused
(``gc_paused``): collecting an old engine there would destroy its graphs
inside the capture. The warm-up and the capture hold ``capture_lock``,
which an engine's device setup takes too: ``torch.cuda.graph`` captures
in the "global" error mode, where a ``cudaMalloc`` or ``cudaHostAlloc``
from any thread invalidates the capture, and a fleet builds a restarted
replica's engine on another thread while the stepping thread may be
capturing a survivor's program.

Kernel launches inside a graph do not pass through their wrappers, so
the launches the capture recorded (``kernels._build.record_launches``)
are counted again on every replay (``count_replay``); the warm-up's are
not counted.

Sampling noise: a private ``torch.Generator`` per stream, registered with
every graph that draws from it (``CUDAGraph.register_generator_state``),
so each replay draws fresh numbers from where the generator stands.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import numpy as np
import torch

from ..kernels import _build

__all__ = ["Program", "StepBuffers", "capture_lock", "gc_paused"]

# held by every program's warm-up and capture and by an engine's device
# setup (see the module docstring)
capture_lock = threading.Lock()


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic garbage collector off for the duration. A capture
    runs under it: an engine dropped earlier (an engine is a reference
    cycle) would otherwise be collected at any allocation inside the
    capture, and destroying its graphs or events there is an operation a
    capturing stream does not permit, which invalidates the capture."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class StepBuffers:
    """Named int32/float32 fields packed into one int32 device buffer,
    staged from one host buffer (pinned on the card) with one copy.
    ``np[name]`` is the host view the engine fills, ``dev[name]`` the
    device view a program reads; float32 fields are the same 32-bit
    words viewed as float32."""

    def __init__(self, fields, device):
        total = sum(n for _, n, _ in fields)
        self.device = torch.zeros(total, dtype=torch.int32, device=device)
        self.host = torch.zeros(total, dtype=torch.int32,
                                pin_memory=device.type == "cuda")
        # marks the end of the last staging copy, which reads the pinned
        # host buffer asynchronously: a program whose output is not read
        # back (a non-final prefill chunk, a copy-on-write) leaves no
        # sync behind it
        self._staged = (torch.cuda.Event() if device.type == "cuda"
                        else None)
        words = self.host.numpy()
        self.np = {}
        self.dev = self._views(fields)
        off = 0
        for name, n, dtype in fields:
            host = words[off:off + n]
            self.np[name] = host.view(np.float32) if dtype == "float32" \
                else host
            off += n
        self._words = words

    @classmethod
    def abstract(cls, fields, device):
        """The device side alone, made under the caller's
        ``FakeTensorMode`` (no memory, no host buffer): the static
        analyzer's stand-in, whose ``dev`` views the programs read."""
        bufs = cls.__new__(cls)
        bufs.device = torch.zeros(sum(n for _, n, _ in fields),
                                  dtype=torch.int32, device=device)
        bufs.host = bufs._staged = bufs._words = None
        bufs.np = {}
        bufs.dev = bufs._views(fields)
        return bufs

    def _views(self, fields):
        dev, off = {}, 0
        for name, n, dtype in fields:
            view = self.device[off:off + n]
            dev[name] = view.view(torch.float32) if dtype == "float32" \
                else view
            off += n
        return dev

    def clear(self):
        """Zero the host buffer for the next fill, once the last staging
        copy has read it."""
        if self._staged is not None:
            self._staged.synchronize()
        self._words[:] = 0

    def stage(self):
        """One host-to-device copy of every field. Non-blocking on the
        card: ``clear`` waits for it before the host buffer is refilled."""
        self.device.copy_(self.host, non_blocking=True)
        if self._staged is not None:
            self._staged.record()


class Program:
    """``fn`` as one launchable program (see the module): a CUDA graph
    replayed on every call on the card, ``fn`` itself on the CPU.
    ``launches`` is what one replay launches, by kernel and variant."""

    def __init__(self, fn, device, *, pool=None, stream=None,
                 generators=()):
        self.fn = fn
        self.graph = None
        self.out = None
        self.launches = {}
        if device.type != "cuda":
            self._run = self._eager
            return
        with capture_lock:
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                _build.record_launches(fn)          # warm-up, not counted
            current.wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            for gen in generators:
                if not hasattr(graph, "register_generator_state"):
                    raise RuntimeError(
                        "this PyTorch cannot register a private generator "
                        "with a CUDA graph (CUDAGraph."
                        "register_generator_state): sampled serving "
                        "programs cannot be captured")
                graph.register_generator_state(gen)

            def capture():
                with gc_paused(), torch.cuda.graph(graph, pool=pool,
                                                   stream=stream):
                    self.out = fn()

            self.launches = _build.record_launches(capture)
            self.graph = graph
        self._run = self._replay

    def _eager(self):
        self.out = self.fn()
        return self.out

    def _replay(self):
        self.graph.replay()
        _build.count_replay(self.launches)
        return self.out

    def __call__(self):
        return self._run()
