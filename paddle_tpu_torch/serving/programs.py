"""The serving engine's step programs.

Counterpart of the JAX engine's compiled programs (``_build_steps``,
``paddle_tpu/serving/engine.py:723``): a decode program (at most two, the
greedy one and the mixed one, as JAX's static ``any_sample`` makes them)
and one prefill program per length bucket. Each is a function of no
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
  asked for the CPU, and the tests run it so).

Kernel launches inside a graph do not pass through their wrappers, so
the launches the capture recorded (``kernels._build.record_launches``)
are counted again on every replay (``count_replay``); the warm-up's are
not counted.

Sampling noise: a private ``torch.Generator`` per stream, registered with
every graph that draws from it (``CUDAGraph.register_generator_state``),
so each replay draws fresh numbers from where the generator stands.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build

__all__ = ["Program", "StepBuffers"]


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
        words = self.host.numpy()
        self.np, self.dev = {}, {}
        off = 0
        for name, n, dtype in fields:
            host, dev = words[off:off + n], self.device[off:off + n]
            if dtype == "float32":
                host, dev = host.view(np.float32), dev.view(torch.float32)
            self.np[name], self.dev[name] = host, dev
            off += n
        self._words = words

    def clear(self):
        self._words[:] = 0

    def stage(self):
        """One host-to-device copy of every field. Non-blocking on the
        card: the host buffer is refilled only after the step's read-back
        has synchronised the stream."""
        self.device.copy_(self.host, non_blocking=True)


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
            self._run = fn
            return
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            _build.record_launches(fn)          # warm-up, not counted
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    "this PyTorch cannot register a private generator with "
                    "a CUDA graph (CUDAGraph.register_generator_state): "
                    "sampled serving programs cannot be captured")
            graph.register_generator_state(gen)

        def capture():
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                self.out = fn()

        self.launches = _build.record_launches(capture)
        self.graph = graph
        self._run = self._replay

    def _replay(self):
        self.graph.replay()
        _build.count_replay(self.launches)
        return self.out

    def __call__(self):
        return self._run()
