"""Graph-break fallback for ``to_static(full_graph=False)``.

Counterpart of ``paddle_tpu/jit/graph_break.py``. The JAX package has
no bytecode VM, so it builds one: a lazy-segment engine at the op
dispatch layer that compiles the straight-line stretches between
data-dependent Python branches. Dynamo is that VM: with
``torch.compile(fullgraph=False)`` it splits the function at every point
it cannot trace (a tensor's truthiness, ``.item()``, ``.numpy()``),
compiles each stretch as one graph and runs the Python in between
eagerly. Gradients compose across the breaks through autograd, as the
JAX segments compose through the tape. So this module is thin: it
counts the graphs the backend compiles (``stats["segments"]``).

Under ``full_graph=True`` the same function raises (``to_static``'s
default: one program or an error).
"""
from __future__ import annotations

import torch

from .api import _backend

__all__ = ["GraphBreakFunction"]


class GraphBreakFunction:
    """``to_static(full_graph=False)`` wrapper (see the module)."""

    def __init__(self, function, layer=None, backend=None):
        self._function = function
        self._layer = layer
        self._real_backend = _backend(backend)
        self.stats = {"segments": 0}
        self._compiled = torch.compile(function, backend=self._compile,
                                       fullgraph=False, dynamic=False)

    def _compile(self, gm, example_inputs):
        self.stats["segments"] += 1
        return self._real_backend(gm, example_inputs)

    def __call__(self, *args, **kwargs):
        return self._compiled(*args, **kwargs)
