"""Activation recomputation (gradient checkpointing).

Counterpart of ``paddle_tpu/distributed/recompute.py``: the segment's
activations are dropped after the forward and recomputed in the
backward, trading operations for device memory. Here it is
``torch.utils.checkpoint`` in its non-reentrant form, which gives the
gradients of the segment's parameters as well as of its tensor inputs
and replays a custom ``autograd.Function`` (the flash kernels) inside the
segment. ``recompute_sequential`` runs a chain of functions in
``ctx["segments"]`` checkpointed chunks, as in the JAX package.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

__all__ = ["recompute", "recompute_sequential"]


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward instead of saved."""
    return checkpoint(function, *args, use_reentrant=False, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Run ``functions`` (a ``Sequential``'s children, or any callables)
    one after another on ``args``, in ``ctx["segments"]`` checkpointed
    chunks (default: one function per segment); ``kwargs`` go to every
    function. A function's tuple output is the next one's arguments."""
    functions = list(functions)
    segments = int((ctx or {}).get("segments", len(functions))) or len(
        functions)
    per = max(1, (len(functions) + segments - 1) // segments)
    out = args
    for i in range(0, len(functions), per):
        chunk = functions[i:i + per]

        def seg_fn(*xs, _chunk=chunk, **kw):
            cur = xs
            for f in _chunk:
                cur = f(*cur, **kw) if kw else f(*cur)
                if not isinstance(cur, tuple):
                    cur = (cur,)
            return cur[0] if len(cur) == 1 else cur

        out = recompute(seg_fn, *(out if isinstance(out, tuple) else (out,)),
                        **kwargs)
    return out
