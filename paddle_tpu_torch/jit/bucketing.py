"""Input bucketing: the recompile-avoidance policy for dynamic shapes.

Counterpart of ``paddle_tpu/jit/bucketing.py``. A compiled program here
has static shapes (``to_static`` compiles with ``dynamic=False``, one
program per input signature, as ``jax.jit``), so variable dims are
padded up to a small set of bucket sizes: one program per bucket
instead of one per shape.

    fn = jit.bucketize(model_fn, buckets={0: [8, 16, 32]})
    fn(x_batch_13)   # pads dim 0 to 16; at most len(buckets) compiles

Outputs whose padded dimension survives to the output are sliced back to
the true size (tracked per call). Padding is ``pad_value`` (zeros);
reductions over the padded axis are the CALLER's responsibility to mask
(same contract as any padded batch).

Slice-back is a size heuristic: an output dim equal to the padded target
is sliced to the true size (unpadded INPUT tensors passed through
unchanged are exempted by identity). An output that coincidentally has
the bucket size on a bucketed dim (e.g. a returned weight of shape
[bucket, k]) would be mis-sliced — return such values outside the
bucketed function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

__all__ = ["bucketize", "BucketedFunction", "next_bucket"]


def next_bucket(size, buckets):
    """Smallest bucket holding ``size`` (buckets ascending). Public: the
    serving engine buckets prefill lengths through the same policy so the
    program set stays bounded."""
    for b in buckets:
        if size <= b:
            return b
    raise ValueError(
        f"size {size} exceeds the largest bucket {buckets[-1]}; add a "
        "bigger bucket"
    )


def pad_to(x, widths, value=0):
    """``x`` padded at the end of each dim by ``widths[d]`` (leading-dim
    order; ``F.pad`` takes the last dim first)."""
    flat = []
    for w in reversed(widths):
        flat += [0, w]
    return F.pad(x, flat, value=value)


class BucketedFunction:
    def __init__(self, fn, buckets, pad_value=0):
        self._fn = fn
        self._buckets = {
            int(d): sorted(int(b) for b in bs) for d, bs in buckets.items()
        }
        self._pad_value = pad_value
        self.signatures = set()  # distinct padded signatures seen

    def __call__(self, *args, **kwargs):
        slice_back = {}   # dim -> (padded, original)
        passthrough = []  # unpadded input tensors: never slice these

        def pad(x):
            if not isinstance(x, torch.Tensor):
                return x
            widths = []
            for d in range(x.dim()):
                bs = self._buckets.get(d)
                if bs is None or x.shape[d] in bs:
                    widths.append(0)
                    continue
                target = next_bucket(x.shape[d], bs)
                widths.append(target - x.shape[d])
                slice_back[d] = (target, x.shape[d])
            if not any(widths):
                passthrough.append(x)
                return x
            return pad_to(x, widths, self._pad_value)

        args = pytree.tree_map(pad, args)
        kwargs = pytree.tree_map(pad, kwargs)
        self.signatures.add(tuple(
            (tuple(v.shape), str(v.dtype))
            for v in pytree.tree_leaves((args, kwargs))
            if isinstance(v, torch.Tensor)
        ))
        out = self._fn(*args, **kwargs)

        def unpad(y):
            if not isinstance(y, torch.Tensor):
                return y
            if any(y is t for t in passthrough):
                return y  # an unpadded input flowed straight through
            idx = []
            changed = False
            for d in range(y.dim()):
                pb = slice_back.get(d)
                if pb and y.shape[d] == pb[0] and pb[0] != pb[1]:
                    idx.append(slice(0, pb[1]))
                    changed = True
                else:
                    idx.append(slice(None))
            return y[tuple(idx)] if changed else y

        return pytree.tree_map(unpad, out)


def bucketize(function=None, buckets=None, pad_value=0):
    """Wrap ``function`` (a plain callable or a to_static StaticFunction)
    with the bucket-padding policy. ``buckets``: {tensor_dim: [sizes]}."""
    if buckets is None:
        raise ValueError("bucketize requires buckets={dim: [sizes]}")

    def wrap(fn):
        return BucketedFunction(fn, buckets, pad_value)

    if function is not None:
        return wrap(function)
    return wrap
