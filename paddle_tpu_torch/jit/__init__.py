"""paddle.jit analogue on ``torch.compile`` and ``torch.export``
(counterpart of ``paddle_tpu/jit/``).

  * ``to_static(fn_or_layer)`` — stage a tensor function or a layer's
    forward (``api``); ``full_graph=False`` splits at graph breaks
    (``graph_break``); ``cache=`` persists compiled eval programs across
    processes (``compilecache``).
  * ``bucketize`` — pad dynamic dims up to buckets (``bucketing``).
  * ``save``/``load`` — one exported program per bucket combination
    (``serialization``).
  * ``TrainStep(model, loss_fn, optimizer)`` — the training step
    (``train_step``).
"""
from .api import StaticFunction, ignore_module, not_to_static, to_static
from .bucketing import BucketedFunction, bucketize
from .serialization import InputSpec, TranslatedLayer, load, save
from .train_step import TrainStep

__all__ = [
    "to_static",
    "not_to_static",
    "ignore_module",
    "StaticFunction",
    "TrainStep",
    "save",
    "load",
    "InputSpec",
    "TranslatedLayer",
    "bucketize",
    "BucketedFunction",
]
