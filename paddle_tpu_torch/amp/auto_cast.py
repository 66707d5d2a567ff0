"""Automatic mixed precision.

Counterpart of ``paddle_tpu/amp/auto_cast.py``: ``auto_cast`` (alias
``amp_guard``) with levels O0/O1/O2 and custom white and black lists,
``decorate``, ``is_auto_cast_enabled`` and ``get_amp_dtype``. The policy
is the JAX package's, by op name, on the same lists (``white_list``,
``black_list``):

* O1: a white-listed op runs in the AMP dtype (its float inputs are cast
  to it), a black-listed op in float32, any other op as its inputs come;
* O2: a black-listed op runs in float32, every other op in the AMP dtype;
* a custom white entry wins over the built-in black list and the other
  way round, as in the JAX hook.

``torch.autocast`` is not the policy: its built-in CUDA lists differ
from these and take no custom lists. The JAX package casts in its
dispatch hook, which every op call goes through; here the hook is one
``torch.overrides.TorchFunctionMode`` (``_AmpMode``), pushed by
``auto_cast``, that maps each torch callable to its paddle op name
(``F.linear`` -> ``linear``, ``torch.matmul`` -> ``matmul``,
``torch.exp`` -> ``exp``, ... in ``_TORCH_OPS``) and casts the float
tensors among its arguments. Torch callables outside that map (views,
shape ops, creation, explicit casts) pass through untouched.

The port's own ops (``rms_norm``, ``scaled_dot_product_attention``,
``cross_entropy``, ``fused_linear_cross_entropy``, ``rope_qk``,
``swiglu``) are single ops of the JAX package: they consult the policy
by their name through ``amp_op`` and run their bodies with the mode
suspended, so their internals keep their own precision and the flash
ops launch their kernels in the dtype the policy chose.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = [
    "auto_cast", "amp_guard", "decorate", "is_auto_cast_enabled",
    "get_amp_dtype", "white_list", "black_list", "amp_op", "suspended",
]

# the JAX package's lists: matmul-class ops run in low precision,
# numerically sensitive ops stay float32, the rest as their inputs come
white_list = {
    "matmul",
    "bmm",
    "mm",
    "mv",
    "einsum",
    "conv1d",
    "conv2d",
    "conv3d",
    "conv1d_transpose",
    "conv2d_transpose",
    "conv3d_transpose",
    "addmm",
    "linear",
    "flash_attention",
    "scaled_dot_product_attention",
}
black_list = {
    "exp",
    "square",
    "log",
    "log2",
    "log10",
    "log1p",
    "mean",
    "sum",
    "cos_sim",
    "softmax",
    "log_softmax",
    "softmax_with_cross_entropy",
    "cross_entropy",
    "binary_cross_entropy",
    "sigmoid_cross_entropy_with_logits",
    "c_softmax_with_cross_entropy",
    "layer_norm",
    "group_norm",
    "instance_norm",
    "rms_norm",
    "reduce_sum",
    "logsumexp",
    "erfinv",
    "acos",
    "asin",
    "cosh",
    "tan",
    "sinh",
    "atanh",
    "acosh",
    "asinh",
    "pow",
    "norm",
    "nll_loss",
    "kl_div",
    "cumsum",
    "cumprod",
    "prod",
    "var",
    "std",
}

_T = torch.Tensor
# torch callable -> the paddle op name the policy knows it by
_TORCH_OPS = {
    F.linear: "linear", torch.matmul: "matmul", _T.matmul: "matmul",
    _T.__matmul__: "matmul", _T.__rmatmul__: "matmul", torch.bmm: "bmm",
    _T.bmm: "bmm", torch.mm: "mm", _T.mm: "mm", torch.mv: "mv",
    _T.mv: "mv", torch.einsum: "einsum", F.conv1d: "conv1d",
    F.conv2d: "conv2d", F.conv3d: "conv3d",
    F.conv_transpose1d: "conv1d_transpose",
    F.conv_transpose2d: "conv2d_transpose",
    F.conv_transpose3d: "conv3d_transpose", torch.addmm: "addmm",
    _T.addmm: "addmm",
    F.scaled_dot_product_attention: "scaled_dot_product_attention",
    torch.exp: "exp", _T.exp: "exp", torch.square: "square",
    _T.square: "square", torch.log: "log", _T.log: "log",
    torch.log2: "log2", _T.log2: "log2", torch.log10: "log10",
    _T.log10: "log10", torch.log1p: "log1p", _T.log1p: "log1p",
    torch.mean: "mean", _T.mean: "mean", torch.sum: "sum", _T.sum: "sum",
    torch.softmax: "softmax", _T.softmax: "softmax", F.softmax: "softmax",
    torch.log_softmax: "log_softmax", _T.log_softmax: "log_softmax",
    F.log_softmax: "log_softmax", F.cross_entropy: "cross_entropy",
    F.binary_cross_entropy: "binary_cross_entropy",
    F.binary_cross_entropy_with_logits:
        "sigmoid_cross_entropy_with_logits",
    F.cosine_similarity: "cos_sim", F.layer_norm: "layer_norm",
    F.group_norm: "group_norm", F.instance_norm: "instance_norm",
    torch.logsumexp: "logsumexp", _T.logsumexp: "logsumexp",
    torch.erfinv: "erfinv", _T.erfinv: "erfinv", torch.acos: "acos",
    _T.acos: "acos", torch.asin: "asin", _T.asin: "asin",
    torch.cosh: "cosh", _T.cosh: "cosh", torch.tan: "tan", _T.tan: "tan",
    torch.sinh: "sinh", _T.sinh: "sinh", torch.atanh: "atanh",
    _T.atanh: "atanh", torch.acosh: "acosh", _T.acosh: "acosh",
    torch.asinh: "asinh", _T.asinh: "asinh", torch.pow: "pow",
    _T.pow: "pow", _T.__pow__: "pow", torch.norm: "norm", _T.norm: "norm",
    torch.linalg.vector_norm: "norm", F.nll_loss: "nll_loss",
    F.kl_div: "kl_div", torch.cumsum: "cumsum", _T.cumsum: "cumsum",
    torch.cumprod: "cumprod", _T.cumprod: "cumprod", torch.prod: "prod",
    _T.prod: "prod", torch.var: "var", _T.var: "var", torch.std: "std",
    _T.std: "std",
    # on no list: as their inputs come under O1, the AMP dtype under O2
    F.embedding: "embedding", torch.add: "add", _T.add: "add",
    _T.__add__: "add", _T.__radd__: "add", torch.sub: "subtract",
    _T.sub: "subtract", _T.__sub__: "subtract", _T.__rsub__: "subtract",
    torch.mul: "multiply", _T.mul: "multiply", _T.__mul__: "multiply",
    _T.__rmul__: "multiply", torch.div: "divide", _T.div: "divide",
    _T.__truediv__: "divide", _T.__rtruediv__: "divide",
    F.silu: "silu", torch.sigmoid: "sigmoid", _T.sigmoid: "sigmoid",
    F.sigmoid: "sigmoid", torch.tanh: "tanh", _T.tanh: "tanh",
    F.tanh: "tanh", F.gelu: "gelu", F.relu: "relu", torch.relu: "relu",
    _T.relu: "relu", torch.sqrt: "sqrt", _T.sqrt: "sqrt",
    torch.rsqrt: "rsqrt", _T.rsqrt: "rsqrt", torch.where: "where",
    torch.maximum: "maximum", torch.minimum: "minimum",
    torch.cat: "concat", torch.stack: "stack",
}
_FLOATS = (torch.float32, torch.float16, torch.bfloat16)
_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()
        self.suspended = 0


_state = _AmpState()


def _amp_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(
            f"auto_cast dtype must be float16 or bfloat16, got {dtype!r}"
        ) from None


def _target(op_name):
    """The dtype op ``op_name``'s float inputs run in under the active
    policy, or None (as they come)."""
    if not _state.enabled or _state.suspended:
        return None
    wl = (white_list | _state.custom_white) - _state.custom_black
    bl = (black_list | _state.custom_black) - _state.custom_white
    if _state.level == "O2":
        return torch.float32 if op_name in bl else _state.dtype
    if op_name in wl:
        return _state.dtype
    if op_name in bl:
        return torch.float32
    return None


def _cast(tree, target):
    """Every float tensor in ``tree`` (tensors, lists, tuples, dicts) in
    ``target``."""
    if isinstance(tree, torch.Tensor):
        if tree.dtype in _FLOATS and tree.dtype != target:
            return tree.to(target)
        return tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, target) for v in tree)
    if isinstance(tree, dict):
        return {k: _cast(v, target) for k, v in tree.items()}
    return tree


class _AmpMode(TorchFunctionMode):
    """The dispatch hook: casts a mapped torch callable's float tensor
    arguments to the policy's dtype. While this handler runs the mode is
    off, so its own casts and the call itself are not intercepted."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _TORCH_OPS.get(func)
        # a custom autograd Function's backward run by loss.backward()
        # inside the block is not a forward op of the policy
        if name is not None and torch._C._current_graph_task_id() < 0:
            target = _target(name)
            if target is not None:
                args, kwargs = _cast(args, target), _cast(kwargs, target)
        return func(*args, **kwargs)


@contextlib.contextmanager
def suspended():
    """Run the block as it comes, whatever policy is active: the
    optimizer's update and the loss scaler, which the JAX package runs
    outside its dispatch hook."""
    _state.suspended += 1
    try:
        yield
    finally:
        _state.suspended -= 1


def amp_op(name):
    """Decorator for the port's own ops: the op's float tensor positional
    arguments are cast as the policy says for op ``name``, and its body
    runs with the mode suspended (one op of the JAX package, not the
    torch calls inside it)."""
    def wrap(fn):
        @functools.wraps(fn)
        def op(*args, **kwargs):
            if not _state.enabled or _state.suspended:
                return fn(*args, **kwargs)
            target = _target(name)
            if target is not None:
                args = _cast(args, target)
            with suspended():
                return fn(*args, **kwargs)
        return op
    return wrap


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Run the block under the AMP policy (``enable=False`` or level
    "O0": as it comes)."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"level must be O0/O1/O2, got {level}")
    prev = (_state.enabled, _state.dtype, _state.level,
            _state.custom_white, _state.custom_black)
    _state.enabled = bool(enable) and level != "O0"
    _state.dtype = _amp_dtype(dtype)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        with _AmpMode():
            yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black) = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 casts every float32 parameter of ``models`` (a module or a list)
    to ``dtype`` in place (the ``Parameter`` objects stay, so an optimizer
    built before keeps them); O1 changes nothing. Master weights come from
    the optimizer's ``multi_precision``, as in the JAX package."""
    if level == "O2":
        target = _amp_dtype(dtype)
        model_list = models if isinstance(models, (list, tuple)) else [
            models]
        for m in model_list:
            if isinstance(m, torch.nn.Module):
                m._amp_dtype = str(target).removeprefix("torch.")
                for p in m.parameters():
                    if p.dtype == torch.float32:
                        p.data = p.data.to(target)
    if optimizers is None:
        return models
    return models, optimizers


def is_auto_cast_enabled():
    return _state.enabled


def get_amp_dtype():
    return str(_state.dtype).removeprefix("torch.")
