"""jit.save / jit.load — ahead-of-time model export over ``torch.export``.

Counterpart of ``paddle_tpu/jit/serialization.py``, where the artifact
is a serialized StableHLO program (``jax.export``). Here each program is
a ``torch.export`` ``ExportedProgram`` written with ``torch.export.save``.
The layer's parameters and buffers are inputs of the program (the layer
runs through ``torch.func.functional_call``), as they are call inputs of
the JAX program, so they are written once, not once per program.

Artifact layout at <path>:
    <path>.pdmodel        the program (no bucket sizes)
    <path>.b<sizes>.pdmodel  one program per bucket combination
    <path>.pdiparams      parameters + buffers (``torch.save``)
    <path>.pdmeta         input specs, buckets, output shapes, torch
                          version (json)

The hand kernels are ``torch.library`` ops, so an exported Llama forward
holds a ``paddle_tpu_torch::flash_attention_fwd`` node per layer and the
loaded program launches the kernel on the card. ``load`` imports
``paddle_tpu_torch.kernels`` first, which registers the ops the program
names.

Dynamic dims: an exported program here has static shapes, so a spec dim
of ``None``/``-1`` needs a policy. ``save(..., bucket_sizes={dim:
[sizes]})`` exports ONE PROGRAM PER BUCKET COMBINATION (the
``jit.bucketing`` policy applied at export time); ``load`` returns a
``TranslatedLayer`` that picks the right program by shape, pads inputs
up to the bucket, and slices padded output dims back. Without
``bucket_sizes`` a dynamic dim is exported at size 1 (call sites must
match exactly).

Version safety: the pdmeta records the exporting torch version; ``load``
raises a clear ValueError naming both sides when a program cannot be
read under the running torch, instead of failing deep inside the
deserializer.
"""
from __future__ import annotations

import itertools
import json

import torch
from torch.utils import _pytree as pytree

from .bucketing import next_bucket, pad_to

__all__ = ["save", "load", "InputSpec", "TranslatedLayer"]

_META_FORMAT = 1


class InputSpec:
    """An input's shape (``None``/-1 for a dynamic dim), dtype name and
    name."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = str(dtype).removeprefix("torch.")
        if not isinstance(getattr(torch, self.dtype, None), torch.dtype):
            raise ValueError(f"InputSpec: unknown dtype {dtype!r}")
        self.name = name

    def dynamic_dims(self):
        return [
            d for d, v in enumerate(self.shape) if v is None or v < 0
        ]

    def example(self, dim_sizes=None, device=None):
        """A zero tensor of the spec; dynamic dims resolve through
        ``dim_sizes`` ({dim: size}, the bucket combination) or 1."""
        dim_sizes = dim_sizes or {}
        shape = [
            (dim_sizes.get(d, 1) if (v is None or v < 0) else v)
            for d, v in enumerate(self.shape)
        ]
        return torch.zeros(shape, dtype=getattr(torch, self.dtype),
                           device=device)

    def to_json(self):
        return {"shape": self.shape, "dtype": self.dtype, "name": self.name}

    @classmethod
    def from_json(cls, d):
        return cls(d["shape"], d["dtype"], d.get("name"))


def _bucket_path(path, combo):
    return f"{path}.b{'x'.join(str(s) for s in combo)}.pdmodel"


class _Staged(torch.nn.Module):
    """``fn(state, *inputs)``: the layer's forward with its parameters
    and buffers as inputs (the layer is held outside the module tree, so
    the exported program keeps no state of its own)."""

    def __init__(self, fn, layer):
        super().__init__()
        self._fn = fn
        object.__setattr__(self, "_held", layer)

    def forward(self, state, *inputs):
        if self._held is None:
            return self._fn(*inputs)
        return torch.func.functional_call(self._held, state, inputs)


def _state(layer):
    if not isinstance(layer, torch.nn.Module):
        return {}
    state = dict(layer.named_parameters())
    state.update(layer.named_buffers())
    return {k: v.detach() for k, v in state.items()}


def _out_shapes(ep):
    """The exported program's output shapes, flat, in order."""
    out = next(n for n in ep.graph.nodes if n.op == "output")
    names = set(ep.graph_signature.user_outputs)
    shapes = []
    for n in out.args[0]:
        if isinstance(n, torch.fx.Node):
            if n.name in names:
                val = n.meta.get("val")
                shapes.append(list(val.shape) if val is not None else None)
        else:
            shapes.append(None)
    return shapes


def _write_program(ep, file):
    # a file object: torch.export names its own archives ``.pt2``
    with open(file, "wb") as f:
        torch.export.save(ep, f)


def save(layer, path, input_spec=None, bucket_sizes=None, **config):
    """Export ``layer`` (a module's forward, or a function) on the given
    specs, in eval and without gradients.

    ``bucket_sizes``: {dim_index: [sizes]} covering every dynamic dim in
    the specs — one program is exported per bucket combination. Without
    it, dynamic dims export at size 1."""
    if input_spec is None:
        raise ValueError("jit.save requires input_spec")
    specs = [
        s if isinstance(s, InputSpec) else InputSpec(**s)
        for s in input_spec
    ]
    dyn_dims = sorted({d for s in specs for d in s.dynamic_dims()})
    buckets = None
    if bucket_sizes:
        buckets = {
            int(d): sorted(int(v) for v in sizes)
            for d, sizes in bucket_sizes.items()
        }
        missing = [d for d in dyn_dims if d not in buckets]
        if missing:
            raise ValueError(
                f"bucket_sizes covers dims {sorted(buckets)} but the "
                f"input specs have dynamic dims {dyn_dims} (missing "
                f"{missing})"
            )
        # only dims that are actually dynamic somewhere get programs
        buckets = {d: buckets[d] for d in dyn_dims}
        if not buckets:
            raise ValueError(
                "bucket_sizes given but no input spec has a dynamic "
                "dim (use concrete shapes instead)"
            )
    module = isinstance(layer, torch.nn.Module)
    state = _state(layer)
    device = next(iter(state.values())).device if state else None
    staged = _Staged(layer.forward if module else layer,
                     layer if module else None)

    def export(dim_sizes):
        examples = [s.example(dim_sizes, device) for s in specs]
        with torch.no_grad():
            return torch.export.export(staged, (state, *examples),
                                       strict=False)

    combos, out_shapes = None, {}
    if buckets:
        dims = sorted(buckets)
        combos = [
            list(c) for c in itertools.product(*[buckets[d] for d in dims])
        ]
        for combo in combos:
            ep = export(dict(zip(dims, combo)))
            out_shapes["x".join(map(str, combo))] = _out_shapes(ep)
            _write_program(ep, _bucket_path(path, combo))
    else:
        ep = export(None)
        out_shapes[""] = _out_shapes(ep)
        _write_program(ep, path + ".pdmodel")
    torch.save(state, path + ".pdiparams")
    with open(path + ".pdmeta", "w") as f:
        json.dump(
            {
                "format": _META_FORMAT,
                "torch_version": torch.__version__,
                "input_spec": [s.to_json() for s in specs],
                "buckets": (
                    {"dims": sorted(buckets), "combos": combos}
                    if buckets else None
                ),
                "out_shapes": out_shapes,
                "state_names": list(state),
            },
            f,
        )


def _deserialize_program(file, meta):
    """``torch.export.load`` with a CLEAR failure mode: a version-
    mismatched or corrupt program raises a ValueError naming the recorded
    and running torch versions instead of failing deep in the
    deserializer."""
    try:
        with open(file, "rb") as f:
            return torch.export.load(f).module()
    except Exception as e:
        # analysis: allow(broad-except) classify-and-reraise: the
        # deserializer's failure types are internal and unstable
        saved = meta.get("torch_version")
        if saved and saved != torch.__version__:
            raise ValueError(
                f"{file}: program was exported with torch {saved} but "
                f"this process runs torch {torch.__version__} and cannot "
                f"read it — re-export the model under the current torch"
            ) from e
        raise ValueError(
            f"{file}: serialized program is unreadable (corrupt file or "
            f"incompatible exporter): {type(e).__name__}: {e}"
        ) from e


class TranslatedLayer:
    """A loaded inference artifact (JAX's ``TranslatedLayer``): runs the
    exported programs with the saved parameters as inputs.

    Bucketed artifacts hold one program per bucket combination: a call
    picks the smallest combination covering the actual dynamic-dim
    sizes, zero-pads the inputs up to it, and slices padded output dims
    back to the true size. Which output dims to slice is DERIVED, not
    guessed: an (output, axis) pair tracks a bucket dim iff its exported
    size varies across that dim's bucket combinations — so a fixed-size
    output dim that merely coincides with a padded target is left alone.
    (With a single bucket size per dim there is nothing to compare, and
    the equal-to-target heuristic is the fallback.)"""

    def __init__(self, program, state, meta, programs=None):
        self._program = program            # single-program artifacts
        self._programs = programs or {}    # {combo: program}
        self._state = state
        self._meta = meta
        buckets = meta.get("buckets") if self._programs else None
        if buckets:
            self._bucket_dims = buckets["dims"]
            self._sizes_per_dim = {
                d: sorted({c[j] for c in buckets["combos"]})
                for j, d in enumerate(self._bucket_dims)
            }
            self._out_tracking = self._derive_out_tracking()

    def _derive_out_tracking(self):
        """{bucket dim: {(flat output index, axis)} that track it} —
        computed once by diffing the exported output shapes between two
        programs that differ only in that dim's bucket size. ``None`` per
        dim when only one size was exported (no pair to compare)."""
        combos = [tuple(c) for c in self._meta["buckets"]["combos"]]
        shapes = self._meta["out_shapes"]
        have = set(combos)
        base = combos[0]
        tracking = {}
        for j, d in enumerate(self._bucket_dims):
            alt = next(
                (s for s in self._sizes_per_dim[d] if s != base[j]), None
            )
            partner = base[:j] + (alt,) + base[j + 1:]
            if alt is None or partner not in have:
                tracking[d] = None  # fall back to the size heuristic
                continue
            s0 = shapes["x".join(map(str, base))]
            s1 = shapes["x".join(map(str, partner))]
            tracking[d] = {
                (i, k)
                for i, (a0, a1) in enumerate(zip(s0, s1))
                if a0 is not None and a1 is not None
                for k, (x0, x1) in enumerate(zip(a0, a1))
                if x0 != x1
            }
        return tracking

    def _pick_program(self, inputs):
        """(program, {dim: (target, required)}) for these inputs."""
        specs = self._meta["input_spec"]
        plan = {}
        for d in self._bucket_dims:
            required = 0
            for spec, a in zip(specs, inputs):
                shape = spec["shape"]
                if d < len(shape) and (shape[d] is None or shape[d] < 0):
                    required = max(required, a.shape[d])
            target = next_bucket(required, self._sizes_per_dim[d])
            plan[d] = (target, required)
        combo = tuple(plan[d][0] for d in self._bucket_dims)
        program = self._programs.get(combo)
        if program is None:
            raise ValueError(
                f"no exported program for bucket combination {combo} "
                f"(available: {sorted(self._programs)})"
            )
        return program, plan

    def _pad_inputs(self, inputs, plan):
        specs = self._meta["input_spec"]
        out = []
        for spec, a in zip(specs, inputs):
            widths = [0] * a.dim()
            for d, (target, _) in plan.items():
                shape = spec["shape"]
                if d < len(shape) and (
                        shape[d] is None or shape[d] < 0) \
                        and a.shape[d] < target:
                    widths[d] = target - a.shape[d]
            out.append(pad_to(a, widths) if any(widths) else a)
        return out

    def _slice_outputs(self, out, plan):
        cuts = {d: (t, r) for d, (t, r) in plan.items() if t != r}
        if not cuts:
            return out
        leaves, spec = pytree.tree_flatten(out)
        new = []
        for i, y in enumerate(leaves):
            if not isinstance(y, torch.Tensor):
                new.append(y)
                continue
            idx = []
            changed = False
            for k in range(y.dim()):
                cut = slice(None)
                for d, (target, required) in cuts.items():
                    tracked = self._out_tracking.get(d)
                    hit = (
                        (i, k) in tracked if tracked is not None
                        # single-size bucket: no cross-program diff to
                        # consult — assume a dim AT the padded target
                        # tracks it
                        else k == d
                    )
                    if hit and y.shape[k] == target:
                        cut = slice(0, required)
                        changed = True
                        break
                idx.append(cut)
            new.append(y[tuple(idx)] if changed else y)
        return pytree.tree_unflatten(new, spec)

    def __call__(self, *inputs):
        inputs = [i if isinstance(i, torch.Tensor) else torch.as_tensor(i)
                  for i in inputs]
        with torch.no_grad():
            if self._programs:
                program, plan = self._pick_program(inputs)
                inputs = self._pad_inputs(inputs, plan)
                out = program(self._state, *inputs)
                return self._slice_outputs(out, plan)
            return self._program(self._state, *inputs)

    forward = __call__

    def eval(self):
        return self

    @property
    def input_spec(self):
        return [
            InputSpec.from_json(d) for d in self._meta["input_spec"]
        ]


def load(path, **config):
    """Read an artifact written by ``save``; the parameters load on the
    device they were saved from."""
    from .. import kernels  # noqa: F401  (registers the kernels' ops)

    with open(path + ".pdmeta") as f:
        meta = json.load(f)
    buckets = meta.get("buckets")
    program, programs = None, None
    if buckets:
        programs = {
            tuple(combo): _deserialize_program(_bucket_path(path, combo),
                                               meta)
            for combo in buckets["combos"]
        }
    else:
        program = _deserialize_program(path + ".pdmodel", meta)
    state = torch.load(path + ".pdiparams", weights_only=True)
    state = {n: state[n] for n in meta["state_names"]}
    return TranslatedLayer(program, state, meta, programs=programs)
