"""Every ported subpackage exports what the JAX subpackage of the same name
exports, but for the names left out on purpose, each with its reason.

A script written against the JAX package imports names from its
subpackages; a name the port lacks fails at import. A future gap (a
JAX export that is neither ported nor listed here) fails this test at
once, and so does a listed name once it is exported (take it off the
list).
"""
import importlib
import pkgutil

import pytest

import paddle_tpu_torch

A9_DIST = ("the collectives, meshes, sharding, pipelines and RPC on "
           "torch.distributed (ROADMAP A9)")
A9_QUANT = "the sparse and quantization surface (ROADMAP A9)"
A9_PLACE = "serving/placement.py and autoscaling (ROADMAP A9)"
A9_TP = "tensor-parallel serving (ROADMAP A9)"
LEFT_OUT = {
    "distributed": dict.fromkeys((
        "ColWiseParallel", "DataParallel", "DistMeta", "DistModel", "Group",
        "ParallelEnv", "Partial", "PipelineParallel", "PipelineStages",
        "Placement", "ProcessMesh", "ReduceOp", "Replicate",
        "RowWiseParallel", "Shard", "ShardDataloader", "ShardingStage1",
        "ShardingStage2", "ShardingStage3", "Strategy", "TCPStore",
        "all_gather", "all_reduce", "all_to_all", "barrier", "broadcast",
        "default_mesh", "destroy_process_group", "dtensor_from_local",
        "dtensor_to_local", "gather_sequence", "get_group", "get_rank",
        "get_world_size", "group_sharded_parallel", "init_parallel_env",
        "new_group", "parallelize", "passes", "pipeline_1f1b",
        "pipeline_apply", "pipeline_program", "pipeline_vpp",
        "pipeline_zero_bubble", "reduce", "reduce_scatter", "reshard",
        "ring_attention", "rpc", "scatter", "schedule_bubble_fraction",
        "shard_dataloader", "shard_layer", "shard_optimizer",
        "shard_tensor", "spawn", "split_sequence", "to_global_array",
        "to_static", "unshard_dtensor"), A9_DIST),
    "incubate": {"nn": "incubate.nn.functional (decode_attention, "
                       "ROADMAP A9)"},
    "quantization": dict.fromkeys((
        "AbsmaxObserver", "EMAObserver", "FakeQuanterWithAbsMax", "PTQ",
        "PerChannelAbsmaxObserver", "QAT", "QuantConfig", "quant_dequant",
        "quantize_weights", "weight_dequantize", "weight_quantize"),
        A9_QUANT),
    "serving": dict(
        dict.fromkeys(("Autoscaler", "PlacementError", "PlacementPlan",
                       "ScalingPolicy"), A9_PLACE),
        **dict.fromkeys(("TPSpec", "build_tp_mesh"), A9_TP)),
}
# ops: the JAX package exports its whole op table (ops.yaml, generated,
# and the manual ops of ops/api.py, ~470 names); the port exports the
# ops its slices run. The rest of the table is ROADMAP A9 ("ops/, the
# op YAML"). What is checked: every op the port implements and the JAX
# package exports is exported from the port's ops.
OPS_REASON = "the rest of the JAX op table (ops.yaml, ROADMAP A9)"
# subpackages whose JAX counterpart declares no __all__ (nothing to
# compare), and the port's own
NO_JAX_ALL = {
    "core": "the JAX core declares no __all__ (tensor, dispatch, flags)",
    "kernels": "the JAX kernels declare no __all__ (pallas modules)",
    "nn": "the JAX nn declares no __all__ (layers, functional, clip)",
}

SUBPACKAGES = sorted(m.name for m in pkgutil.iter_modules(
    paddle_tpu_torch.__path__))


def _all(module):
    return set(getattr(module, "__all__", None) or ())


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_subpackage_exports_match_jax(name):
    port = importlib.import_module(f"paddle_tpu_torch.{name}")
    jax_mod = importlib.import_module(f"paddle_tpu.{name}")
    want = _all(jax_mod)
    if not want:
        assert name in NO_JAX_ALL, (
            f"paddle_tpu.{name} declares no __all__; say why in NO_JAX_ALL")
        return
    assert name not in NO_JAX_ALL
    got = _all(port)
    assert got, f"paddle_tpu_torch.{name} declares no __all__"
    for n in got:
        assert hasattr(port, n), f"paddle_tpu_torch.{name}.{n} in __all__"
    missing = want - got
    if name == "ops":
        implemented = set()
        for mod in pkgutil.iter_modules(port.__path__):
            implemented |= _all(importlib.import_module(
                f"paddle_tpu_torch.ops.{mod.name}"))
        unexported = sorted((implemented & want) - got)
        assert not unexported, (
            f"ops the port implements and the JAX package exports, not "
            f"in paddle_tpu_torch.ops.__all__: {unexported}")
        # the rest of the table is OPS_REASON's; the port exports no op
        # name the JAX package lacks
        assert got <= want, sorted(got - want)
        return
    left_out = LEFT_OUT.get(name, {})
    gaps = sorted(missing - set(left_out))
    assert not gaps, (
        f"paddle_tpu.{name} exports {gaps}, which paddle_tpu_torch.{name} "
        f"lacks: port them or list them in LEFT_OUT with the reason")
    stale = sorted(set(left_out) - missing)
    assert not stale, f"{stale} are exported now: take them off LEFT_OUT"
    assert all(left_out.values())


# vision.models: the whole zoo is ported
def test_vision_models_exports_match_jax():
    from paddle_tpu.vision import models as jax_models
    from paddle_tpu_torch.vision import models

    want, got = set(jax_models.__all__), set(models.__all__)
    assert all(hasattr(models, n) for n in got)
    assert got == want, sorted(got ^ want)


def test_the_slice_names_are_exported():
    # the names this slice adds to the surface, by subpackage
    from paddle_tpu_torch import models, observability, ops, optimizer, \
        serving

    for mod, names in (
            (optimizer, ("SGD", "Momentum", "Adagrad", "Adadelta", "Adamax",
                         "ASGD", "Lamb", "LBFGS", "NAdam", "RAdam",
                         "RMSProp", "Rprop")),
            (models, ("DiT", "DiTConfig", "dit_xl_2", "dit_b_4",
                      "LlamaModel")),
            (ops, ("softmax_with_cross_entropy",)),
            (observability, ("StepStats", "register_stepstats_view")),
            (serving, ("FleetRequest",)),
            (ops, ("conv2d", "batch_norm_with_stats", "max_pool2d_with_index",
                   "adaptive_avg_pool2d", "flatten", "pad", "relu"))):
        for n in names:
            assert n in mod.__all__ and getattr(mod, n) is not None
