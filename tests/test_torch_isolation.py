"""paddle_tpu_torch stands alone: importing it (its serving, training,
MoE and quantization modules too) loads neither jax nor anything of
paddle_tpu, and its entry points refuse to fall back to the CPU quietly
when no CUDA device exists."""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import paddle_tpu_torch
import paddle_tpu_torch.serving
import paddle_tpu_torch.models
import paddle_tpu_torch.kernels.paged_attention
import paddle_tpu_torch.kernels.flash_attention
import paddle_tpu_torch.kernels.grouped_matmul
import paddle_tpu_torch.kernels.kv_write
import paddle_tpu_torch.serving.programs
import paddle_tpu_torch.ops.moe_ops
import paddle_tpu_torch.incubate
import paddle_tpu_torch.quantization
import paddle_tpu_torch.optimizer
import paddle_tpu_torch.nn
import paddle_tpu_torch.jit
import paddle_tpu_torch.distributed
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.")
    or m == "paddle_tpu" or m.startswith("paddle_tpu.")
)
print(",".join(bad))
"""


def test_import_loads_no_jax_and_no_paddle_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"imported: {out.stdout.strip()}"


def test_sources_name_no_jax_import():
    pkg = os.path.join(REPO, "paddle_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                for line in f:
                    s = line.strip()
                    if s.startswith(("import ", "from ")):
                        mod = s.split()[1]
                        assert not mod.startswith(("jax", "paddle_tpu.")), (
                            f"{name}: {s}"
                        )
                        assert mod != "paddle_tpu", f"{name}: {s}"


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")


def test_model_without_device_raises_without_cuda():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    _require_no_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny())


def test_moe_layer_and_int8_engine_without_device_raise_without_cuda():
    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig

    _require_no_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MoELayer(8, 2, 16, impl="ragged")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny(num_experts=4))
    # given the CPU, both build there, and an int8 engine follows its
    # model's device
    assert MoELayer(8, 2, 16, device="cpu").gate.weight.device.type == "cpu"
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    engine = Engine(model, EngineConfig(max_batch_slots=2, max_model_len=16,
                                        page_size=4, kv_cache_dtype="int8"))
    assert all(t.device == torch.device("cpu")
               for pair in engine.pool.k for t in pair)


def test_kv_pool_without_device_raises_without_cuda():
    from paddle_tpu_torch.serving import KVPool

    _require_no_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVPool(1, 2, 4, 4, 8)
    # the dtype is checked first: a bad one is a ValueError on any host
    with pytest.raises(ValueError, match="quant_dtype"):
        KVPool(1, 2, 4, 4, 8, quant_dtype="fp8")
    assert KVPool(1, 2, 4, 4, 8, device="cpu").device == torch.device("cpu")


def test_resolve_device_default_raises_explicit_cpu_works():
    from paddle_tpu_torch import resolve_device

    _require_no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_engine_runs_on_the_models_device():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig

    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    engine = Engine(model, EngineConfig(max_batch_slots=2, max_model_len=16,
                                        page_size=4))
    assert engine.device == torch.device("cpu")
    assert all(t.device == torch.device("cpu") for t in engine.pool.k)


def test_kernel_build_needs_nvcc_not_at_import():
    # importing the kernel modules builds nothing; the build directory is
    # only created by a launch on the card (or chip_smoke.py)
    from paddle_tpu_torch.kernels import _build

    assert _build._libs == {}
    assert _build.KERNELS == ("paged_attention", "flash_attention",
                              "flash_attention_bwd", "grouped_matmul",
                              "kv_write")
