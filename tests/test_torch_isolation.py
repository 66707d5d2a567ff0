"""paddle_tpu_torch stands alone: importing it (its serving, training,
MoE and quantization modules, the journal, QoS, the HTTP server and its
CLI, the retry policy, the replica supervisor and the fleet, the step
observatory, the compile log and the host spill tier, the data loader,
amp, the checkpoints, the watchdog and the train loop, DiT and the
optimizers, the nn layer set, vision and the DataLoader's process
workers, the static analyzer and the observability CLI, fft, signal,
audio, distribution and the random ops too) loads neither
jax, nor anything of paddle_tpu, nor ml_dtypes, and its entry points
refuse to fall back to the CPU quietly when no CUDA device exists."""
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
import paddle_tpu_torch.kernels.paged_prefill
import paddle_tpu_torch.serving.programs
import paddle_tpu_torch.serving.prefix_cache
import paddle_tpu_torch.serving.speculation
import paddle_tpu_torch.ops.moe_ops
import paddle_tpu_torch.incubate
import paddle_tpu_torch.quantization
import paddle_tpu_torch.optimizer
import paddle_tpu_torch.nn
import paddle_tpu_torch.jit
import paddle_tpu_torch.distributed
import paddle_tpu_torch.resilience
import paddle_tpu_torch.observability
import paddle_tpu_torch.serving.journal
import paddle_tpu_torch.serving.access_log
import paddle_tpu_torch.serving.qos
import paddle_tpu_torch.serving.server
import paddle_tpu_torch.serving.__main__
import paddle_tpu_torch.resilience.retry
import paddle_tpu_torch.serving.supervisor
import paddle_tpu_torch.serving.fleet
import paddle_tpu_torch.serving.spill
import paddle_tpu_torch.observability.stepstats
import paddle_tpu_torch.observability.jit_events
import paddle_tpu_torch.io
import paddle_tpu_torch.amp
import paddle_tpu_torch.regularizer
import paddle_tpu_torch.optimizer.lr
import paddle_tpu_torch.distributed.checkpoint
import paddle_tpu_torch.distributed.watchdog
import paddle_tpu_torch.resilience.train_state
import paddle_tpu_torch.models.dit
import paddle_tpu_torch.optimizer.lbfgs
import paddle_tpu_torch.nn.functional
import paddle_tpu_torch.nn.initializer
import paddle_tpu_torch.nn.parameter
import paddle_tpu_torch.nn.layer.layers
import paddle_tpu_torch.nn.layer.conv
import paddle_tpu_torch.nn.layer.norm
import paddle_tpu_torch.nn.layer.pooling
import paddle_tpu_torch.nn.layer.activation
import paddle_tpu_torch.nn.layer.common
import paddle_tpu_torch.nn.layer.container
import paddle_tpu_torch.nn.layer.loss
import paddle_tpu_torch.ops.manipulation
import paddle_tpu_torch.vision
import paddle_tpu_torch.vision.models.resnet
import paddle_tpu_torch.vision.transforms
import paddle_tpu_torch.vision.datasets
import paddle_tpu_torch.io.dataloader
import paddle_tpu_torch.analysis
import paddle_tpu_torch.analysis.__main__
import paddle_tpu_torch.analysis.astlint
import paddle_tpu_torch.analysis.trace
import paddle_tpu_torch.analysis.passes
import paddle_tpu_torch.analysis.compiled
import paddle_tpu_torch.observability.__main__
import paddle_tpu_torch.compilecache
import paddle_tpu_torch.compilecache.__main__
import paddle_tpu_torch.jit.api
import paddle_tpu_torch.jit.bucketing
import paddle_tpu_torch.jit.graph_break
import paddle_tpu_torch.jit.serialization
import paddle_tpu_torch.fft
import paddle_tpu_torch.signal
import paddle_tpu_torch.audio
import paddle_tpu_torch.audio.functional
import paddle_tpu_torch.audio.features
import paddle_tpu_torch.audio.backends
import paddle_tpu_torch.distribution
import paddle_tpu_torch.distribution.transform
import paddle_tpu_torch.ops.random
import paddle_tpu_torch.ops.math
import paddle_tpu_torch.ops.fft_ops
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.")
    or m == "paddle_tpu" or m.startswith("paddle_tpu.")
    or m == "ml_dtypes" or m.startswith("ml_dtypes.")
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
                        assert not mod.startswith(("jax", "paddle_tpu.",
                                                   "ml_dtypes")), (
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


def test_spill_and_observatory_follow_the_models_device():
    """An engine with the spill tier and the observatory on: without a
    card a default-device model cannot be built; given the CPU the pool,
    the slab (not pinned) and the observatory's peak row are the CPU's."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig

    _require_no_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny())
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    engine = Engine(model, EngineConfig(max_batch_slots=2, max_model_len=16,
                                        page_size=4, host_spill_bytes=1 << 20))
    assert engine.pool.device == torch.device("cpu")
    assert not engine.spill.slab.rows.is_pinned()
    assert engine.stepstats.backend == "cpu"
    assert engine.stepstats.peak_source == "CPU placeholder"


def test_dataloader_without_device_raises_without_cuda():
    from paddle_tpu_torch.io import DataLoader, TensorDataset

    _require_no_cuda()
    data = TensorDataset([torch.arange(8)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataLoader(data, batch_size=2)
    batches = list(DataLoader(data, batch_size=2, device="cpu"))
    assert len(batches) == 4 and batches[0][0].device.type == "cpu"


def test_signal_and_distribution_creation_without_device_raise():
    """The FFT frequencies, the random creation ops and a distribution
    over Python numbers go to the card by default: without one they
    raise; given the CPU they build there."""
    from paddle_tpu_torch import distribution, fft, ops

    _require_no_cuda()
    for make in (lambda **kw: fft.fftfreq(8, **kw),
                 lambda **kw: ops.uniform([4], **kw),
                 lambda **kw: distribution.Normal(0.0, 1.0, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert fft.fftfreq(8, device="cpu").device.type == "cpu"
    assert ops.uniform([4], device="cpu").device.type == "cpu"
    d = distribution.Normal(0.0, 1.0, device="cpu")
    assert d.sample([3]).device.type == "cpu"


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
                              "grouped_matmul_bwd", "kv_write",
                              "paged_prefill")


def test_prefill_ext_on_cpu_tensors_takes_the_plain_version():
    # a continuation on CPU tensors runs paged_prefill_ref through the
    # kernel wrapper (uncounted); it never reaches the kernel
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import KVPool
    from paddle_tpu_torch.serving.adapter import LlamaServingAdapter

    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    ad = LlamaServingAdapter(model)
    pool = KVPool(ad.num_layers, ad.num_kv_heads, 8, 4, ad.head_dim,
                  device="cpu")
    _build.reset_launch_counts()
    logits = ad.prefill_ext(pool.k, pool.v, torch.arange(1, 9), 5, 6,
                            torch.arange(8, dtype=torch.int32))
    assert logits.shape == (model.config.vocab_size,)
    assert bool(torch.isfinite(logits).all())
    assert set(_build.launch_counts().values()) == {0}
    assert _build._libs == {}


def test_cli_and_serve_default_to_the_card(capsys):
    """``python -m paddle_tpu_torch.serving serve`` without ``--device``
    builds its engine on the card: without one it exits with the named
    error and starts nothing; ``serve`` fronts whatever engine it is
    given, and an engine over a default-device model cannot be built."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, serve
    from paddle_tpu_torch.serving.__main__ import main

    _require_no_cuda()
    assert main(["serve", "--model", "tiny", "--port", "0"]) == 2
    err = capsys.readouterr().err
    assert "error: ConfigError" in err and "no CUDA device" in err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny())
    engine = Engine(LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"),
                    EngineConfig(max_batch_slots=2, max_model_len=16,
                                 page_size=4))
    import signal

    term = signal.getsignal(signal.SIGTERM)
    srv = serve(engine, port=0)     # installs the SIGTERM drain
    try:
        assert srv.backend.device == torch.device("cpu")
    finally:
        srv.close()
        signal.signal(signal.SIGTERM, term)


def test_fleet_replicas_run_on_the_models_device(capsys):
    """A fleet's replicas follow their shared model's device; the CLI's
    ``--replicas`` without ``--device`` needs the card like the engine."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import EngineConfig, Fleet, FleetConfig
    from paddle_tpu_torch.serving.__main__ import main

    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    fleet = Fleet(model, EngineConfig(max_batch_slots=2, max_model_len=16,
                                      page_size=4),
                  FleetConfig(num_replicas=2))
    assert [s.engine.device for s in fleet.replicas] == [
        torch.device("cpu")] * 2
    assert fleet.replicas[0].engine.pool.k[0].data_ptr() != \
        fleet.replicas[1].engine.pool.k[0].data_ptr()
    _require_no_cuda()
    assert main(["serve", "--model", "tiny", "--port", "0",
                 "--replicas", "2"]) == 2
    err = capsys.readouterr().err
    assert "error: ConfigError" in err and "no CUDA device" in err
