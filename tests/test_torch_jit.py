"""The port's jit surface (``to_static``, graph breaks, ``bucketize``,
``jit.save``/``load``) and the hand kernels as ``torch.library`` ops,
held against the JAX package on the CPU.

* ``to_static`` of a tiny Llama (and its GQA variant) and of a plain
  function: the same seeded numpy inputs and converted weights through
  JAX's ``to_static`` and the port's (``backend="aot_eager"``: Dynamo and
  AOTAutograd without Inductor's code generation); f32 logits within
  1e-4. One compile per input signature: a second call at the same shape
  compiles nothing, a new shape compiles once, a parameter update
  compiles nothing.
* Graph breaks: a data-dependent branch under ``full_graph=False``
  splits the function and matches JAX's graph-break function on both
  branches; under ``full_graph=True`` it raises.
* ``bucketize`` against JAX's on the same shapes; ``jit.save``/``load``
  per bucket: pad, slice, an oversize input and a version mismatch
  raising, the exported Llama holding its flash op nodes.
* Each custom op under ``torch.library.opcheck``.

The one Inductor compile of the CPU suite is the compile cache's round
trip (``test_to_static_cache_round_trip_hits_inductor_caches``): a cold
instance stores ``save_cache_artifacts``, a fresh instance over fresh
local caches loads them and Inductor's FX-graph cache hits.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import compilecache, jit
from paddle_tpu_torch.jit import serialization as S
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import grouped_matmul as gk
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.observability import jit_events

TOL = dict(atol=1e-4, rtol=1e-4)
EAGER = "aot_eager"


def _pair(kv=None):
    over = {"num_key_value_heads": kv} if kv else {}
    paddle.seed(0)
    jax_model = JaxLlama(JaxLlamaConfig.tiny(**over))
    state = {k: v.numpy() for k, v in jax_model.state_dict().items()}
    port = LlamaForCausalLM(LlamaConfig.tiny(**over), device="cpu")
    load_reference_state(port, state)
    return jax_model, port


# ------------------------------------------------------------ to_static --
@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa"])
def test_to_static_llama_matches_jax(kv):
    jax_model, port = _pair(kv)
    ids = np.random.RandomState(0).randint(1, 128, (2, 11)).astype("int64")
    jax_model.eval()
    staged_jax = paddle.jit.to_static(jax_model)
    with paddle.no_grad():
        ref = staged_jax(paddle.to_tensor(ids)).numpy()
    port.eval()
    jit.to_static(port, backend=EAGER)
    with torch.no_grad():
        out = port(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(out, ref, **TOL)
        assert port.forward.compiles == 1
        again = port(torch.from_numpy(ids)).numpy()
        assert port.forward.compiles == 1           # same shape: cached
        np.testing.assert_array_equal(again, out)
        short = port(torch.from_numpy(ids[:, :7])).numpy()
        assert port.forward.compiles == 2           # new shape: one more
    with paddle.no_grad():
        ref_short = staged_jax(paddle.to_tensor(ids[:, :7])).numpy()
    np.testing.assert_allclose(short, ref_short, **TOL)


def _fn(x, w):
    return torch.tanh(x @ w).sum(-1) * 0.5


def _jax_fn(x, w):
    return paddle.tanh(paddle.matmul(x, w)).sum(-1) * 0.5


def test_to_static_plain_function_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5).astype("float32")
    w = rng.randn(5, 4).astype("float32")
    ref = paddle.jit.to_static(_jax_fn)(paddle.to_tensor(x),
                                         paddle.to_tensor(w)).numpy()
    staged = jit.to_static(_fn, backend=EAGER)
    out = staged(torch.tensor(x), torch.tensor(w))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert staged.compiles == 1
    kinds = [e for e in jit_events.compile_log()
             if e["kind"] == "to_static" and e["fn"] == "_fn"]
    assert kinds and not kinds[-1]["retrace"]


def test_parameter_update_needs_no_recompile():
    torch.manual_seed(0)
    layer = torch.nn.Linear(4, 3)
    staged = jit.to_static(torch.nn.Linear(4, 3), backend=EAGER)
    staged.load_state_dict(layer.state_dict())
    x = torch.randn(2, 4)
    with torch.no_grad():
        torch.testing.assert_close(staged(x), layer(x))
        for p, q in zip(staged.parameters(), layer.parameters()):
            p.mul_(1.5).add_(0.25)
            q.mul_(1.5).add_(0.25)
        torch.testing.assert_close(staged(x), layer(x))
    assert staged.forward.compiles == 1


def test_batch_norm_buffers_update_under_to_static():
    torch.manual_seed(0)
    eager = torch.nn.BatchNorm1d(4)
    staged = jit.to_static(torch.nn.BatchNorm1d(4), backend=EAGER)
    for step in range(3):
        x = torch.randn(8, 4) * (step + 1)
        torch.testing.assert_close(staged(x), eager(x))
    torch.testing.assert_close(staged.running_mean, eager.running_mean)
    torch.testing.assert_close(staged.running_var, eager.running_var)
    assert int(staged.num_batches_tracked) == 3


def test_train_mode_gradients_match_eager():
    _, port = _pair()
    _, ref = _pair()
    ids = torch.from_numpy(
        np.random.RandomState(2).randint(1, 128, (2, 9)).astype("int64"))
    jit.to_static(port, backend=EAGER)
    _, loss = port(ids, labels=ids)
    loss.backward()
    _, ref_loss = ref(ids, labels=ids)
    ref_loss.backward()
    torch.testing.assert_close(loss, ref_loss, **TOL)
    for (name, p), q in zip(port.named_parameters(), ref.parameters()):
        torch.testing.assert_close(p.grad, q.grad, atol=1e-5, rtol=1e-4,
                                   msg=name)


def test_ragged_moe_layer_compiles_whole_graph():
    from paddle_tpu_torch.incubate import MoELayer

    torch.manual_seed(0)
    layer = MoELayer(16, 4, 32, k=2, impl="ragged", device="cpu")
    x = torch.randn(2, 8, 16)
    out, aux = layer(x)
    (out.sum() + aux).backward()
    want = {n: p.grad.clone() for n, p in layer.named_parameters()}
    layer.zero_grad()
    jit.to_static(layer, backend=EAGER)
    got, got_aux = layer(x)
    (got.sum() + got_aux).backward()
    torch.testing.assert_close(got, out)
    torch.testing.assert_close(got_aux, aux)
    for n, p in layer.named_parameters():
        torch.testing.assert_close(p.grad, want[n], msg=n)
    assert layer.forward.compiles == 1      # fullgraph: one program


def test_check_error_raises_before_compiling():
    from paddle_tpu_torch.analysis import AnalysisError

    def syncs(x):
        if x.sum().item() > 0:
            return x * 2
        return x

    staged = jit.to_static(syncs, check="error", backend=EAGER)
    with pytest.raises(AnalysisError, match="host-sync"):
        staged(torch.ones(3))
    assert staged.compiles == 0


def test_not_to_static_and_argument_rules():
    @jit.not_to_static
    def stay(x):
        return x + 1

    assert jit.to_static(stay) is stay
    assert jit.ignore_module([torch]) is None
    with pytest.raises(ValueError, match="full_graph"):
        jit.to_static(_fn, cache="unused", full_graph=False)
    with pytest.raises(ValueError, match="full_graph"):
        jit.to_static(_fn, check="warn", full_graph=False)
    with pytest.raises(ValueError, match="check must be"):
        jit.to_static(_fn, check="loud")


# ---------------------------------------------------------- graph breaks --
def _branchy(x):
    y = x * 2.0
    if y.sum() > 0:       # data-dependent: a graph break
        return y + 1.0
    return -y


def _jax_branchy(x):
    y = x * 2.0
    if float(y.sum()) > 0:
        return y + 1.0
    return -y


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["pos", "neg"])
def test_graph_breaks_match_jax_and_eager(sign):
    x = (np.arange(6, dtype="float32").reshape(2, 3) + 1.0) * sign
    ref = paddle.jit.to_static(_jax_branchy, full_graph=False)(
        paddle.to_tensor(x)).numpy()
    staged = jit.to_static(_branchy, full_graph=False, backend=EAGER)
    out = staged(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    torch.testing.assert_close(out, _branchy(torch.tensor(x)))
    assert staged.stats["segments"] >= 2     # split at the branch


def test_full_graph_true_raises_on_a_data_dependent_branch():
    staged = jit.to_static(_branchy, full_graph=True, backend=EAGER)
    with pytest.raises(Exception):
        staged(torch.ones(3))


# ------------------------------------------------------------ bucketize --
def test_bucketize_matches_jax():
    from paddle_tpu.jit import bucketize as jax_bucketize

    def f(x):
        return x * 3.0 + 1.0, x.sum(-1)

    def jf(x):
        return x * 3.0 + 1.0, x.sum(-1)

    ours = jit.bucketize(f, buckets={0: [4, 8]})
    theirs = jax_bucketize(jf, buckets={0: [4, 8]})
    for n in (3, 4, 6):
        x = np.random.RandomState(n).randn(n, 5).astype("float32")
        got = ours(torch.tensor(x))
        want = theirs(paddle.to_tensor(x))
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    assert ours.signatures == {(((4, 5), "torch.float32"),),
                               (((8, 5), "torch.float32"),)}
    with pytest.raises(ValueError, match="exceeds the largest"):
        ours(torch.zeros(9, 5))


# --------------------------------------------------------- save / load --
class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(8, 4)

    def forward(self, x):
        return self.fc(x)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("export")
    torch.manual_seed(3)
    net = _Net().eval()
    S.save(net, str(d / "m"), input_spec=[S.InputSpec([None, 8])],
           bucket_sizes={0: [2, 4]})
    return str(d / "m"), net


def test_programs_per_bucket_on_disk(saved):
    path, _ = saved
    assert os.path.exists(path + ".b2.pdmodel")
    assert os.path.exists(path + ".b4.pdmodel")
    with open(path + ".pdmeta") as f:
        meta = json.load(f)
    assert meta["buckets"] == {"dims": [0], "combos": [[2], [4]]}
    assert meta["torch_version"] == torch.__version__


def test_load_picks_pads_slices(saved):
    path, net = saved
    tl = jit.load(path)
    for n in (1, 2, 3, 4):
        x = torch.tensor(
            np.random.RandomState(n).randn(n, 8).astype("float32"))
        with torch.no_grad():
            ref = net(x)
        got = tl(x)
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-6)


def test_fixed_output_dim_at_bucket_size_not_sliced(tmp_path):
    class TableNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(8, 3)

        def forward(self, x):
            # second output: fixed (4, 3); axis 0 equals the larger
            # bucket size but does NOT track the batch
            return self.fc(x), torch.ones(4, 3)

    torch.manual_seed(9)
    net = TableNet().eval()
    S.save(net, str(tmp_path / "m"), input_spec=[S.InputSpec([None, 8])],
           bucket_sizes={0: [2, 4]})
    tl = S.load(str(tmp_path / "m"))
    x = torch.randn(3, 8)
    pred, table = tl(x)         # n = 3 -> bucket 4, sliced back to 3
    assert pred.shape == (3, 3)
    assert table.shape == (4, 3)
    with torch.no_grad():
        torch.testing.assert_close(pred, net(x)[0], atol=1e-6, rtol=1e-6)


def test_oversize_input_errors_clearly(saved):
    tl = jit.load(saved[0])
    with pytest.raises(ValueError, match="exceeds the largest"):
        tl(torch.zeros(5, 8))


def test_missing_bucket_dim_rejected(tmp_path):
    with pytest.raises(ValueError, match="dynamic dims"):
        S.save(_Net(), str(tmp_path / "m"),
               input_spec=[S.InputSpec([None, 8])], bucket_sizes={1: [8]})


def test_version_mismatch_errors_clearly(saved, tmp_path):
    src, _ = saved
    d = str(tmp_path / "m")
    for suffix in (".pdmeta", ".pdiparams", ".b2.pdmodel", ".b4.pdmodel"):
        shutil.copy(src + suffix, d + suffix)
    with open(d + ".pdmeta") as f:
        meta = json.load(f)
    meta["torch_version"] = "0.0.1"
    with open(d + ".pdmeta", "w") as f:
        json.dump(meta, f)
    with open(d + ".b2.pdmodel", "r+b") as f:   # the zip's directory cut
        f.truncate(os.path.getsize(d + ".b2.pdmodel") // 2)
    with pytest.raises(ValueError, match="exported with torch 0.0.1"):
        S.load(d)


def test_saved_llama_holds_the_flash_op_and_matches_jax(tmp_path):
    jax_model, port = _pair()
    port.eval()
    S.save(port, str(tmp_path / "m"),
           input_spec=[S.InputSpec([2, None], "int64")],
           bucket_sizes={1: [8, 16]})
    with open(str(tmp_path / "m.b16.pdmodel"), "rb") as f:
        ep = torch.export.load(f)
    targets = [str(n.target) for n in ep.graph.nodes]
    assert targets.count("paddle_tpu_torch.flash_attention_fwd.default") \
        == port.config.num_hidden_layers
    ids = np.random.RandomState(4).randint(1, 128, (2, 11)).astype("int64")
    got = S.load(str(tmp_path / "m"))(torch.from_numpy(ids))
    assert tuple(got.shape) == (2, 11, 128)      # padded to 16, sliced
    with paddle.no_grad():
        ref = jax_model(paddle.to_tensor(ids)).numpy()
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


# ------------------------------------------------------------ the cache --
def test_to_static_cache_keys_mode_and_refuses_unstable_args(tmp_path,
                                                            capsys):
    class Knob:
        pass  # default object repr: "<...Knob object at 0x...>"

    def f(x, knob):
        return x * 2.0

    cache = str(tmp_path / "ts")
    staged = jit.to_static(f, cache=cache, backend=EAGER)
    with torch.no_grad():
        y = staged(torch.ones(2, 2), Knob())
    assert (y == 2.0).all()
    assert "no stable repr" in capsys.readouterr().err
    cc = compilecache.resolve(cache)
    snap = cc.metrics.snapshot()
    assert snap["hits"] == snap["misses"] == 0
    assert compilecache.ArtifactStore(cache).keys() == []
    # the layer's train/eval flag is part of the key
    net = _Net()
    sf = jit.to_static(net, cache=cache, backend=EAGER).forward
    template, tensors = ((("spec",), "()"), [torch.ones(2, 8)])
    net.eval()
    k_eval = sf._cache_key(template, tensors)
    net.train()
    k_train = sf._cache_key(template, tensors)
    assert k_eval[2] != k_train[2] and "mode=False" in k_eval[1]


def test_to_static_cache_round_trip_hits_inductor_caches(tmp_path,
                                                         monkeypatch):
    """A cold instance compiles with Inductor and stores the process's
    cache artifacts; a fresh instance, over fresh local caches (as a new
    process has), loads them before its compile: Inductor's FX-graph
    cache hits and misses nothing, the output is bit-identical."""
    from torch._dynamo.utils import counters

    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "ind0"))
    cache = str(tmp_path / "ts")
    cc = compilecache.resolve(cache)
    x = torch.tensor(np.random.RandomState(0).randn(2, 8)
                     .astype("float32"))

    def build():
        torch.manual_seed(7)
        return jit.to_static(_Net().eval(), cache=cache)

    with torch.no_grad():
        y1 = build()(x)
    assert cc.metrics.misses == 1 and cc.metrics.bytes_written > 0
    torch._dynamo.reset()
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "ind1"))
    counters.clear()
    hits0 = jit_events.aot_hits()
    with torch.no_grad():
        y2 = build()(x)
    assert cc.metrics.hits == 1
    assert jit_events.aot_hits() == hits0 + 1
    assert counters["inductor"]["fxgraph_cache_hit"] >= 1
    assert counters["inductor"]["fxgraph_cache_miss"] == 0
    assert torch.equal(y1, y2)


# ---------------------------------------------------------- custom ops --
def _op_cases():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 4, 16, generator=g)
    k = torch.randn(1, 8, 2, 16, generator=g)
    v = torch.randn(1, 8, 2, 16, generator=g)
    out, lse = fa.flash_attention_fwd(q, k, v)
    lhs = torch.randn(10, 16, generator=g)
    rhs = torch.randn(3, 16, 8, generator=g)
    gs = torch.tensor([4, 0, 6], dtype=torch.int32)
    ops = torch.ops.paddle_tpu_torch
    return {
        "flash_attention_fwd": (ops.flash_attention_fwd.default, (
            q.requires_grad_(), k.requires_grad_(), v.requires_grad_(),
            True, 0.25)),
        "flash_attention_bwd": (ops.flash_attention_bwd.default, (
            q.detach(), k.detach(), v.detach(), out, lse,
            torch.randn_like(out), True, 0.25)),
        "grouped_matmul": (ops.grouped_matmul.default, (
            lhs.requires_grad_(), rhs.requires_grad_(), gs, None, False)),
        "grouped_matmul_wgrad": (ops.grouped_matmul_wgrad.default, (
            lhs.detach(), torch.randn(10, 8, generator=g), gs, 3)),
    }


@pytest.mark.parametrize("name", ["flash_attention_fwd",
                                  "flash_attention_bwd", "grouped_matmul",
                                  "grouped_matmul_wgrad"])
def test_kernel_op_passes_opcheck(name):
    op, args = _op_cases()[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_kernel_ops_in_a_compiled_graph_match_eager():
    # the ops stay opaque under fullgraph compile, gradients through
    # their registered autograd
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 8, 4, 16, generator=g, requires_grad=True)
               for _ in range(3))
    lhs = torch.randn(10, 16, generator=g, requires_grad=True)
    rhs = torch.randn(3, 16, 8, generator=g, requires_grad=True)
    gs = torch.tensor([4, 0, 6], dtype=torch.int32)

    def f(q, k, v, lhs, rhs):
        return (fa.flash_attention(q, k, v).square().sum()
                + gk.grouped_matmul(lhs, rhs, gs).square().sum())

    want = torch.autograd.grad(f(q, k, v, lhs, rhs), (q, k, v, lhs, rhs))
    staged = jit.to_static(f, backend=EAGER)
    got = torch.autograd.grad(staged(q, k, v, lhs, rhs), (q, k, v, lhs, rhs))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)
    assert staged.compiles == 1
