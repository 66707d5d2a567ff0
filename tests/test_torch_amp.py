"""The port's ``amp`` against the JAX package's, on the CPU.

* ``auto_cast`` O1/O2 output dtypes and values of the cases of
  ``tests/test_amp_misc.py::TestAutoCast``, custom lists included, and
  of the port's own ops, which consult the policy by name (``rms_norm``,
  ``scaled_dot_product_attention``, ``cross_entropy``,
  ``fused_linear_cross_entropy``): the same dtype as the JAX op, values
  within one bf16 rounding (rtol 2^-7) of it;
* ``GradScaler``'s state machine step for step against the JAX scaler
  (``TestGradScalerFP16``'s cases and a longer run of finite and
  non-finite gradients): scale and counters equal, the same steps
  skipped, weights within the f32 tolerance (atol 1e-5, rtol 1e-4);
* a tiny Llama trained 5 steps under O1 bf16 in both packages: losses
  within 2e-3 relative (bf16 products rounded in each framework's own
  order through 2 layers);
* the float16 path of ``flash_eligible``: CPU tensors take the plain
  version, a CUDA float16 call is eligible.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import GradScaler as JaxGradScaler
from paddle_tpu.amp import auto_cast as jax_auto_cast
from paddle_tpu.amp import decorate as jax_decorate
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn.parameter import Parameter as JaxParameter
from paddle_tpu_torch import amp
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.nn import ClipGradByNorm
from paddle_tpu_torch.ops import (
    cross_entropy,
    fused_linear_cross_entropy,
    rms_norm,
    scaled_dot_product_attention,
)
from paddle_tpu_torch.ops.nn_ops import flash_eligible
from paddle_tpu_torch.optimizer import Adam, AdamW

TOL = dict(atol=1e-5, rtol=1e-4)
BF16 = dict(atol=1e-6, rtol=2 ** -7)
LLAMA_LOSS_RTOL = 2e-3


def _x(seed=0, shape=(4, 4)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _name(t):
    return str(t.dtype).split(".")[-1]


def _jname(t):
    return t.dtype.name


def test_o1_matmul_bf16_and_black_listed_sum_f32():
    x = _x()
    tx = torch.from_numpy(x)
    with amp.auto_cast(True):
        out = torch.matmul(tx, tx)
        s = torch.sum(tx)
        m = tx @ tx
    with jax_auto_cast(True):
        jout = paddle.matmul(paddle.to_tensor(x), paddle.to_tensor(x))
    assert _name(out) == _jname(jout) == "bfloat16"
    assert _name(m) == "bfloat16"
    assert _name(s) == "float32"
    np.testing.assert_allclose(out.float().numpy(),
                               jout.astype("float32").numpy(), **BF16)
    assert amp.is_auto_cast_enabled() is False
    assert _name(torch.matmul(tx, tx)) == "float32"   # off outside


def test_custom_lists():
    tx = torch.from_numpy(_x())
    with amp.auto_cast(True, custom_black_list={"matmul"}):
        assert _name(torch.matmul(tx, tx)) == "float32"
    with amp.auto_cast(True, custom_white_list={"sum"}):
        assert _name(torch.sum(tx)) == "bfloat16"
        assert amp.get_amp_dtype() == "bfloat16"
    with amp.auto_cast(True, dtype="float16"):
        assert _name(torch.matmul(tx, tx)) == "float16"
        assert amp.get_amp_dtype() == "float16"
    with amp.auto_cast(True, level="O0"):
        assert _name(torch.matmul(tx, tx)) == "float32"
        assert not amp.is_auto_cast_enabled()
    with amp.auto_cast(True):
        with amp.auto_cast(False):
            assert _name(torch.matmul(tx, tx)) == "float32"
        assert _name(torch.matmul(tx, tx)) == "bfloat16"
    with pytest.raises(ValueError):
        with amp.auto_cast(level="O3"):
            pass


def test_o2_casts_unlisted_ops_and_keeps_black_listed_f32():
    tx = torch.from_numpy(_x())
    with amp.auto_cast(True, level="O2"):
        assert _name(tx + tx) == "bfloat16"
        assert _name(torch.nn.functional.silu(tx)) == "bfloat16"
        assert _name(torch.exp(tx)) == "float32"
        assert _name(tx.reshape(16)) == "float32"   # not an op of the list
    with jax_auto_cast(True, level="O2"):
        jx = paddle.to_tensor(_x())
        assert _jname(jx + jx) == "bfloat16"
        assert _jname(paddle.exp(jx)) == "float32"


def test_o2_decorate_casts_parameters_in_place():
    model = torch.nn.Linear(4, 4)
    weight = model.weight
    out = amp.decorate(models=model, optimizers=None, level="O2")
    assert out is model and model.weight is weight
    assert model.weight.dtype == torch.bfloat16
    jmodel = jax_decorate(models=paddle.nn.Linear(4, 4), optimizers=None,
                          level="O2")
    assert _jname(jmodel.weight) == "bfloat16"
    m1 = torch.nn.Linear(4, 4)
    opt = Adam(parameters=m1.parameters())
    assert amp.decorate(m1, opt, level="O1") == (m1, opt)
    assert m1.weight.dtype == torch.float32


def test_grad_flows_through_cast():
    x = torch.from_numpy(_x())
    w = torch.from_numpy(_x(1)).requires_grad_()
    with amp.auto_cast(True):
        loss = torch.matmul(x, w).sum()
    loss.backward()
    assert w.grad is not None and w.grad.shape == (4, 4)
    assert w.grad.dtype == torch.float32


def test_backward_inside_the_block_is_not_recast():
    x = torch.from_numpy(_x()).requires_grad_()
    with amp.auto_cast(True, level="O2"):
        y = scaled_dot_product_attention(
            x.view(1, 4, 1, 4), x.view(1, 4, 1, 4), x.view(1, 4, 1, 4),
            is_causal=True)
        y.float().sum().backward()
    assert x.grad.dtype == torch.float32


def _jops():
    from paddle_tpu.ops import api
    return api


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_port_ops_follow_the_policy_by_name(level):
    rng = np.random.RandomState(3)
    h = rng.randn(2, 6, 8).astype(np.float32)
    w = (1 + 0.1 * rng.randn(8)).astype(np.float32)
    q = rng.randn(1, 6, 2, 4).astype(np.float32)
    logits = rng.randn(6, 11).astype(np.float32)
    labels = rng.randint(0, 11, 6).astype(np.int64)
    head = rng.randn(8, 11).astype(np.float32)      # JAX layout [d, vocab]
    api = _jops()
    with amp.auto_cast(True, level=level):
        r = rms_norm(torch.from_numpy(h).bfloat16(), torch.from_numpy(w))
        a = scaled_dot_product_attention(
            *(torch.from_numpy(q) for _ in range(3)), is_causal=True)
        c = cross_entropy(torch.from_numpy(logits).bfloat16(),
                          torch.from_numpy(labels))
        f = fused_linear_cross_entropy(
            torch.from_numpy(h[0]), torch.from_numpy(head.T.copy()),
            torch.from_numpy(labels), chunk_size=4)
    with jax_auto_cast(True, level=level):
        jr = api.rms_norm(paddle.to_tensor(h).astype("bfloat16"),
                          paddle.to_tensor(w))
        ja = api.scaled_dot_product_attention(
            *(paddle.to_tensor(q) for _ in range(3)), is_causal=True)
        jc = api.cross_entropy(paddle.to_tensor(logits).astype("bfloat16"),
                               paddle.to_tensor(labels))
        jf = api.fused_linear_cross_entropy(
            paddle.to_tensor(h[0]), paddle.to_tensor(head),
            paddle.to_tensor(labels), chunk_size=4)
    for got, want in ((r, jr), (a, ja), (c, jc), (f, jf)):
        assert _name(got) == _jname(want)
        np.testing.assert_allclose(got.float().detach().numpy(),
                                   want.astype("float32").numpy(), **BF16)
    assert _name(r) == "float32" and _name(a) == "bfloat16"


def _cuda_like(shape, dtype, requires_grad=False):
    return types.SimpleNamespace(shape=shape, dtype=dtype,
                                 device=types.SimpleNamespace(type="cuda"),
                                 requires_grad=requires_grad)


def test_float16_flash_path():
    q = torch.randn(1, 8, 2, 64, dtype=torch.float16)
    # CPU tensors take the plain version, in any dtype
    assert not flash_eligible(q, q, q, None, True)
    out = scaled_dot_product_attention(q, q, q, is_causal=True)
    ref, _ = fa.flash_attention_ref(q, q, q, causal=True)
    torch.testing.assert_close(out, ref, rtol=2 ** -10, atol=2 ** -14)
    got, _ = fa.flash_attention_fwd(q, q, q, causal=True)
    assert torch.equal(got, ref)
    # a CUDA float16 call is the kernel's: eligible, on the wgmma design
    # at d 64 and 128, the float16 instance (launch dtype 2)
    for d in (64, 128, 32):
        t = _cuda_like((2, 16, 4, d), torch.float16, requires_grad=True)
        assert flash_eligible(t, t, t, None, True)
    assert fa._fwd_variant(torch.float16, 128, 16, 16) == "wgmma"
    assert fa._bwd_variant(torch.float16, 64, 16, 16) == "wgmma"
    assert fa._fwd_variant(torch.float16, 32, 16, 16) == "mma"
    assert fa._DTYPES[torch.float16] == 2
    assert fa._dtype_name(q) == "float16"
    # mixed dtypes stay the math form's
    k = _cuda_like((2, 16, 4, 64), torch.bfloat16)
    assert not flash_eligible(_cuda_like((2, 16, 4, 64), torch.float16),
                              k, k, None, True)


def _param(v):
    return torch.nn.Parameter(torch.tensor(v, dtype=torch.float32))


def test_scale_and_unscale_roundtrip():
    p = _param([1.0])
    opt = Adam(learning_rate=0.1, parameters=[p])
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    loss = (p * 2.0).sum()
    scaled = scaler.scale(loss)
    assert scaled.item() == loss.item() * 1024.0
    scaled.backward()
    scaler.unscale_(opt)
    assert p.grad.item() == 2.0          # unscaled exactly
    with pytest.raises(RuntimeError, match="already been called"):
        scaler.unscale_(opt)
    scaler.step(opt)
    scaler.update()
    np.testing.assert_allclose(p.detach().numpy(), [0.9], rtol=1e-6)


def test_inf_grad_skips_step_and_decays_scale():
    p = _param([1.0])
    opt = Adam(learning_rate=0.1, parameters=[p])
    scaler = amp.GradScaler(init_loss_scaling=1024.0,
                            decr_every_n_nan_or_inf=1)
    p.grad = torch.tensor([np.inf])
    scaler.step(opt)
    scaler.update()
    assert p.item() == 1.0
    assert scaler._scale == 512.0
    assert opt.state_dict()["global_step"] == 0


def test_scale_grows_after_good_steps():
    p = _param([1.0])
    opt = Adam(learning_rate=0.0, parameters=[p])
    scaler = amp.GradScaler(init_loss_scaling=2.0, incr_every_n_steps=2)
    for _ in range(2):
        p.grad = torch.tensor([1.0])
        scaler.step(opt)
        scaler.update()
    assert scaler._scale == 4.0


def test_disabled_passthrough():
    scaler = amp.GradScaler(enable=False)
    x = torch.tensor([2.0])
    assert scaler.scale(x) is x
    assert not scaler.is_enable()


GRADS = [1.0, 2.0, np.inf, 0.5, np.nan, 1.5, 1.0, 3.0, -np.inf, -np.inf,
         2.0, 1.0, 1.0, 0.25]


@pytest.mark.parametrize("decr_every", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_scaler_state_machine_matches_jax(decr_every, dtype):
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=decr_every)
    # float16 weights keep f32 masters (multi_precision) on both sides
    jp = JaxParameter(np.asarray([1.0, -1.0], dtype))
    tp = torch.nn.Parameter(torch.tensor([1.0, -1.0],
                                         dtype=getattr(torch, dtype)))
    mp = dtype == "float16"
    jopt = paddle.optimizer.Adam(learning_rate=0.1, parameters=[jp],
                                 multi_precision=mp)
    topt = Adam(learning_rate=0.1, parameters=[tp], multi_precision=mp)
    js, ts = JaxGradScaler(**kw), amp.GradScaler(**kw)
    for i, g in enumerate(GRADS):
        scaled = np.asarray([g, 0.5], np.float32) * js._scale
        jp.grad = paddle.to_tensor(scaled).astype(dtype)
        tp.grad = torch.from_numpy(scaled).to(getattr(torch, dtype))
        js.step(jopt)
        ts.step(topt)
        assert ts._found_inf == js._found_inf, i
        js.update()
        ts.update()
        assert ts.state_dict() == js.state_dict(), i
        assert topt.state_dict()["global_step"] == jopt._global_step, i
        np.testing.assert_allclose(tp.detach().float().numpy(),
                                   jp.astype("float32").numpy(), **TOL)
    restored = amp.GradScaler(**kw)
    restored.load_state_dict(ts.state_dict())
    assert restored.state_dict() == ts.state_dict()


def _o1_losses_jax(state, cfg, ids, steps):
    paddle.seed(0)
    model = JaxLlama(JaxLlamaConfig.tiny(**cfg))
    model.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    opt = paddle.optimizer.AdamW(learning_rate=3e-3, epsilon=1e-3,
                                 parameters=model.parameters())
    out = []
    for _ in range(steps):
        with jax_auto_cast(True, level="O1", dtype="bfloat16"):
            loss = model(paddle.to_tensor(ids), labels=paddle.to_tensor(
                ids))[1]
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(float(loss.astype("float32").numpy()))
    return out


def _o1_losses_port(state, cfg, ids, steps):
    model = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_reference_state(model, state)
    opt = AdamW(learning_rate=3e-3, epsilon=1e-3,
                parameters=model.parameters())
    out = []
    for _ in range(steps):
        with amp.auto_cast(True, level="O1", dtype="bfloat16"):
            loss = model(torch.from_numpy(ids), labels=torch.from_numpy(
                ids))[1]
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(loss.float().item())
    return out


@pytest.mark.parametrize("cfg", [{}, {"num_key_value_heads": 2}],
                         ids=["mha", "gqa"])
def test_tiny_llama_o1_bf16_losses_match_jax(cfg):
    paddle.seed(0)
    ref = JaxLlama(JaxLlamaConfig.tiny(**cfg))
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    ids = np.random.RandomState(5).randint(1, 128, (2, 16)).astype(np.int64)
    want = _o1_losses_jax(state, cfg, ids, 5)
    got = _o1_losses_port(state, cfg, ids, 5)
    np.testing.assert_allclose(got, want, rtol=LLAMA_LOSS_RTOL)
    assert got[-1] < got[0]


def test_optimizer_and_scaler_run_outside_the_policy():
    """The update inside an O2 block equals the one outside it, bit for
    bit (the JAX package's update is a staged program its hook never
    sees), and a scaled f32 loss stays f32."""
    def run(inside):
        p = _param([1.0, -2.0, 3.0])
        opt = AdamW(learning_rate=0.1, parameters=[p], weight_decay=0.1,
                    grad_clip=ClipGradByNorm(0.5))
        p.grad = torch.tensor([0.3, 0.2, -0.1])
        if inside:
            with amp.auto_cast(True, level="O2"):
                opt.step()
        else:
            opt.step()
        return p.detach()

    assert torch.equal(run(True), run(False))
    assert run(True).dtype == torch.float32
    with amp.auto_cast(True, level="O2", dtype="float16"):
        scaled = amp.GradScaler().scale(torch.tensor(10.0))
    assert scaled.dtype == torch.float32 and scaled.item() == 655360.0
