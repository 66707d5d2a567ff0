"""The port's LR schedulers, gradient clips, regularizers and
``recompute_sequential`` against the JAX package's, on the CPU.

* every scheduler of ``optimizer.lr``: its value at each of 100 steps
  within 1e-12 of the JAX one, and a ``state_dict`` taken at step 37 and
  loaded into a fresh scheduler continues identically;
* the three clips on the same gradients as the JAX ``_clip_arrays``, and
  through an AdamW update, with a parameter that opts out (``need_clip``);
* L1Decay, L2Decay and a parameter's own regularizer (under AdamW too)
  through 5 optimizer steps;
* ``recompute_sequential`` gradients of a small chain of layers.

f32 tolerance atol 1e-5, rtol 1e-4 (the same as the optimizer tests).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.recompute import (
    recompute_sequential as jax_recompute_sequential,
)
from paddle_tpu.nn.parameter import Parameter as JaxParameter
from paddle_tpu_torch import regularizer
from paddle_tpu_torch.distributed import recompute_sequential
from paddle_tpu_torch.nn import (
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
)
from paddle_tpu_torch.optimizer import Adam, AdamW, lr

TOL = dict(atol=1e-5, rtol=1e-4)
LR_TOL = 1e-12
SHAPES = [(4, 3), (5,), (2, 3, 2)]


def _schedulers(mod):
    """name -> a zero-argument constructor of the scheduler in ``mod``
    (the JAX ``paddle.optimizer.lr`` or the port's ``lr``)."""
    return {
        "noam": lambda: mod.NoamDecay(d_model=64, warmup_steps=10,
                                      learning_rate=2.0),
        "piecewise": lambda: mod.PiecewiseDecay([10, 30, 60],
                                                [1.0, 0.5, 0.1, 0.01]),
        "natural_exp": lambda: mod.NaturalExpDecay(0.5, gamma=0.05),
        "inverse_time": lambda: mod.InverseTimeDecay(0.5, gamma=0.1),
        "polynomial": lambda: mod.PolynomialDecay(0.5, decay_steps=40,
                                                  end_lr=0.01, power=2.0),
        "polynomial_cycle": lambda: mod.PolynomialDecay(
            0.5, decay_steps=15, end_lr=0.01, power=1.0, cycle=True),
        "linear_warmup_cosine": lambda: mod.LinearWarmup(
            mod.CosineAnnealingDecay(0.3, T_max=80, eta_min=0.01),
            warmup_steps=12, start_lr=0.0, end_lr=0.3),
        "linear_warmup_const": lambda: mod.LinearWarmup(
            0.2, warmup_steps=7, start_lr=0.01, end_lr=0.2),
        "exponential": lambda: mod.ExponentialDecay(0.5, gamma=0.97),
        "multistep": lambda: mod.MultiStepDecay(0.5, milestones=[20, 50, 70],
                                                gamma=0.3),
        "step": lambda: mod.StepDecay(0.5, step_size=13, gamma=0.7),
        "lambda": lambda: mod.LambdaDecay(0.5, lambda e: 0.95 ** e),
        "multiplicative": lambda: mod.MultiplicativeDecay(
            0.5, lambda e: 0.98),
        "cosine": lambda: mod.CosineAnnealingDecay(0.4, T_max=30,
                                                   eta_min=0.02),
        "cosine_restarts": lambda: mod.CosineAnnealingWarmRestarts(
            0.4, T_0=10, T_mult=2, eta_min=0.01),
        "cyclic": lambda: mod.CyclicLR(0.01, 0.1, step_size_up=9,
                                       step_size_down=14, mode="triangular2"),
        "cyclic_exp_range": lambda: mod.CyclicLR(
            0.01, 0.1, step_size_up=7, mode="exp_range", exp_gamma=0.99),
        "one_cycle": lambda: mod.OneCycleLR(0.1, total_steps=100),
        "one_cycle_three_phase": lambda: mod.OneCycleLR(
            0.1, total_steps=100, three_phase=True,
            anneal_strategy="linear"),
        "linear_lr": lambda: mod.LinearLR(0.5, total_steps=60,
                                          start_factor=0.2, end_factor=1.0),
    }


def _values(sched, n=100):
    out = [sched()]
    for _ in range(n - 1):
        sched.step()
        out.append(sched())
    return out


@pytest.mark.parametrize("name", sorted(_schedulers(lr)))
def test_scheduler_values_match_jax(name):
    want = _values(_schedulers(paddle.optimizer.lr)[name]())
    got = _values(_schedulers(lr)[name]())
    np.testing.assert_allclose(got, want, rtol=0, atol=LR_TOL)


@pytest.mark.parametrize("name", sorted(_schedulers(lr)))
def test_scheduler_state_dict_round_trip(name):
    make = _schedulers(lr)[name]
    a = make()
    for _ in range(37):
        a.step()
    state = a.state_dict()
    b = make()
    b.set_state_dict(state)
    assert b() == a()
    assert _values(a, 40) == _values(b, 40)
    # the JAX scheduler's state at the same step loads into the port's
    j = _schedulers(paddle.optimizer.lr)[name]()
    for _ in range(37):
        j.step()
    c = make()
    c.set_state_dict(j.state_dict())
    np.testing.assert_allclose(_values(c, 20), _values(j, 20), rtol=0,
                               atol=LR_TOL)


def test_reduce_on_plateau_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.61, 0.62, 0.63, 0.64,
               0.2, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3] * 5
    j = paddle.optimizer.lr.ReduceOnPlateau(0.5, patience=2, factor=0.5,
                                            cooldown=1, min_lr=0.01)
    t = lr.ReduceOnPlateau(0.5, patience=2, factor=0.5, cooldown=1,
                           min_lr=0.01)
    for i, m in enumerate(metrics):
        j.step(m)
        t.step(torch.tensor(m) if i % 2 else m)
        assert abs(t() - j()) <= LR_TOL
    b = lr.ReduceOnPlateau(0.5, patience=2, factor=0.5, cooldown=1,
                           min_lr=0.01)
    b.set_state_dict(t.state_dict())
    for m in metrics[:10]:
        t.step(m)
        b.step(m)
        assert b() == t()


def _arrays(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(scale * rng.randn(*s)).astype(np.float32) for s in SHAPES]


CLIPS = {
    "value": (lambda: paddle.nn.ClipGradByValue(0.7, min=-0.4),
              lambda: ClipGradByValue(0.7, min=-0.4)),
    "value_symmetric": (lambda: paddle.nn.ClipGradByValue(0.5),
                        lambda: ClipGradByValue(0.5)),
    "norm": (lambda: paddle.nn.ClipGradByNorm(1.5),
             lambda: ClipGradByNorm(1.5)),
    "global_norm": (lambda: paddle.nn.ClipGradByGlobalNorm(2.0),
                    lambda: ClipGradByGlobalNorm(2.0)),
}


@pytest.mark.parametrize("name", sorted(CLIPS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_matches_jax_clip_arrays(name, dtype):
    make_jax, make_port = CLIPS[name]
    grads = _arrays(3, scale=2.0)
    need = [True, False, True]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = make_jax()._clip_arrays(
        [None] * 3, [jnp.asarray(g).astype(jdt) for g in grads], need)
    got = [torch.from_numpy(g).to(tdt) for g in grads]
    make_port().clip_(got, need)
    tol = TOL if dtype == "float32" else dict(atol=0, rtol=2 ** -8)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)), **tol)
    # the eager (param, grad) form returns new gradients and leaves the
    # ones it was given alone; a parameter's need_clip opts it out
    want32 = make_jax()._clip_arrays(
        [None] * 3, [jnp.asarray(g) for g in grads], need)
    params = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES]
    params[1].need_clip = False
    pairs = [(p, torch.from_numpy(g)) for p, g in zip(params, grads)]
    out = make_port()(pairs)
    for (p, g), q, w in zip(out, params, want32):
        assert p is q
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for (_, g), orig in zip(pairs, grads):
        assert np.array_equal(g.numpy(), orig)


def _run(make_jax, make_port, steps=5, grad_scale=1.0, setup=None):
    jp = [JaxParameter(a) for a in _arrays(0)]
    tp = [torch.nn.Parameter(torch.from_numpy(a)) for a in _arrays(0)]
    if setup is not None:
        setup(jp, tp)
    jopt, topt = make_jax(jp), make_port(tp)
    for i in range(steps):
        for p, q, g in zip(jp, tp, _arrays(10 + i, grad_scale)):
            p.grad = paddle.to_tensor(g)
            q.grad = torch.from_numpy(g)
        jopt.step()
        topt.step()
    for p, q in zip(jp, tp):
        np.testing.assert_allclose(q.detach().numpy(), p.numpy(), **TOL)
    jstate, tstate = jopt.state_dict(), topt.state_dict()
    assert set(jstate) == set(tstate)
    for key, want in jstate.items():
        if key == "global_step":
            assert tstate[key] == want
        else:
            np.testing.assert_allclose(tstate[key].numpy(), want.numpy(),
                                       **TOL, err_msg=key)


def _opt_out_of_clip(jp, tp):
    jp[1].need_clip = False
    tp[1].need_clip = False


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_clip_through_adamw_matches_jax(name):
    make_jax, make_port = CLIPS[name]
    _run(lambda ps: paddle.optimizer.AdamW(
            learning_rate=0.01, parameters=ps, weight_decay=0.05,
            grad_clip=make_jax()),
         lambda ps: AdamW(learning_rate=0.01, parameters=ps,
                          weight_decay=0.05, grad_clip=make_port()),
         grad_scale=3.0, setup=_opt_out_of_clip)


REGULARIZERS = {
    "float": (0.1, 0.1),
    "l2": (lambda: paddle.regularizer.L2Decay(0.1),
           lambda: regularizer.L2Decay(0.1)),
    "l1": (lambda: paddle.regularizer.L1Decay(0.05),
           lambda: regularizer.L1Decay(0.05)),
}


@pytest.mark.parametrize("name", sorted(REGULARIZERS))
def test_adam_weight_decay_regularizers_match_jax(name):
    j, t = REGULARIZERS[name]
    _run(lambda ps: paddle.optimizer.Adam(
            learning_rate=0.01, parameters=ps,
            weight_decay=j() if callable(j) else j),
         lambda ps: Adam(learning_rate=0.01, parameters=ps,
                         weight_decay=t() if callable(t) else t))


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_param_regularizer_overrides_group_and_applies_under_adamw(kind):
    j, t = REGULARIZERS[kind]

    def setup(jp, tp):
        jp[0].regularizer = j()
        tp[0].regularizer = t()

    _run(lambda ps: paddle.optimizer.AdamW(learning_rate=0.1,
                                           parameters=ps, weight_decay=0.0),
         lambda ps: AdamW(learning_rate=0.1, parameters=ps,
                          weight_decay=0.0), setup=setup)
    _run(lambda ps: paddle.optimizer.Adam(
            learning_rate=0.1, parameters=ps,
            weight_decay=paddle.regularizer.L2Decay(0.3)),
         lambda ps: Adam(learning_rate=0.1, parameters=ps,
                         weight_decay=regularizer.L2Decay(0.3)), setup=setup)


def test_param_regularizer_decays_under_adamw_with_zero_grad():
    # tests/test_optimizer.py::test_adamw_applies_param_regularizer
    p = torch.nn.Parameter(torch.tensor([1.0]))
    p.regularizer = regularizer.L2Decay(0.5)
    o = AdamW(learning_rate=0.1, weight_decay=0.0, parameters=[p])
    p.grad = torch.tensor([0.0])
    o.step()
    assert float(p[0]) < 1.0


def test_set_lr_scheduler_and_minimize():
    w = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    o = AdamW(learning_rate=0.5, parameters=[w], weight_decay=0.0)
    sched = lr.StepDecay(0.2, step_size=1, gamma=0.5)
    o.set_lr_scheduler(sched)
    assert o.get_lr() == 0.2
    with pytest.raises(TypeError):
        o.set_lr_scheduler(0.1)
    loss = (w * w).sum()
    _, pg = o.minimize(loss)
    assert [p for p, _ in pg] == [w]
    assert o.state_dict()["global_step"] == 1
    assert float(w[0]) < 1.0 and float(w[1]) > -2.0


def test_found_inf_keeps_weights_and_state():
    w = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    o = AdamW(learning_rate=0.1, parameters=[w])
    w.grad = torch.tensor([0.5, 0.5])
    o.step()
    before = w.detach().clone()
    m1 = o.state_dict()["param_0_moment1_0"].clone()
    o._set_found_inf(torch.tensor(True))
    w.grad = torch.tensor([1.0, 1.0])
    o.step()
    assert torch.equal(w.detach(), before)
    assert torch.equal(o.state_dict()["param_0_moment1_0"], m1)
    assert o.state_dict()["global_step"] == 2
    o._set_found_inf(torch.tensor(False))
    o.step()
    assert not torch.equal(w.detach(), before)


def _chain_weights(seed, dims=(6, 8, 8, 5)):
    rng = np.random.RandomState(seed)
    return [(0.3 * rng.randn(a, b)).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("segments", [1, 2, 3])
def test_recompute_sequential_gradients_match_jax(segments):
    ws = _chain_weights(0)
    x = np.random.RandomState(1).randn(4, 6).astype(np.float32)

    jl = [paddle.nn.Linear(w.shape[0], w.shape[1], bias_attr=False)
          for w in ws]
    for layer, w in zip(jl, ws):
        layer.weight._rebind(jnp.asarray(w))
    jx = paddle.to_tensor(x, stop_gradient=False)
    jfns = [jl[0], paddle.nn.functional.silu, jl[1], paddle.tanh, jl[2]]
    jout = jax_recompute_sequential({"segments": segments}, jfns, jx)
    (jout * jout).sum().backward()

    tl = [torch.nn.Linear(w.shape[0], w.shape[1], bias=False) for w in ws]
    with torch.no_grad():
        for layer, w in zip(tl, ws):
            layer.weight.copy_(torch.from_numpy(w.T))   # [out, in]
    tx = torch.from_numpy(x).requires_grad_()
    tfns = [tl[0], torch.nn.functional.silu, tl[1], torch.tanh, tl[2]]
    tout = recompute_sequential({"segments": segments}, tfns, tx)
    (tout * tout).sum().backward()

    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL)
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t.weight.grad.numpy().T,
                                   j.weight.grad.numpy(), **TOL)
