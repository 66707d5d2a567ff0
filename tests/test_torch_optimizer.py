"""The port's optimizers, LR schedules and gradient clip against the JAX
package's, on the CPU.

The same numpy parameters and per-step gradients (fixed seeds) go through
``paddle_tpu.optimizer`` and ``paddle_tpu_torch.optimizer`` for 5 steps;
weights and optimizer state must match within the f32 tolerance (atol
1e-5, rtol 1e-4).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import Adam, AdamW, lr

TOL = dict(atol=1e-5, rtol=1e-4)
SHAPES = [(4, 3), (5,), (2, 3, 2)]


def _arrays(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(scale * rng.randn(*s)).astype(np.float32) for s in SHAPES]


def _jax_params(arrays, dtype):
    ps = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    return [p.astype("bfloat16") for p in ps] if dtype == "bfloat16" else ps


def _port_params(arrays, dtype):
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return [torch.nn.Parameter(torch.from_numpy(a).to(dt)) for a in arrays]


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype("float32").numpy())


def _run(make_jax, make_port, dtype="float32", steps=5, grad_scale=1.0,
         schedulers=None):
    """``make_*(params) -> optimizer``; ``schedulers`` (jax, port) are
    stepped after every update."""
    jp = _jax_params(_arrays(0), dtype)
    tp = _port_params(_arrays(0), dtype)
    jopt, topt = make_jax(jp), make_port(tp)
    for i in range(steps):
        for p, q, g in zip(jp, tp, _arrays(10 + i, grad_scale)):
            jg = paddle.to_tensor(g)
            p.grad = jg.astype("bfloat16") if dtype == "bfloat16" else jg
            q.grad = torch.from_numpy(g).to(q.dtype)
        jopt.step()
        topt.step()
        if schedulers:
            for s in schedulers:
                s.step()
    return jp, jopt, tp, topt


def _assert_match(jp, jopt, tp, topt, weight_tol=TOL):
    for p, q in zip(jp, tp):
        np.testing.assert_allclose(_f32(q), _f32(p), **weight_tol)
    jstate, tstate = jopt.state_dict(), topt.state_dict()
    assert set(jstate) == set(tstate)
    for key, want in jstate.items():
        if key in ("global_step", "LR_Scheduler"):
            assert tstate[key] == want
            continue
        np.testing.assert_allclose(_f32(tstate[key]), _f32(want), **TOL,
                                   err_msg=key)


def _ratio(p):
    return 0.5 if tuple(p.shape) == (5,) else 1.0


CASES = {
    "adamw": dict(weight_decay=0.1),
    "adamw_decay_fun_lr_ratio": dict(
        weight_decay=0.2, lr_ratio=_ratio,
        apply_decay_param_fun=lambda name: name != "param_1"),
    "adamw_clip": dict(weight_decay=0.1, clip=0.5),
    "adamw_amsgrad_betas": dict(weight_decay=0.0, amsgrad=True, beta1=0.8,
                                beta2=0.95, epsilon=1e-6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_matches_jax_f32(case):
    kw = dict(CASES[case])
    clip = kw.pop("clip", None)

    def jax_opt(ps):
        return paddle.optimizer.AdamW(
            learning_rate=0.01, parameters=ps, **kw,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(clip) if clip else None)

    def port_opt(ps):
        return AdamW(learning_rate=0.01, parameters=ps, **kw,
                     grad_clip=ClipGradByGlobalNorm(clip) if clip else None)

    # gradients 3x larger than the clip norm's share, so the clip acts
    _assert_match(*_run(jax_opt, port_opt, grad_scale=3.0))


def test_adamw_bf16_multi_precision_matches_jax():
    # fp32 masters in the state match to f32 tolerance; the bf16 weights
    # are the masters rounded to bf16 on both sides, so they match to one
    # bf16 ulp (2^-8 relative) where an f32 rounding difference of the
    # masters crosses a bf16 rounding boundary
    def jax_opt(ps):
        return paddle.optimizer.AdamW(
            learning_rate=0.01, parameters=ps, weight_decay=0.1,
            multi_precision=True,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))

    def port_opt(ps):
        return AdamW(learning_rate=0.01, parameters=ps, weight_decay=0.1,
                     multi_precision=True,
                     grad_clip=ClipGradByGlobalNorm(1.0))

    jp, jopt, tp, topt = _run(jax_opt, port_opt, dtype="bfloat16",
                              grad_scale=2.0)
    assert all(q.dtype == torch.bfloat16 for q in tp)
    state = topt.state_dict()
    assert state["param_0_master_weight_0"].dtype == torch.float32
    assert state["param_0_moment1_0"].dtype == torch.float32
    _assert_match(jp, jopt, tp, topt, weight_tol=dict(atol=0, rtol=2 ** -8))


def test_adam_l2_decay_matches_jax():
    # Adam's float weight_decay is the coupled L2 term g + coeff * w
    _assert_match(*_run(
        lambda ps: paddle.optimizer.Adam(learning_rate=0.02, parameters=ps,
                                         weight_decay=0.05),
        lambda ps: Adam(learning_rate=0.02, parameters=ps,
                        weight_decay=0.05),
    ))


def test_param_groups_match_jax():
    def groups(ps):
        return [{"params": [ps[0]], "weight_decay": 0.0,
                 "learning_rate": 0.5},
                {"params": ps[1:], "weight_decay": 0.3}]

    _assert_match(*_run(
        lambda ps: paddle.optimizer.AdamW(learning_rate=0.01,
                                          parameters=groups(ps)),
        lambda ps: AdamW(learning_rate=0.01, parameters=groups(ps)),
    ))


def _warmup_cosine(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(0.01, T_max=40,
                                                     eta_min=1e-4),
                            warmup_steps=10, start_lr=0.0, end_lr=0.01)


def test_lr_warmup_cosine_values_match_jax():
    jsched, tsched = _warmup_cosine(paddle.optimizer.lr), _warmup_cosine(lr)
    for _ in range(50):
        assert tsched() == pytest.approx(jsched(), rel=1e-12, abs=1e-15)
        jsched.step()
        tsched.step()
    state = tsched.state_dict()
    again = _warmup_cosine(lr).set_state_dict(state)
    assert again() == tsched() and again.last_epoch == 50


def test_adamw_with_scheduler_matches_jax():
    jsched, tsched = _warmup_cosine(paddle.optimizer.lr), _warmup_cosine(lr)
    _assert_match(*_run(
        lambda ps: paddle.optimizer.AdamW(learning_rate=jsched,
                                          parameters=ps),
        lambda ps: AdamW(learning_rate=tsched, parameters=ps),
        steps=12, schedulers=(jsched, tsched),
    ))


@pytest.mark.parametrize("clip_norm", [0.5, 100.0], ids=["clips", "no_op"])
def test_clip_global_norm_matches_jax(clip_norm):
    grads = _arrays(3, 2.0)
    need = [True, False, True]
    want = paddle.nn.ClipGradByGlobalNorm(clip_norm)._clip_arrays(
        [None] * 3, [paddle.to_tensor(g)._data for g in grads], need)
    got = [torch.from_numpy(g.copy()) for g in grads]
    ClipGradByGlobalNorm(clip_norm).clip_(got, need)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_state_dict_round_trip_and_errors():
    ps = _port_params(_arrays(0), "float32")
    sched = _warmup_cosine(lr)
    opt = AdamW(learning_rate=sched, parameters=ps)
    for p, g in zip(ps, _arrays(1)):
        p.grad = torch.from_numpy(g)
    opt.step()
    sched.step()
    state = opt.state_dict()
    assert state["global_step"] == 1
    fresh = AdamW(learning_rate=_warmup_cosine(lr),
                  parameters=_port_params(_arrays(0), "float32"))
    fresh.set_state_dict(state)
    for key, t in fresh.state_dict().items():
        if isinstance(t, torch.Tensor):
            torch.testing.assert_close(t, state[key], rtol=0, atol=0)
    assert fresh.get_lr() == opt.get_lr()
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    bad = dict(state, param_0_moment1_0=torch.zeros(2, 2))
    with pytest.raises(ValueError, match="shape mismatch"):
        fresh.set_state_dict(bad)
    opt.clear_grad()
    assert all(p.grad is None for p in ps)


def test_named_parameters_keep_their_names():
    model = torch.nn.Linear(3, 2)
    opt = AdamW(learning_rate=0.1, parameters=model.named_parameters(),
                apply_decay_param_fun=lambda n: n == "weight")
    model.weight.grad = torch.ones(2, 3)
    model.bias.grad = torch.ones(2)
    opt.step()
    assert {k for k in opt.state_dict() if k != "global_step"} == {
        "weight_moment1_0", "weight_moment2_0", "bias_moment1_0",
        "bias_moment2_0"}
    assert opt.param_name(model.bias) == "bias"
