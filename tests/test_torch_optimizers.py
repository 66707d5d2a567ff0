"""The port's twelve other optimizers (SGD, Momentum, Adagrad, Adadelta,
Adamax, ASGD, Lamb, NAdam, RAdam, RMSProp, Rprop and LBFGS) against the
JAX package's, on the CPU.

The same numpy parameters and per-step gradients (fixed seeds) go through
``paddle_tpu.optimizer`` and ``paddle_tpu_torch.optimizer`` for 5 steps,
with and without weight decay; the weights and every accumulator of
``state_dict`` (the same keys on both sides) must agree within f32
rounding (atol 1e-6, rtol 1e-5). ``multi_precision`` runs one bf16
parameter among f32 ones (its f32 master within the f32 tolerance, the
bf16 weight within one bf16 ulp), and a ``state_dict`` saved after 3
steps and loaded into a fresh optimizer continues bit for bit. LBFGS
runs a seeded least-squares problem, plain and with the strong-Wolfe
search, against JAX's iterates.
"""
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import optimizer as topt

TOL = dict(atol=1e-6, rtol=1e-5)
SHAPES = [(4, 3), (5,), (2, 3, 2)]


def _arrays(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(scale * rng.randn(*s)).astype(np.float32) for s in SHAPES]


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype("float32").numpy())


def _excluded(p):
    # Lamb: no decay for 1-D parameters (biases), a common choice
    return len(p.shape) == 1


# name -> (class name, keyword arguments), each also run with decay
CASES = {
    "sgd": ("SGD", dict(learning_rate=0.05)),
    "momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.8)),
    "momentum_nesterov": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                           use_nesterov=True)),
    "adagrad": ("Adagrad", dict(learning_rate=0.1, epsilon=1e-6,
                                initial_accumulator_value=0.1)),
    "adadelta": ("Adadelta", dict(learning_rate=0.5, rho=0.9,
                                  epsilon=1e-6)),
    "adamax": ("Adamax", dict(learning_rate=0.02, beta1=0.8, beta2=0.99)),
    "asgd": ("ASGD", dict(learning_rate=0.05, batch_num=3)),
    "lamb": ("Lamb", dict(learning_rate=0.02, lamb_weight_decay=0.0)),
    "lamb_exclude": ("Lamb", dict(learning_rate=0.02, lamb_weight_decay=0.1,
                                  exclude_from_weight_decay_fn=_excluded)),
    "nadam": ("NAdam", dict(learning_rate=0.02)),
    "radam": ("RAdam", dict(learning_rate=0.02)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01, rho=0.9, epsilon=1e-6)),
    "rmsprop_centered_momentum": ("RMSProp", dict(
        learning_rate=0.01, rho=0.9, epsilon=1e-6, momentum=0.5,
        centered=True)),
    "rprop": ("Rprop", dict(learning_rate=0.01,
                            learning_rate_range=(1e-4, 0.05),
                            etas=(0.4, 1.3))),
}
# Lamb and Rprop take no weight_decay argument: Lamb's decay runs as its
# lamb_weight_decay, Rprop (full-batch, no decay in the JAX class) once


# Each side gets its own copy of every array. ``paddle.to_tensor`` of a
# numpy array whose buffer happens to be 64-byte aligned keeps that buffer
# (no copy) on the CPU, and ``torch.from_numpy`` always shares it: the
# port's in-place update would then move the JAX parameter too, in
# whichever test the allocator left the array aligned.


def _params(dtypes):
    """(JAX tensors, port parameters) from the seed-0 arrays, each in its
    dtype of ``dtypes``; no memory shared between the two."""
    jp, tp = [], []
    for a, dt in zip(_arrays(0), dtypes):
        j = paddle.to_tensor(a, stop_gradient=False)
        jp.append(j.astype("bfloat16") if dt == "bfloat16" else j)
        tp.append(torch.nn.Parameter(torch.tensor(a).to(
            torch.bfloat16 if dt == "bfloat16" else torch.float32)))
    return jp, tp


def _set_grads(jp, tp, i):
    # the same gradients every run; Rprop sees sign changes across steps
    for p, q, g in zip(jp, tp, _arrays(10 + i)):
        jg = paddle.to_tensor(g)
        p.grad = jg.astype(p.dtype) if str(p.dtype).endswith(
            "bfloat16") else jg
        q.grad = torch.tensor(g).to(q.dtype)


def _aligned_arrays(arrays, align=64):
    """Copies of ``arrays`` whose buffers start on ``align`` bytes."""
    out = []
    for a in arrays:
        buf = np.empty(a.nbytes + align, np.uint8)
        off = (-buf.ctypes.data) % align
        b = buf[off:off + a.nbytes].view(a.dtype).reshape(a.shape)
        b[...] = a
        out.append(b)
    return out


def test_no_memory_shared_with_jax_on_aligned_arrays(monkeypatch):
    # an in-place change on the port's side leaves the JAX parameters
    # and gradients as they were, also when every array is 64-byte
    # aligned (the heap state under which a test's JAX weights used to
    # follow the port's update)
    real = _arrays
    monkeypatch.setattr(
        sys.modules[__name__], "_arrays",
        lambda seed, scale=1.0: _aligned_arrays(real(seed, scale)))
    jp, tp = _params(["float32"] * 3)
    _set_grads(jp, tp, 0)
    before = [(p.numpy().copy(), p.grad.numpy().copy()) for p in jp]
    with torch.no_grad():
        for q in tp:
            q.sub_(1.0)
            q.grad.mul_(3.0)
    for p, (w, g) in zip(jp, before):
        np.testing.assert_array_equal(p.numpy(), w)
        np.testing.assert_array_equal(p.grad.numpy(), g)


def _make(cls, kw, decay, jp, tp, multi_precision=False):
    kw = dict(kw)
    if decay:
        kw["weight_decay"] = 0.05
    extra = {"multi_precision": True} if multi_precision else {}
    return (getattr(paddle.optimizer, cls)(parameters=jp, **kw, **extra),
            getattr(topt, cls)(parameters=tp, **kw, **extra))


def _assert_match(jp, jopt, tp, topt_, weight_tol=TOL):
    for p, q in zip(jp, tp):
        np.testing.assert_allclose(_f32(q), _f32(p), **weight_tol)
    jstate, tstate = jopt.state_dict(), topt_.state_dict()
    assert set(jstate) == set(tstate)
    for key, want in jstate.items():
        if key == "global_step":
            assert tstate[key] == want
            continue
        np.testing.assert_allclose(_f32(tstate[key]), _f32(want), **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("case,decay", [
    (case, decay) for case in sorted(CASES) for decay in (False, True)
    if not (decay and CASES[case][0] == "Rprop")])
def test_five_steps_match_jax(case, decay):
    cls, kw = CASES[case]
    if decay and cls == "Lamb":
        # Lamb's decay is its own argument
        kw = dict(kw, lamb_weight_decay=0.05)
        decay = False
    jp, tp = _params(["float32"] * 3)
    jopt, popt = _make(cls, kw, decay, jp, tp)
    for i in range(5):
        _set_grads(jp, tp, i)
        jopt.step()
        popt.step()
    _assert_match(jp, jopt, tp, popt)


@pytest.mark.parametrize("case", ["sgd", "momentum_nesterov", "adagrad",
                                  "adadelta", "adamax", "asgd",
                                  "lamb_exclude", "nadam", "radam",
                                  "rmsprop_centered_momentum", "rprop"])
def test_multi_precision_bf16_parameter_matches_jax(case):
    # the middle parameter is bf16 with an f32 master on both sides: the
    # master and the accumulators match to the f32 tolerance, the bf16
    # weight (the master rounded) to one bf16 ulp (2^-8 relative)
    cls, kw = CASES[case]
    jp, tp = _params(["float32", "bfloat16", "float32"])
    jopt, popt = _make(cls, kw, False, jp, tp, multi_precision=True)
    for i in range(5):
        _set_grads(jp, tp, i)
        jopt.step()
        popt.step()
    assert tp[1].dtype == torch.bfloat16
    state = popt.state_dict()
    assert state["param_1_master_weight_0"].dtype == torch.float32
    _assert_match(jp, jopt, tp, popt, weight_tol=dict(atol=0, rtol=2 ** -8))


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_round_trip_continues_bit_for_bit(case):
    cls, kw = CASES[case]

    def run(steps, load=None):
        _, tp = _params(["float32"] * 3)
        opt = getattr(topt, cls)(parameters=tp, **kw)
        if load is not None:
            weights, state = load
            with torch.no_grad():
                for p, w in zip(tp, weights):
                    p.copy_(w)
            opt.set_dict(state)
        for i in steps:
            for q, g in zip(tp, _arrays(10 + i)):
                q.grad = torch.from_numpy(g)
            opt.step()
        return tp, opt

    tp, opt = run(range(3))
    saved = ([p.detach().clone() for p in tp], opt.state_dict())
    whole, _ = run(range(5))
    resumed, opt2 = run(range(3, 5), load=saved)
    assert opt2.state_dict()["global_step"] == 5
    for a, b in zip(whole, resumed):
        assert torch.equal(a, b)


def test_asgd_finalize_copies_the_average():
    cls, kw = CASES["asgd"]
    jp, tp = _params(["float32"] * 3)
    jopt, popt = _make(cls, kw, False, jp, tp)
    for i in range(4):
        _set_grads(jp, tp, i)
        jopt.step()
        popt.step()
    jopt.finalize()
    popt.finalize()
    for p, q in zip(jp, tp):
        np.testing.assert_allclose(_f32(q), _f32(p), **TOL)


def test_name_lazy_mode_and_set_dict_are_accepted():
    # the JAX arguments (C2): name= on every optimizer, lazy_mode= on
    # Adam and AdamW (dense gradients: it changes nothing), set_dict
    _, tp = _params(["float32"] * 3)
    for cls in ("Adam", "AdamW"):
        a = getattr(topt, cls)(parameters=tp, lazy_mode=True, name="opt")
        b = getattr(topt, cls)(parameters=tp)
        for opt in (a, b):
            for q, g in zip(tp, _arrays(10)):
                q.grad = torch.from_numpy(g)
            opt.step()
        for key, want in b.state_dict().items():
            got = a.state_dict()[key]
            assert torch.equal(got, want) if torch.is_tensor(want) else \
                got == want
    sgd = topt.SGD(parameters=tp, name="sgd")
    assert sgd._name == "sgd" and sgd.set_dict == sgd.set_state_dict


# ------------------------------------------------------------------ LBFGS
def _least_squares(seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(24, 4).astype(np.float32)
    y = (a @ rng.randn(4, 2) + 0.3 * rng.randn(24, 2)).astype(np.float32)
    w0 = (0.1 * rng.randn(4, 2)).astype(np.float32)
    b0 = np.zeros(2, np.float32)
    return a, y, w0, b0


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
@pytest.mark.parametrize("decay", [None, 0.01])
def test_lbfgs_iterates_match_jax(line_search, decay):
    a, y, w0, b0 = _least_squares()
    jw = paddle.to_tensor(w0, stop_gradient=False)
    jb = paddle.to_tensor(b0, stop_gradient=False)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tb = torch.nn.Parameter(torch.from_numpy(b0.copy()))
    kw = dict(learning_rate=1.0, max_iter=4, history_size=3,
              line_search_fn=line_search, weight_decay=decay)
    jopt = paddle.optimizer.LBFGS(parameters=[jw, jb], **kw)
    popt = topt.LBFGS(parameters=[tw, tb], **kw)
    ja, jy = paddle.to_tensor(a), paddle.to_tensor(y)
    ta, ty = torch.from_numpy(a), torch.from_numpy(y)

    def jclosure():
        jopt.clear_grad()
        loss = ((ja @ jw + jb - jy) ** 2).mean()
        loss.backward()
        return loss

    def tclosure():
        popt.clear_grad()
        loss = ((ta @ tw + tb - ty) ** 2).mean()
        loss.backward()
        return loss

    for _ in range(3):
        jl = float(jopt.step(jclosure).numpy())
        tl = float(popt.step(tclosure))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(_f32(tw), _f32(jw), atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(_f32(tb), _f32(jb), atol=1e-5, rtol=1e-4)
    assert popt._func_evals == jopt._func_evals
    js, ts = jopt.state_dict(), popt.state_dict()
    assert len(ts["hist_s"]) == len(js["hist_s"]) <= 3
    for key in ("hist_s", "hist_y"):
        for got, want in zip(ts[key], js[key]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-4)


def test_lbfgs_ring_overwrites_the_oldest_pair_and_round_trips():
    a, y, w0, b0 = _least_squares(1)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    ta, ty = torch.from_numpy(a), torch.from_numpy(y)
    opt = topt.LBFGS(parameters=[tw], max_iter=6, history_size=2)

    def closure():
        opt.clear_grad()
        loss = ((ta @ tw - ty) ** 2).mean()
        loss.backward()
        return loss

    opt.step(closure)
    state = opt.state_dict()
    assert len(opt._ring) == 2 and len(state["hist_s"]) == 2
    fresh = topt.LBFGS(parameters=[tw], max_iter=6, history_size=2)
    fresh.set_state_dict(state)
    for got, want in zip(fresh.state_dict()["hist_s"], state["hist_s"]):
        assert torch.equal(got, want)
    d = torch.randn(8)
    assert torch.equal(fresh._direction(d), opt._direction(d))


def test_lbfgs_requires_a_closure():
    opt = topt.LBFGS(parameters=[torch.nn.Parameter(torch.zeros(2))])
    with pytest.raises(TypeError, match="closure"):
        opt.step()
