"""The port's recurrent and transformer layers against the JAX package's,
on the CPU.

Each case builds the JAX layer and the port's with the same arguments,
copies the JAX state dict into the port's, runs both on the same seeded
numpy inputs and compares the outputs, the final states, and (under a
seeded random cotangent on every output) the gradients of the inputs and
of every parameter, all within 1e-5 relative L2 (f32: the two compute
the same products, summed in other orders). A gradient that is zero
analytically (the key projection's bias: softmax ignores a shift shared
by all of a query's scores) holds rounding noise on both sides; it
passes when both are below 1e-5 in norm.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu_torch import nn as pnn

TOL = 1e-5


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, tol=TOL):
    if np.linalg.norm(want) < 1e-5 and np.linalg.norm(got) < 1e-5:
        return True
    return rel(got, want) <= tol


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t.numpy()


def _flat(out):
    """Every tensor of a nested (tuple / list / namedtuple) output."""
    if out is None:
        return []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _pair(cls, *args, **kw):
    paddle.seed(0)
    j = getattr(jnn, cls)(*args, **kw)
    p = getattr(pnn, cls)(*args, **kw)
    missing, unexpected = p.set_state_dict(
        {k: v.numpy() for k, v in j.state_dict().items()})
    assert not missing and not unexpected, (missing, unexpected)
    return j, p


def _compare(j, p, inputs, call=None, grads=True, tol=TOL):
    """Outputs and gradients of ``j`` and ``p`` on ``inputs`` (numpy
    arrays; nested tuples allowed), called as ``call(layer, *tensors)``."""
    call = call or (lambda layer, *xs: layer(*xs))

    def conv(x, make):
        if isinstance(x, (tuple, list)):
            return type(x)(conv(e, make) for e in x)
        return None if x is None else make(x)

    jx = conv(inputs, lambda a: paddle.to_tensor(a, stop_gradient=False))
    px = conv(inputs, lambda a: torch.tensor(a, requires_grad=True))
    jo, po = _flat(call(j, *jx)), _flat(call(p, *px))
    assert len(jo) == len(po)
    for a, b in zip(jo, po):
        assert tuple(b.shape) == tuple(a.shape)
        assert rel(_np(b), _np(a)) <= tol
    if not grads:
        return
    cot = [_x(*a.shape, seed=20 + i) for i, a in enumerate(jo)]
    jl = sum((a * paddle.to_tensor(c)).sum() for a, c in zip(jo, cot))
    pl = sum((b * torch.from_numpy(c)).sum() for b, c in zip(po, cot))
    jl.backward()
    pl.backward()
    for a, b in zip(_flat(jx), _flat(px)):
        assert _close(b.grad.numpy(), a.grad.numpy(), tol)
    jp = dict(j.named_parameters())
    for name, q in p.named_parameters():
        assert q.grad is not None, name
        assert _close(q.grad.numpy(), jp[name].grad.numpy(), tol), name


# -- recurrent -------------------------------------------------------------
CELLS = {
    "simple_tanh": ("SimpleRNNCell", dict()),
    "simple_relu": ("SimpleRNNCell", dict(activation="relu")),
    "lstm": ("LSTMCell", dict()),
    "gru": ("GRUCell", dict()),
    "gru_no_bias": ("GRUCell", dict(bias_ih_attr=False,
                                    bias_hh_attr=False)),
}


@pytest.mark.parametrize("case", sorted(CELLS))
def test_cell_step_matches_jax(case):
    cls, kw = CELLS[case]
    j, p = _pair(cls, 5, 7, **kw)
    states = ((_x(3, 7, seed=1), _x(3, 7, seed=2)) if cls == "LSTMCell"
              else _x(3, 7, seed=1))
    _compare(j, p, (_x(3, 5), states))
    # zero initial states from get_initial_states
    _compare(j, p, (_x(3, 5, seed=4),))


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("time_major,reverse", [(False, False),
                                                (True, True)])
def test_rnn_wrapper_matches_jax(cell, time_major, reverse):
    paddle.seed(0)
    jc = getattr(jnn, cell)(4, 6)
    pc = getattr(pnn, cell)(4, 6)
    pc.set_state_dict({k: v.numpy() for k, v in jc.state_dict().items()})
    j = jnn.RNN(jc, is_reverse=reverse, time_major=time_major)
    p = pnn.RNN(pc, is_reverse=reverse, time_major=time_major)
    x = _x(5, 2, 4) if time_major else _x(2, 5, 4)
    _compare(j, p, (x,))


def test_birnn_matches_jax():
    paddle.seed(0)
    jf, jb = jnn.LSTMCell(4, 6), jnn.GRUCell(4, 6)
    pf, pb = pnn.LSTMCell(4, 6), pnn.GRUCell(4, 6)
    pf.set_state_dict({k: v.numpy() for k, v in jf.state_dict().items()})
    pb.set_state_dict({k: v.numpy() for k, v in jb.state_dict().items()})
    _compare(jnn.BiRNN(jf, jb), pnn.BiRNN(pf, pb), (_x(2, 5, 4),))


MULTI = {
    # name -> (class, kwargs)
    "lstm_2l_bi": ("LSTM", dict(num_layers=2, direction="bidirect")),
    "lstm_time_major": ("LSTM", dict(num_layers=2, time_major=True)),
    "gru_2l_bi": ("GRU", dict(num_layers=2, direction="bidirectional")),
    "gru_1l": ("GRU", dict()),
    "simple_tanh_bi": ("SimpleRNN", dict(num_layers=2,
                                         direction="bidirect")),
    "simple_relu": ("SimpleRNN", dict(activation="relu")),
}


@pytest.mark.parametrize("case", sorted(MULTI))
def test_multilayer_matches_jax(case):
    cls, kw = MULTI[case]
    j, p = _pair(cls, 4, 6, **kw)
    x = _x(5, 3, 4) if kw.get("time_major") else _x(3, 5, 4)
    _compare(j, p, (x,))
    # given initial states and a sequence_length (accepted and not
    # applied, in both packages)
    d = 2 if "direction" in kw else 1
    n = kw.get("num_layers", 1) * d
    h0 = _x(n, 3, 6, seed=5)
    init = (h0, _x(n, 3, 6, seed=6)) if cls == "LSTM" else h0
    lengths = np.array([5, 3, 1], np.int64)

    def call(layer, xs, states):
        lens = (paddle.to_tensor(lengths) if layer is j
                else torch.from_numpy(lengths))
        return layer(xs, states, sequence_length=lens)

    _compare(j, p, (x, init), call=call)


def test_multilayer_parameter_names_are_the_jax_ones():
    j, p = _pair("LSTM", 4, 6, num_layers=2, direction="bidirect")
    assert [n for n, _ in p.named_parameters()] == [
        n for n, _ in j.named_parameters()]
    assert "weight_ih_l1_reverse" in dict(p.named_parameters())


def test_bad_direction_and_activation_raise():
    with pytest.raises(ValueError, match="direction"):
        pnn.LSTM(4, 6, direction="sideways")
    with pytest.raises(ValueError, match="tanh or relu"):
        pnn.SimpleRNNCell(4, 6, activation="gelu")


# -- transformer -----------------------------------------------------------
def _mask(sq, sk, seed=7):
    """An additive float mask [sq, sk]: -1e9 on a seeded third of the
    entries, never a whole row."""
    m = np.random.RandomState(seed).rand(sq, sk) < 0.3
    m[:, 0] = False
    return np.where(m, -1e9, 0.0).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kv", ["self", "cross"])
def test_multi_head_attention_matches_jax(masked, kv):
    j, p = _pair("MultiHeadAttention", 16, 4, kdim=12 if kv == "cross"
                 else None, vdim=12 if kv == "cross" else None)
    j.eval()
    p.eval()
    q = _x(2, 5, 16)
    if kv == "self":
        inputs = (q, q, q, _mask(5, 5) if masked else None)
    else:
        m = _x(2, 7, 12, seed=3)
        inputs = (q, m, m, _mask(5, 7) if masked else None)
    _compare(j, p, inputs)


def test_multi_head_attention_caches_match_jax():
    j, p = _pair("MultiHeadAttention", 16, 4)
    j.eval()
    p.eval()
    mem = _x(2, 6, 16, seed=1)
    steps = [_x(2, 1, 16, seed=10 + t) for t in range(3)]
    jm, pm = paddle.to_tensor(mem), torch.from_numpy(mem)
    # incremental Cache: one query step at a time, the cache grows
    jc, pc = j.gen_cache(jm), p.gen_cache(pm)
    assert tuple(pc.k.shape) == tuple(jc.k.shape) == (2, 0, 4, 4)
    for s in steps:
        jo, jc = j(paddle.to_tensor(s), cache=jc)
        po, pc = p(torch.from_numpy(s), cache=pc)
        assert rel(_np(po), _np(jo)) <= TOL
        assert rel(_np(pc.k), _np(jc.k)) <= TOL
        assert rel(_np(pc.v), _np(jc.v)) <= TOL
    assert tuple(pc.k.shape) == (2, 3, 4, 4)
    # StaticCache: the projected memory, reused by every step
    js = j.gen_cache(jm, jm, type=jnn.MultiHeadAttention.StaticCache)
    ps = p.gen_cache(pm, pm, type=pnn.MultiHeadAttention.StaticCache)
    assert isinstance(ps, pnn.MultiHeadAttention.StaticCache)
    assert rel(_np(ps.k), _np(js.k)) <= TOL
    for s in steps:
        jo = j(paddle.to_tensor(s), cache=js)
        po = p(torch.from_numpy(s), cache=ps)
        assert rel(_np(po), _np(jo)) <= TOL


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_stack_matches_jax(normalize_before):
    paddle.seed(0)
    kw = dict(d_model=16, nhead=4, dim_feedforward=32, dropout=0.0,
              normalize_before=normalize_before)
    j = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(**kw), 2,
                               jnn.LayerNorm(16) if normalize_before
                               else None)
    p = pnn.TransformerEncoder(pnn.TransformerEncoderLayer(**kw), 2,
                               pnn.LayerNorm(16) if normalize_before
                               else None)
    p.set_state_dict({k: v.numpy() for k, v in j.state_dict().items()})
    _compare(j, p, (_x(2, 5, 16), _mask(5, 5)))
    _compare(j, p, (_x(2, 5, 16, seed=2),))


def test_decoder_stack_and_cache_match_jax():
    paddle.seed(0)
    kw = dict(d_model=16, nhead=4, dim_feedforward=32, dropout=0.0,
              activation="gelu")
    j = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(**kw), 2)
    p = pnn.TransformerDecoder(pnn.TransformerDecoderLayer(**kw), 2)
    p.set_state_dict({k: v.numpy() for k, v in j.state_dict().items()})
    tgt, mem = _x(2, 4, 16), _x(2, 6, 16, seed=1)
    causal = np.triu(np.full((4, 4), -1e9, np.float32), 1)
    _compare(j, p, (tgt, mem, causal, _mask(4, 6)))
    # incremental decoding through gen_cache: a step at a time
    j.eval()
    p.eval()
    jm, pm = paddle.to_tensor(mem), torch.from_numpy(mem)
    jc, pc = j.gen_cache(jm), p.gen_cache(pm)
    for t in range(3):
        s = _x(2, 1, 16, seed=30 + t)
        jo, jc = j(paddle.to_tensor(s), jm, cache=jc)
        po, pc = p(torch.from_numpy(s), pm, cache=pc)
        assert rel(_np(po), _np(jo)) <= TOL


def test_transformer_with_masks_matches_jax():
    paddle.seed(0)
    kw = dict(d_model=16, nhead=4, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=32, dropout=0.0)
    j, p = jnn.Transformer(**kw), pnn.Transformer(**kw)
    p.set_state_dict({k: v.numpy() for k, v in j.state_dict().items()})
    src, tgt = _x(2, 6, 16), _x(2, 4, 16, seed=1)
    jmask = jnn.Transformer.generate_square_subsequent_mask(4)
    pmask = pnn.Transformer.generate_square_subsequent_mask(4)
    np.testing.assert_array_equal(_np(pmask), _np(jmask))
    causal = np.where(np.isinf(_np(pmask)), -1e9, 0.0).astype(np.float32)
    _compare(j, p, (src, tgt, _mask(6, 6), causal, _mask(4, 6, seed=9)))
    _compare(j, p, (src, tgt))


def test_transformer_dropout_is_off_in_eval_and_on_in_train():
    p = pnn.Transformer(d_model=16, nhead=4, num_encoder_layers=1,
                        num_decoder_layers=1, dim_feedforward=32)
    src, tgt = torch.from_numpy(_x(2, 6, 16)), torch.from_numpy(_x(2, 4, 16))
    p.eval()
    a, b = p(src, tgt), p(src, tgt)
    assert torch.equal(a, b)
    p.train()
    torch.manual_seed(0)
    assert not torch.equal(p(src, tgt), a)
