"""The port's ``nn`` layer set against the JAX package's, on the CPU.

Each case builds the JAX layer and the port's with the same arguments,
copies the JAX layer's state dict into the port's (``set_state_dict``),
runs both on the same seeded numpy inputs and compares: forward outputs
within 1e-5 relative L2 (f32), the gradients through the convolutions,
the pools and the norms (of the input and every parameter, under a
seeded random cotangent) within 1e-4. Integer outputs (``return_mask``)
and exact ops compare equal. Cases that repeat each other are one
parametrised test each.

Two places where the port differs from the JAX package on purpose are
held to their own references: ``ceil_mode`` (the JAX pools ignore it;
here a numpy window loop gives shape and values) and the batch norms'
running statistics under a bf16 input (f32 buffers).
"""
import collections

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import ops as pF

FWD = 1e-5
GRAD = 1e-4


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(name, *args, **kw):
    """The JAX layer ``name`` and the port's, the JAX weights copied in."""
    paddle.seed(0)
    j = getattr(jnn, name)(*args, **kw)
    p = getattr(pnn, name)(*args, **kw)
    missing, unexpected = p.set_state_dict(
        {k: v.numpy() for k, v in j.state_dict().items()})
    assert not missing and not unexpected, (missing, unexpected)
    return j, p


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t.numpy()


def _check(j, p, *xs, grads=False, tol=FWD, gtol=GRAD):
    """Forward (and with ``grads`` every gradient) of JAX layer ``j`` and
    port layer ``p`` on inputs ``xs``."""
    jx = [paddle.to_tensor(x, stop_gradient=not grads) for x in xs]
    px = [torch.tensor(x, requires_grad=grads) for x in xs]
    jo, po = j(*jx), p(*px)
    assert tuple(po.shape) == tuple(jo.shape)
    assert rel(_np(po), _np(jo)) <= tol
    if not grads:
        return jo, po
    g = _x(*jo.shape, seed=9)
    (jo * paddle.to_tensor(g)).sum().backward()
    (po * torch.from_numpy(g)).sum().backward()
    for a, b in zip(jx, px):
        assert rel(b.grad.numpy(), a.grad.numpy()) <= gtol
    jp = dict(j.named_parameters())
    for name, q in p.named_parameters():
        assert rel(q.grad.numpy(), jp[name].grad.numpy()) <= gtol, name
    return jo, po


# -- convolutions ---------------------------------------------------------
CONVS = {
    "1d": ("Conv1D", (4, 6, 3), dict(stride=2, padding=1), (2, 4, 11)),
    "1d_nlc": ("Conv1D", (4, 6, 3), dict(padding=1, data_format="NLC"),
               (2, 11, 4)),
    "2d_groups_dilation": ("Conv2D", (4, 6, 3),
                           dict(padding=2, dilation=2, groups=2),
                           (2, 4, 9, 9)),
    "2d_same_stride2": ("Conv2D", (3, 5, 3), dict(stride=2,
                                                  padding="SAME"),
                        (2, 3, 10, 9)),
    "2d_same_k4": ("Conv2D", (3, 5, 4), dict(padding="same"),
                   (2, 3, 7, 8)),
    "2d_valid": ("Conv2D", (3, 5, 3), dict(stride=2, padding="VALID"),
                 (2, 3, 9, 9)),
    "2d_four_ints": ("Conv2D", (3, 5, 3), dict(padding=[1, 2, 0, 1]),
                     (2, 3, 8, 8)),
    "2d_pairs": ("Conv2D", (3, 5, (3, 2)), dict(padding=[[2, 0], [1, 1]],
                                                stride=(2, 1)),
                 (2, 3, 8, 7)),
    "2d_nhwc": ("Conv2D", (3, 5, 3), dict(padding=1, stride=2,
                                          data_format="NHWC"),
                (2, 8, 8, 3)),
    "2d_no_bias": ("Conv2D", (3, 4, 1), dict(bias_attr=False),
                   (2, 3, 5, 5)),
    "3d": ("Conv3D", (2, 4, 3), dict(padding=1, stride=(1, 2, 2)),
           (1, 2, 5, 6, 6)),
    "1d_transpose": ("Conv1DTranspose", (4, 6, 3),
                     dict(stride=2, padding=1, output_padding=1),
                     (2, 4, 7)),
    "2d_transpose": ("Conv2DTranspose", (4, 6, 3),
                     dict(stride=2, padding=1, output_padding=1),
                     (2, 4, 5, 5)),
    "2d_transpose_groups_dilation": ("Conv2DTranspose", (4, 6, 3),
                                     dict(stride=2, dilation=2, groups=2,
                                          padding=2),
                                     (2, 4, 5, 5)),
    "2d_transpose_pairs": ("Conv2DTranspose", (3, 4, 3),
                           dict(stride=2, padding=[[1, 2], [0, 1]],
                                output_padding=1),
                           (2, 3, 5, 4)),
    "2d_transpose_big_output_padding": ("Conv2DTranspose", (3, 4, 3),
                                        dict(stride=1, padding=1,
                                             output_padding=2),
                                        (2, 3, 5, 5)),
    "2d_transpose_nhwc": ("Conv2DTranspose", (3, 4, 3),
                          dict(stride=2, padding=1, output_padding=1,
                               data_format="NHWC"), (2, 5, 5, 3)),
    "3d_transpose": ("Conv3DTranspose", (2, 3, 3),
                     dict(stride=2, padding=1, output_padding=1),
                     (1, 2, 3, 4, 4)),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv_matches_jax(case):
    name, args, kw, shape = CONVS[case]
    j, p = _pair(name, *args, **kw)
    _check(j, p, _x(*shape), grads=True)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_transposed_conv_string_padding_raises_as_jax(padding):
    # the JAX op hands the string to lax, which refuses it for the
    # gradient-of-conv form: both refuse
    j, p = _pair("Conv2DTranspose", 3, 4, 3, stride=2, padding=padding)
    x = _x(2, 3, 5, 5)
    with pytest.raises(ValueError, match="[Ss]tring padding"):
        j(paddle.to_tensor(x))
    with pytest.raises(ValueError, match="string padding"):
        p(torch.from_numpy(x))


def test_conv_default_init_bounds():
    # Uniform(+-1/sqrt(fan_in)) for weight and bias, as the JAX layer
    p = pnn.Conv2D(6, 8, 3, groups=2)
    bound = 1.0 / np.sqrt(6 // 2 * 9)
    for t in (p.weight, p.bias):
        assert float(t.detach().abs().max()) <= bound
    assert tuple(p.weight.shape) == (8, 3, 3, 3)
    t = pnn.Conv2DTranspose(6, 8, 3, groups=2)
    assert tuple(t.weight.shape) == (6, 4, 3, 3)


# -- pooling --------------------------------------------------------------
POOLS = {
    "max2d": ("MaxPool2D", (3, 2, 1), {}, (2, 3, 9, 9)),
    "max2d_asym": ("MaxPool2D", (3,), dict(stride=2, padding=[0, 2, 1, 0]),
                   (2, 3, 8, 8)),
    "max2d_same": ("MaxPool2D", (3, 2, "SAME"), {}, (2, 3, 8, 7)),
    "max2d_nhwc": ("MaxPool2D", (2, 2), dict(data_format="NHWC"),
                   (2, 6, 6, 3)),
    "max1d": ("MaxPool1D", (3, 2, 1), {}, (2, 3, 10)),
    "max3d": ("MaxPool3D", (2, 2), {}, (1, 2, 4, 6, 6)),
    "avg2d_exclusive": ("AvgPool2D", (3, 2, 1), {}, (2, 3, 9, 9)),
    "avg2d_inclusive": ("AvgPool2D", (3, 2, 1), dict(exclusive=False),
                        (2, 3, 9, 9)),
    "avg2d_asym_exclusive": ("AvgPool2D", (3, 2, [1, 2, 0, 1]), {},
                             (2, 3, 8, 8)),
    "avg2d_asym_inclusive": ("AvgPool2D", (3, 2, [1, 2, 0, 1]),
                             dict(exclusive=False), (2, 3, 8, 8)),
    "avg1d": ("AvgPool1D", (4, 2, 1), {}, (2, 3, 11)),
    "avg3d": ("AvgPool3D", (2, 2, 1), dict(exclusive=False),
              (1, 2, 4, 5, 5)),
    "adaptive_avg2d": ("AdaptiveAvgPool2D", ((1, 1),), {}, (2, 3, 4, 4)),
    "adaptive_avg2d_uneven": ("AdaptiveAvgPool2D", ((3, 2),), {},
                              (2, 3, 7, 5)),
    "adaptive_max2d_uneven": ("AdaptiveMaxPool2D", ((3, 2),), {},
                              (2, 3, 7, 5)),
    "adaptive_avg1d_uneven": ("AdaptiveAvgPool1D", (3,), {}, (2, 3, 7)),
}


@pytest.mark.parametrize("case", sorted(POOLS))
def test_pool_matches_jax(case):
    name, args, kw, shape = POOLS[case]
    j, p = _pair(name, *args, **kw)
    _check(j, p, _x(*shape), grads=True)


@pytest.mark.parametrize("kw", [dict(padding=1), dict(padding=[0, 1, 1, 0]),
                                dict(padding="SAME")],
                         ids=["sym", "asym", "same"])
def test_max_pool_return_mask_matches_jax(kw):
    j, p = _pair("MaxPool2D", 3, 2, return_mask=True, **kw)
    x = _x(2, 3, 9, 8)
    if kw["padding"] == "SAME":
        # string padding has no index form, as in the JAX op
        with pytest.raises(ValueError, match="string padding"):
            p(torch.from_numpy(x))
        return
    jo, jm = j(paddle.to_tensor(x))
    po, pm = p(torch.from_numpy(x))
    np.testing.assert_array_equal(po.numpy(), jo.numpy())
    np.testing.assert_array_equal(pm.numpy(), jm.numpy().astype(np.int64))
    # the mask indexes the input's H * W
    flat = torch.from_numpy(x).flatten(2)
    np.testing.assert_array_equal(
        flat.gather(2, pm.flatten(2)).reshape(po.shape).numpy(), po.numpy())


def _pool_loop(x, k, s, pads, ceil, kind, count_pad):
    """2-D pooling by an explicit window loop: output ceil((L - k) / s) +
    1 windows over L = h + lo + hi with ``ceil``, less the last one if it
    starts in the high padding; a max never takes padding; an average
    counts the padding (not the cells past it) with ``count_pad``."""
    n, c, h, w = x.shape
    (tl, th), (ll, lh) = pads

    def size(dim, lo, hi, kk, ss):
        length = dim + lo + hi
        if not ceil:
            return (length - kk) // ss + 1
        out = -(-(length - kk) // ss) + 1
        if (out - 1) * ss >= dim + lo:
            out -= 1
        return out

    oh, ow = size(h, tl, th, k, s), size(w, ll, lh, k, s)
    out = np.zeros((n, c, oh, ow), np.float64)
    for i in range(oh):
        for j in range(ow):
            y0, x0 = i * s - tl, j * s - ll
            ys = [y for y in range(y0, y0 + k) if 0 <= y < h]
            xs = [v for v in range(x0, x0 + k) if 0 <= v < w]
            win = x[:, :, ys][:, :, :, xs].reshape(n, c, -1)
            if kind == "max":
                out[:, :, i, j] = win.max(-1)
                continue
            if count_pad:
                yc = min(y0 + k, h + th) - max(y0, -tl)
                xc = min(x0 + k, w + lh) - max(x0, -ll)
                cnt = yc * xc
            else:
                cnt = len(ys) * len(xs)
            out[:, :, i, j] = win.sum(-1) / cnt
    return out


CEIL = {
    "max_sym": ("max", 3, 2, 1, True),
    "max_k2_s2": ("max", 2, 2, 0, True),
    "max_asym": ("max", 3, 2, [0, 1, 1, 0], True),
    "avg_exclusive": ("avg", 3, 2, 1, False),
    "avg_inclusive": ("avg", 3, 2, 1, True),
    "avg_asym_inclusive": ("avg", 3, 2, [1, 0, 0, 1], True),
    "avg_asym_exclusive": ("avg", 3, 2, [1, 0, 0, 1], False),
}


@pytest.mark.parametrize("case", sorted(CEIL))
def test_ceil_mode_against_window_loop(case):
    # the JAX pools ignore ceil_mode (floor-mode shape); the port
    # implements it: shape and values of a numpy window loop
    kind, k, s, padding, count_pad = CEIL[case]
    x = _x(2, 3, 8, 7)
    pairs = ([(padding, padding)] * 2 if isinstance(padding, int)
             else [(padding[0], padding[1]), (padding[2], padding[3])])
    want = _pool_loop(x.astype(np.float64), k, s, pairs, True, kind,
                      count_pad)
    if kind == "max":
        layer = pnn.MaxPool2D(k, s, padding, ceil_mode=True)
    else:
        layer = pnn.AvgPool2D(k, s, padding, ceil_mode=True,
                              exclusive=not count_pad)
    got = layer(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert rel(got, want) <= FWD
    floor = _pool_loop(x.astype(np.float64), k, s, pairs, False, kind,
                       count_pad)
    assert floor.shape != want.shape   # the case exercises ceil mode
    # the JAX layer returns the floor-mode shape (the fault repaired here)
    jcls = jnn.MaxPool2D if kind == "max" else jnn.AvgPool2D
    jkw = {} if kind == "max" else dict(exclusive=not count_pad)
    jo = jcls(k, s, padding, ceil_mode=True, **jkw)(paddle.to_tensor(x))
    assert tuple(jo.shape) == floor.shape


def test_ceil_mode_return_mask_against_window_loop():
    x = _x(1, 2, 8, 7)
    out, mask = pnn.MaxPool2D(3, 2, 1, return_mask=True,
                              ceil_mode=True)(torch.from_numpy(x))
    want = _pool_loop(x.astype(np.float64), 3, 2, [(1, 1), (1, 1)], True,
                      "max", False)
    assert out.shape == want.shape and rel(out.numpy(), want) <= FWD
    flat = torch.from_numpy(x).flatten(2)
    assert torch.equal(flat.gather(2, mask.flatten(2)).reshape(out.shape),
                       out)


# -- normalisation --------------------------------------------------------
BATCH_NORMS = {
    "1d_2d_input": ("BatchNorm1D", (5,), {}, (6, 5)),
    "1d": ("BatchNorm1D", (5,), {}, (4, 5, 3)),
    "2d": ("BatchNorm2D", (4,), {}, (3, 4, 5, 5)),
    "2d_nhwc": ("BatchNorm2D", (4,), dict(data_format="NHWC"),
                (3, 5, 5, 4)),
    "3d": ("BatchNorm3D", (3,), {}, (2, 3, 2, 4, 4)),
    "any_rank": ("BatchNorm", (4,), dict(momentum=0.8, epsilon=1e-3),
                 (3, 4, 6)),
    "sync": ("SyncBatchNorm", (4,), {}, (3, 4, 5, 5)),
}


@pytest.mark.parametrize("case", sorted(BATCH_NORMS))
def test_batch_norm_train_eval_and_running_stats(case):
    name, args, kw, shape = BATCH_NORMS[case]
    j, p = _pair(name, *args, **kw)
    x1, x2 = _x(*shape, seed=1) * 3 + 1, _x(*shape, seed=2)
    _check(j, p, x1, grads=True)          # train call 1, with gradients
    _check(j, p, x2)                      # train call 2
    for buf in ("_mean", "_variance"):
        assert rel(getattr(p, buf).numpy(),
                   getattr(j, buf).numpy()) <= FWD, buf
    j.eval()
    p.eval()
    _check(j, p, _x(*shape, seed=3), grads=True)   # running statistics
    assert rel(p._mean.numpy(), j._mean.numpy()) <= FWD   # unchanged


def test_batch_norm_running_stats_are_jax_formula():
    # m = 0.9, the batch's BIASED variance (torch's own batch_norm keeps
    # the unbiased one and weights the batch by its momentum)
    p = pnn.BatchNorm2D(3)
    x = _x(4, 3, 2, 2, seed=5)
    p(torch.from_numpy(x))
    mean = x.mean(axis=(0, 2, 3))
    var = x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(p._mean.numpy(), 0.1 * mean, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(p._variance.numpy(), 0.9 + 0.1 * var,
                               rtol=1e-5)


@pytest.mark.parametrize("use_global_stats", [True, False])
def test_batch_norm_use_global_stats(use_global_stats):
    j, p = _pair("BatchNorm2D", 4, use_global_stats=use_global_stats)
    buf = dict(_mean=np.linspace(-1, 1, 4).astype(np.float32),
               _variance=np.linspace(0.5, 2, 4).astype(np.float32))
    j.set_state_dict({k: paddle.to_tensor(v) for k, v in buf.items()})
    p.set_state_dict(buf)
    x = _x(3, 4, 5, 5)
    if not use_global_stats:
        # batch statistics, buffers updated, even in eval
        j.eval()
        p.eval()
    _check(j, p, x, grads=True)
    for name in buf:
        assert rel(getattr(p, name).numpy(), getattr(j, name).numpy()) \
            <= FWD


def test_batch_norm_bf16_input():
    # statistics in f32, the normalised value in bf16 before the scale;
    # the running buffers stay f32 (JAX: the policy's dtype)
    j, p = _pair("BatchNorm2D", 4)
    x = _x(3, 4, 5, 5) * 2 + 0.5
    jo = j(paddle.to_tensor(x).astype("bfloat16"))
    po = p.to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16))
    assert po.dtype == torch.bfloat16
    assert rel(_np(po.float()), jo.astype("float32").numpy()) <= 1e-2
    # an f32 layer on a bf16 input keeps f32 buffers at f32 accuracy
    q = pnn.BatchNorm2D(4)
    q(torch.from_numpy(x).to(torch.bfloat16))
    assert q._mean.dtype == torch.float32
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(q._variance.numpy(),
                               0.9 + 0.1 * xb.var(axis=(0, 2, 3)),
                               rtol=1e-5)


NORMS = {
    "layer_norm": ("LayerNorm", (6,), {}, (3, 4, 6)),
    "layer_norm_2axes": ("LayerNorm", ([4, 6],), dict(epsilon=1e-3),
                         (3, 4, 6)),
    "layer_norm_no_affine": ("LayerNorm", (6,),
                             dict(weight_attr=False, bias_attr=False),
                             (3, 6)),
    "rms_norm": ("RMSNorm", (6,), {}, (3, 4, 6)),
    "group_norm": ("GroupNorm", (2, 6), {}, (3, 6, 4, 4)),
    "group_norm_nhwc": ("GroupNorm", (3, 6), dict(data_format="NHWC"),
                        (3, 4, 4, 6)),
    "instance_norm1d": ("InstanceNorm1D", (4,), {}, (3, 4, 7)),
    "instance_norm2d": ("InstanceNorm2D", (4,), {}, (3, 4, 5, 5)),
    "instance_norm3d": ("InstanceNorm3D", (2,), {}, (2, 2, 3, 4, 4)),
    "local_response_norm": ("LocalResponseNorm", (3,), dict(alpha=1e-2),
                            (2, 6, 4, 4)),
}


@pytest.mark.parametrize("case", sorted(NORMS))
def test_norm_matches_jax(case):
    name, args, kw, shape = NORMS[case]
    j, p = _pair(name, *args, **kw)
    _check(j, p, _x(*shape) * 2 + 1, grads=True)


def test_spectral_norm_matches_jax():
    j, p = _pair("SpectralNorm", [6, 4, 3], dim=1, power_iters=2)
    w = _x(6, 4, 3)
    for _ in range(2):   # the buffers advance each call
        _check(j, p, w, grads=True)
    assert rel(p.weight_u.numpy(), j.weight_u.numpy()) <= FWD


# -- activations ----------------------------------------------------------
ACTIVATIONS = {
    "CELU": dict(alpha=0.7), "ELU": dict(alpha=0.5), "GELU": {},
    "GELU_tanh": dict(approximate=True), "GLU": dict(axis=1),
    "Hardshrink": dict(threshold=0.3), "Hardsigmoid": {}, "Hardswish": {},
    "Hardtanh": dict(min=-0.5, max=0.8), "LeakyReLU": dict(
        negative_slope=0.1), "LogSigmoid": {}, "LogSoftmax": dict(axis=1),
    "Maxout": dict(groups=2, axis=1), "Mish": {}, "PReLU": {},
    "PReLU_channels": dict(num_parameters=4, init=0.1), "ReLU": {},
    "ReLU6": {}, "SELU": {}, "Sigmoid": {}, "Silu": {},
    "Softmax": dict(axis=-1), "Softplus": dict(beta=2.0, threshold=3.0),
    "Softshrink": dict(threshold=0.4), "Softsign": {}, "Swish": {},
    "Tanh": {}, "Tanhshrink": {}, "ThresholdedReLU": dict(threshold=0.5),
    "RReLU_eval": {},
}


@pytest.mark.parametrize("case", sorted(ACTIVATIONS))
def test_activation_matches_jax(case):
    name = case.split("_")[0]
    j, p = _pair(name, **ACTIVATIONS[case])
    if case == "RReLU_eval":
        j.eval()
        p.eval()
    _check(j, p, _x(2, 4, 3, 3) * 3, grads=True)


def test_rrelu_training_slopes_lie_in_bounds():
    x = -torch.rand(4, 1000) - 0.5
    layer = pnn.RReLU(0.1, 0.3, generator=torch.Generator().manual_seed(1))
    out = layer(x)
    slope = out / x
    assert float(slope.min()) >= 0.1 and float(slope.max()) <= 0.3
    assert float(slope.std()) > 0.03          # drawn per element
    again = pnn.RReLU(0.1, 0.3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(again(x), out)
    torch.testing.assert_close(layer.eval()(x), x * 0.2)


# -- common layers --------------------------------------------------------
COMMON = {
    "Linear": ((5, 3), {}, [(2, 4, 5)]),
    "Linear_no_bias": ((5, 3), dict(bias_attr=False), [(2, 5)]),
    "Bilinear": ((3, 4, 2), {}, [(5, 3), (5, 4)]),
    "Flatten": ((), {}, [(2, 3, 4, 5)]),
    "Flatten_mid": ((1, 2), {}, [(2, 3, 4, 5)]),
    "Identity": ((), {}, [(2, 3)]),
    "Pad1D": (([1, 2],), dict(mode="reflect"), [(2, 3, 6)]),
    "Pad2D": (([1, 0, 2, 1],), dict(mode="replicate"), [(2, 3, 4, 5)]),
    "Pad2D_constant": (([1, 0, 2, 1],), dict(value=0.5), [(2, 3, 4, 5)]),
    "Pad3D": (([1, 1, 0, 1, 1, 0],), dict(mode="circular"),
              [(1, 2, 3, 4, 4)]),
    "ZeroPad2D": (([1, 2, 0, 1],), {}, [(2, 3, 4, 4)]),
    "Upsample_nearest": ((), dict(scale_factor=2), [(2, 3, 3, 4)]),
    "Upsample_nearest_size": ((), dict(size=[5, 7]), [(2, 3, 3, 4)]),
    "Upsample_bilinear": ((), dict(size=[6, 7], mode="bilinear"),
                          [(2, 3, 3, 4)]),
    "Upsample_bilinear_corners": ((), dict(size=[6, 7], mode="bilinear",
                                           align_corners=True),
                                  [(2, 3, 3, 4)]),
    "UpsamplingBilinear2D": ((), dict(scale_factor=2), [(2, 3, 3, 4)]),
    "PixelShuffle": ((2,), {}, [(2, 8, 3, 3)]),
    "PixelUnshuffle": ((2,), {}, [(2, 2, 4, 6)]),
    "Unfold": (([2, 3],), dict(strides=[1, 2], paddings=1),
               [(2, 3, 5, 6)]),
    "CosineSimilarity": ((), dict(axis=1), [(3, 5), (3, 5)]),
}


@pytest.mark.parametrize("case", sorted(COMMON))
def test_common_layer_matches_jax(case):
    args, kw, shapes = COMMON[case]
    j, p = _pair(case.split("_")[0], *args, **kw)
    xs = [_x(*s, seed=i) for i, s in enumerate(shapes)]
    grads = case.startswith(("Linear", "Bilinear", "Upsample", "Pad2D"))
    _check(j, p, *xs, grads=grads)


def test_linear_weight_is_in_out():
    p = pnn.Linear(5, 3)
    assert tuple(p.weight.shape) == (5, 3)
    assert not isinstance(p, torch.nn.Linear)


@pytest.mark.parametrize("padding_idx", [None, 2])
def test_embedding_matches_jax(padding_idx):
    j, p = _pair("Embedding", 7, 4, padding_idx=padding_idx)
    ids = np.array([[0, 2, 6], [2, 1, 3]], np.int64)
    jo = j(paddle.to_tensor(ids))
    po = p(torch.from_numpy(ids))
    np.testing.assert_array_equal(po.detach().numpy(), jo.numpy())
    po.sum().backward()
    if padding_idx is not None:
        assert float(p.weight.grad[padding_idx].abs().sum()) == 0.0


@pytest.mark.parametrize("name,kw,shape", [
    ("Dropout", {}, (64, 64)),
    ("Dropout", dict(axis=1), (64, 64)),
    ("Dropout", dict(mode="downscale_in_infer"), (64, 64)),
    ("Dropout2D", {}, (4, 32, 3, 3)),
    ("Dropout3D", {}, (4, 32, 2, 2, 2)),
    ("AlphaDropout", {}, (64, 64)),
], ids=["dropout", "dropout_axis", "downscale", "2d", "3d", "alpha"])
def test_dropout_masks(name, kw, shape):
    # the keep-masks come from the generator (JAX: its PRNG key), so the
    # masks differ from JAX's; what is held: eval is the JAX layer's,
    # train keeps about 1 - p, scales as the mode says, drops whole
    # channels for the 2-D / 3-D forms, and repeats under one seed
    x = _x(*shape) + 3.0
    j, p = _pair(name, p=0.5, **kw)
    j.eval()
    p.eval()
    _check(j, p, x)
    p.train()

    def run(seed):
        p.generator = torch.Generator().manual_seed(seed)
        return p(torch.from_numpy(x))

    a, b = run(1), run(1)
    assert torch.equal(a, b) and not torch.equal(a, run(2))
    xt = torch.from_numpy(x)
    if name == "AlphaDropout":
        alpha_p = -1.6732632423543772 * 1.0507009873554805
        ka = 1.0 / (0.5 * (1.0 + 0.5 * alpha_p ** 2)) ** 0.5
        kb = -ka * alpha_p * 0.5
        kept = torch.isclose(a, ka * xt + kb)
        dropped = torch.isclose(a, torch.tensor(ka * alpha_p + kb))
        assert bool((kept | dropped).all())
        assert 0.4 < float(kept.float().mean()) < 0.6
        return
    keep = a != 0
    assert 0.4 < float(keep.float().mean()) < 0.6
    scale = 1.0 if kw.get("mode") == "downscale_in_infer" else 2.0
    torch.testing.assert_close(a[keep], xt[keep] * scale)
    if name != "Dropout" or "axis" in kw:
        # one decision per (sample, channel) / per column
        flat = keep.reshape(shape[0], shape[1], -1)
        assert bool((flat.all(-1) | ~flat.any(-1)).all())


# -- containers -----------------------------------------------------------
def _names(layer):
    return sorted(layer.state_dict())


def test_container_names_match_jax():
    def build(m):
        seq = m.Sequential(m.Linear(2, 3), m.ReLU(), m.Linear(3, 1))
        named = m.Sequential(("a", m.Linear(2, 2)), ("b", m.BatchNorm1D(2)))
        od = m.Sequential(collections.OrderedDict(
            [("x", m.Linear(1, 1)), ("y", m.Linear(1, 1))]))
        ll = m.LayerList([m.Linear(1, 2)])
        ll.append(m.Linear(2, 2))
        ll.insert(0, m.Linear(3, 1))
        ld = m.LayerDict({"p": m.Linear(1, 1)})
        ld["q"] = m.Linear(2, 1)
        pl = m.ParameterList([m.Linear(1, 1).weight])
        return [seq, named, od, ll, ld, pl]

    paddle.seed(0)
    for jl, pl in zip(build(jnn), build(pnn)):
        assert _names(pl) == _names(jl)
        assert len(pl) == len(jl)
    seq = build(pnn)[0]
    assert isinstance(seq[1], pnn.ReLU) and len(seq[0:2]) == 2
    assert list(build(pnn)[3]._modules) == ["0", "1", "2"]


def test_sequential_forward_matches_jax():
    def build(m):
        # no conv bias before the norm (its gradient is 0 there)
        return m.Sequential(m.Conv2D(3, 4, 3, padding=1, bias_attr=False),
                            m.BatchNorm2D(4),
                            m.ReLU(), m.MaxPool2D(2), m.Flatten(),
                            m.Linear(4 * 4 * 4, 5))

    paddle.seed(0)
    j, p = build(jnn), build(pnn)
    p.set_state_dict({k: v.numpy() for k, v in j.state_dict().items()})
    _check(j, p, _x(2, 3, 8, 8), grads=True)


# -- losses ---------------------------------------------------------------
def _logits(n=6, c=5):
    return _x(n, c)


def _probs(n=6, c=5):
    return 1 / (1 + np.exp(-_x(n, c, seed=4)))


LOSSES = {
    "CrossEntropyLoss": ({}, lambda: [_logits(), np.array(
        [0, 4, 2, 1, 3, 0], np.int64)]),
    "CrossEntropyLoss_smooth_weight": (dict(label_smoothing=0.1), lambda: [
        _logits(), np.array([0, 4, 2, 1, 3, 0], np.int64)]),
    "MSELoss": ({}, lambda: [_x(6, 5), _x(6, 5, seed=1)]),
    "L1Loss": (dict(reduction="sum"), lambda: [_x(6, 5), _x(6, 5, seed=1)]),
    "NLLLoss": (dict(ignore_index=2), lambda: [
        np.log(_probs() / _probs().sum(-1, keepdims=True)),
        np.array([0, 4, 2, 1, 3, 0], np.int64)]),
    "BCELoss": ({}, lambda: [_probs(), (_x(6, 5, seed=2) > 0).astype(
        np.float32)]),
    "BCEWithLogitsLoss": ({}, lambda: [_logits(), (_x(6, 5, seed=2) > 0)
                                       .astype(np.float32)]),
    "KLDivLoss": (dict(reduction="batchmean"), lambda: [
        np.log(_probs()), _probs(6, 5) * 0.5]),
    "SmoothL1Loss": (dict(delta=0.5), lambda: [_x(6, 5), _x(6, 5, seed=1)]),
    "MarginRankingLoss": (dict(margin=0.2), lambda: [
        _x(6), _x(6, seed=1), np.sign(_x(6, seed=2)).astype(np.float32)]),
    "CosineEmbeddingLoss": (dict(margin=0.1), lambda: [
        _x(6, 5), _x(6, 5, seed=1),
        np.array([1, -1, 1, 1, -1, -1], np.float32)]),
    "HingeEmbeddingLoss": ({}, lambda: [
        _x(6, 5), np.sign(_x(6, 5, seed=1)).astype(np.float32)]),
    "TripletMarginLoss": (dict(margin=0.5), lambda: [
        _x(6, 5), _x(6, 5, seed=1), _x(6, 5, seed=2)]),
    "CTCLoss": ({}, lambda: [
        _x(7, 2, 5), np.array([[1, 2, 2], [3, 1, 0]], np.int64),
        np.array([7, 6], np.int64), np.array([3, 2], np.int64)]),
}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_matches_jax(case):
    kw, data = LOSSES[case]
    name = case.split("_")[0]
    if case == "CrossEntropyLoss_smooth_weight":
        w = np.linspace(0.5, 1.5, 5).astype(np.float32)
        j = jnn.CrossEntropyLoss(weight=paddle.to_tensor(w), **kw)
        p = pnn.CrossEntropyLoss(weight=torch.from_numpy(w), **kw)
    else:
        j, p = getattr(jnn, name)(**kw), getattr(pnn, name)(**kw)
    xs = data()
    jx = [paddle.to_tensor(x, stop_gradient=x.dtype != np.float32 or i)
          for i, x in enumerate(xs)]
    px = [torch.tensor(x, requires_grad=bool(x.dtype == np.float32
                                             and not i))
          for i, x in enumerate(xs)]
    jo, po = j(*jx), p(*px)
    assert rel(_np(po), _np(jo)) <= FWD
    jo.sum().backward()
    po.sum().backward()
    assert rel(px[0].grad.numpy(), jx[0].grad.numpy()) <= GRAD


# -- functional and initializers -----------------------------------------
def test_functional_names_are_jax_s():
    import paddle_tpu_torch.nn.functional as pfn

    left_out = set()
    want = {n for n in dir(jF) if not n.startswith("_")}
    got = {n for n in dir(pfn) if not n.startswith("_")}
    assert want - got == left_out
    assert pfn.conv2d is pF.conv2d and pfn.relu is pF.relu


def test_flatten_and_pad_match_jax():
    x = _x(2, 3, 4, 5)
    for a, b in [(0, -1), (1, 2), (2, 1)]:
        np.testing.assert_array_equal(
            pF.flatten(torch.from_numpy(x), a, b).numpy(),
            paddle.flatten(paddle.to_tensor(x), a, b).numpy())
    for kw in (dict(pad=[1, 2]), dict(pad=[1, 0, 0, 2], mode="reflect"),
               dict(pad=[1, 2, 0, 1], pad_from_last_axis=False),
               dict(pad=[2, 1], mode="replicate", pad_from_last_axis=False)):
        np.testing.assert_array_equal(
            pF.pad(torch.from_numpy(x), **kw).numpy(),
            jF.pad(paddle.to_tensor(x), **kw).numpy())


@pytest.mark.parametrize("name", ["Constant", "Dirac", "Assign"])
def test_deterministic_initializers_match_jax(name):
    from paddle_tpu.nn import initializer as JI
    from paddle_tpu_torch.nn import initializer as PI

    arg = {"Constant": (0.3,), "Dirac": (2,),
           "Assign": (np.arange(24, dtype=np.float32),)}[name]
    shape = [4, 3, 2, 1] if name != "Dirac" else [4, 2, 3, 3]
    np.testing.assert_array_equal(getattr(PI, name)(*arg)(shape).numpy(),
                                  np.asarray(getattr(JI, name)(*arg)(shape)))


@pytest.mark.parametrize("name,kw,std", [
    ("Normal", dict(mean=1.0, std=2.0), 2.0),
    ("TruncatedNormal", dict(std=0.5), 0.5 * 0.8796),
    ("Uniform", dict(low=-3.0, high=1.0), 4 / 12 ** 0.5),
    ("XavierNormal", {}, (2 / (400 + 300)) ** 0.5),
    ("XavierUniform", {}, (6 / 700) ** 0.5 / 3 ** 0.5),
    ("KaimingNormal", {}, (2 / 400) ** 0.5),
    ("KaimingUniform", {}, (2 / 400) ** 0.5),
    ("Orthogonal", dict(gain=2.0), 2.0 / 400 ** 0.5),
])
def test_random_initializers_draw_from_the_generator(name, kw, std):
    from paddle_tpu_torch.nn import initializer as PI

    init = getattr(PI, name)(**kw)
    a = init([400, 300], generator=torch.Generator().manual_seed(0))
    b = init([400, 300], generator=torch.Generator().manual_seed(0))
    c = init([400, 300], generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.std()) / std - 1) < 0.05


def test_init_generator_seeds_layers_and_precedence():
    from paddle_tpu_torch.nn import initializer as PI

    def make():
        with PI.init_generator(torch.Generator().manual_seed(3)):
            return pnn.Linear(4, 5)

    assert torch.equal(make().weight, make().weight)
    assert PI.calculate_gain("leaky_relu", 0.2) == \
        jnn.initializer.calculate_gain("leaky_relu", 0.2)
    # ParamAttr's initializer over the layer's default; the override over
    # both
    attr = pnn.ParamAttr(initializer=PI.Constant(0.5), learning_rate=0.1,
                         need_clip=False)
    lin = pnn.Linear(2, 2, weight_attr=attr)
    assert bool((lin.weight == 0.5).all()) and lin.weight.need_clip is False
    assert lin.weight.optimize_attr["learning_rate"] == 0.1
    with PI.param_init_override(PI.Constant(2.0), dtype="float64"):
        lin = pnn.Linear(2, 2, weight_attr=attr)
    assert lin.weight.dtype == torch.float64 and bool((lin.weight == 2).all())
    frozen = pnn.Linear(2, 2, weight_attr=pnn.ParamAttr(trainable=False))
    assert frozen.weight.stop_gradient and not frozen.weight.requires_grad


def test_layer_surface():
    layer = pnn.Conv2D(2, 3, 1)
    layer.register_buffer("scratch", torch.zeros(2), persistable=False)
    assert "scratch" not in layer.state_dict()
    missing, unexpected = layer.set_state_dict(
        {"weight": np.ones((3, 2, 1, 1), np.float32), "extra": np.ones(1)})
    assert missing == ["bias"] and unexpected == ["extra"]
    assert bool((layer.weight == 1).all())
    with pytest.raises(ValueError, match="shape mismatch"):
        layer.set_state_dict({"weight": np.ones((2, 2, 1, 1))})
    layer.to(dtype="float64")
    assert layer.weight.dtype == torch.float64
    assert layer.astype("float32").bias.dtype == torch.float32
    seen = []
    handle = layer.register_forward_post_hook(
        lambda m, i, o: seen.append(o.shape))
    layer(torch.zeros(1, 2, 3, 3))
    handle.remove()
    layer(torch.zeros(1, 2, 3, 3))
    assert len(seen) == 1
    outer = pnn.Sequential(layer, pnn.Sequential(pnn.ReLU()))
    assert len(outer.sublayers()) == 3 and \
        len(outer.sublayers(include_self=True)) == 4
    with pytest.raises(TypeError):
        outer.add_parameter("w", torch.zeros(1))
