"""paddle_tpu_torch's FFT ops (``ops/fft_ops.py``, the ``fft`` namespace)
and ``signal`` against the JAX package's, on the CPU.

The same numpy inputs (fixed seeds) go through both: transforms within
rtol 1e-5 of the result's largest magnitude (atol 1e-5 x max |out|, as an
FFT's rounding error scales with the whole input), framing and
overlap-add exact or 1e-6, ``stft``/``istft`` within 1e-5 of the
largest magnitude. Gradients of real compositions (``irfft(rfft(x))``, a
power spectrum, ``|stft|^2``) against JAX's tape at 1e-4 relative; the
silent stretch of a power spectrum keeps them finite on both sides.
Float16 and bfloat16 inputs: the real-input transforms refuse them with
JAX's ``ValueError``, the others take them as float32, as JAX does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import signal as jsignal
from paddle_tpu.ops.impl import fft_ops as jf
from paddle_tpu_torch import fft as pfft
from paddle_tpu_torch import ops
from paddle_tpu_torch import signal


def _x(shape=(4, 16), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cx(shape=(4, 16), seed=0):
    return (_x(shape, seed) + 1j * _x(shape, seed + 100)).astype(
        np.complex64)


def _close(port, ref, rel=1e-5):
    ref = np.asarray(ref)
    got = port.detach().resolve_conj().numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    scale = max(float(np.max(np.abs(ref))), 1e-30) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * scale)


# (op, input kind, kwargs): n / s pad and truncate, axes, the norms
CASES_1D = [
    (op, kind, kw)
    for op, kind in (("fft", "c"), ("ifft", "c"), ("rfft", "r"),
                     ("irfft", "c"), ("hfft", "c"), ("ihfft", "r"),
                     ("fft", "r"))
    for kw in (dict(), dict(n=24), dict(n=9, axis=0),
               dict(norm="ortho"), dict(norm="forward", axis=0))
]


@pytest.mark.parametrize("op,kind,kw", CASES_1D,
                         ids=[f"{o}-{k}-{i}" for i, (o, k, _)
                              in enumerate(CASES_1D)])
def test_1d_transforms_match_jax(op, kind, kw):
    x = _cx((10, 16)) if kind == "c" else _x((10, 16))
    _close(getattr(ops, op)(torch.from_numpy(x), **kw),
           getattr(jf, op)(jnp.asarray(x), **kw))


CASES_ND = [
    (op, kind, kw)
    for op, kind in (("fft2", "c"), ("ifft2", "c"), ("rfft2", "r"),
                     ("irfft2", "c"), ("fftn", "c"), ("ifftn", "c"),
                     ("rfftn", "r"), ("irfftn", "c"))
    for kw in (dict(), dict(s=(6, 10)), dict(axes=(0, 2)),
               dict(norm="ortho", s=(3, 12), axes=(1, 2)))
]


@pytest.mark.parametrize("op,kind,kw", CASES_ND,
                         ids=[f"{o}-{i}" for i, (o, _, _)
                              in enumerate(CASES_ND)])
def test_nd_transforms_match_jax(op, kind, kw):
    x = _cx((3, 8, 12)) if kind == "c" else _x((3, 8, 12))
    _close(getattr(ops, op)(torch.from_numpy(x), **kw),
           getattr(jf, op)(jnp.asarray(x), **kw))


def test_fftn_over_all_axes_and_float64():
    x = _x((2, 4, 6))
    _close(ops.fftn(torch.from_numpy(x)), jf.fftn(jnp.asarray(x)))
    got = ops.rfft(torch.from_numpy(x.astype(np.float64)))
    assert got.dtype == torch.complex128      # JAX, x64 off: complex64
    _close(got.to(torch.complex64), jf.rfft(jnp.asarray(x)))


def test_fft_namespace_is_the_ops():
    for name in pfft.__all__:
        assert getattr(pfft, name) is getattr(ops, name)
    assert pfft.__all__ == paddle_tpu.fft.__all__


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_16bit_inputs_as_jax(dtype):
    x = _x((4, 16))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = paddle_tpu.to_tensor(x).astype(dtype)
    for op in ("rfft", "ihfft", "rfft2", "rfftn"):
        with pytest.raises(ValueError, match="float32 or float64") as mine:
            getattr(ops, op)(tx)
        with pytest.raises(ValueError) as theirs:
            getattr(paddle_tpu.ops, op)(jx)
        assert str(mine.value) == str(theirs.value)
    for op in ("fft", "ifft", "fft2", "fftn", "hfft", "irfft"):
        got = getattr(ops, op)(tx)
        want = getattr(paddle_tpu.ops, op)(jx).numpy()
        _close(got, want, rel=1e-5)


def test_bad_norm_is_a_value_error():
    x = _x((8,))
    for op in ("fft", "rfft", "irfft", "fft2", "rfftn"):
        with pytest.raises(ValueError, match="norm"):
            getattr(ops, op)(torch.from_numpy(x).reshape(2, 4), norm="bogus")
        with pytest.raises(ValueError, match="norm"):
            getattr(jf, op)(jnp.asarray(x).reshape(2, 4), norm="bogus")


def test_shift_and_freq_match_jax():
    x = _x((5, 9))
    for kw in (dict(), dict(axes=[1]), dict(axes=[0, 1])):
        _close(ops.fftshift(torch.from_numpy(x), **kw),
               jf.fftshift(jnp.asarray(x), **kw))
        _close(ops.ifftshift(torch.from_numpy(x), **kw),
               jf.ifftshift(jnp.asarray(x), **kw))
    for n, d in ((8, 1.0), (9, 0.5), (400, 1 / 16000)):
        _close(ops.fftfreq(n, d, device="cpu"), jf.fftfreq(n=n, d=d),
               rel=1e-6)
        _close(ops.rfftfreq(n, d, device="cpu"), jf.rfftfreq(n=n, d=d),
               rel=1e-6)
    assert pfft.fftfreq(8, dtype="float64", device="cpu").dtype == \
        torch.float64


def test_gradients_of_real_compositions_match_jax_tape():
    x, w = _x((16,)), _x((16,), 1)

    t = torch.from_numpy(x).requires_grad_()
    (ops.irfft(ops.rfft(t), n=16) * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jf.irfft(jf.rfft(a), n=16) * w))(
        jnp.asarray(x))
    _close(t.grad, want, rel=1e-4)

    x[4:12] = 0.0                         # a silent stretch
    t = torch.from_numpy(x).requires_grad_()
    c = ops.rfft(t, norm="ortho")
    ops.real(c * ops.conj(c)).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jnp.real(
        jf.rfft(a, norm="ortho") * jnp.conj(jf.rfft(a, norm="ortho")))))(
        jnp.asarray(x))
    assert torch.isfinite(t.grad).all()
    _close(t.grad, want, rel=1e-4)

    # |fft|^2 through abs over an all-zero signal: finite, as JAX's
    z = np.zeros(16, np.float32)
    t = torch.from_numpy(z).requires_grad_()
    (ops.abs(ops.fft(t)) ** 2).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jnp.abs(jf.fft(a)) ** 2))(
        jnp.asarray(z))
    assert torch.isfinite(t.grad).all()
    _close(t.grad, want)


# ---- frame / overlap_add ---------------------------------------------------
FRAME = [((40,), -1), ((40,), 0), ((3, 40), -1), ((3, 40), 1),
         ((40, 3), 0), ((2, 40, 3), 1), ((2, 40, 3), -2)]


@pytest.mark.parametrize("shape,axis", FRAME,
                         ids=[f"{len(s)}d-axis{a}" for s, a in FRAME])
def test_ops_frame_matches_jax(shape, axis):
    x = _x(shape)
    got = ops.frame(torch.from_numpy(x), 8, 3, axis=axis)
    want = jf.frame(jnp.asarray(x), frame_length=8, hop_length=3, axis=axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hop", [1, 3, 8, 11])
def test_ops_overlap_add_matches_jax(hop):
    x = _x((2, 3, 8, 5))
    _close(ops.overlap_add(torch.from_numpy(x), hop),
           jf.overlap_add(jnp.asarray(x), hop_length=hop), rel=1e-6)
    z = _cx((8, 5))
    _close(ops.overlap_add(torch.from_numpy(z), hop),
           jf.overlap_add(jnp.asarray(z), hop_length=hop), rel=1e-6)
    with pytest.raises(NotImplementedError):
        ops.overlap_add(torch.from_numpy(x), hop, axis=0)


@pytest.mark.parametrize("axis", [0, -1])
def test_signal_frame_and_overlap_add_match_jax(axis):
    x = _x((50, 3)) if axis == 0 else _x((3, 50))
    got = signal.frame(torch.from_numpy(x), 10, 4, axis=axis)
    want = jsignal.frame(paddle_tpu.to_tensor(x), 10, 4, axis=axis).numpy()
    np.testing.assert_array_equal(got.numpy(), want)
    _close(signal.overlap_add(got, 4, axis=axis),
           jsignal.overlap_add(paddle_tpu.to_tensor(want), 4,
                               axis=axis).numpy(), rel=1e-6)
    with pytest.raises(ValueError):
        signal.frame(torch.from_numpy(x), 10, 4, axis=1)
    with pytest.raises(ValueError):
        signal.frame(torch.from_numpy(x[:, :5] if axis else x[:5].T), 10, 4)


def test_overlap_add_twice_is_bit_identical():
    x = torch.from_numpy(_x((4, 400, 60)))
    assert torch.equal(ops.overlap_add(x, 160), ops.overlap_add(x, 160))


# ---- stft / istft ----------------------------------------------------------
def _hann(n):
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(
        np.float32)


STFT = {
    "default": dict(n_fft=64),
    "hann_hop": dict(n_fft=64, hop_length=16, window=64),
    "win_lt_nfft": dict(n_fft=64, hop_length=12, win_length=48, window=48),
    "no_center": dict(n_fft=64, hop_length=16, center=False, window=64),
    "two_sided": dict(n_fft=32, hop_length=8, onesided=False, window=32),
    "normalized": dict(n_fft=64, hop_length=16, normalized=True, window=64),
    "constant_pad": dict(n_fft=64, hop_length=16, pad_mode="constant",
                         window=64),
    "whisper": dict(n_fft=400, hop_length=160, window=400),
}


def _kw(case, make):
    kw = dict(STFT[case])
    if "window" in kw:
        kw["window"] = make(_hann(kw["window"]))
    return kw


@pytest.mark.parametrize("case", sorted(STFT))
@pytest.mark.parametrize("batch", [True, False])
def test_stft_matches_jax(case, batch):
    x = _x((2, 1200) if batch else (1200,), 5)
    got = signal.stft(torch.from_numpy(x), **_kw(case, torch.from_numpy))
    want = jsignal.stft(paddle_tpu.to_tensor(x),
                        **_kw(case, paddle_tpu.to_tensor)).numpy()
    _close(got, want)


ISTFT = {
    "default": (dict(n_fft=64, hop_length=16, window=64), {}),
    "win_lt_nfft": (dict(n_fft=64, hop_length=12, win_length=48,
                         window=48), {}),
    "no_center": (dict(n_fft=64, hop_length=16, center=False, window=64),
                  {}),
    "normalized": (dict(n_fft=64, hop_length=16, normalized=True,
                        window=64), {}),
    "two_sided": (dict(n_fft=32, hop_length=8, onesided=False, window=32),
                  {}),
    "two_sided_complex": (dict(n_fft=32, hop_length=8, onesided=False,
                               window=32), dict(return_complex=True)),
    "unaligned_length": (dict(n_fft=64, hop_length=16, window=64),
                         dict(length=1210)),
    "short_length": (dict(n_fft=64, hop_length=16, window=64),
                     dict(length=900)),
    "whisper": (dict(n_fft=400, hop_length=160, window=400), {}),
}


@pytest.mark.parametrize("case", sorted(ISTFT))
def test_istft_matches_jax(case):
    skw, ikw = ISTFT[case]
    x = _x((2, 1203), 6)
    kw_t = _kw_from(skw, torch.from_numpy)
    kw_j = _kw_from(skw, paddle_tpu.to_tensor)
    spec_t = signal.stft(torch.from_numpy(x), **kw_t)
    spec_j = jsignal.stft(paddle_tpu.to_tensor(x), **kw_j)
    kw_t.pop("pad_mode", None)
    kw_j.pop("pad_mode", None)
    got = signal.istft(spec_t, **kw_t, **ikw)
    want = jsignal.istft(spec_j, **kw_j, **ikw).numpy()
    _close(got, want)
    if skw.get("center", True) and "length" not in ikw:
        # the frames cover every sample but the unaligned tail
        n = got.shape[-1]
        np.testing.assert_allclose(
            np.real(got.numpy()), x[:, :n], atol=1e-5)


def _kw_from(skw, make):
    kw = dict(skw)
    kw["window"] = make(_hann(kw["window"]))
    return kw


def test_stft_gradient_through_a_silent_stretch_matches_jax_tape():
    x = _x((1, 600), 7)
    x[:, 200:400] = 0.0
    w = _hann(64)

    t = torch.from_numpy(x).requires_grad_()
    spec = signal.stft(t, 64, 16, window=torch.from_numpy(w))
    (ops.abs(spec) ** 2).sum().backward()
    jt = paddle_tpu.to_tensor(x)
    jt.stop_gradient = False
    jspec = jsignal.stft(jt, 64, 16, window=paddle_tpu.to_tensor(w))
    paddle_tpu.ops.sum(paddle_tpu.ops.abs(jspec) ** 2).backward()
    assert torch.isfinite(t.grad).all()
    _close(t.grad, jt.grad.numpy(), rel=1e-4)


def test_stft_refuses_a_window_of_another_length_and_a_short_signal():
    x = torch.from_numpy(_x((1, 100)))
    with pytest.raises(ValueError, match="win_length"):
        signal.stft(x, 64, window=torch.ones(32))
    with pytest.raises(ValueError, match="frame_length"):
        signal.stft(x[:, :20], 64, center=False)
