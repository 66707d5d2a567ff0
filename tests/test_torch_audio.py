"""paddle_tpu_torch.audio against the JAX package's ``audio``, on the CPU:
the windows, the mel scales and filterbanks, decibels, the DCT, the
feature layers' buffers, outputs and gradients, and the WAV backend.

The same numpy inputs (fixed seeds) go through both. Windows within 1e-7
(both compute them in float64 numpy; JAX hands back float32, the port the
dtype asked for, float64 by default); mel frequencies within 1e-6
relative, filterbanks within 1e-5 of their largest weight, the DCT
exactly; the features within 1e-5 of their largest
value (spectrograms), 1e-4 dB plus 1e-5 relative (log-mel: 10 log10 of
a 1e-5 relative gap is 4e-5 dB, and the quiet bins, 50 dB under the
peak, carry the FFT's error relative to the peak) and 1e-4 relative for
MFCC's and its
waveform gradient through a silent stretch (the log of a clipped floor).
WAV files written by either package read back bit-equal in the other.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import audio as jaudio
from paddle_tpu_torch import audio

WINDOWS = ["hann", "hamming", "blackman", "nuttall", "bartlett", "triang",
           "cosine", "gaussian", "kaiser", "exponential", "bohman", "tukey",
           ("gaussian", 3.0), ("kaiser", 6.0), ("exponential", None, 4.0),
           ("tukey", 0.0), ("tukey", 1.0), ("tukey", 0.25)]


@pytest.mark.parametrize("fftbins", [True, False])
@pytest.mark.parametrize("window", WINDOWS, ids=str)
def test_windows_match_jax(window, fftbins):
    for n in (1, 16, 25):
        got = audio.functional.get_window(window, n, fftbins=fftbins)
        want = jaudio.functional.get_window(window, n,
                                            fftbins=fftbins).numpy()
        assert got.dtype == torch.float64 and want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    f32 = audio.functional.get_window(window, 16, fftbins, dtype="float32")
    assert f32.dtype == torch.float32


def test_unknown_window_is_a_value_error():
    with pytest.raises(ValueError, match="unknown window"):
        audio.functional.get_window("boxcar", 8)
    with pytest.raises(ValueError, match="unknown window"):
        jaudio.functional.get_window("boxcar", 8)


@pytest.mark.parametrize("htk", [False, True])
def test_mel_scales_match_jax(htk):
    F, J = audio.functional, jaudio.functional
    for f in (0.0, 300.0, 1000.0, 4321.0, 8000.0):
        assert F.hz_to_mel(f, htk) == pytest.approx(J.hz_to_mel(f, htk),
                                                    rel=1e-12)
        m = F.hz_to_mel(f, htk)
        assert F.mel_to_hz(m, htk) == pytest.approx(J.mel_to_hz(m, htk),
                                                    rel=1e-12)
    hz = np.linspace(0, 8000, 33).astype(np.float32)
    got = F.hz_to_mel(torch.from_numpy(hz), htk)
    want = J.hz_to_mel(paddle_tpu.to_tensor(hz), htk).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        F.mel_to_hz(got, htk).numpy(),
        J.mel_to_hz(paddle_tpu.to_tensor(want), htk).numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        F.mel_frequencies(40, 20.0, 7600.0, htk).numpy(),
        J.mel_frequencies(40, 20.0, 7600.0, htk).numpy(), rtol=1e-6)
    np.testing.assert_allclose(F.fft_frequencies(16000, 400).numpy(),
                               J.fft_frequencies(16000, 400).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("sr,n_fft,n_mels,f_min,f_max,htk,norm", [
    (16000, 400, 80, 0.0, 8000.0, False, "slaney"),
    (22050, 512, 64, 50.0, None, False, "slaney"),
    (16000, 256, 40, 20.0, 7000.0, True, None),
])
def test_fbank_matrix_matches_jax(sr, n_fft, n_mels, f_min, f_max, htk,
                                  norm):
    got = audio.functional.compute_fbank_matrix(sr, n_fft, n_mels, f_min,
                                                f_max, htk, norm)
    want = jaudio.functional.compute_fbank_matrix(
        sr, n_fft, n_mels, f_min, f_max, htk, norm).numpy()
    assert got.shape == (n_mels, 1 + n_fft // 2)
    # the mel points come from linspaces that differ in the last bit
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kw", [dict(), dict(top_db=None),
                                dict(ref_value=2.0, amin=1e-5, top_db=40.0)])
def test_power_to_db_matches_jax(kw):
    s = np.random.default_rng(0).exponential(1.0, (2, 8, 30)).astype(
        np.float32) ** 6
    got = audio.functional.power_to_db(torch.from_numpy(s), **kw)
    want = jaudio.functional.power_to_db(paddle_tpu.to_tensor(s), **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    with pytest.raises(ValueError):
        audio.functional.power_to_db(torch.from_numpy(s), top_db=-1.0)


@pytest.mark.parametrize("norm", ["ortho", None])
def test_dct_matches_jax(norm):
    got = audio.functional.create_dct(13, 40, norm)
    want = jaudio.functional.create_dct(13, 40, norm).numpy()
    np.testing.assert_array_equal(got.numpy(), want)


def _wave(batch=2, n=4000, seed=0, silent=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (200 + 1500 * t) * t)[None]
         + 0.05 * rng.standard_normal((batch, n))).astype(np.float32)
    if silent:
        x[:, silent[0]:silent[1]] = 0.0
    return x


LAYERS = {
    "spectrogram": ("Spectrogram", dict(n_fft=256, hop_length=64)),
    "magnitude": ("Spectrogram", dict(n_fft=256, win_length=200,
                                      power=1.0, window="hamming")),
    "mel": ("MelSpectrogram", dict(sr=16000, n_fft=400, hop_length=160,
                                   n_mels=80, f_min=0.0, f_max=8000.0)),
    "mel_htk": ("MelSpectrogram", dict(sr=16000, n_fft=256, n_mels=40,
                                       htk=True, norm=None)),
    "logmel": ("LogMelSpectrogram", dict(sr=16000, n_fft=400,
                                         hop_length=160, n_mels=80,
                                         f_min=0.0, f_max=8000.0,
                                         top_db=80.0)),
    "mfcc": ("MFCC", dict(sr=16000, n_mfcc=40, n_fft=400, hop_length=160,
                          n_mels=80, f_min=0.0, f_max=8000.0)),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_feature_layers_match_jax(case):
    name, kw = LAYERS[case]
    layer = getattr(audio.features, name)(**kw)
    ref = getattr(jaudio.features, name)(**kw)
    for buf in ("fft_window", "fbank_matrix", "dct_matrix"):
        mine = [b for n, b in layer.named_buffers() if n.endswith(buf)]
        theirs = [getattr(m, buf) for m in _sublayers(ref)
                  if buf in getattr(m, "_buffers", {})]
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5 * np.abs(b.numpy()).max())
    x = _wave()
    got = layer(torch.from_numpy(x)).numpy()
    want = ref(paddle_tpu.to_tensor(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if name == "LogMelSpectrogram":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def _sublayers(layer):
    out = [layer]
    for sub in getattr(layer, "_sub_layers", {}).values():
        out += _sublayers(sub)
    return out


def test_spectrogram_hop_defaults_to_a_quarter_of_the_window():
    assert audio.features.Spectrogram(n_fft=512, win_length=200) \
        .hop_length == 50
    assert jaudio.features.Spectrogram(n_fft=512, win_length=200) \
        .hop_length == 50
    with pytest.raises(ValueError, match="n_mfcc"):
        audio.features.MFCC(n_mfcc=70, n_mels=64)


def test_float64_layer_and_move():
    layer = audio.features.MelSpectrogram(sr=16000, n_fft=256, n_mels=32,
                                          dtype="float64")
    assert {b.dtype for b in layer.buffers()} == {torch.float64}
    x = torch.from_numpy(_wave()).double()
    out64 = layer(x)
    assert out64.dtype == torch.float64
    out32 = audio.features.MelSpectrogram(sr=16000, n_fft=256, n_mels=32)(
        x.float())
    np.testing.assert_allclose(out32.numpy(), out64.numpy(), rtol=1e-4,
                               atol=1e-5 * float(out64.abs().max()))
    moved = layer.to(torch.float32)
    assert {b.dtype for b in moved.buffers()} == {torch.float32}


def test_mfcc_gradient_through_a_silent_stretch_matches_jax_tape():
    kw = dict(sr=16000, n_mfcc=13, n_fft=256, hop_length=64, n_mels=40,
              top_db=80.0)
    x = _wave(1, 3000, 3, silent=(1000, 2200))
    w = np.random.default_rng(4).standard_normal(
        (1, 13, 3000 // 64 + 1)).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_()
    (audio.features.MFCC(**kw)(t) * torch.from_numpy(w)).sum().backward()
    jt = paddle_tpu.to_tensor(x)
    jt.stop_gradient = False
    out = jaudio.features.MFCC(**kw)(jt)
    paddle_tpu.ops.sum(out * paddle_tpu.to_tensor(w)).backward()
    want = jt.grad.numpy()
    assert torch.isfinite(t.grad).all() and np.isfinite(want).all()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


# ---- the WAV backend -------------------------------------------------------
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_files_cross_read_bit_equal(tmp_path, channels):
    x = np.clip(_wave(channels, 3000, 5), -1, 1)
    mine, theirs = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    audio.save(mine, torch.from_numpy(x), 16000)
    jaudio.save(theirs, paddle_tpu.to_tensor(x), 16000)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got, sr = audio.load(theirs)
    want, jsr = jaudio.load(mine)
    assert sr == jsr == 16000 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    part, _ = audio.load(mine, frame_offset=100, num_frames=500,
                         normalize=False, channels_first=False)
    jpart, _ = jaudio.load(mine, frame_offset=100, num_frames=500,
                           normalize=False, channels_first=False)
    np.testing.assert_array_equal(part.numpy(), jpart.numpy())
    a, b = audio.info(mine), jaudio.info(mine)
    assert (a.sample_rate, a.num_samples, a.num_channels,
            a.bits_per_sample) == (b.sample_rate, b.num_samples,
                                   b.num_channels, b.bits_per_sample)


def test_backend_registry():
    b = audio.backends
    assert b.list_available_backends() == ["wave_backend"]
    assert b.get_current_backend() == "wave_backend"
    b.set_backend("wave_backend")
    with pytest.raises(NotImplementedError):
        b.set_backend("soundfile")
    with pytest.raises(NotImplementedError):
        audio.save("unused.wav", torch.zeros(1, 4), 16000,
                   bits_per_sample=24)
