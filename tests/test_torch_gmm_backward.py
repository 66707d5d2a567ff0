"""The ragged grouped GEMM's backward in the port against the JAX package,
on the CPU.

* ``dlhs`` on the transposed instance: ``_forward(g, rhs, gs,
  trans_rhs=True)`` (on CPU tensors its plain version,
  ``grouped_matmul_ref`` on the view ``rhs.transpose(1, 2)``; the CUDA
  kernels are held to it on the card by ``chip_smoke.py``) against JAX's
  ``grouped_matmul_xla(g, jnp.swapaxes(rhs, 1, 2), gs)`` over empty,
  1-row and tile-unaligned groups: f32 within rtol 1e-5 (atol 1e-5: sums
  of 40 products in another order), bf16 within rtol 1e-2 (atol 1e-2:
  both round the f32 sum to bf16, at most an ulp apart).
* ``GroupedMatmulFunction``'s whole VJP (``dlhs`` and ``drhs``) against
  ``jax.vjp`` of ``grouped_matmul_xla``, f32, the same tolerance; its
  backward hands ``rhs`` itself to the transposed entry (no copy).
* The wrappers' choices, made before any launch: ``_wgrad_variant``
  around its crossover, the transposed instance's variant, and the
  refusals (int8 with ``trans_rhs``, an unknown ``variant``) by name.
* The C launch functions' parameters against the ``ctypes`` types the
  wrapper declares.
"""
import ctypes
import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas import grouped_matmul as jgmm
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import grouped_matmul as gmm
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)

GROUPS = {
    "empty_and_one_row": [0, 1, 5, 0, 9, 1],
    "one_row_each": [1, 1, 1, 29],
    "unaligned": [37, 0, 50, 13],
    "all_empty": [0, 0, 0],
}


def _inputs(gs, k, m, seed):
    rng = np.random.RandomState(seed)
    n = int(np.sum(gs))
    g = rng.randn(n, m).astype(np.float32)
    rhs = (rng.randn(len(gs), k, m) / np.sqrt(m)).astype(np.float32)
    return g, rhs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GROUPS))
def test_transposed_plain_route_matches_jax(case, dtype):
    gs = np.array(GROUPS[case], np.int32)
    k, m = 24, 40
    g, rhs = _inputs(gs, k, m, 5)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jgmm.grouped_matmul_xla(
        jnp.asarray(g, jdt), jnp.swapaxes(jnp.asarray(rhs, jdt), 1, 2),
        jnp.asarray(gs)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    reset_launch_counts()
    got = gmm._forward(torch.from_numpy(g).to(tdt),
                       torch.from_numpy(rhs).to(tdt), torch.from_numpy(gs),
                       trans_rhs=True)
    assert set(launch_counts().values()) == {0}
    assert got.dtype == tdt and got.shape == (len(g), k)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))


@pytest.mark.parametrize("case", sorted(GROUPS))
def test_grouped_matmul_vjp_matches_jax(case):
    gs = np.array(GROUPS[case], np.int32)
    k, m = 24, 40
    rng = np.random.RandomState(6)
    n = int(gs.sum())
    lhs = rng.randn(n, k).astype(np.float32)
    rhs = (rng.randn(len(gs), k, m) / np.sqrt(k)).astype(np.float32)
    dout = rng.randn(n, m).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jgmm.grouped_matmul_xla(
        a, b, jnp.asarray(gs)), jnp.asarray(lhs), jnp.asarray(rhs))
    want_dlhs, want_drhs = (np.asarray(x) for x in vjp(jnp.asarray(dout)))
    tl = torch.tensor(lhs, requires_grad=True)
    tr = torch.tensor(rhs, requires_grad=True)
    gmm.grouped_matmul(tl, tr, torch.from_numpy(gs)).backward(
        torch.tensor(dout))
    np.testing.assert_allclose(tl.grad.numpy(), want_dlhs, **F32_TOL)
    np.testing.assert_allclose(tr.grad.numpy(), want_drhs, **F32_TOL)


def test_backward_passes_rhs_itself_to_the_transposed_entry():
    # dlhs reads the expert weights where they lie: the backward calls the
    # entry with rhs itself (its storage, shape and strides) and
    # trans_rhs=True, not with a transposed copy
    rng = np.random.RandomState(7)
    gs = torch.tensor([3, 0, 6], dtype=torch.int32)
    lhs = torch.tensor(rng.randn(9, 8).astype(np.float32),
                       requires_grad=True)
    rhs = torch.tensor(rng.randn(3, 8, 5).astype(np.float32),
                       requires_grad=True)
    calls = []
    real = gmm._forward

    def spy(a, b, sizes, rhs_scales=None, trans_rhs=False):
        calls.append((b.data_ptr(), tuple(b.shape), b.stride(), trans_rhs))
        return real(a, b, sizes, rhs_scales, trans_rhs=trans_rhs)

    gmm._forward = spy
    try:
        gmm.grouped_matmul(lhs, rhs, gs).sum().backward()
    finally:
        gmm._forward = real
    whole = (rhs.data_ptr(), (3, 8, 5), rhs.stride())
    assert calls == [(*whole, False), (*whole, True)]
    want = gmm.grouped_matmul_ref(torch.ones(9, 5), rhs.detach()
                                  .transpose(1, 2), gs)
    torch.testing.assert_close(lhs.grad, want)


@pytest.mark.parametrize("dtype, n, k, m, e, want", [
    (torch.float32, 16384, 1024, 2816, 8, "fma"),      # f32: always FMA
    (torch.float32, 32, 24, 40, 4, "fma"),
    (torch.bfloat16, 16384, 1024, 2816, 8, "wgmma"),   # the MoE bench shape
    (torch.float16, 16384, 2816, 1024, 8, "wgmma"),
    (torch.bfloat16, 512, 1024, 256, 8, "wgmma"),      # at the crossover
    (torch.bfloat16, 512, 1024, 248, 8, "mma"),        # below it
    (torch.bfloat16, 512, 256, 256, 8, "mma"),         # the forward's 2^25
    (torch.bfloat16, 32, 24, 40, 4, "mma"),            # the JAX sweep
    (torch.bfloat16, 0, 24, 40, 3, "mma"),             # no rows
    (torch.bfloat16, 16384, 1024, 2816, 160, "wgmma"),  # its work list fits
    (torch.bfloat16, 16384, 1024, 2816, 161, "mma"),    # too many groups
])
def test_wgrad_variant(dtype, n, k, m, e, want):
    assert gmm.WGRAD_WGMMA_MIN_MACS == 512 * 1024 * 256
    assert gmm._wgrad_variant(dtype, n, k, m, e) == want


@pytest.mark.parametrize("k, m, want", [
    (2816, 1024, "wgmma"),   # the up projection's dlhs (n 16384)
    (1024, 2816, "wgmma"),   # the down projection's
    (40, 24, "mma"),         # the JAX sweep's
])
def test_transposed_instance_takes_the_forward_crossover(k, m, want):
    # dlhs reduces over the forward's m and is as wide as its k: the same
    # multiply-adds, so the forward's chooser and crossover
    n = 16384 if want == "wgmma" else 32
    assert gmm._gmm_variant(torch.bfloat16, torch.bfloat16, n, k, m,
                            8) == want


def test_int8_rhs_refuses_trans_rhs_by_name():
    lhs = torch.ones(6, 8, dtype=torch.bfloat16)
    q = torch.ones(2, 8, 8, dtype=torch.int8)
    scales = torch.ones(2, 8)
    gs = torch.tensor([2, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="int8 rhs is inference-only and "
                                         "takes no trans_rhs"):
        gmm._forward(lhs, q, gs, scales, trans_rhs=True)
    with pytest.raises(ValueError, match="int8 rhs is inference-only and "
                                         "takes no trans_rhs"):
        gmm._launch(lhs, q, gs, scales, trans_rhs=True)


def test_an_unknown_variant_is_refused_by_name():
    # the choice is checked before anything reaches the device
    lhs = torch.ones(6, 8, dtype=torch.bfloat16)
    rhs = torch.ones(2, 8, 16, dtype=torch.bfloat16)
    gs = torch.tensor([2, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"grouped_matmul: variant "
                                         r"'wgmma_t' is not one of"):
        gmm._launch(lhs, rhs.transpose(1, 2), gs, None, variant="wgmma_t",
                    trans_rhs=True)
    with pytest.raises(ValueError, match=r"grouped_matmul_wgrad: variant "
                                         r"'tma' is not one of"):
        gmm._launch_wgrad(lhs, torch.ones(6, 16, dtype=torch.bfloat16), gs,
                          2, variant="tma")


def test_transposed_launch_checks_the_stored_shape():
    lhs = torch.ones(6, 8, dtype=torch.bfloat16)
    gs = torch.tensor([2, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"trans_rhs wants rhs \[e, m, 8\]"):
        gmm._launch(lhs, torch.ones(2, 8, 16, dtype=torch.bfloat16), gs,
                    None, trans_rhs=True)


def _c_params(source, fn):
    src = (_build.CSRC_DIR / f"{source}.cu").read_text()
    (sig,) = re.findall(rf"int {fn}\(([^)]*)\)", src)
    params = [" ".join(p.split()) for p in sig.split(",")]
    types = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    return [p.split()[-1].lstrip("*") for p in params], types


@pytest.mark.parametrize("source, fn, loader, tail", [
    ("grouped_matmul", "grouped_matmul_launch", "_kernel",
     ["lhs_dtype", "rhs_int8", "variant", "trans_rhs", "stream"]),
    ("grouped_matmul_bwd", "grouped_matmul_wgrad_launch", "_wgrad_kernel",
     ["dtype", "variant", "stream"]),
])
def test_launch_abi_matches_the_c_signature(monkeypatch, source, fn, loader,
                                            tail):
    names, want = _c_params(source, fn)
    assert names[-len(tail):] == tail
    lib = SimpleNamespace(**{fn: SimpleNamespace()})
    monkeypatch.setattr(gmm, "_lib", None)
    monkeypatch.setattr(gmm, "_wgrad_lib", None)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    assert getattr(gmm, loader)() is lib
    assert getattr(lib, fn).argtypes == want
    assert getattr(lib, fn).restype is ctypes.c_int


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_plain_step_covers_the_transposed_entry():
    # the card's comparison step swaps the entry for its plain version; it
    # must take trans_rhs too, or the backward would fail (or, on the
    # card, run the kernel it is meant to check)
    cs = _chip_smoke()
    rng = np.random.RandomState(8)
    gs = torch.tensor([4, 0, 5], dtype=torch.int32)
    lhs = torch.tensor(rng.randn(9, 8).astype(np.float32),
                       requires_grad=True)
    rhs = torch.tensor(rng.randn(3, 8, 16).astype(np.float32),
                       requires_grad=True)
    dout = torch.tensor(rng.randn(9, 16).astype(np.float32))
    gmm.grouped_matmul(lhs, rhs, gs).backward(dout)
    want = lhs.grad.clone(), rhs.grad.clone()
    lhs.grad = rhs.grad = None
    seen = []
    real = gmm.grouped_matmul_ref

    def spy(*args, **kwargs):
        seen.append(args[1].shape)
        return real(*args, **kwargs)

    with cs.plain_gmm_autograd(gmm):
        gmm.grouped_matmul_ref = spy
        try:
            gmm.grouped_matmul(lhs, rhs, gs).backward(dout)
        finally:
            gmm.grouped_matmul_ref = real
    assert seen == [(3, 8, 16), (3, 16, 8)]   # forward, then dlhs
    torch.testing.assert_close(lhs.grad, want[0])
    torch.testing.assert_close(rhs.grad, want[1])
    assert cs.MOE_LAYER_LAUNCHES == {"grouped_matmul/wgmma": 3,
                                     "grouped_matmul/wgmma_t": 3,
                                     "grouped_matmul_wgrad/wgmma": 3}
