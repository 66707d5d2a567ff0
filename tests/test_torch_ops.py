"""paddle_tpu_torch ops against the JAX package's functions of the same name.

The same numpy inputs (fixed seeds) go through the JAX function and its
PyTorch counterpart on the CPU; f32 tolerance atol 1e-5, rtol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.generation import warp_logits as jax_warp_logits
from paddle_tpu.ops.impl.activation import swiglu as jax_swiglu
from paddle_tpu.ops.impl.fused_ops import rope_qk as jax_rope_qk
from paddle_tpu.ops.impl.nn_ops import rms_norm as jax_rms_norm
from paddle_tpu.ops.impl.nn_ops import (
    scaled_dot_product_attention as jax_sdpa,
)
from paddle_tpu_torch.generation import warp_logits
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.ops import (
    rms_norm,
    rope_qk,
    scaled_dot_product_attention,
    swiglu,
)

TOL = dict(atol=1e-5, rtol=1e-4)


def _close(port, ref, **tol):
    np.testing.assert_allclose(
        port.detach().numpy(), np.asarray(ref), **(tol or TOL)
    )


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 16)])
def test_rms_norm(shape, eps):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)
    _close(rms_norm(torch.from_numpy(x), torch.from_numpy(w), epsilon=eps),
           jax_rms_norm(jnp.asarray(x), jnp.asarray(w), epsilon=eps))
    _close(rms_norm(torch.from_numpy(x), epsilon=eps),
           jax_rms_norm(jnp.asarray(x), epsilon=eps))


@pytest.mark.parametrize("offset", [None, 0, 7])
def test_rope_qk(offset):
    rng = np.random.RandomState(1)
    q = rng.randn(2, 6, 4, 16).astype(np.float32)
    k = rng.randn(2, 6, 2, 16).astype(np.float32)
    if offset is None:
        pos_np = None
    else:
        # per-row positions, as serving decode passes them
        pos_np = (offset + np.arange(6)[None, :]
                  + np.array([[0], [3]])).astype(np.int32)
    qp, kp = rope_qk(
        torch.from_numpy(q), torch.from_numpy(k),
        None if pos_np is None else torch.from_numpy(pos_np),
        base=500000.0 if offset == 7 else 10000.0,
    )
    qj, kj = jax_rope_qk(
        jnp.asarray(q), jnp.asarray(k),
        None if pos_np is None else jnp.asarray(pos_np),
        base=500000.0 if offset == 7 else 10000.0,
    )
    _close(qp, qj)
    _close(kp, kj)


def test_rope_qk_1d_positions():
    rng = np.random.RandomState(2)
    q = rng.randn(1, 3, 2, 8).astype(np.float32)
    pos = np.array([5, 6, 7], np.int32)
    qp, kp = rope_qk(torch.from_numpy(q), torch.from_numpy(q),
                     torch.from_numpy(pos))
    qj, kj = jax_rope_qk(jnp.asarray(q), jnp.asarray(q), jnp.asarray(pos))
    _close(qp, qj)
    _close(kp, kj)


@pytest.mark.parametrize("shape", [(4, 32), (2, 3, 128)])
def test_swiglu(shape):
    rng = np.random.RandomState(3)
    x = (3 * rng.randn(*shape)).astype(np.float32)
    y = rng.randn(*shape).astype(np.float32)
    _close(swiglu(torch.from_numpy(x), torch.from_numpy(y)),
           jax_swiglu(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize(
    "sq,sk,causal",
    [(8, 8, True), (3, 10, True), (8, 8, False), (5, 12, False)],
    ids=["causal_square", "causal_bottom_right", "full", "full_rect"],
)
def test_sdpa_math(sq, sk, causal):
    rng = np.random.RandomState(4)
    q = rng.randn(2, sq, 4, 16).astype(np.float32)
    k = rng.randn(2, sk, 4, 16).astype(np.float32)
    v = rng.randn(2, sk, 4, 16).astype(np.float32)
    reset_launch_counts()
    port = scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=causal,
    )
    ref = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   is_causal=causal)
    _close(port, ref)
    # CPU tensors never reach the flash kernel
    assert launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("mask_kind", ["bool", "additive"])
def test_sdpa_mask(mask_kind):
    rng = np.random.RandomState(5)
    q = rng.randn(1, 4, 2, 8).astype(np.float32)
    k = rng.randn(1, 9, 2, 8).astype(np.float32)
    v = rng.randn(1, 9, 2, 8).astype(np.float32)
    # the generate() cached-branch keep mask: key j visible to query i
    # when j <= position + i
    keep = (np.arange(9)[None, :] <= (3 + np.arange(4))[:, None])[None, None]
    mask = keep if mask_kind == "bool" else np.where(
        keep, 0.0, -1e30
    ).astype(np.float32)
    port = scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask),
    )
    ref = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(mask))
    _close(port, ref)


def test_sdpa_gqa_math_repeats_kv():
    rng = np.random.RandomState(6)
    q = rng.randn(1, 5, 4, 8).astype(np.float32)
    k = rng.randn(1, 5, 2, 8).astype(np.float32)
    v = rng.randn(1, 5, 2, 8).astype(np.float32)
    port = scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=True,
    )
    ref = jax_sdpa(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=2),
                   jnp.repeat(jnp.asarray(v), 2, axis=2), is_causal=True)
    _close(port, ref)


@pytest.mark.parametrize(
    "temperature,top_k,top_p",
    [(1.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.6),
     (1.3, 12, 0.8)],
    ids=["noop", "temperature", "top_k", "top_p", "all"],
)
def test_warp_logits_scalar(temperature, top_k, top_p):
    rng = np.random.RandomState(7)
    logits = rng.randn(3, 40).astype(np.float32)
    _close(warp_logits(torch.from_numpy(logits), temperature, top_k, top_p),
           jax_warp_logits(jnp.asarray(logits), temperature, top_k, top_p))


def test_warp_logits_top_k_ties():
    # tokens tied with the k-th largest logit are all kept
    logits = np.array([[3.0, 1.0, 2.0, 2.0, 2.0, 0.5]], np.float32)
    port = warp_logits(torch.from_numpy(logits), 1.0, 2, 1.0)
    _close(port, jax_warp_logits(jnp.asarray(logits), 1.0, 2, 1.0))
    assert int((port > -1e29).sum()) == 4


def test_warp_logits_per_row():
    rng = np.random.RandomState(8)
    logits = rng.randn(4, 32).astype(np.float32)
    t = np.array([0.7, 1.0, 1.3, 0.9], np.float32)
    k = np.array([5, 0, 12, 3], np.int32)
    p = np.array([0.8, 1.0, 0.5, 0.95], np.float32)
    port = warp_logits(torch.from_numpy(logits), torch.from_numpy(t),
                       torch.from_numpy(k), torch.from_numpy(p))
    _close(port, jax_warp_logits(jnp.asarray(logits), jnp.asarray(t),
                                 jnp.asarray(k), jnp.asarray(p)))
