"""The port's Llama against the JAX package's, on converted weights.

The JAX ``LlamaForCausalLM`` (``tiny()``, its GQA variant and a tied-
embedding variant) is built from a seed; its ``state_dict`` goes through
numpy into the port with ``load_reference_state``. Logits must match
within the f32 tolerance (atol 1e-5, rtol 1e-4) and greedy ``generate``
tokens must be identical.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)

TOL = dict(atol=1e-5, rtol=1e-4)
VARIANTS = {
    "mha": {},
    "gqa": {"num_key_value_heads": 2},
    "tied": {"tie_word_embeddings": True},
}


def _pair(variant, seed=0):
    over = VARIANTS[variant]
    paddle.seed(seed)
    jax_model = JaxLlama(JaxLlamaConfig.tiny(**over))
    state = {k: v.numpy() for k, v in jax_model.state_dict().items()}
    port = LlamaForCausalLM(LlamaConfig.tiny(**over), device="cpu")
    load_reference_state(port, state)
    return jax_model, port


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    return _pair(request.param)


def test_converted_weights_are_transposed_projections(pair):
    jax_model, port = pair
    state = jax_model.state_dict()
    wq = state["llama.layers.0.self_attn.q_proj.weight"].numpy()
    np.testing.assert_array_equal(
        port.llama.layers[0].self_attn.q_proj.weight.detach().numpy(), wq.T
    )
    np.testing.assert_array_equal(
        port.llama.embed_tokens.weight.detach().numpy(),
        state["llama.embed_tokens.weight"].numpy(),
    )


def test_logits_match(pair):
    jax_model, port = pair
    ids = np.random.RandomState(0).randint(1, 128, (2, 11)).astype("int64")
    ref = jax_model(paddle.to_tensor(ids)).numpy()
    reset_launch_counts()
    with torch.no_grad():
        out = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert launch_counts()["flash_attention"] == 0   # CPU: math form


def test_cached_forward_matches_full_forward(pair):
    # the generate() path: prefill through the cache, then one token
    _, port = pair
    ids = torch.from_numpy(
        np.random.RandomState(1).randint(1, 128, (2, 9)).astype("int64")
    )
    with torch.no_grad():
        full = port(ids)
        caches = port.init_kv_cache(2, 12)
        pre, caches = port(ids[:, :8], caches=caches, position=0)
        step, _ = port(ids[:, 8:], caches=caches, position=8)
    np.testing.assert_allclose(pre.numpy(), full[:, :8].numpy(), **TOL)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 8].numpy(), **TOL)


@pytest.mark.parametrize("prompt_len,max_new", [(5, 6), (9, 4)])
def test_greedy_generate_identical(pair, prompt_len, max_new):
    jax_model, port = pair
    ids = np.random.RandomState(prompt_len).randint(
        1, 128, (2, prompt_len)
    ).astype("int64")
    ref = jax_model.generate(paddle.to_tensor(ids),
                             max_new_tokens=max_new).numpy()
    out = port.generate(torch.from_numpy(ids), max_new_tokens=max_new)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generate_eos_padding_matches():
    jax_model, port = _pair("mha")
    ids = np.random.RandomState(3).randint(1, 128, (2, 4)).astype("int64")
    free = port.generate(torch.from_numpy(ids), max_new_tokens=6)
    eos = int(free[0, 5])   # row 0 stops at its second new token
    ref = jax_model.generate(paddle.to_tensor(ids), max_new_tokens=6,
                             eos_token_id=eos, pad_token_id=0).numpy()
    out = port.generate(torch.from_numpy(ids), max_new_tokens=6,
                        eos_token_id=eos, pad_token_id=0)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_load_reference_state_rejects_mismatch():
    jax_model, _ = _pair("mha")
    state = {k: v.numpy() for k, v in jax_model.state_dict().items()}
    port = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2),
                            device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_reference_state(port, state)
    state.pop("lm_head.weight")
    with pytest.raises(KeyError, match="lm_head"):
        load_reference_state(
            LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), state
        )


def test_moe_config_not_ported():
    # the MoE model is ported (tests/test_torch_moe.py); what the JAX
    # package does not serve, the port does not either: its serving
    # adapter refuses MoE
    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.serving import Engine

    model = LlamaForCausalLM(LlamaConfig.tiny(num_experts=4), device="cpu")
    assert isinstance(model.llama.layers[0].mlp, MoELayer)
    assert model.llama.layers[0].mlp.impl == "dense"
    with pytest.raises(NotImplementedError, match="MoE"):
        Engine(model)


def test_seeded_init_is_deterministic():
    a = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=3)
    b = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=3)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=na)
    w = a.llama.layers[0].mlp.gate_proj.weight
    assert abs(w.std().item() - (2.0 / (64 + 128)) ** 0.5) < 0.02
