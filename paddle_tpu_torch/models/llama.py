"""Llama-family decoder: RMSNorm + RoPE + GQA attention + SwiGLU, or a
Mixtral-style MoE feed-forward when ``num_experts > 0``.

Counterpart of ``paddle_tpu/models/llama.py``. Module names match the
JAX package (``llama.layers.0.self_attn.q_proj.weight`` ...), so a JAX
``state_dict`` maps onto this model key for key (``models.convert``).
Projections are ``torch.nn.Linear``: their weights are [out, in], the
transpose of the JAX package's [in, out] ``Linear``.

``LlamaForCausalLM.forward(input_ids, labels=None, attn_mask=None,
caches=None, position=None)`` keeps the JAX argument order and return
contract: the pretraining loss (shift by one, optionally through the
chunked fused head) as well as logits and the cached decode step.

``LlamaForCausalLM(config, device=None, seed=0)`` builds on the CUDA
device unless ``device`` names another one (``"cpu"`` for the tests),
and raises when there is no CUDA device and no device was named. Its
weights are drawn from a ``torch.Generator`` seeded with ``seed``, from
the same distributions the JAX package initialises with: embedding
N(0, 1), projections Xavier-normal, MoE gate and expert weights
Xavier-uniform, norms 1.

MoE (``num_experts > 0``): each decoder layer's MLP is an
``incubate.MoELayer`` with the default dense impl and ``k =
num_experts_per_tok``, as in the JAX package. The model sums the layers'
aux losses and the loss adds ``router_aux_loss_coef * aux`` (fused and
plain loss alike); the cached decode branch discards them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..distributed.recompute import recompute
from ..generation import GenerationMixin, KVCache
from ..incubate.moe import MoELayer, SwiGLUExperts, TopKGate
from ..ops.activation import swiglu
from ..ops.fused_ops import fused_linear_cross_entropy, rope_qk
from ..ops.nn_ops import (
    cross_entropy,
    rms_norm,
    scaled_dot_product_attention,
)

__all__ = [
    "LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
    "LlamaModel", "LlamaForCausalLM", "torch_dtype",
]

_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(dtype):
    """``"float32"``/``"bfloat16"``/``"float16"`` or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None


class LlamaConfig:
    def __init__(
        self,
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=11008,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=None,
        max_position_embeddings=4096,
        rms_norm_eps=1e-6,
        rope_theta=10000.0,
        tie_word_embeddings=False,
        dtype="float32",
        num_experts=0,
        num_experts_per_tok=2,
        router_aux_loss_coef=0.02,
        recompute=False,
        fused_loss_chunk=0,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.tie_word_embeddings = tie_word_embeddings
        self.dtype = dtype
        # > 0 makes each MLP a Mixtral-style MoE of num_experts experts,
        # num_experts_per_tok of them per token, and the loss adds
        # router_aux_loss_coef times the summed load-balancing loss
        self.num_experts = num_experts
        self.num_experts_per_tok = num_experts_per_tok
        self.router_aux_loss_coef = router_aux_loss_coef
        # recompute each decoder layer's activations in the backward
        self.recompute = recompute
        # > 0: the loss goes through the chunked fused LM head, and the
        # [b, s, vocab] logits are never built
        self.fused_loss_chunk = fused_loss_chunk

    @classmethod
    def tiny(cls, **overrides):
        """Test-scale config, the same as the JAX package's."""
        base = dict(
            vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=128,
        )
        base.update(overrides)
        return cls(**base)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype)
        )
        self.epsilon = epsilon

    def forward(self, x):
        return rms_norm(x, self.weight, epsilon=self.epsilon)


def _linear(n_in, n_out, device, dtype):
    return nn.Linear(n_in, n_out, bias=False, device=device, dtype=dtype)


class LlamaAttention(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.hidden_size = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.rope_theta = config.rope_theta
        h, hd = self.hidden_size, self.head_dim
        self.q_proj = _linear(h, self.num_heads * hd, device, dtype)
        self.k_proj = _linear(h, self.num_kv_heads * hd, device, dtype)
        self.v_proj = _linear(h, self.num_kv_heads * hd, device, dtype)
        self.o_proj = _linear(self.num_heads * hd, h, device, dtype)

    def forward(self, hidden, attn_mask=None, cache=None, position=None):
        """Causal attention; ``attn_mask`` (a bool keep-mask or an additive
        float mask, broadcast to [b, heads, s, keys]) composes with
        causality, and a masked call takes the math form.

        cache: KVCache ([b, max_len, kv_heads, d] k/v) with ``position``
        (an int) tokens already in it; the new k/v are written into the
        cache in place and attention runs over the whole buffer under a
        causal keep-mask on the absolute timeline. GQA k/v are repeated
        inside ``scaled_dot_product_attention``."""
        b, s = hidden.shape[0], hidden.shape[1]
        q = self.q_proj(hidden).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(hidden).view(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(hidden).view(b, s, self.num_kv_heads, self.head_dim)
        if cache is None:
            q, k = rope_qk(q, k, base=self.rope_theta)
            out = scaled_dot_product_attention(q, k, v, attn_mask,
                                               is_causal=True)
        else:
            steps = torch.arange(s, dtype=torch.int32, device=hidden.device)
            q, k = rope_qk(q, k, position + steps, base=self.rope_theta)
            cache.k[:, position:position + s] = k
            cache.v[:, position:position + s] = v
            k, v = cache.k, cache.v
            max_len = k.shape[1]
            keep = (
                torch.arange(max_len, device=hidden.device)[None, :]
                <= (position + steps)[:, None]
            )[None, None]                                # [1, 1, s, max_len]
            if attn_mask is not None:
                # compose with the caller's mask over the cache timeline
                if attn_mask.dtype == torch.bool:
                    keep = keep & attn_mask
                else:
                    keep = torch.where(
                        keep, attn_mask.float(),
                        torch.full_like(attn_mask.float(), -1e30),
                    )
            out = scaled_dot_product_attention(q, k, v, keep, is_causal=False)
        out = self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))
        return out if cache is None else (out, KVCache(cache.k, cache.v))


class LlamaMLP(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, i, device, dtype)
        self.up_proj = _linear(h, i, device, dtype)
        self.down_proj = _linear(i, h, device, dtype)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device, dtype)
        self.self_attn = LlamaAttention(config, device, dtype)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, eps, device, dtype
        )
        self._moe = config.num_experts > 0
        if self._moe:
            self.mlp = MoELayer(
                config.hidden_size, config.num_experts,
                d_ff=config.intermediate_size,
                k=config.num_experts_per_tok, device=device, dtype=dtype,
            )
        else:
            self.mlp = LlamaMLP(config, device, dtype)

    def forward(self, hidden, attn_mask=None, cache=None, position=None):
        """-> out, or (out, aux) for an MoE layer; with a cache, (out,
        new_cache) and the aux loss discarded."""
        residual = hidden
        hidden = self.input_layernorm(hidden)
        new_cache = None
        if cache is None:
            hidden = self.self_attn(hidden, attn_mask)
        else:
            hidden, new_cache = self.self_attn(
                hidden, attn_mask, cache, position
            )
        hidden = residual + hidden
        aux = None
        if self._moe:
            mlp_out, aux = self.mlp(self.post_attention_layernorm(hidden))
        else:
            mlp_out = self.mlp(self.post_attention_layernorm(hidden))
        out = hidden + mlp_out
        if cache is not None:
            return out, new_cache
        return (out, aux) if self._moe else out


class LlamaModel(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(
            config.vocab_size, config.hidden_size, device=device, dtype=dtype
        )
        self.layers = nn.ModuleList([
            LlamaDecoderLayer(config, device, dtype)
            for _ in range(config.num_hidden_layers)
        ])
        self.norm = RMSNorm(
            config.hidden_size, config.rms_norm_eps, device, dtype
        )

    def forward(self, input_ids, attn_mask=None, caches=None, position=None):
        """-> hidden; (hidden, new_caches) with caches; (hidden, aux) for
        an MoE model without caches, aux the sum of the layers' losses."""
        hidden = self.embed_tokens(input_ids)
        new_caches = []
        aux_total = None
        for i, layer in enumerate(self.layers):
            if caches is not None:
                hidden, c = layer(hidden, attn_mask, caches[i], position)
                new_caches.append(c)
                continue
            if self.config.recompute and torch.is_grad_enabled():
                out = recompute(layer, hidden, attn_mask)
            else:
                out = layer(hidden, attn_mask)
            if isinstance(out, tuple):
                hidden, aux = out
                aux_total = aux if aux_total is None else aux_total + aux
            else:
                hidden = out
        hidden = self.norm(hidden)
        if caches is not None:
            return hidden, new_caches
        if self.config.num_experts > 0:
            return hidden, aux_total
        return hidden


class LlamaForCausalLM(GenerationMixin, nn.Module):
    def __init__(self, config, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = torch_dtype(config.dtype)
        self.config = config
        self.llama = LlamaModel(config, device, dtype)
        self.lm_head = None
        if not config.tie_word_embeddings:
            self.lm_head = _linear(
                config.hidden_size, config.vocab_size, device, dtype
            )
        self.init_weights(torch.Generator(device=device).manual_seed(seed))

    @property
    def device(self):
        return self.llama.embed_tokens.weight.device

    @property
    def dtype(self):
        return self.llama.embed_tokens.weight.dtype

    @torch.no_grad()
    def init_weights(self, generator):
        """Embedding N(0, 1), projections Xavier-normal
        (std = sqrt(2 / (fan_in + fan_out))), norms 1 — drawn in f32 from
        ``generator`` (on the model's device) and cast to the weight
        dtype."""
        def draw(w, std):
            noise = torch.empty(w.shape, dtype=torch.float32,
                                device=w.device)
            noise.normal_(0.0, std, generator=generator)
            w.copy_(noise)

        for mod in self.modules():
            if isinstance(mod, nn.Embedding):
                draw(mod.weight, 1.0)
            elif isinstance(mod, nn.Linear):
                fan_out, fan_in = mod.weight.shape
                draw(mod.weight, (2.0 / (fan_in + fan_out)) ** 0.5)
            elif isinstance(mod, (TopKGate, SwiGLUExperts)):
                mod.reset_parameters(generator)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    def init_kv_cache(self, batch_size, max_length, dtype=None):
        """One zeroed KVCache per layer, [b, max_length, kv_heads, d]."""
        c = self.config
        head_dim = c.hidden_size // c.num_attention_heads
        shape = (batch_size, max_length, c.num_key_value_heads, head_dim)
        dtype = dtype or self.dtype
        return [
            KVCache(
                torch.zeros(shape, dtype=dtype, device=self.device),
                torch.zeros(shape, dtype=dtype, device=self.device),
            )
            for _ in range(c.num_hidden_layers)
        ]

    def head_weight(self):
        """The LM head as [vocab, hidden]: ``lm_head.weight``, or the
        embedding when the two are tied."""
        if self.lm_head is not None:
            return self.lm_head.weight
        return self.llama.embed_tokens.weight

    def logits(self, hidden):
        return F.linear(hidden, self.head_weight())

    def forward(self, input_ids, labels=None, attn_mask=None, caches=None,
                position=None):
        """Return contract, by arguments (the JAX model's):

        * ``caches`` given (decode): ``(logits, new_caches)``.
        * ``labels=None``: ``logits``.
        * ``labels`` given: ``(logits, loss)``, the mean cross entropy of
          position t's logits against ``labels[:, t + 1]`` (shift by
          one); with ``config.fused_loss_chunk > 0`` the loss goes
          through ``fused_linear_cross_entropy`` and the return is
          ``(None, loss)``: the [b, s, vocab] logits are never built.

        ``attn_mask`` composes with causality (see ``LlamaAttention``).
        An MoE model's loss adds ``router_aux_loss_coef`` times the summed
        aux loss on both loss branches."""
        if caches is not None:
            hidden, new_caches = self.llama(
                input_ids, attn_mask, caches=caches, position=position
            )
            return self.logits(hidden), new_caches
        hidden = self.llama(input_ids, attn_mask)
        aux = None
        if isinstance(hidden, tuple):
            hidden, aux = hidden
        chunk = self.config.fused_loss_chunk
        if labels is not None and chunk > 0:
            h = hidden.shape[-1]
            loss = fused_linear_cross_entropy(
                hidden[:, :-1].reshape(-1, h), self.head_weight(),
                labels[:, 1:].reshape(-1), chunk_size=chunk,
            )
            if aux is not None:
                loss = loss + self.config.router_aux_loss_coef * aux
            return None, loss
        logits = self.logits(hidden)
        if labels is None:
            return logits
        vocab = logits.shape[-1]
        loss = cross_entropy(
            logits[:, :-1].reshape(-1, vocab), labels[:, 1:].reshape(-1)
        )
        if aux is not None:
            loss = loss + self.config.router_aux_loss_coef * aux
        return logits, loss

    def num_params(self):
        return sum(p.numel() for p in self.parameters())
