"""Model adapter: the compute behind the serving engine.

Counterpart of ``paddle_tpu/serving/adapter.py``, with its two main-path
entry points:

  * ``prefill(kp, vp, ids, length, block_table)`` — run one prompt
    (padded to a length bucket) through the model, write its K/V into
    the request's pages, return the logits at position ``length - 1``.
    Attention is causal ``scaled_dot_product_attention``, which runs the
    flash kernel on the card (bf16 and f32; float16 takes the math form).
  * ``decode(kp, vp, tokens, positions, block_tables, active)`` — one
    token for every batch slot at once: write each active slot's K/V at
    its position, attend over its block table with the paged decode
    kernel, return [slots, vocab] logits. Inactive slots attend over
    ``lengths = positions + 1`` of whatever their table names (page 0 when
    zeroed, always a valid read) and their logits are never read.

Both are shape-static and free of host syncs, so the engine can capture
them into CUDA graphs (``serving.programs``): ``length`` may be a device
scalar, every page write is one ``kernels.kv_write`` launch per layer for
K and V together (decode: row = slot, position, valid = active; prefill:
row 0, position t, valid = t < length), and the logits row is picked by
``index_select``.

Int8 pools (``EngineConfig(kv_cache_dtype="int8")``): every per-layer
pool entry is an ``(int8 pages, f32 scales)`` pair (``split_pages``).
Page writes quantize on write (the scale landing in the same slot of the
scale plane) and decode reads through the int8 paged kernel; prefill
attends over the in-flight float K/V, as in JAX.

``decode_kernel`` picks decode attention as the JAX adapter's knob does:
"auto" and "pallas" run the paged kernel, "xla" runs the plain
``paged_attention_ref`` (on the card too, counted as
``paged_attention_ref`` in ``kernels._build`` on every call: an explicit
choice, never a fallback).

Differences from the JAX adapter: the adapter reads the model's modules
directly (PyTorch runs eagerly, so there is no weight snapshot to
refresh), and page writes go into the pool IN PLACE, so the entry points
return logits only. ``prefill_ext``, ``verify`` and tensor parallelism
are not ported yet.
"""
from __future__ import annotations

import torch

from ..kernels import _build
from ..kernels.kv_write import kv_write
from ..kernels.paged_attention import paged_attention, paged_attention_ref
from ..ops.fused_ops import rope_qk
from ..ops.nn_ops import rms_norm, scaled_dot_product_attention

__all__ = ["LlamaServingAdapter", "build_adapter", "required_attrs",
           "DECODE_KERNELS"]

# the duck-typed adapter surface the engine relies on
required_attrs = (
    "num_layers", "num_kv_heads", "head_dim", "vocab_size", "device",
    "dtype", "prefill", "decode",
)
# ``decode_kernel`` values, as ``EngineConfig(decode_kernel=)`` takes them
DECODE_KERNELS = ("auto", "pallas", "xla")


class LlamaServingAdapter:
    """Paged-KV serving forward for a ``models.llama.LlamaForCausalLM``."""

    def __init__(self, model):
        cfg = model.config
        if getattr(cfg, "num_experts", 0) > 0:
            raise NotImplementedError(
                "serving adapter: MoE Llama not supported yet (dense only)"
            )
        self.num_layers = cfg.num_hidden_layers
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.hidden_size = cfg.hidden_size
        self.vocab_size = cfg.vocab_size
        self.rope_theta = cfg.rope_theta
        self.eps = cfg.rms_norm_eps
        self.model = model
        self.decode_kernel = "auto"

    @property
    def device(self):
        return self.model.device

    @property
    def dtype(self):
        """The float KV pool's dtype: the model's (an int8 pool keeps its
        scales in f32)."""
        return self.model.dtype

    def _qkv(self, attn, h, b, s):
        q = attn.q_proj(h).view(b, s, self.num_heads, self.head_dim)
        k = attn.k_proj(h).view(b, s, self.num_kv_heads, self.head_dim)
        v = attn.v_proj(h).view(b, s, self.num_kv_heads, self.head_dim)
        return q, k, v

    def _mlp(self, blk, x):
        h = rms_norm(x, blk.post_attention_layernorm.weight, epsilon=self.eps)
        return x + blk.mlp(h)

    def _paged_attn(self, q, kp, vp, block_tables, lengths):
        if self.decode_kernel == "xla":
            _build.count_launch("paged_attention_ref")
            return paged_attention_ref(q, kp, vp, block_tables, lengths)
        return paged_attention(q, kp, vp, block_tables, lengths)

    @torch.no_grad()
    def prefill(self, kp, vp, ids, length, block_table):
        """ids [S] (padded to a bucket), length an int or a device scalar
        tensor, block_table [P] int32 on the adapter's device. Writes the
        prompt's K/V into ``kp``/``vp`` (per-layer page tensors) in place;
        returns logits [vocab] at position ``length - 1``."""
        m = self.model
        s, dev = ids.shape[0], ids.device
        if not isinstance(length, torch.Tensor):
            length = torch.tensor(int(length), device=dev)
        t = torch.arange(s, dtype=torch.int32, device=dev)
        # prompt token t goes to row 0 at position t while t < length;
        # the padded tail (t >= length) is not written
        valid = t < length
        rows = torch.zeros_like(t)
        table = block_table.to(torch.int32)[None]
        x = m.llama.embed_tokens(ids)[None]               # [1, S, hid]
        for li, blk in enumerate(m.llama.layers):
            attn = blk.self_attn
            h = rms_norm(x, blk.input_layernorm.weight, epsilon=self.eps)
            q, k, v = self._qkv(attn, h, 1, s)
            q, k = rope_qk(q, k, t[None], base=self.rope_theta)
            kv_write(kp[li], vp[li], k[0], v[0], table, rows, t, valid)
            # causal attention over the in-flight prompt; right-padding
            # is invisible to valid queries under causality
            o = scaled_dot_product_attention(q, k, v, is_causal=True)
            x = x + attn.o_proj(o.reshape(1, s, -1))
            x = self._mlp(blk, x)
        x = rms_norm(x, m.llama.norm.weight, epsilon=self.eps)
        # clamped: a program's warm-up runs at length 0
        last = x[0].index_select(
            0, (length.reshape(1) - 1).clamp(min=0).long())[0]
        return m.logits(last)

    @torch.no_grad()
    def decode(self, kp, vp, tokens, positions, block_tables, active):
        """tokens/positions [slots] int, block_tables [slots, P] int32,
        active [slots] bool, all on the adapter's device. Writes each
        active slot's new K/V in place; returns logits [slots, vocab]."""
        m = self.model
        b = tokens.shape[0]
        # int32 once for all layers; the new token attends to itself
        pos = positions.to(torch.int32)
        lengths = pos + 1
        tables = block_tables.to(torch.int32)
        rows = torch.arange(b, dtype=torch.int32, device=tokens.device)
        valid = active.to(torch.bool)
        x = m.llama.embed_tokens(tokens)                  # [slots, hid]
        for li, blk in enumerate(m.llama.layers):
            attn = blk.self_attn
            h = rms_norm(x, blk.input_layernorm.weight, epsilon=self.eps)
            q, k, v = self._qkv(attn, h[:, None, :], b, 1)
            q, k = rope_qk(q, k, pos[:, None], base=self.rope_theta)
            kv_write(kp[li], vp[li], k[:, 0], v[:, 0], tables, rows, pos,
                     valid)
            o = self._paged_attn(q[:, 0], kp[li], vp[li], tables, lengths)
            x = x + attn.o_proj(o.reshape(b, -1))
            x = self._mlp(blk, x)
        x = rms_norm(x, m.llama.norm.weight, epsilon=self.eps)
        return m.logits(x)


def build_adapter(model):
    """Pass-through for objects already exposing the adapter surface,
    ``LlamaServingAdapter`` for the port's Llama."""
    if all(hasattr(model, a) for a in required_attrs):
        return model
    from ..models.llama import LlamaForCausalLM

    if isinstance(model, LlamaForCausalLM):
        return LlamaServingAdapter(model)
    raise TypeError(
        f"cannot serve {type(model).__name__}: pass an adapter exposing "
        f"{required_attrs} or a LlamaForCausalLM"
    )
