"""Model adapter: the compute behind the serving engine.

Counterpart of ``paddle_tpu/serving/adapter.py``, with its two main-path
entry points:

  * ``prefill(kp, vp, ids, length, block_table)`` — run one prompt
    (padded to a length bucket) through the model, write its K/V into
    the request's pages, return the logits at position ``length - 1``.
    Attention is causal ``scaled_dot_product_attention``, which runs the
    flash kernel on the card.
  * ``decode(kp, vp, tokens, positions, block_tables, active)`` — one
    token for every batch slot at once: write each active slot's K/V at
    its position (``kernels.paged_attention.update_pages``), attend over
    its block table with the paged decode kernel, return
    [slots, vocab] logits. Inactive slots attend over ``lengths = 1`` of
    block-table zeros (page 0 is always a valid read) and their logits
    are never read.

Int8 pools (``EngineConfig(kv_cache_dtype="int8")``): every per-layer
pool entry is an ``(int8 pages, f32 scales)`` pair (``split_pages``).
Page writes quantize on write (``quantize_tokens``, the scale landing in
the same slot of the scale plane) and decode reads through the int8
paged kernel; prefill attends over the in-flight float K/V, as in JAX.

Differences from the JAX adapter: the adapter reads the model's modules
directly (PyTorch runs eagerly, so there is no weight snapshot to
refresh), and page writes go into the pool IN PLACE, so the entry points
return logits only. JAX drops out-of-range scatter rows and clamps
out-of-range gathers; PyTorch raises on both, so the writes here select
the rows to write explicitly and clamp the block-table index.
``prefill_ext``, ``verify`` and tensor parallelism are not ported yet.
"""
from __future__ import annotations

import torch

from ..kernels.paged_attention import (
    paged_attention, quantize_tokens, rows_below_capacity, split_pages,
    update_pages,
)
from ..ops.fused_ops import rope_qk
from ..ops.nn_ops import rms_norm, scaled_dot_product_attention

__all__ = ["LlamaServingAdapter", "build_adapter", "required_attrs"]

# the duck-typed adapter surface the engine relies on
required_attrs = (
    "num_layers", "num_kv_heads", "head_dim", "vocab_size", "device",
    "dtype", "prefill", "decode",
)


def _paged_attn(q, kp, vp, block_tables, lengths):
    return paged_attention(q, kp, vp, block_tables, lengths)


def _write_prompt_pages(pages, kv, block_table, length):
    """Write a prompt's [S, kv_heads, d] K or V into its pages in place:
    token t < length lands in page ``block_table[t // block_size]``, slot
    ``t % block_size``; padded tail rows (t >= length) are not written."""
    _write_chunk_pages(pages, kv, block_table, length, 0)


def _write_chunk_pages(pages, kv, block_table, length, cache_len):
    """``_write_prompt_pages`` with a position offset: chunk token t
    lands at global position ``cache_len + t``. Only the first ``length``
    rows are written; the block-table index is clamped to the table, as
    the JAX gather clamps. An int8 entry quantizes on write, and each
    token's per-head scale goes to the same slot of the scale plane."""
    buf, scales = split_pages(pages)
    block_size = buf.shape[2]
    gpos = cache_len + torch.arange(length, device=buf.device)
    logical = torch.clamp(gpos // block_size, max=block_table.shape[0] - 1)
    phys = block_table.long()[logical]
    slot = gpos % block_size
    if scales is None:
        buf[:, phys, slot] = kv[:length].transpose(0, 1).to(buf.dtype)
        return
    q8, sc = quantize_tokens(kv[:length])      # [L, kvh, d], [L, kvh]
    buf[:, phys, slot] = q8.transpose(0, 1)
    scales[:, phys, slot] = sc.transpose(0, 1)


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

    @torch.no_grad()
    def prefill(self, kp, vp, ids, length, block_table):
        """ids [S] (padded to a bucket), length int, block_table [P] on
        the adapter's device. Writes the prompt's K/V into ``kp``/``vp``
        (per-layer page tensors) in place; returns logits [vocab] at
        position ``length - 1``."""
        m = self.model
        s = ids.shape[0]
        x = m.llama.embed_tokens(ids)[None]               # [1, S, hid]
        pos = torch.arange(s, dtype=torch.int32, device=ids.device)[None]
        for li, blk in enumerate(m.llama.layers):
            attn = blk.self_attn
            h = rms_norm(x, blk.input_layernorm.weight, epsilon=self.eps)
            q, k, v = self._qkv(attn, h, 1, s)
            q, k = rope_qk(q, k, pos, base=self.rope_theta)
            _write_prompt_pages(kp[li], k[0], block_table, length)
            _write_prompt_pages(vp[li], v[0], block_table, length)
            # causal attention over the in-flight prompt; right-padding
            # is invisible to valid queries under causality
            o = scaled_dot_product_attention(q, k, v, is_causal=True)
            x = x + attn.o_proj(o.reshape(1, s, -1))
            x = self._mlp(blk, x)
        x = rms_norm(x, m.llama.norm.weight, epsilon=self.eps)
        return m.logits(x[0, length - 1])

    @torch.no_grad()
    def decode(self, kp, vp, tokens, positions, block_tables, active):
        """tokens/positions [slots] int, block_tables [slots, P] int32,
        active [slots] bool, all on the adapter's device. Writes each
        active slot's new K/V in place; returns logits [slots, vocab]."""
        m = self.model
        b = tokens.shape[0]
        page_size = split_pages(kp[0])[0].shape[2]
        capacity = block_tables.shape[1] * page_size
        # inactive slots: write position at capacity -> not written; the
        # rows to write are found once for all layers
        write_pos = torch.where(active, positions,
                                torch.full_like(positions, capacity))
        rows = rows_below_capacity(write_pos, block_tables, page_size)
        # the new token attends to itself; int32 once for all layers
        lengths = (positions + 1).to(torch.int32)
        x = m.llama.embed_tokens(tokens)                  # [slots, hid]
        for li, blk in enumerate(m.llama.layers):
            attn = blk.self_attn
            h = rms_norm(x, blk.input_layernorm.weight, epsilon=self.eps)
            q, k, v = self._qkv(attn, h[:, None, :], b, 1)
            q, k = rope_qk(q, k, positions[:, None], base=self.rope_theta)
            update_pages(kp[li], vp[li], k[:, 0], v[:, 0], block_tables,
                         write_pos, rows)
            o = _paged_attn(q[:, 0], kp[li], vp[li], block_tables, lengths)
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
