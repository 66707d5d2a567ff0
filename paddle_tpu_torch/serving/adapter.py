"""Model adapter: the compute behind the serving engine.

Counterpart of ``paddle_tpu/serving/adapter.py``, with its main-path
entry points:

  * ``prefill(kp, vp, ids, length, block_table)`` — run one prompt
    (padded to a length bucket) through the model, write its K/V into
    the request's pages, return the logits at position ``length - 1``.
    Attention is causal ``scaled_dot_product_attention`` over the
    in-flight K/V, which runs the flash kernel on the card (bf16 and
    f32; float16 takes the math form).
  * ``prefill_ext(kp, vp, ids, length, cache_len, block_table)`` — a
    prefill CONTINUATION (chunked prefill, or the suffix after a prefix
    forked from the prefix cache): the chunk's tokens sit at global
    positions ``cache_len + t``; their K/V are written into the pages
    first, then every chunk token attends over the pages through the
    block table (cached prefix + chunk so far, causal) with the
    ``kernels.paged_prefill`` kernel; returns the logits at the chunk's
    position ``length - 1``.
  * ``decode(kp, vp, tokens, positions, block_tables, active)`` — one
    token for every batch slot at once: write each active slot's K/V at
    its position, attend over its block table with the paged decode
    kernel, return [slots, vocab] logits. Inactive slots attend over
    ``lengths = positions + 1`` of whatever their table names (page 0 when
    zeroed, always a valid read) and their logits are never read.
  * ``verify(kp, vp, tokens, positions, draft_lens, block_tables,
    active)`` — speculative verification: every slot's K+1-token window
    (its pending token, then its draft) at global positions
    ``positions[s] + j``, written into the pages, then attended over each
    slot's block table in one batched ``kernels.paged_prefill`` launch
    per layer; returns [slots, K+1, vocab] logits, row j scoring the
    token after window position j.

All four are shape-static and free of host syncs, so the engine can
capture them into CUDA graphs (``serving.programs``): ``length`` and
``cache_len`` may be device scalars, RoPE and the page write are one
``kernels.rope_kv_write`` launch per layer (q and k rotated, the rotated
K and V written together; decode: row = slot, position, valid = active;
prefill: row 0, position ``cache_len + t``, valid = t < length; verify:
row = slot, position ``positions[s] + j``, valid = active and j <=
draft_lens[s]), its angles built once per call by ``ops.rope_table`` at
the same positions (JAX rotates by ``rope_qk`` and writes by
``update_pages`` in each layer, XLA fusing both into the program), and
the logits row is picked by ``index_select``.

The attention choice for prefill. JAX's one-shot ``prefill`` and its
``prefill_ext`` use the same ``_sdpa`` form, so in JAX any chunking of a
prompt is bit-identical to one shot (in f32). The port keeps the flash
kernel for one-shot ``prefill`` over the in-flight K/V, as JAX keeps its
``prefill`` program, and runs continuations through ``paged_prefill``,
which reads K/V through the block table from any ``cache_len``. On the
card, chunked and one-shot prefill of the same prompt therefore agree to
a tolerance, not to the bit, as the engine and ``generate`` already do
there; on the CPU in f32 both are plain PyTorch, and a chunked prefill
gives one shot's logits and pages bit for bit.

Int8 pools (``EngineConfig(kv_cache_dtype="int8")``): every per-layer
pool entry is an ``(int8 pages, f32 scales)`` pair (``split_pages``).
Page writes quantize on write (the scale landing in the same slot of the
scale plane); decode and continuations read through the int8 kernels
(continuations see the cached prefix dequantized, as JAX's
``_gather_context``); one-shot prefill attends over the in-flight float
K/V, as in JAX.

``decode_kernel`` picks the paged reads as the JAX adapter's knob picks
decode attention: "auto" and "pallas" run the kernels, "xla" runs the
plain ``paged_attention_ref`` for decode and ``paged_prefill_ref`` for
continuations and verify windows (on the card too, counted as
``paged_attention_ref`` / ``paged_prefill_ref`` in ``kernels._build`` on
every call: an explicit choice, never a fallback; JAX's continuation and
verify are always their XLA form).

Verify and decode. A verify window's row 0 must give the decode step's
token. The port's verify runs the continuation attention
(``paged_prefill``) and its decode the paged decode attention: on the
card they agree to a tolerance, as chunked and one-shot prefill do. On
the CPU the window's plain attention reduces each row as decode's does,
so row 0's attention is the decode step's bit for bit; the projections
over slots * (K+1) rows may round an ulp apart from decode's over slots
rows, and greedy tokens agree (``tests/test_torch_speculation.py``).

Differences from the JAX adapter: the adapter reads the model's modules
directly (PyTorch runs eagerly, so there is no weight snapshot to
refresh), and page writes go into the pool IN PLACE, so the entry points
return logits only. Tensor parallelism is not ported yet.
"""
from __future__ import annotations

import torch

from ..kernels import _build
from ..kernels.kv_write import rope_kv_write
from ..kernels.paged_attention import (
    paged_attention,
    paged_attention_ref,
    split_pages,
)
from ..kernels.paged_prefill import paged_prefill, paged_prefill_ref
from ..ops.fused_ops import rope_table
from ..ops.nn_ops import rms_norm, scaled_dot_product_attention

__all__ = ["LlamaServingAdapter", "build_adapter", "required_attrs",
           "optional_attrs", "DECODE_KERNELS"]

# the duck-typed adapter surface the engine relies on
required_attrs = (
    "num_layers", "num_kv_heads", "head_dim", "vocab_size", "device",
    "dtype", "prefill", "decode",
)
# entry points the engine needs only for some EngineConfig flags (it
# names the missing one and the flags at build time)
optional_attrs = ("prefill_ext", "verify")
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

    @property
    def weights(self):
        """The model's weights as the JAX adapter's tree (``embed``,
        ``layers`` of per-block dicts, ``norm``, ``head``: None when the
        embedding is tied), the tensors themselves: what the step
        observatory counts parameters from."""
        m = self.model
        layers = [{
            "ln1": blk.input_layernorm.weight,
            "wq": blk.self_attn.q_proj.weight,
            "wk": blk.self_attn.k_proj.weight,
            "wv": blk.self_attn.v_proj.weight,
            "wo": blk.self_attn.o_proj.weight,
            "ln2": blk.post_attention_layernorm.weight,
            "wg": blk.mlp.gate_proj.weight,
            "wu": blk.mlp.up_proj.weight,
            "wd": blk.mlp.down_proj.weight,
        } for blk in m.llama.layers]
        return {
            "embed": m.llama.embed_tokens.weight, "layers": layers,
            "norm": m.llama.norm.weight,
            "head": m.lm_head.weight if m.lm_head is not None else None,
        }

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
            if not _build.is_fake(q):   # the analyzer's trace counts nothing
                _build.count_launch("paged_attention_ref")
            return paged_attention_ref(q, kp, vp, block_tables, lengths)
        return paged_attention(q, kp, vp, block_tables, lengths)

    def _context_attn(self, q, kp, vp, block_table, cache_len, length):
        """Continuation attention through the block table: one chunk, or
        (batched) every verify window, one launch either way."""
        if self.decode_kernel == "xla":
            if not _build.is_fake(q):   # the analyzer's trace counts nothing
                _build.count_launch("paged_prefill_ref")
            return paged_prefill_ref(q, kp, vp, block_table, cache_len,
                                     length)
        return paged_prefill(q, kp, vp, block_table, cache_len, length)

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
        cos, sin = rope_table(t, self.head_dim, self.rope_theta)
        x = m.llama.embed_tokens(ids)[None]               # [1, S, hid]
        for li, blk in enumerate(m.llama.layers):
            attn = blk.self_attn
            h = rms_norm(x, blk.input_layernorm.weight, epsilon=self.eps)
            q, k, v = self._qkv(attn, h, 1, s)
            q, k = rope_kv_write(q[0], k[0], v[0], cos, sin, kp[li], vp[li],
                                 table, rows, t, valid, want_k=True)
            # causal attention over the in-flight prompt; right-padding
            # is invisible to valid queries under causality
            o = scaled_dot_product_attention(q[None], k[None], v,
                                             is_causal=True)
            x = x + attn.o_proj(o.reshape(1, s, -1))
            x = self._mlp(blk, x)
        x = rms_norm(x, m.llama.norm.weight, epsilon=self.eps)
        # clamped: a program's warm-up runs at length 0
        last = x[0].index_select(
            0, (length.reshape(1) - 1).clamp(min=0).long())[0]
        return m.logits(last)

    @torch.no_grad()
    def prefill_ext(self, kp, vp, ids, length, cache_len, block_table):
        """Prefill CONTINUATION: one chunk of a prompt whose first
        ``cache_len`` tokens are already in the pages. ids [S] (padded to
        a bucket) hold the chunk, ``length`` its valid token count;
        ``length`` and ``cache_len`` are ints or device scalar tensors.
        Writes the chunk's K/V into ``kp``/``vp`` in place (positions
        ``cache_len + t``, t < length), attends every chunk token over the
        page timeline (keys ``c <= cache_len + t``), returns logits
        [vocab] at chunk position ``length - 1``."""
        m = self.model
        s, dev = ids.shape[0], ids.device
        if not isinstance(length, torch.Tensor):
            length = torch.tensor(int(length), device=dev)
        if not isinstance(cache_len, torch.Tensor):
            cache_len = torch.tensor(int(cache_len), device=dev)
        t = torch.arange(s, dtype=torch.int32, device=dev)
        pos = cache_len.to(torch.int32) + t
        valid = t < length
        rows = torch.zeros_like(t)
        table = block_table.to(torch.int32)
        cos, sin = rope_table(pos, self.head_dim, self.rope_theta)
        x = m.llama.embed_tokens(ids)[None]               # [1, S, hid]
        for li, blk in enumerate(m.llama.layers):
            attn = blk.self_attn
            h = rms_norm(x, blk.input_layernorm.weight, epsilon=self.eps)
            q, k, v = self._qkv(attn, h, 1, s)
            q = rope_kv_write(q[0], k[0], v[0], cos, sin, kp[li], vp[li],
                              table[None], rows, pos, valid)
            o = self._context_attn(q, kp[li], vp[li], table, cache_len,
                                   length)
            x = x + attn.o_proj(o.reshape(1, s, -1))
            x = self._mlp(blk, x)
        x = rms_norm(x, m.llama.norm.weight, epsilon=self.eps)
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
        cos, sin = rope_table(pos, self.head_dim, self.rope_theta)
        x = m.llama.embed_tokens(tokens)                  # [slots, hid]
        for li, blk in enumerate(m.llama.layers):
            attn = blk.self_attn
            h = rms_norm(x, blk.input_layernorm.weight, epsilon=self.eps)
            q, k, v = self._qkv(attn, h[:, None, :], b, 1)
            q = rope_kv_write(q[:, 0], k[:, 0], v[:, 0], cos, sin, kp[li],
                              vp[li], tables, rows, pos, valid)
            o = self._paged_attn(q, kp[li], vp[li], tables, lengths)
            x = x + attn.o_proj(o.reshape(b, -1))
            x = self._mlp(blk, x)
        x = rms_norm(x, m.llama.norm.weight, epsilon=self.eps)
        return m.logits(x)

    @torch.no_grad()
    def verify(self, kp, vp, tokens, positions, draft_lens, block_tables,
               active):
        """Speculative verification: score a K+1-token window for every
        slot in one pass. tokens [slots, K+1] hold each slot's pending
        token at column 0 and its draft after it; window token j sits at
        global position ``positions[s] + j``. ``draft_lens`` [slots]
        counts the valid draft tokens, so columns j <= draft_lens are real
        and later ones padding: their page writes are dropped (the kernel
        skips them, the plain ``rope_kv_write_ref`` routes them to the
        sink page) and their logits are never read, as for inactive slots.
        block_tables [slots, P] int32, active [slots] bool, all on the
        adapter's device. Writes the windows' K/V in place; returns logits
        [slots, K+1, vocab], row j scoring the token FOLLOWING position
        ``positions[s] + j``.

        A rejected draft's write is dead: the engine advances
        ``num_cached`` by the accepted count only, every later query's
        mask ends at its own position, and the next write at that
        position overwrites it."""
        m = self.model
        b, s = tokens.shape
        dev = tokens.device
        tables = block_tables.to(torch.int32)
        capacity = tables.shape[1] * split_pages(kp[0])[0].shape[2]
        offs = torch.arange(s, dtype=torch.int32, device=dev)
        pos = positions.to(torch.int32)[:, None] + offs[None]   # [slots, S]
        act = active.to(torch.bool)
        dl = draft_lens.to(torch.int32)
        valid = (act[:, None] & (offs[None] <= dl[:, None])
                 & (pos < capacity)).reshape(-1)
        rows = torch.arange(b, dtype=torch.int32, device=dev) \
            .repeat_interleave(s)
        flat = pos.reshape(-1)
        # attention: slot s sees its keys c <= positions[s] + j, over
        # length = draft_lens + 1 valid rows (0 when inactive)
        cache_len = pos[:, 0]
        lengths = torch.where(act, dl + 1, torch.zeros_like(dl))
        cos, sin = rope_table(flat, self.head_dim, self.rope_theta)
        x = m.llama.embed_tokens(tokens)                  # [slots, S, hid]
        for li, blk in enumerate(m.llama.layers):
            attn = blk.self_attn
            h = rms_norm(x, blk.input_layernorm.weight, epsilon=self.eps)
            q, k, v = self._qkv(attn, h, b, s)
            q = rope_kv_write(q.reshape(b * s, *q.shape[2:]),
                              k.reshape(b * s, *k.shape[2:]),
                              v.reshape(b * s, *v.shape[2:]), cos, sin,
                              kp[li], vp[li], tables, rows, flat, valid)
            o = self._context_attn(q.view(b, s, *q.shape[1:]), kp[li],
                                   vp[li], tables, cache_len, lengths)
            x = x + attn.o_proj(o.reshape(b, s, -1))
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
