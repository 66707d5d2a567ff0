"""Transformer layers (counterpart of ``paddle_tpu/nn/layer/transformer.py``):
``MultiHeadAttention`` (with ``Cache``, ``StaticCache`` and ``gen_cache``
for incremental decoding), the encoder and decoder layers and stacks,
and ``Transformer`` with ``generate_square_subsequent_mask``.

The attention core is ``ops.scaled_dot_product_attention`` in the
``[batch, seq, heads, head_dim]`` layout, as in the JAX package: on the
card a call with no mask and no dropout runs the flash kernels (the
encoder's self-attention in eval mode, a cross-attention with no memory
mask); a masked call, or one with attention dropout in training, takes
the math form. Parameter names and layouts are the JAX package's
(``Linear`` weights ``[in, out]``), so a JAX state dict loads unchanged.
"""
from __future__ import annotations

import collections
import copy

import torch

from ... import ops as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = [
    "MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
    "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
]


class MultiHeadAttention(Layer):
    """q, k, v and output projections around the attention op;
    ``need_weights`` appends None (the weights are not materialized)."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of the projected key and value (``type=
        StaticCache``), else an empty ``Cache`` that grows a step at a
        time."""
        if type == MultiHeadAttention.StaticCache:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        empty = key.new_zeros((key.shape[0], 0, self.num_heads,
                               self.head_dim))
        return self.Cache(empty, empty.clone())

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        mask = attn_mask
        if mask is not None and mask.dim() == 3:
            mask = mask.unsqueeze(1)
        out = F.scaled_dot_product_attention(
            q, k, v, mask, dropout_p=self.dropout if self.training else 0.0)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if cache is not None and not isinstance(cache, self.StaticCache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


_ACTIVATIONS = {"relu": F.relu, "gelu": F.gelu, "silu": F.silu}


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = _ACTIVATIONS[activation]

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _clones(layer, n):
    return LayerList([layer] + [copy.deepcopy(layer) for _ in range(n - 1)])


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output, new_caches = src, []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, new_cache = layer(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = _ACTIVATIONS[activation]

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                              cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                                  cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental, cache[1]))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output, new_caches = tgt, []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = layer(output, memory, tgt_mask,
                                          memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*caches)) if do_zip else caches


class Transformer(Layer):
    """The JAX class's defaults are the Transformer base: d_model 512, 8
    heads, 6 + 6 layers, FFN 2048, dropout 0.1."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args), num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args), num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """Additive causal mask [length, length]: 0 on and below the
        diagonal, -inf above (float32, on the CPU)."""
        return torch.full((length, length), float("-inf")).triu(1)
