"""Autoregressive generation over a preallocated KV cache.

Counterpart of ``paddle_tpu/generation``. The cache is a fixed buffer
per layer ([b, max_len, kv_heads, d]) written IN PLACE at the current
position (the JAX version rebuilds it with ``dynamic_update_slice``);
each step runs eagerly. Sampling (temperature / top-k / top-p, then the
Gumbel trick) draws its noise from a ``torch.Generator``.
"""
from __future__ import annotations

import collections

import torch

__all__ = ["KVCache", "GenerationConfig", "GenerationMixin", "warp_logits"]

# fixed-size decode cache for one attention layer:
#   k, v: [batch, max_length, num_kv_heads, head_dim]
KVCache = collections.namedtuple("KVCache", ["k", "v"])


class GenerationConfig:
    def __init__(self, max_new_tokens=32, do_sample=False, temperature=1.0,
                 top_k=0, top_p=1.0, eos_token_id=None, pad_token_id=0):
        self.max_new_tokens = max_new_tokens
        self.do_sample = do_sample
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id


def _is_scalar(x):
    return not isinstance(x, torch.Tensor)


def warp_logits(logits, temperature=1.0, top_k=0, top_p=1.0):
    """Logit warps on [rows, vocab] logits (returned as f32). Knobs may
    be python scalars or per-row [rows] tensors. Tokens tied with the
    k-th largest logit are kept (value threshold); top-p keeps tokens
    whose exclusive cumulative mass is < top_p, and always the argmax.
    Removed tokens get -1e30."""
    x = logits.float()
    rows, vocab = x.shape
    if (_is_scalar(temperature) and _is_scalar(top_k) and _is_scalar(top_p)
            and temperature == 1.0 and top_k <= 0 and top_p >= 1.0):
        return x
    dev = x.device
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=dev).expand(rows)
    k = torch.as_tensor(top_k, dtype=torch.int64, device=dev).expand(rows)
    p = torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(rows)
    x = x / t[:, None]
    sx = torch.sort(x, dim=-1, descending=True).values
    # top-k: value threshold at the k-th largest (k <= 0 disables)
    k_eff = torch.where(k > 0, torch.clamp(k, max=vocab),
                        torch.full_like(k, vocab))
    kth = torch.gather(sx, 1, (k_eff - 1)[:, None])
    # a fill, not a copy from the host: the serving programs capture this
    neg = torch.full((), -1e30, dtype=torch.float32, device=dev)
    x = torch.where(x >= kth, x, neg)
    sx = torch.where(sx >= kth, sx, neg)
    # top-p: threshold at the smallest logit still kept
    probs = torch.softmax(sx, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p[:, None]
    masked = torch.where(keep_sorted, sx, torch.full_like(sx, 1e30))
    thresh = masked.min(dim=-1, keepdim=True).values
    return torch.where(x >= thresh, x, neg)


def uniform_noise(shape, generator, device):
    """Uniform noise in [1e-9, 1) for the Gumbel trick."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u * (1.0 - 1e-9) + 1e-9


def _sample(logits, do_sample, temperature, top_k, top_p, generator=None):
    """Next token per row of [b, vocab] logits: argmax when greedy, else
    argmax of the warped logits plus Gumbel noise."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    warped = warp_logits(logits, temperature, top_k, top_p)
    u = uniform_noise(warped.shape, generator, warped.device)
    return torch.argmax(warped - torch.log(-torch.log(u)), dim=-1)


class GenerationMixin:
    """Adds ``generate`` to a causal-LM module, which must implement
    ``init_kv_cache(batch, max_length)`` and
    ``forward(input_ids, caches=..., position=...) -> (logits, caches)``.
    """

    @torch.no_grad()
    def generate(self, input_ids, generation_config=None, generator=None,
                 **kwargs):
        """Returns [batch, prompt_len + max_new_tokens] token ids (the
        prompt included; rows finished at EOS padded with pad_token_id).
        Explicit kwargs override fields of ``generation_config``; unknown
        kwargs raise. ``generator`` feeds the sampling noise."""
        if generation_config is not None:
            cfg = GenerationConfig(**vars(generation_config))
            for k, v in kwargs.items():
                if not hasattr(cfg, k):
                    raise TypeError(f"generate() got unknown kwarg {k!r}")
                setattr(cfg, k, v)
        else:
            cfg = GenerationConfig(**kwargs)
        b, prompt_len = input_ids.shape
        max_len = prompt_len + cfg.max_new_tokens
        device = self.device
        input_ids = input_ids.to(device)
        if cfg.do_sample and generator is None:
            generator = torch.Generator(device=device).manual_seed(0)

        def step(tok, caches, position):
            logits, caches = self.forward(
                tok, caches=caches, position=position
            )
            nxt = _sample(logits[:, -1], cfg.do_sample, cfg.temperature,
                          cfg.top_k, cfg.top_p, generator)
            return nxt, caches

        caches = self.init_kv_cache(b, max_len)
        nxt, caches = step(input_ids, caches, 0)   # prefill
        position = prompt_len
        tokens = [input_ids]
        finished = torch.zeros(b, dtype=torch.bool, device=device)
        pad = torch.full((b,), cfg.pad_token_id, dtype=nxt.dtype,
                         device=device)
        for i in range(cfg.max_new_tokens):
            if cfg.eos_token_id is not None:
                nxt = torch.where(finished, pad, nxt)
                finished = finished | (nxt == cfg.eos_token_id)
            tokens.append(nxt.reshape(b, 1).to(input_ids.dtype))
            if i == cfg.max_new_tokens - 1:
                break
            if cfg.eos_token_id is not None and bool(finished.all()):
                rest = cfg.max_new_tokens - 1 - i
                tokens.append(torch.full(
                    (b, rest), cfg.pad_token_id, dtype=input_ids.dtype,
                    device=device,
                ))
                break
            nxt, caches = step(nxt.reshape(b, 1), caches, position)
            position += 1
        return torch.cat(tokens, dim=1)
