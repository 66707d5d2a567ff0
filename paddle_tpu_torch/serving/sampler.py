"""Batched sampling for the continuous batch.

Counterpart of ``paddle_tpu/serving/sampler.py``: ``generation.
warp_logits`` with per-slot parameter tensors, so one [slots, vocab] pass
samples every occupant of the batch; greedy rows keep the plain argmax.
"""
from __future__ import annotations

import numpy as np
import torch

from ..generation import warp_logits

__all__ = ["sample_tokens", "pack_sampling_params"]


def sample_tokens(logits, temperature, top_k, top_p, do_sample, u=None):
    """Next token per slot on [slots, vocab] logits.

    ``temperature/top_k/top_p/do_sample``: [slots] tensors. ``u``: uniform
    (0, 1] noise of logits' shape, passed in so the caller owns the
    random stream (the Gumbel trick). ``u=None`` declares the whole batch
    greedy and skips the warp."""
    greedy = torch.argmax(logits, dim=-1)
    if u is None:
        return greedy
    warped = warp_logits(logits, temperature, top_k, top_p)
    sampled = torch.argmax(warped - torch.log(-torch.log(u)), dim=-1)
    return torch.where(do_sample.to(torch.bool), sampled, greedy)


def pack_sampling_params(requests):
    """Per-slot SamplingParams packed into host arrays (empty slots get
    inert defaults). ``requests``: one Request-or-None per slot."""
    n = len(requests)
    temperature = np.ones(n, np.float32)
    top_k = np.zeros(n, np.int64)
    top_p = np.ones(n, np.float32)
    do_sample = np.zeros(n, bool)
    for i, r in enumerate(requests):
        if r is None:
            continue
        p = r.sampling_params
        temperature[i] = p.temperature
        top_k[i] = p.top_k
        top_p[i] = p.top_p
        do_sample[i] = p.do_sample
    return {
        "temperature": temperature,
        "top_k": top_k,
        "top_p": top_p,
        "do_sample": do_sample,
    }
