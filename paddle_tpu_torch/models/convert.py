"""Load a JAX-package ``state_dict`` into the port's model (Llama, DiT,
the ResNets and any model of the port's ``nn`` layers).

``state`` maps the JAX parameter names (``llama.embed_tokens.weight``,
``llama.layers.0.self_attn.q_proj.weight``, ``lm_head.weight``, ...) to
numpy arrays. The port's module names are the same; what differs is the
projection layout: the JAX ``Linear`` weight is [in, out] (the adapter
computes ``h @ wq``) and ``torch.nn.Linear`` keeps [out, in], so every
projection is transposed on load. Embedding and norm weights load as
they are. With tied embeddings neither side has ``lm_head.weight``; the
port's head is then ``embed.T`` (``F.linear(h, embed)``).

MoE layers (``num_experts > 0``): the gate ``weight [d_model, e]`` and the
stacked expert weights ``[e, in, out]`` are not ``nn.Linear`` and have the
same layout on both sides, so they load untransposed; so do the int8
experts' ``*_scale`` buffers of a quantized model (quantize the port's
model first, as in the JAX package).

Models of the port's ``nn`` layers (the ResNets): their ``nn.Linear`` keeps
the JAX [in, out] weight and is not a ``torch.nn.Linear``, so it loads
untransposed; convolution weights are [out, in / groups, *k] (transposed
ones [in, out / groups, *k]) on both sides and load as they are; the
batch norms' ``_mean`` and ``_variance`` load as buffers.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["load_reference_state"]


@torch.no_grad()
def load_reference_state(model, state):
    """Copy ``state`` (JAX names -> numpy arrays) into ``model`` in place,
    casting to each parameter's (or buffer's) dtype and device. Raises ``KeyError`` on
    missing or unexpected names and ``ValueError`` on a shape mismatch.
    Returns ``model``."""
    # torch.nn.Linear only: the port's nn.Linear keeps [in, out]
    linear_weights = {
        f"{name}.weight" for name, mod in model.named_modules()
        if isinstance(mod, nn.Linear)
    }
    params = dict(model.named_parameters())
    params.update((n, b) for n, b in model.named_buffers() if b is not None)
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError(
            f"load_reference_state: missing {missing}, unexpected "
            f"{unexpected}"
        )
    for name, param in params.items():
        arr = np.asarray(state[name])
        if name in linear_weights:
            arr = arr.T                       # [in, out] -> [out, in]
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(
                f"load_reference_state: {name} has shape {arr.shape}, "
                f"the port expects {tuple(param.shape)}"
            )
        param.copy_(torch.tensor(arr))
    return model
