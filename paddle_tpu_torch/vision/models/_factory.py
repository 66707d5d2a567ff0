"""What the zoo's factories share: build on the CPU from a seeded
generator, then move to the device (the card unless named)."""
from __future__ import annotations

import torch

from ...core.device import resolve_device
from ...nn import initializer as I


def _no_pretrained(pretrained):
    if pretrained:
        raise ValueError(
            "pretrained weights are not available; load a state dict "
            "with model.set_state_dict(...) or "
            "models.load_reference_state(model, state)")


def _build(cls, pretrained, *args, device=None, seed=0, **kwargs):
    """``cls(*args, **kwargs)`` with its weights drawn from a
    ``torch.Generator`` seeded with ``seed``, on ``device``."""
    _no_pretrained(pretrained)
    device = resolve_device(device)
    with I.init_generator(torch.Generator().manual_seed(seed)):
        model = cls(*args, **kwargs)
    return model.to(device)
