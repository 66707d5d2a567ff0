"""Diffusion Transformer (DiT), the model of BASELINE config #5.

Counterpart of ``paddle_tpu/models/dit.py``: patchify a latent, add a
position embedding, condition on the timestep and the class through
adaLN-Zero blocks (each block's six modulation vectors come from the
conditioning vector, and start at zero so a block starts as the
identity), then unpatchify to the noise prediction. Attention is
non-causal and goes through the port's
``ops.scaled_dot_product_attention``: on the card, the flash kernels at
the head dims they take (``kernels.flash_attention.SUPPORTED_HEAD_DIMS``;
``dit_xl_2``'s d 72 takes the math form).

Module names are the JAX package's (``x_embed.weight``, ``pos_embed``,
``t_embed.fc1.weight``, ``y_embed.weight``, ``blocks.0.qkv.weight``,
...), so a JAX ``state_dict`` loads through
``models.convert.load_reference_state``, which transposes every
``nn.Linear`` weight and loads the rest as it is.

``DiT(config, device=None, seed=0)`` builds on the CUDA device unless
``device`` names another one. Weights are drawn from a
``torch.Generator`` seeded with ``seed``, from the JAX package's
distributions: projections Xavier-normal with zero biases, the class
embedding N(0, 1), ``ada`` zero; ``pos_embed`` is the JAX package's own
draw (numpy ``RandomState(0)``, times 0.02).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..ops.nn_ops import scaled_dot_product_attention

__all__ = [
    "DiTConfig", "TimestepEmbedder", "DiTBlock", "DiT", "dit_xl_2",
    "dit_b_4",
]


class DiTConfig:
    def __init__(self, input_size=32, patch_size=2, in_channels=4,
                 hidden_size=1152, depth=28, num_heads=16, mlp_ratio=4.0,
                 num_classes=1000, learn_sigma=False):
        self.input_size = input_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.hidden_size = hidden_size
        self.depth = depth
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.num_classes = num_classes
        self.learn_sigma = learn_sigma

    @classmethod
    def tiny(cls, **over):
        """Test-scale config, the same as the JAX package's."""
        base = dict(input_size=8, patch_size=2, in_channels=4,
                    hidden_size=64, depth=2, num_heads=4, num_classes=10)
        base.update(over)
        return cls(**base)


def _frequencies(dim, max_period=10000.0):
    """The sinusoids' frequencies, computed as the JAX package does (in
    numpy float32), so both packages embed a timestep alike."""
    half = dim // 2
    return torch.from_numpy(np.exp(
        -math.log(max_period) * np.arange(half, dtype=np.float32) / half))


def _timestep_embedding(t, dim, max_period=10000.0, freqs=None):
    """Sinusoidal timestep features [cos, sin] (the DDPM convention)."""
    if freqs is None:
        freqs = _frequencies(dim, max_period)
    args = t.float().unsqueeze(-1) * freqs.to(t.device)
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _layer_norm(hidden_size, device):
    return nn.LayerNorm(hidden_size, eps=1e-5, elementwise_affine=False,
                        device=device)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size, freq_dim=256, device=None):
        super().__init__()
        self.freq_dim = freq_dim
        self.fc1 = nn.Linear(freq_dim, hidden_size, device=device)
        self.fc2 = nn.Linear(hidden_size, hidden_size, device=device)
        # float32 whatever the weights' dtype, and not in the state (the
        # JAX model has no such entry): kept on the device it last ran on
        self._freqs = _frequencies(freq_dim)

    def forward(self, t):
        if self._freqs.device != t.device:
            self._freqs = self._freqs.to(t.device)
        h = _timestep_embedding(t, self.freq_dim, freqs=self._freqs)
        return self.fc2(F.silu(self.fc1(h)))


class DiTBlock(nn.Module):
    """adaLN-Zero block: LayerNorm, modulate (shift, scale), attention or
    MLP, then a gated residual; the six modulation vectors come from the
    conditioning vector through ``ada``."""

    def __init__(self, hidden_size, num_heads, mlp_ratio=4.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = _layer_norm(hidden_size, device)
        self.qkv = nn.Linear(hidden_size, hidden_size * 3, device=device)
        self.proj = nn.Linear(hidden_size, hidden_size, device=device)
        self.norm2 = _layer_norm(hidden_size, device)
        mlp_dim = int(hidden_size * mlp_ratio)
        self.mlp_fc1 = nn.Linear(hidden_size, mlp_dim, device=device)
        self.mlp_fc2 = nn.Linear(mlp_dim, hidden_size, device=device)
        self.ada = nn.Linear(hidden_size, 6 * hidden_size, device=device)

    def _attn(self, x):
        b, s, d = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(b, s, 3, h, d // h)
        # strided views of the projection; the flash wrapper makes each
        # contiguous before its launch
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = scaled_dot_product_attention(q, k, v)
        return self.proj(out.reshape(b, s, d))

    def forward(self, x, c):
        mods = self.ada(F.silu(c))                          # [b, 6 d]
        (shift_a, scale_a, gate_a, shift_m, scale_m,
         gate_m) = mods.chunk(6, dim=-1)

        def mod(h, shift, scale):
            return h * (1.0 + scale.unsqueeze(1)) + shift.unsqueeze(1)

        x = x + gate_a.unsqueeze(1) * self._attn(
            mod(self.norm1(x), shift_a, scale_a))
        h = mod(self.norm2(x), shift_m, scale_m)
        return x + gate_m.unsqueeze(1) * self.mlp_fc2(
            F.gelu(self.mlp_fc1(h), approximate="tanh"))


class DiT(nn.Module):
    """``forward(x [b, c, h, w], t [b], y [b])`` -> the noise prediction
    [b, c, h, w] (2c channels with ``learn_sigma``)."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        self.num_patches = (cfg.input_size // cfg.patch_size) ** 2
        patch_dim = cfg.in_channels * cfg.patch_size ** 2
        self.x_embed = nn.Linear(patch_dim, cfg.hidden_size, device=device)
        self.pos_embed = nn.Parameter(torch.from_numpy((
            np.random.RandomState(0).randn(
                1, self.num_patches, cfg.hidden_size) * 0.02
        ).astype(np.float32)).to(device))
        self.t_embed = TimestepEmbedder(cfg.hidden_size, device=device)
        self.y_embed = nn.Embedding(cfg.num_classes + 1, cfg.hidden_size,
                                    device=device)
        self.blocks = nn.ModuleList([
            DiTBlock(cfg.hidden_size, cfg.num_heads, cfg.mlp_ratio, device)
            for _ in range(cfg.depth)
        ])
        self.final_norm = _layer_norm(cfg.hidden_size, device)
        self.out_channels = cfg.in_channels * (2 if cfg.learn_sigma else 1)
        self.final = nn.Linear(cfg.hidden_size,
                               cfg.patch_size ** 2 * self.out_channels,
                               device=device)
        self.init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator):
        """Projections Xavier-normal (std sqrt(2 / (fan_in + fan_out)))
        with zero biases, the class embedding N(0, 1), every block's
        ``ada`` zero, drawn in f32 from ``generator``."""
        ada = {id(blk.ada) for blk in self.blocks}
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.bias.zero_()
                if id(mod) in ada:
                    mod.weight.zero_()
                    continue
                fan_out, fan_in = mod.weight.shape
                mod.weight.normal_(0.0, (2.0 / (fan_in + fan_out)) ** 0.5,
                                   generator=generator)
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0, generator=generator)

    def _patchify(self, x):
        b, c, h, w = x.shape
        p = self.config.patch_size
        x = x.reshape(b, c, h // p, p, w // p, p)
        x = x.permute(0, 2, 4, 3, 5, 1)             # b, gh, gw, p, p, c
        return x.reshape(b, (h // p) * (w // p), p * p * c)

    def _unpatchify(self, x):
        b = x.shape[0]
        p = self.config.patch_size
        g = self.config.input_size // p
        x = x.reshape(b, g, g, p, p, self.out_channels)
        x = x.permute(0, 5, 1, 3, 2, 4)
        return x.reshape(b, self.out_channels, g * p, g * p)

    def forward(self, x, t, y):
        h = self.x_embed(self._patchify(x)) + self.pos_embed
        c = self.t_embed(t) + self.y_embed(y)
        for blk in self.blocks:
            h = blk(h, c)
        return self._unpatchify(self.final(self.final_norm(h)))

    def num_params(self):
        return sum(p.numel() for p in self.parameters())


def dit_xl_2(device=None, seed=0, **over):
    return DiT(DiTConfig(patch_size=2, hidden_size=1152, depth=28,
                         num_heads=16, **over), device=device, seed=seed)


def dit_b_4(device=None, seed=0, **over):
    return DiT(DiTConfig(patch_size=4, hidden_size=768, depth=12,
                         num_heads=12, **over), device=device, seed=seed)
