"""Seeded weight initialization, drawn from an explicit `torch.Generator`.

Follows the JAX package's initializers where they matter for the signal:
lecun-normal kernels with zero biases (flax's Dense/Conv default), unit/zero
norms and running statistics, and each module's own `init_weights` hook for
the rest (MSDA's offset grid, layer-scale gammas, embeddings).
"""

import math

import torch
from torch import nn


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize every parameter and buffer of `model` in place (also after
    `to_empty()`); raises if one is left unset."""
    for p in model.parameters():
        p.fill_(float("nan"))
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            if isinstance(m, nn.Linear):
                fan_in = w.shape[1]
            elif isinstance(m, nn.ConvTranspose2d):   # (in, out, kh, kw)
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:                                     # (out, in/groups, kh, kw)
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
    for m in model.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(generator)
    unset = [n for n, p in model.named_parameters() if torch.isnan(p).any()]
    if unset:
        raise RuntimeError(f"parameters left uninitialized: {unset[:5]}")
    return model
