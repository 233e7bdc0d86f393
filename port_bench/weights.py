"""The weights of a run, made on the device from the seed by the benchmark
itself and handed alike to the program and to the reference.

One normal draw of all the matrices' and tensors' elements, then each
tensor a scaled view of it: weights of two or more dimensions at
N(0, std) with std = min(0.02, fan_in ** -0.5); norm scales and running
variances 1; biases, running means and counters 0; layer scales (`gamma`,
`gamma_1`, `gamma_2`, `gamma1`, `gamma2`) 0.1, so that every block's
branch and the adapter's injectors do real work from the first step; the
sampling-offset
bias of each deformable attention its directional grid, as at
initialization."""

from __future__ import annotations

import math
from typing import Dict

import torch

GAMMA = 0.1
MAX_STD = 0.02


def msda_grid(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """Head h points along angle 2 pi h / n_heads, scaled to the unit Linf
    ball and by (point index + 1)."""
    thetas = torch.arange(n_heads, dtype=torch.float32) * (2.0 * math.pi
                                                           / n_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], dim=-1)
    grid = grid / grid.abs().max(dim=-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, n_levels, n_points, 1)
    scale = torch.arange(1, n_points + 1, dtype=torch.float32)
    return (grid * scale[None, None, :, None]).reshape(-1)


def make_state(shapes: Dict[str, torch.Size], msda: Dict[str, tuple],
               seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict for `shapes` (name -> shape, fp32 except the int64
    counters): `msda` maps a deformable attention's prefix to its
    (heads, levels, points)."""
    g = torch.Generator(device).manual_seed(seed)
    big = [n for n, s in shapes.items() if len(s) >= 2]
    total = sum(math.prod(shapes[n]) for n in big)
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for n in big:
        s = shapes[n]
        k = math.prod(s)
        fan_in = k // s[0]
        out[n] = flat[off:off + k].view(s).mul_(min(MAX_STD,
                                                    fan_in ** -0.5))
        off += k
    for n, s in shapes.items():
        if len(s) >= 2:
            continue
        leaf = n.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            out[n] = torch.zeros(s, dtype=torch.int64, device=device)
        elif leaf in ("gamma", "gamma_1", "gamma_2", "gamma1", "gamma2"):
            out[n] = torch.full(s, GAMMA, device=device)
        elif leaf in ("weight", "running_var"):
            out[n] = torch.ones(s, device=device)
        elif n.endswith("sampling_offsets.bias"):
            out[n] = msda_grid(*msda[n[:-len(".sampling_offsets.bias")]]) \
                .to(device)
        else:
            out[n] = torch.zeros(s, device=device)
    return out


def model_shapes(model: torch.nn.Module) -> Dict[str, torch.Size]:
    return {n: t.shape for n, t in model.state_dict().items()}


def msda_geometry(model: torch.nn.Module) -> Dict[str, tuple]:
    """(heads, levels, points) of each module with a `sampling_offsets`
    projection and those three counts, by its name."""
    return {n: (m.n_heads, m.n_levels, m.n_points)
            for n, m in model.named_modules()
            if hasattr(m, "sampling_offsets") and hasattr(m, "n_points")}
