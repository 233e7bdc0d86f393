"""AdamW with layer-wise LR decay and the poly / cosine schedules with
warmup, in plain PyTorch: layer id 0 for pos_embed / cls_token /
patch_embed, `blocks.i` -> i + 1, everything else -> num_layers - 1; lr
scale = rate ** (num_layers - id - 1) with num_layers = depth + 2; no
weight decay on 1-D parameters and pos_embed. A step clips the gradients by
their global norm (max_norm / (norm + 1e-6)), then takes PyTorch's AdamW
(its loop over the parameters, eps 1e-8) with one param group per (lr
scale, weight decay), the group's lr the scale times the schedule."""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

Schedule = Callable[[int], float]
STACKED = "pixel_decoder.encoder.layers."
# the port keeps the reference's names where the JAX package renamed a
# parameter, and the layer-decay id and the decay mask go by the JAX names:
# the Uni-Perceiver patch projection (JAX `visual_embed/proj`: no
# `patch_embed`, so scale 1) and its text position table (JAX
# `token_embed/pos_embed`: id 0 and no weight decay)
JAX_NAMES = (("visual_embed.patch_embed.proj.", "visual_embed.proj."),
             ("token_embed.embeddings_pos.position_embeddings.",
              "token_embed.pos_embed."))


def jax_name(name: str) -> str:
    """The port's parameter name as the JAX package's rules read it."""
    for ours, theirs in JAX_NAMES:
        name = name.replace(ours, theirs)
    return name


def vit_layer_id(name: str, num_layers: int) -> int:
    """A parameter name's layer-decay id (reference `get_num_layer_for_vit`);
    the port's names carry `blocks.<i>.` where JAX's carry `blocks_<i>`
    (the Uni-Perceiver trunk's `layers.<i>` take the last id in both)."""
    name = jax_name(name)
    if "pos_embed" in name or "cls_token" in name or "patch_embed" in name:
        return 0
    m = re.search(r"(?:^|\.)blocks\.(\d+)\.", name)
    if m:
        return int(m.group(1)) + 1
    return num_layers - 1


def layer_decay_scales(named_params: Iterable[Tuple[str, torch.Tensor]],
                       depth: int, decay_rate: float) -> Dict[str, float]:
    """Per-parameter multiplicative lr scale, by name."""
    num_layers = depth + 2
    return {n: decay_rate ** (num_layers - vit_layer_id(n, num_layers) - 1)
            for n, _ in named_params}


def weight_decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]
                      ) -> Dict[str, bool]:
    """True where weight decay applies: not 1-D, not pos_embed/cls_token.
    The JAX package stacks the pixel decoder's encoder layers along a new
    first axis (`nn.scan`), so their 1-D parameters are 2-D there and take
    weight decay; the port counts that axis too."""
    def ndim(n, p):
        return p.dim() + (STACKED in n)

    return {n: (ndim(n, p) > 1 and "pos_embed" not in jax_name(n)
                and "cls_token" not in n) for n, p in named_params}


def poly_schedule_with_warmup(base_lr: float, total_steps: int,
                              warmup_steps: int = 1500,
                              warmup_ratio: float = 1e-6,
                              power: float = 1.0,
                              min_lr: float = 0.0) -> Schedule:
    """mmcv poly policy: linear warmup, then (1 - t / T) ** power decay."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (warmup_ratio + (1 - warmup_ratio)
                              * step / max(warmup_steps, 1))
        t = min(max((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return (base_lr - min_lr) * (1 - t) ** power + min_lr

    return schedule


def cosine_schedule_with_warmup(base_lr: float, total_steps: int,
                                warmup_steps: int = 0,
                                final_lr: float = 0.0,
                                start_warmup_lr: float = 0.0) -> Schedule:
    """Half-cosine decay with linear warmup (reference `cosine_scheduler`)."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return start_warmup_lr + (base_lr - start_warmup_lr) * (
                step / max(warmup_steps, 1))
        t = min(max((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return final_lr + 0.5 * (base_lr - final_lr) * (1 + math.cos(
            math.pi * t))

    return schedule


@dataclasses.dataclass
class LayerDecayAdamW:
    adamw: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR
    grad_clip: Optional[float] = None

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, update, advance the schedule; returns the global norm of
        the gradients before clipping."""
        params = [p for g in self.adamw.param_groups for p in g["params"]]
        grads = [p.grad for p in params if p.grad is not None]
        norm = torch.stack([g.float().norm() for g in grads]).square() \
            .sum().sqrt()
        clip = math.inf if self.grad_clip is None else self.grad_clip
        coef = (clip / (norm + 1e-6)).clamp(max=1.0)
        for g in grads:
            g.mul_(coef)
        self.adamw.step()
        self.scheduler.step()
        return norm


def make_optimizer(
    model: nn.Module,
    base_lr: float = 12e-5,
    weight_decay: float = 0.01,
    depth: int = 12,
    layer_decay_rate: float = 0.95,
    total_steps: int = 160_000,
    warmup_steps: int = 1500,
    grad_clip: Optional[float] = None,
    b1: float = 0.9,
    b2: float = 0.999,
    lr_policy: str = "poly",
) -> Tuple[LayerDecayAdamW, Schedule]:
    """AdamW + layer decay + poly/cosine schedule over the model's
    parameters: one param group per (lr scale, weight decay) pair, the fused
    update as PyTorch's per-parameter loop. Returns (optimizer,
    schedule)."""
    if lr_policy == "cosine":
        schedule = cosine_schedule_with_warmup(base_lr, total_steps,
                                               warmup_steps)
    else:
        schedule = poly_schedule_with_warmup(base_lr, total_steps,
                                             warmup_steps)
    named = list(model.named_parameters())
    scales = layer_decay_scales(named, depth, layer_decay_rate)
    decay = weight_decay_mask(named)
    groups: Dict[Tuple[float, float], list] = {}
    for n, p in named:
        key = (scales[n], weight_decay if decay[n] else 0.0)
        groups.setdefault(key, []).append(p)
    param_groups = [dict(params=ps, lr=s, weight_decay=wd)
                    for (s, wd), ps in groups.items()]
    adamw = torch.optim.AdamW(param_groups, betas=(b1, b2), eps=1e-8,
                              foreach=False, fused=False)
    scheduler = torch.optim.lr_scheduler.LambdaLR(adamw, schedule)
    return LayerDecayAdamW(adamw, scheduler, grad_clip), schedule
