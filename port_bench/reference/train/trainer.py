"""The Mask2Former and UperNet train steps in plain PyTorch: the model's
forward in training mode (DropPath and dropout drawing from a
`torch.Generator`, BatchNorm on batch statistics), the loss, the backward
and one optimizer update, in place.

step(optimizer, batch, generator) -> logs: batch {"image": (B, H, W, 3)
normalized float, "label": (B, H, W) int, 255 = ignore}; logs holds
`loss` and `grad_norm` (before clipping) as 0-d tensors. The Mask2Former
step takes `assign` and `points`, matches and uncertain points to follow
(see `mask2former_loss`), and logs `match_gap`, `point_gap` and the
matches and points it followed."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from port_bench.reference.heads.mask2former_loss import mask2former_loss
from port_bench.reference.models.segmentor import segmentation_loss
from port_bench.reference.ops.point_sample import uniform_sampler


def make_m2f_train_step(model: nn.Module, num_classes: int,
                        max_instances: int = 60,
                        num_points: int = 12544) -> Callable:
    def step(optimizer, batch, generator: torch.Generator, assign=None,
             points=None):
        model.train()
        cls_list, mask_list = model(batch["image"], generator=generator)
        loss, logs = mask2former_loss(
            uniform_sampler(generator), cls_list, mask_list, batch["label"],
            num_classes=num_classes, max_instances=max_instances,
            num_points=num_points, assign=assign, points=points)
        optimizer.zero_grad()
        loss.backward()
        return {"loss": loss.detach(), "grad_norm": optimizer.step(),
                "match_gap": logs["match_gap"], "assign": logs["assign"],
                "point_gap": logs["point_gap"], "points": logs["points"],
                "cost": logs["cost"], "n_valid": logs["n_valid"]}

    return step


def make_seg_train_step(model: nn.Module, aux_weight: float = 0.4,
                        ignore_index: int = 255) -> Callable:
    def step(optimizer, batch, generator: torch.Generator):
        model.train()
        logits, aux = model(batch["image"], with_aux=True,
                            generator=generator)
        loss, _ = segmentation_loss(logits, aux, batch["label"], aux_weight,
                                    ignore_index)
        optimizer.zero_grad()
        loss.backward()
        return {"loss": loss.detach(), "grad_norm": optimizer.step()}

    return step
