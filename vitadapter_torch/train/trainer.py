"""Training state and the Mask2Former, UperNet and detector train steps
(counterpart of `vitadapter/train/trainer.py` and of the step in
`vitadapter/train/det_loop.py`).

One step: the model's forward in training mode (DropPath and dropout
drawing from a `torch.Generator`, BatchNorm on batch statistics, moving its
running statistics), the loss (Mask2Former's over every decoder layer, the
decode and auxiliary heads' cross entropy, or a detector's), the
backward, and one optimizer update. The port updates the model and the optimizer in
place, where JAX returns a new state.

Under a process group of several ranks (`parallel/`), each rank's step
takes its share of the global batch: the loss normalizers count over the
global batch (`parallel.global_normalizer`), BatchNorm is SyncBN, the
optimizer averages the gradients before it clips them, and the logs are
the ranks' mean, so that W ranks take the step JAX takes on a W-device
mesh. The `generator` a step is given on rank r is seeded from (seed,
rank) by the loop (`parallel.rank_generator`): DropPath, dropout, the
loss's point draws and DINO's denoising draws are independent across the
ranks, as across the images of JAX's global batch. Under a (data, model)
grid (`parallel/tp.py`) the same step runs on a split model: "the ranks"
above are then the data group's, and the ranks of a model group hold
the same images and draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from vitadapter_torch.heads.mask2former_loss import mask2former_loss
from vitadapter_torch.models.segmentor import segmentation_loss
from vitadapter_torch.ops.point_sample import Sampler, uniform_sampler
from vitadapter_torch.parallel.collectives import all_reduce_dict
from vitadapter_torch.parallel.mesh import data_group
from vitadapter_torch.train.optim import LayerDecayAdamW


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the number of steps taken and optional
    EMA parameters (the reference's wsdm training keeps EMA weights)."""
    model: nn.Module
    optimizer: LayerDecayAdamW
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema_decay: float = 0.0

    @classmethod
    def create(cls, model: nn.Module, optimizer: LayerDecayAdamW,
               ema_decay: float = 0.0) -> "TrainState":
        ema = None
        if ema_decay > 0:
            ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        return cls(model=model, optimizer=optimizer, ema_params=ema,
                   ema_decay=ema_decay)

    @torch.no_grad()
    def update_ema(self) -> None:
        if self.ema_params is None:
            return
        d = self.ema_decay
        for n, p in self.model.named_parameters():
            e = self.ema_params[n]
            e.copy_(d * e + (1 - d) * p)


def make_m2f_train_step(model: nn.Module, num_classes: int,
                        max_instances: int = 60,
                        num_points: int = 12544) -> Callable:
    """Train step for `EncoderDecoderMask2Former`: per-layer
    Hungarian-matched cls and point-sampled mask/dice losses (reference
    `Mask2FormerHead.loss`).

    train_step(state, batch, generator, sampler=None) -> (state, logs):
    batch {"image": (B, H, W, 3) normalized float, "label": (B, H, W) int,
    255 = ignore}. DropPath draws from `generator`; the loss's points from
    `sampler` (by default uniform draws from `generator`). logs holds
    `loss`, `grad_norm` (before clipping) and the last layer's `loss_cls`,
    `loss_mask` and `loss_dice`, as 0-d tensors."""

    def train_step(state: TrainState, batch, generator: torch.Generator,
                   sampler: Optional[Sampler] = None):
        if sampler is None:
            sampler = uniform_sampler(generator)
        model.train()
        cls_list, mask_list = model(batch["image"], generator=generator)
        loss, logs = mask2former_loss(
            sampler, cls_list, mask_list, batch["label"],
            num_classes=num_classes, max_instances=max_instances,
            num_points=num_points)
        state.optimizer.zero_grad()
        loss.backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        state.update_ema()
        logs = all_reduce_dict({**{k: v.detach() for k, v in logs.items()
                                   if not k.startswith("d")},
                                "loss": loss.detach()}, data_group())
        logs["grad_norm"] = grad_norm
        return state, logs

    return train_step


def make_seg_train_step(model: nn.Module, aux_weight: float = 0.4,
                        ignore_index: int = 255) -> Callable:
    """Train step for `EncoderDecoder` (UperNet): the decode head's cross
    entropy plus `aux_weight` times the auxiliary head's
    (`segmentation_loss`), pixels labelled `ignore_index` left out.

    train_step(state, batch, generator) -> (state, logs): batch {"image":
    (B, H, W, 3) normalized float, "label": (B, H, W) int}. DropPath and
    dropout draw from `generator`. logs holds `loss_decode`, `loss_aux`,
    `loss` and `grad_norm` (before clipping), as 0-d tensors."""

    def train_step(state: TrainState, batch, generator: torch.Generator):
        model.train()
        logits, aux = model(batch["image"], with_aux=True,
                            generator=generator)
        loss, logs = segmentation_loss(logits, aux, batch["label"],
                                       aux_weight, ignore_index)
        state.optimizer.zero_grad()
        loss.backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        state.update_ema()
        logs = all_reduce_dict({**{k: v.detach() for k, v in logs.items()},
                                "loss": loss.detach()}, data_group())
        logs["grad_norm"] = grad_norm
        return state, logs

    return train_step


def det_losses(model: nn.Module, batch, generator: torch.Generator,
               sampler: Optional[Sampler] = None, **kw):
    """A detector's `forward_train` on a batch: `GroundingDINO` takes the
    text (`refer`, `r_mask`); `DINO`, `ATSS` and `SparseRCNN` the boxes
    alone; Mask R-CNN and Cascade Mask R-CNN the masks and the `sampler`;
    `kw` go to the DINO detectors (`dn_draws`, `assigner`) and Sparse
    R-CNN (`assigner`)."""
    if "refer" in batch:
        return model.forward_train(
            batch["image"], batch["refer"], batch["r_mask"],
            batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"],
            generator=generator, **kw)
    if "gt_masks" not in batch:
        return model.forward_train(batch["image"], batch["gt_boxes"],
                                   batch["gt_labels"], batch["gt_valid"],
                                   generator=generator, **kw)
    return model.forward_train(
        batch["image"], batch["gt_boxes"], batch["gt_labels"],
        batch["gt_masks"], batch["gt_valid"], generator=generator,
        sampler=sampler)


def make_det_train_step(model: nn.Module) -> Callable:
    """Train step for a detector's `forward_train` (`det.mask_rcnn.MaskRCNN`,
    `det.cascade.CascadeRCNN`, `det.single_stage.ATSS`,
    `det.sparse_rcnn.SparseRCNN`, `det.dino_detector.DINO`,
    `det.grounding_dino.GroundingDINO`): the sum of its losses.

    train_step(state, batch, generator, sampler=None, **kw) -> (state,
    logs): batch {"image": (B, H, W, 3) normalized float, "gt_boxes" (B, G,
    4), "gt_labels" (B, G) int, "gt_valid" (B, G) bool, and "gt_masks" (B,
    G, H, W) bool for the R-CNNs or "refer"/"r_mask" (B, T) for
    GroundingDINO}. DropPath (and DINO's denoising noise) draws from
    `generator`, the RPN and RoI samplers from `sampler` (by default from
    `generator`); `kw` go to a DINO or Sparse R-CNN detector's
    `forward_train`. A parameter
    that no loss reaches (HTC's semantic logits, which take no loss; a cls
    token the detection BEiT does not use; the adapter's `up` where the
    grounding configs return strides 8-32 only) gets a zero gradient, as
    JAX's `value_and_grad` gives it, so that AdamW decays it as optax
    does. logs holds the losses, `loss` and `grad_norm` (before clipping),
    as 0-d tensors."""

    def train_step(state: TrainState, batch, generator: torch.Generator,
                   sampler: Optional[Sampler] = None, **kw):
        model.train()
        losses = det_losses(model, batch, generator, sampler, **kw)
        state.optimizer.zero_grad()
        losses["loss"].backward()
        for p in model.parameters():
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
        grad_norm = state.optimizer.step()
        state.step += 1
        state.update_ema()
        logs = all_reduce_dict({k: v.detach() for k, v in losses.items()},
                               data_group())
        logs["grad_norm"] = grad_norm
        return state, logs

    return train_step
