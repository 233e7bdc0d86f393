"""Greedy non-maximum suppression: the Hopper kernel's wrapper and its plain
version, with the IoU both compute.

Counterpart of the `lax.scan` in `vitadapter/det/boxes.py::nms`, which is
not a Pallas kernel: in PyTorch a loop over the boxes would launch kernels
per box. The kernel is `csrc/nms.cu` (an IoU > thr bitmask in 64-box tiles,
then one block's walk over the tiles, their rows of bits staged in shared
memory ahead of the walk in chunks that `walk_plan` sizes).
`nms_keep(boxes, finite, iou_thr)` takes boxes already in score order and
returns which are kept: box i when
`finite[i]` and no earlier kept box overlaps it by IoU > `iou_thr`. The
kernel and the plain version compute the IoU with the same roundings, so
their kept sets are equal, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from vitadapter_torch.ops import cuda_ext

MAX_BOXES = 64 * 1024      # the walk keeps 1024 words of bits in shared memory
TILE = 64                  # boxes a word of bits covers
WALK_MAX_CHUNK = 128       # words of a tile's rows staged at once
WALK_MAX_STAGES = 4        # chunks in the walk's ring
# the ring's shared memory: a CTA's 227 KB less the removed bits (8 KB),
# the 8 warps' partials of a chunk and 1 KB
WALK_SMEM = 232448 - 8 * 1024 - 8 * WALK_MAX_CHUNK * 8 - 1024


def walk_plan(n: int):
    """(words, pitch, chunk, stages) of the kernel over n boxes: words of
    64 boxes; the bit matrix's rows `pitch` words apart (words rounded up
    to even, so each row starts on 16 bytes); each tile's rows staged from
    its diagonal word on in chunks of `chunk` words (a staged row holds
    `chunk` plus 2 rounded up to even: its copy starts on an even word),
    `stages` chunks in the ring (as many as fit, at most 4)."""
    words = -(-n // TILE)
    chunk = max(min(words, WALK_MAX_CHUNK), 1)
    stride = (chunk + 3) & ~1
    stages = min(WALK_MAX_STAGES, WALK_SMEM // (TILE * stride * 8))
    return words, words + words % 2, chunk, stages


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    return ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))


def bbox_overlaps(a: torch.Tensor, b: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """IoU matrix (..., N, M) of xyxy boxes (mmdet `bbox_overlaps`)."""
    w = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
         - torch.maximum(a[..., :, None, 0], b[..., None, :, 0])).clamp(min=0)
    h = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
         - torch.maximum(a[..., :, None, 1], b[..., None, :, 1])).clamp(min=0)
    inter = w * h
    union = bbox_area(a)[..., :, None] + bbox_area(b)[..., None, :] - inter
    return inter / union.clamp(min=eps)


def nms_keep_plain(boxes: torch.Tensor, finite: torch.Tensor,
                   iou_thr: float) -> torch.Tensor:
    """The JAX scan on the host: walk the boxes in order, keep a live one
    and suppress every box it overlaps by IoU > iou_thr. Returns (N,) bool
    on the boxes' device."""
    over = (bbox_overlaps(boxes, boxes) > iou_thr).cpu().numpy()
    live = finite.cpu().numpy().astype(bool)
    suppressed = np.zeros(len(live), bool)
    keep = np.zeros(len(live), bool)
    for i in range(len(live)):
        if live[i] and not suppressed[i]:
            keep[i] = True
            suppressed |= over[i]
    return torch.from_numpy(keep).to(boxes.device)


def _kernel_keep(boxes: torch.Tensor, finite: torch.Tensor,
                 iou_thr: float) -> torch.Tensor:
    N = boxes.shape[0]
    if boxes.dtype != torch.float32 or tuple(boxes.shape) != (N, 4):
        raise ValueError(f"boxes: {tuple(boxes.shape)} {boxes.dtype}; the "
                         "kernel takes (N, 4) fp32")
    if N > MAX_BOXES:
        raise ValueError(f"{N} boxes; the kernel takes at most {MAX_BOXES}")
    if finite.shape != (N,) or finite.device != boxes.device:
        raise ValueError("finite must be (N,) on the boxes' device")
    boxes = boxes.contiguous()
    flags = finite.to(torch.uint8).contiguous()
    _, pitch, chunk, stages = walk_plan(N)
    mask = torch.empty(N * pitch, dtype=torch.int64, device=boxes.device)
    keep = torch.empty(N, dtype=torch.uint8, device=boxes.device)
    cuda_ext.launch("nms", boxes.device, boxes.data_ptr(), flags.data_ptr(),
                    mask.data_ptr(), keep.data_ptr(), N, float(iou_thr),
                    chunk, stages)
    return keep.bool()


def nms_keep(boxes: torch.Tensor, finite: torch.Tensor,
             iou_thr: float) -> torch.Tensor:
    """Kept flags (N,) of score-ordered boxes (N, 4): the plain version on
    CPU tensors, the kernel on CUDA tensors (or raise)."""
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, finite, iou_thr)
    return _kernel_keep(boxes, finite, iou_thr)
