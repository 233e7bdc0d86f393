"""Image preprocessing (counterpart of `vitadapter/data/preprocess.py`).

Normalization constants match the reference `img_norm_cfg`: ImageNet
mean/std, RGB.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def normalize(img: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8/float RGB NHWC -> normalized float, computed in fp32."""
    m = torch.tensor(mean, dtype=torch.float32, device=img.device)
    s = torch.tensor(std, dtype=torch.float32, device=img.device)
    return ((img.float() - m) / s).to(dtype)


def pad_to_multiple(img: torch.Tensor, divisor: int = 32,
                    value: float = 0.0) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Pad NHWC H, W up to a multiple of divisor. Returns (img, (H, W))."""
    B, H, W, C = img.shape
    Hp = -(-H // divisor) * divisor
    Wp = -(-W // divisor) * divisor
    if (Hp, Wp) != (H, W):
        img = F.pad(img, (0, 0, 0, Wp - W, 0, Hp - H), value=value)
    return img, (H, W)
