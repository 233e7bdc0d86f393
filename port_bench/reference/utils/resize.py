"""Torch-exact separable resizing as two matrix contractions (counterpart
of `vitadapter/utils/resize.py`).

`F.interpolate(mode='bicubic'|'bilinear', align_corners=False)` samples at
half-pixel centres with a cubic kernel a = -0.75 and clamped borders. The
1-D interpolation matrices are built on the host (numpy) and applied as two
contractions, exactly as the JAX package does, so both packages round alike.
"""

from functools import lru_cache

import numpy as np
import torch


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    return np.where(
        at <= 1.0,
        (a + 2) * at**3 - (a + 3) * at**2 + 1,
        np.where(at < 2.0, a * (at**3 - 5 * at**2 + 8 * at - 4), 0.0),
    )


def _linear_kernel(t: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(t))


@lru_cache(maxsize=256)
def resize_matrix(n_in: int, n_out: int, method: str = "bilinear") -> np.ndarray:
    """(n_out, n_in) interpolation matrix, half-pixel centres, clamped
    borders. Cached: do not write to the result."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    scale = n_in / n_out
    if method == "nearest":
        # torch F.interpolate(mode='nearest'): src = floor(dst * in/out)
        M = np.zeros((n_out, n_in), dtype=np.float64)
        idx = np.minimum((np.arange(n_out) * scale).astype(np.int64),
                         n_in - 1)
        M[np.arange(n_out), idx] = 1.0
        return M.astype(np.float32)
    centers = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    base = np.floor(centers).astype(np.int64)
    M = np.zeros((n_out, n_in), dtype=np.float64)
    if method == "bicubic":
        taps, kern = range(-1, 3), _cubic_kernel
    elif method == "bilinear":
        taps, kern = range(0, 2), _linear_kernel
    else:
        raise ValueError(method)
    rows = np.arange(n_out)
    for k in taps:
        idx = np.clip(base + k, 0, n_in - 1)
        w = kern(centers - (base + k))
        np.add.at(M, (rows, idx), w)
    return M.astype(np.float32)


def _matrix(n_in: int, n_out: int, method: str, like: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(resize_matrix(n_in, n_out, method)).to(
        device=like.device, dtype=dtype)


def resize_2d(x: torch.Tensor, out_hw, method: str = "bilinear") -> torch.Tensor:
    """Resize channels-last (..., H, W, C) maps to (..., H', W', C)."""
    H, W = x.shape[-3], x.shape[-2]
    Ho, Wo = out_hw
    if (H, W) == (Ho, Wo):
        return x
    if x.dtype == torch.bfloat16:
        # bf16 maps stay bf16, with bf16 tap weights (as the JAX package)
        mh = _matrix(H, Ho, method, x, x.dtype)
        mw = _matrix(W, Wo, method, x, x.dtype)
        y = torch.einsum("oh,...hwc->...owc", mh, x)
        return torch.einsum("ow,...hwc->...hoc", mw, y)
    mh = _matrix(H, Ho, method, x, torch.float32)
    mw = _matrix(W, Wo, method, x, torch.float32)
    y = torch.einsum("oh,...hwc->...owc", mh, x.float())
    y = torch.einsum("ow,...hwc->...hoc", mw, y)
    return y.to(x.dtype)


def resize_hw(x: torch.Tensor, out_hw, method: str = "bilinear") -> torch.Tensor:
    """Resize channel-free (..., H, W) maps (masks, logit fields), in fp32,
    returning x's dtype."""
    H, W = x.shape[-2], x.shape[-1]
    Ho, Wo = out_hw
    if (H, W) == (Ho, Wo):
        return x
    mh = _matrix(H, Ho, method, x, torch.float32)
    mw = _matrix(W, Wo, method, x, torch.float32)
    y = torch.einsum("oh,...hw->...ow", mh, x.float())
    y = torch.einsum("ow,...hw->...ho", mw, y)
    return y.to(x.dtype)
