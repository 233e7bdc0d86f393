"""Reference-checkpoint conversion (counterpart of the JAX package's
`tools/convert_checkpoint.py` and `utils/checkpoint.py::
resample_rel_pos_table`).

The port keeps the reference's key names, so converting a reference
checkpoint takes four steps (`convert_state_dict`): unwrap it
(`utils/checkpoint_io.py::unwrap_state_dict`), keep its EMA weights
(`strip_ema`), map an official Uni-Perceiver release's names
(`remap_uniperceiver_keys`), and resample each BEiT relative-position table
to the target grid (`resample_rel_pos_table`).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from vitadapter_torch.utils.checkpoint_io import unwrap_state_dict

KINDS = ("segmentor", "backbone", "uniperceiver")
BEIT_MARK = "backbone.blocks.0.attn.q_bias"
REL_TABLE = re.compile(r"^backbone\.blocks\.\d+\.attn\."
                       r"relative_position_bias_table$")


def remap_uniperceiver_keys(sd: Dict[str, Any]) -> Dict[str, Any]:
    """An official Uni-Perceiver release's names -> the reference model's:
    `fused_encoder.` -> `layers.`, `in_proj_weight`/`in_proj_bias` ->
    `in_proj.weight`/`in_proj.bias`, `video_embed` -> `visual_embed`."""
    out = {}
    for k, v in sd.items():
        k = k.replace("fused_encoder.", "layers.")
        k = k.replace("in_proj_weight", "in_proj.weight")
        k = k.replace("in_proj_bias", "in_proj.bias")
        k = k.replace("video_embed", "visual_embed")
        out[k] = v
    return out


def strip_ema(sd: Dict[str, Any]) -> Dict[str, Any]:
    """The bare entries, each replaced by its EMA copy where the dict holds
    one; the `ema_`, optimizer and meta entries dropped.

    An EMA hook (mmcv's `EMAHook`) stores the average of parameter `a.b_c`
    as `ema_a_b_c` beside it and keeps the buffers (BatchNorm's running
    statistics) under their bare names alone. The JAX package's `strip_ema`
    keeps only the `ema_` entries, named back by turning every `_` into `.`,
    which mangles any name holding an underscore (`cls_token`, `q_bias`)
    and loses the buffers; here each bare entry looks up its own copy."""
    return {k: sd.get("ema_" + k.replace(".", "_"), v) for k, v in sd.items()
            if not k.startswith(("ema_", "optimizer", "meta"))}


def resample_rel_pos_table(table: np.ndarray, src_grid: int, dst_grid: int,
                           n_extra: int = 3) -> np.ndarray:
    """Geometric-progression cubic resampling of a BEiT relative-position
    bias table ((2g-1)^2 + n_extra, heads) from grid g=src to g=dst.

    Reproduces the reference loader (`detection/mmcv_custom/checkpoint.py:
    396-445`): source coordinates follow a geometric progression (binary
    search for ratio q so the cumulative span reaches the target
    half-window), then per-head bicubic interpolation on the non-uniform
    grid; the n_extra cls entries are carried over unchanged."""
    from scipy import interpolate

    if src_grid == dst_grid:
        return table
    src = 2 * src_grid - 1
    dst = 2 * dst_grid - 1
    heads = table.shape[1]
    extra = table[src * src:]
    body = table[: src * src]

    def geometric_positions(size, target):
        # find q with sum_{i=1..size//2} q^i == target (reference binary
        # search)
        left, right = 1.01, 1.5
        while right - left > 1e-6:
            q = (left + right) / 2.0
            gp = (q ** np.arange(1, size // 2 + 1)).sum()
            if gp > target:
                right = q
            else:
                left = q
        q = (left + right) / 2.0
        dis = np.cumsum(q ** np.arange(1, size // 2 + 1))
        return np.concatenate([-dis[::-1], [0.0], dis])

    x = geometric_positions(src, dst // 2.0)
    t = dst // 2.0
    dx = np.arange(-t, t + 0.1, 1.0)
    out = np.zeros((dst * dst, heads), np.float32)
    for h in range(heads):
        z = body[:, h].reshape(src, src).astype(np.float64)
        f = interpolate.RectBivariateSpline(x, x, z, kx=3, ky=3)
        out[:, h] = f(dx, dx).reshape(-1).astype(np.float32)
    return np.concatenate([out, extra], axis=0)


def resample_table_to(table: torch.Tensor, target_grid: int) -> torch.Tensor:
    """One BEiT table to `target_grid`, its grid and cls entries read off
    its length as the JAX converter reads them."""
    t = table.detach().cpu().float().numpy()
    n = t.shape[0]
    n_extra = 3 if int(np.sqrt(n - 3)) ** 2 == n - 3 else 0
    src_grid = (int(np.sqrt(n - n_extra)) + 1) // 2
    return torch.from_numpy(np.ascontiguousarray(
        resample_rel_pos_table(t, src_grid, target_grid, n_extra)))


def convert_state_dict(ckpt, kind: str = "segmentor",
                       target_grid: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
    """A reference checkpoint -> the port's `state_dict`: unwrapped, the
    EMA weights kept, a Uni-Perceiver release's names mapped (`kind`
    "uniperceiver"), and a segmentor's BEiT tables resampled to
    `target_grid` (as the JAX script's `--target-grid`, which only its
    segmentor conversion reads)."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: one of {KINDS}")
    sd = strip_ema(unwrap_state_dict(ckpt))
    if kind == "uniperceiver":
        sd = remap_uniperceiver_keys(sd)
    if kind == "segmentor" and target_grid is not None and BEIT_MARK in sd:
        sd = {k: (resample_table_to(v, target_grid) if REL_TABLE.match(k)
                  else v) for k, v in sd.items()}
    return {k: torch.as_tensor(v) for k, v in sd.items()
            if isinstance(v, (torch.Tensor, np.ndarray))}
