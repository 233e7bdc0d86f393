"""Shared helpers of the `tests/test_torch_*.py` parity tests: seeded weight
randomization (in the style of `test_torch_parity.randomize`, so that
zero-initialized gammas and MSDA heads carry signal) and the tiny
configuration both packages are built at."""

import numpy as np
import torch

# tiny ViT-Adapter + Mask2Former: 48 wide, 4 blocks, one per interaction
TINY_BACKBONE = dict(patch_size=16, embed_dim=48, depth=4, num_heads=4,
                     deform_num_heads=6, conv_inplane=16, pretrain_size=224,
                     interaction_indexes=((0, 0), (1, 1), (2, 2), (3, 3)))
TINY_HEAD = dict(num_classes=7, num_queries=5, feat_channels=64,
                 out_channels=64, num_heads=4, decoder_ffn_dim=96,
                 pixel_encoder_ffn_dim=96, pixel_encoder_heads=4)


def randomize(model: torch.nn.Module, seed: int) -> None:
    """Random port weights: norm scales and gammas near 1, everything else
    0.1 * N(0, 1); random BatchNorm statistics."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1 and (name.endswith("weight") or "gamma" in name):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.3 * torch.randn(m.running_mean.shape,
                                                       generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                     generator=g))


def randomize_flax(tree, seed: int, stats: bool = False):
    """Random flax weights in the same style: `scale` and `gamma*` leaves
    near 1, others 0.1 * N(0, 1); with `stats`, a batch_stats tree (mean
    around 0, var in [0.5, 1.5])."""
    rng = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v)
                continue
            shape = np.shape(v)
            if stats and k == "var":
                out[k] = (0.5 + rng.rand(*shape)).astype(np.float32)
            elif stats:
                out[k] = (0.3 * rng.randn(*shape)).astype(np.float32)
            elif k == "scale" or k.startswith("gamma"):
                out[k] = (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
            else:
                out[k] = (0.1 * rng.randn(*shape)).astype(np.float32)
        return out

    return walk(tree)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)
