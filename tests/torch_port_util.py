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


# the tiny model's train settings: no stochastic depth (JAX's dropout bits
# cannot be replayed in torch), few points; the whole-step test cuts the
# trunk to 2 blocks (one per interaction) and the decoder to 2 layers (3
# outputs), which keeps JAX's compile of the step short
TINY_TRAIN = dict(num_points=64, max_instances=60)
TINY_TRAIN_BACKBONE = dict(TINY_BACKBONE, depth=2,
                           interaction_indexes=((0, 0), (1, 1)))
TINY_TRAIN_HEAD = dict(TINY_HEAD, num_decoder_layers=2)


def jax_loss_draws(rng, n_layers: int, B: int, Q: int, num_points: int,
                   oversample_ratio: float = 3.0,
                   importance_sample_ratio: float = 0.75):
    """The uniform draws `vitadapter.heads.mask2former_loss.mask2former_loss`
    makes from `rng`, in the order the port's loss asks its sampler for
    them: the assignment points of all layers (key split of
    `mask2former_loss.py:266`), then per layer the oversampled pool and the
    fresh points (`:160` and `point_sample.py:92-93, :109`)."""
    import jax

    rngs = jax.random.split(rng, n_layers + 1)
    draws = [jax.random.uniform(rngs[-1], (n_layers, B, num_points, 2))]
    n_sampled = int(num_points * oversample_ratio)
    n_random = num_points - int(importance_sample_ratio * num_points)
    for i in range(n_layers):
        _, r_pts = jax.random.split(rngs[i])
        r1, r2 = jax.random.split(r_pts)
        draws.append(jax.random.uniform(r1, (B * Q, n_sampled, 2)))
        if n_random > 0:
            draws.append(jax.random.uniform(r2, (B * Q, n_random, 2)))
    return [np.asarray(d) for d in draws]


class ReplaySampler:
    """A loss sampler that hands out given draws in order, checking each
    shape, and must be used up."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, shape):
        d = self.draws.pop(0)
        assert tuple(d.shape) == tuple(shape), (d.shape, shape)
        return torch.from_numpy(np.array(d, np.float32))

    def done(self) -> bool:
        return not self.draws
