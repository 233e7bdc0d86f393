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


# the tiny Mask R-CNN of `tests/test_mask_rcnn.py`, windowed: 48 wide,
# depth 4, 3-token windows on 2 of the 4 blocks; on a 64x96 image the 4x6
# token grid pads to 6x6
DET_BACKBONE = dict(patch_size=16, embed_dim=48, depth=4, num_heads=4,
                    deform_num_heads=4, conv_inplane=16,
                    interaction_indexes=((0, 0), (1, 1), (2, 2), (3, 3)),
                    window_attn=(True, False, True, False),
                    window_size=(3, None, 3, None))
DET_HEADS = dict(num_classes=5, fpn_channels=32, num_proposals_test=50,
                 num_proposals_train=50, num_roi_samples=16, max_dets=10)
DET_HW = (64, 96)


def assert_close(got, want, tol=2e-4, msg=""):
    """Within `tol` of the reference's scale (its largest |value|)."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (msg, err, scale)


def flax_variables(module, x, seed, **kw):
    """Random flax variables of `module` (shapes by `jax.eval_shape`, so
    nothing is compiled; values as `randomize_flax`), the class, box and
    mask logits' layers scaled by 0.1 so that softmax and sigmoid do not
    saturate."""
    import jax

    shapes = jax.eval_shape(lambda x: module.init(jax.random.PRNGKey(0), x,
                                                  **kw), x)
    p = randomize_flax(shapes["params"], seed)
    for head, layer in (("bbox_head", "fc_cls"), ("bbox_head", "fc_reg"),
                        ("mask_head", "conv_logits")):
        if head in p:
            p[head][layer]["kernel"] = p[head][layer]["kernel"] * 0.1
    s = randomize_flax(shapes.get("batch_stats", {}), seed + 1, stats=True)
    return {"params": p, "batch_stats": s}


def port_like(module, v):
    """A port module built on meta, allocated on the CPU and loaded with
    the flax variables `v`, in eval mode."""
    from vitadapter_torch.utils.init import init_weights
    from vitadapter_torch.utils.weights import load_flax

    module = init_weights(module.to_empty(device="cpu"),
                          torch.Generator().manual_seed(0)).eval()
    return load_flax(module, v["params"], v["batch_stats"])


def nms_margin(boxes, scores, thr):
    """(smallest |IoU - thr| over the pairs of finite-score boxes, smallest
    score gap of two finite-score boxes that overlap by IoU > thr / 2): the
    margins by which float noise cannot flip an NMS over these boxes (the
    order of boxes that cannot suppress each other does not matter)."""
    from vitadapter_torch.ops.nms import bbox_overlaps

    boxes, scores = np.asarray(boxes), np.asarray(scores)
    fin = np.isfinite(scores)
    b = torch.from_numpy(boxes[fin].astype(np.float32))
    s = scores[fin]
    iou = bbox_overlaps(b, b).numpy()
    i, j = np.triu_indices(len(b), 1)
    near = iou[i, j] > thr / 2
    return (float(np.abs(iou[i, j] - thr).min()) if len(i) else np.inf,
            float(np.abs(s[i] - s[j])[near].min()) if near.any() else np.inf)


def proposal_margins(cls_out, reg_out, anchors, img_hw, nms_pre=1000,
                     iou_thr=0.7, max_per_img=50):
    """The margins of `det.rpn.get_proposals` on these RPN outputs (per
    level (B, H, W, A) logits and (B, H, W, 4A) deltas, numpy or torch):
    the smallest gap at a level's top-k cut; the smallest |IoU - thr| and
    the smallest logit gap of two overlapping candidates (`nms_margin`:
    the NMS's decisions); and the smallest logit gap of two kept
    proposals (their order, which pairs the sampler's draws with them),
    each over the images. The NMS orders by the sigmoid of the logits, a
    monotone map."""
    from vitadapter_torch.det.boxes import RPN_STDS, delta2bbox
    from vitadapter_torch.det.rpn import get_proposals

    cls_out = [to_np(c) for c in cls_out]
    reg_out = [to_np(r) for r in reg_out]
    cut, iou_gap, logit_gap = np.inf, np.inf, np.inf
    for b in range(cls_out[0].shape[0]):
        cand_b, cand_s = [], []
        for c, r, a in zip(cls_out, reg_out, anchors):
            s = c[b].reshape(-1)
            order = np.argsort(-s, kind="stable")[:nms_pre]
            if len(s) > nms_pre:
                cut = min(cut, float(s[order[-1]]
                                     - np.sort(s)[::-1][nms_pre]))
            d = torch.from_numpy(r[b].reshape(-1, 4)[order])
            cand_b.append(to_np(delta2bbox(torch.as_tensor(a)[order], d,
                                           RPN_STDS, img_hw)))
            cand_s.append(s[order])
        i, g = nms_margin(np.concatenate(cand_b), np.concatenate(cand_s),
                          iou_thr)
        iou_gap, logit_gap = min(iou_gap, i), min(logit_gap, g)
    _, scores, valid = get_proposals(
        [torch.from_numpy(c) for c in cls_out],
        [torch.from_numpy(r) for r in reg_out],
        [torch.as_tensor(a) for a in anchors], img_hw,
        max_per_img=max_per_img)
    kept = min(float(np.diff(np.sort(np.log(s / (1 - s)))).min())
               for s, v in zip(to_np(scores).astype(np.float64),
                               valid.numpy()) for s in [s[v]])
    return cut, iou_gap, logit_gap, kept


COCO_CATEGORIES = (1, 3, 7)


def write_coco(root, sizes, seed=0):
    """A COCO-layout dataset under `root` (`train2017`/`val2017` images,
    `annotations/instances_{train,val}2017.json`, the same images in both
    splits): on each image three polygon instances of categories 1, 3 and
    7, one instance as compressed RLE (a crowd region on odd images), one
    `ignore` annotation and one under a pixel wide (both dropped by the
    dataset); the last image has no annotation (left out of training).
    Returns the JSON's path of each split."""
    import json
    import os

    from PIL import Image

    from vitadapter_torch.data.coco import encode_rle

    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    images, anns = [], []
    for split in ("train2017", "val2017"):
        os.makedirs(os.path.join(root, split), exist_ok=True)
    for i, (h, w) in enumerate(sizes):
        name = f"{i:012d}.png"
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for split in ("train2017", "val2017"):
            Image.fromarray(img).save(os.path.join(root, split, name))
        images.append({"id": i + 1, "file_name": name, "height": h,
                       "width": w})
        if i == len(sizes) - 1:
            continue
        for k, cat in enumerate(COCO_CATEGORIES):
            x, y = rs.rand() * w * 0.5, rs.rand() * h * 0.5
            bw, bh = 6 + rs.rand() * w * 0.4, 6 + rs.rand() * h * 0.4
            poly = [x, y, x + bw, y + 0.3 * bh, x + 0.7 * bw, y + bh,
                    x, y + bh]
            anns.append({"image_id": i + 1, "category_id": cat,
                         "bbox": [x, y, bw, bh], "area": 0.8 * bw * bh,
                         "iscrowd": 0, "segmentation": [poly]})
        m = np.zeros((h, w), np.uint8)
        m[h // 4:h // 2 + 3, w // 5:w // 2] = 1
        anns.append({"image_id": i + 1, "category_id": 3,
                     "bbox": [w // 5, h // 4, w // 2 - w // 5,
                              h // 2 + 3 - h // 4],
                     "area": float(m.sum()), "iscrowd": i % 2,
                     "segmentation": encode_rle(m)})
        anns.append({"image_id": i + 1, "category_id": 1, "ignore": 1,
                     "bbox": [1, 1, 9, 9], "area": 81.0, "iscrowd": 0,
                     "segmentation": [[1, 1, 10, 1, 10, 10]]})
        anns.append({"image_id": i + 1, "category_id": 7,
                     "bbox": [3, 3, 0.5, 9], "area": 4.5, "iscrowd": 0,
                     "segmentation": [[3, 3, 3.5, 3, 3.5, 12]]})
    for k, a in enumerate(anns):
        a["id"] = k + 1
    cats = [{"id": c, "name": f"class{c}"} for c in COCO_CATEGORIES]
    paths = {}
    for split in ("train", "val"):
        paths[split] = os.path.join(root, "annotations",
                                    f"instances_{split}2017.json")
        with open(paths[split], "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": cats}, f)
    return paths
