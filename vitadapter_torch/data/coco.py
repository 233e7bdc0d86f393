"""COCO-format detection dataset (self-contained: no pycocotools), copied
from `vitadapter/data/coco.py`.

Parses instances JSON, rasterizes polygon segmentations with PIL and decodes
COCO compressed RLE for crowd regions. Emits static-shape training targets
(boxes/labels/masks padded to max_instances) matching `det/mask_rcnn.py`.
The RLE codec is the numpy/Python one: the JAX package's native codec
(`native/rle.cpp`) is not ported yet (ROADMAP.md §1 item 6); it gives the
same masks and strings. The panoptic dataset comes with ROADMAP.md §1
item 3.

Parity targets: mmdet `CocoDataset` + the reference detection pipelines
(`mask_rcnn_deit_adapter_tiny_fpn_3x_coco.py`: multi-scale resize + flip +
pad). `encode_mask_results`-style RLE output is provided for submission
dumps (reference `segmentation/mmseg_custom/core/mask/utils.py:38`).
"""

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw


def decode_rle(counts, size) -> np.ndarray:
    """Decode COCO RLE (compressed string or uncompressed list) -> (H, W)."""
    H, W = size
    if isinstance(counts, list):
        runs = counts
    else:
        # LEB128-style signed varint deltas (COCO compressed RLE)
        if isinstance(counts, str):
            counts = counts.encode("ascii")
        runs = []
        i = 0
        while i < len(counts):
            x, k, more = 0, 0, True
            while more:
                c = counts[i] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                i += 1
                k += 1
            if x & (1 << (5 * k - 1)):  # sign-extend
                x |= -1 << (5 * k)
            if len(runs) > 2:
                x += runs[-2]
            runs.append(x)
    mask = np.zeros(H * W, np.uint8)
    pos, val = 0, 0
    for r in runs:
        if val:
            mask[pos:pos + r] = 1
        pos += r
        val ^= 1
    # COCO RLE is column-major
    return mask.reshape(W, H).T


def encode_rle(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask -> COCO compressed RLE dict."""
    H, W = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    # run lengths starting with a 0-run
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [len(flat)]])
    runs = np.diff(idx).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    out = []
    for i, x in enumerate(runs):
        if i > 2:
            x -= runs[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c & 0x10)) and \
                not (x == -1 and (c & 0x10))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return {"size": [H, W], "counts": "".join(out)}


def polygons_to_mask(polys: Sequence[Sequence[float]], h: int, w: int
                     ) -> np.ndarray:
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polys:
        if len(poly) >= 6:
            draw.polygon([float(v) for v in poly], outline=1, fill=1)
    return np.asarray(img, np.uint8)


class CocoDataset:
    """Detection/instance-seg dataset over a COCO instances JSON."""

    def __init__(self, ann_file: str, img_dir: str,
                 with_masks: bool = True,
                 filter_empty: bool = True):
        with open(ann_file) as f:
            coco = json.load(f)
        self.img_dir = img_dir
        self.with_masks = with_masks
        cats = sorted(c["id"] for c in coco["categories"])
        self.cat_to_label = {cid: i for i, cid in enumerate(cats)}
        self.label_to_cat = {i: cid for cid, i in self.cat_to_label.items()}
        self.num_classes = len(cats)
        self.images = {im["id"]: im for im in coco["images"]}
        anns: Dict[int, List] = {im_id: [] for im_id in self.images}
        for a in coco.get("annotations", []):
            if a.get("ignore", 0):
                continue
            anns[a["image_id"]].append(a)
        self.ids = [i for i in self.images
                    if not filter_empty or any(
                        not a.get("iscrowd", 0) for a in anns[i])]
        self.anns = anns

    def __len__(self):
        return len(self.ids)

    def load(self, i: int):
        """Returns (img uint8 RGB, targets dict with boxes xyxy, labels,
        masks (G,H,W) uint8 or None, iscrowd)."""
        im_id = self.ids[i]
        info = self.images[im_id]
        path = os.path.join(self.img_dir, info["file_name"])
        img = np.asarray(Image.open(path).convert("RGB"))
        h, w = img.shape[:2]
        boxes, labels, masks, crowd, areas = [], [], [], [], []
        for a in self.anns[im_id]:
            x, y, bw, bh = a["bbox"]
            if bw < 1 or bh < 1:
                continue
            boxes.append([x, y, x + bw, y + bh])
            labels.append(self.cat_to_label[a["category_id"]])
            crowd.append(bool(a.get("iscrowd", 0)))
            # COCOeval area-range gating uses the ANNOTATION area (the
            # segmentation area), not the bbox area, even for bbox eval
            areas.append(float(a.get("area", bw * bh)))
            if self.with_masks:
                seg = a.get("segmentation")
                if isinstance(seg, dict):
                    masks.append(decode_rle(seg["counts"], seg["size"]))
                elif seg:
                    masks.append(polygons_to_mask(seg, h, w))
                else:
                    masks.append(np.zeros((h, w), np.uint8))
        targets = {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int32),
            "iscrowd": np.asarray(crowd, bool),
            "area": np.asarray(areas, np.float64),
            "masks": (np.stack(masks) if masks else
                      np.zeros((0, h, w), np.uint8)) if self.with_masks
                     else None,
        }
        return img, targets


def pad_targets(targets: Dict, max_instances: int) -> Dict:
    """Pad per-image targets to a static budget with a validity mask."""
    g = len(targets["labels"])
    k = min(g, max_instances)
    out = dict(targets)
    out["valid"] = np.zeros(max_instances, bool)
    out["valid"][:k] = ~targets["iscrowd"][:k]
    pad = max_instances - k

    out["boxes"] = np.pad(targets["boxes"][:k], ((0, pad), (0, 0)))
    out["labels"] = np.pad(targets["labels"][:k], (0, pad))
    out["iscrowd"] = np.pad(targets["iscrowd"][:k], (0, pad))
    if targets.get("masks") is not None:
        out["masks"] = np.pad(targets["masks"][:k],
                              ((0, pad), (0, 0), (0, 0)))
    return out
