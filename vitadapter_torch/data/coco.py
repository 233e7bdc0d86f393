"""COCO-format detection dataset (self-contained: no pycocotools), copied
from `vitadapter/data/coco.py`.

Parses instances JSON, rasterizes polygon segmentations with PIL and decodes
COCO compressed RLE for crowd regions. Emits static-shape training targets
(boxes/labels/masks padded to max_instances) matching `det/mask_rcnn.py`.
Compressed RLE strings go through the native codec (`ops/native.py`,
`ops/host/rle.cpp`), as in the JAX package; `decode_rle_plain` and
`encode_rle_plain` are the numpy/Python codec, which gives the same masks
and strings. `CocoPanopticDataset` reads the COCO panoptic format for
`--eval PQ`.

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

from vitadapter_torch.ops import native


def decode_rle(counts, size) -> np.ndarray:
    """Decode COCO RLE (compressed string or uncompressed list) -> (H, W):
    a compressed string by the native codec, a list of runs in numpy."""
    if isinstance(counts, list):
        return decode_rle_plain(counts, size)
    H, W = size
    s = counts.decode("ascii") if isinstance(counts, bytes) else counts
    return native.rle_decode(s, H, W)


def decode_rle_plain(counts, size) -> np.ndarray:
    """`decode_rle` in numpy/Python (the codec's plain version)."""
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
    """Binary (H, W) mask -> COCO compressed RLE dict (the native codec)."""
    H, W = mask.shape
    return {"size": [H, W], "counts": native.rle_encode(mask)}


def encode_rle_plain(mask: np.ndarray) -> Dict:
    """`encode_rle` in numpy/Python (the codec's plain version)."""
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


class CocoPanopticDataset:
    """COCO panoptic-format dataset (reference: mmdet CocoPanopticDataset as
    used by `detection/configs/mask2former/..._coco-panoptic.py`).

    `ann_file` is the standard panoptic JSON: images + annotations with
    `segments_info` and a per-image PNG whose pixel encodes the segment id
    as R + 256*G + 65536*B (0 = void). `seg_dir` holds the PNGs (defaults to
    the JSON's path without its extension). Categories with `isthing=1` map
    to contiguous labels [0, n_things); stuff to [n_things,
    n_things+n_stuff). `load` returns (img, {"pan": (H, W) int64 `label *
    INSTANCE_OFFSET + inst_id` map with -1 void: the `heads/panoptic.py`
    convention}); crowd segments are void.
    """

    def __init__(self, ann_file: str, img_dir: str, seg_dir: str = None):
        with open(ann_file) as f:
            coco = json.load(f)
        self.img_dir = img_dir
        if seg_dir is None:
            seg_dir = os.path.splitext(ann_file)[0]
        self.seg_dir = seg_dir
        things = [c for c in coco["categories"] if c.get("isthing", 0)]
        stuff = [c for c in coco["categories"] if not c.get("isthing", 0)]
        self.num_things = len(things)
        self.num_stuff = len(stuff)
        self.num_classes = self.num_things + self.num_stuff
        self.cat_to_label = {
            c["id"]: i for i, c in enumerate(
                sorted(things, key=lambda c: c["id"]))}
        self.cat_to_label.update({
            c["id"]: self.num_things + i for i, c in enumerate(
                sorted(stuff, key=lambda c: c["id"]))})
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns = {a["image_id"]: a for a in coco.get("annotations", [])}
        self.ids = [i for i in self.images if i in self.anns]

    def __len__(self):
        return len(self.ids)

    def load(self, i: int):
        from vitadapter_torch.heads.panoptic import INSTANCE_OFFSET

        im_id = self.ids[i]
        info = self.images[im_id]
        img = np.asarray(Image.open(
            os.path.join(self.img_dir, info["file_name"])).convert("RGB"))
        ann = self.anns[im_id]
        rgb = np.asarray(Image.open(
            os.path.join(self.seg_dir, ann["file_name"])).convert("RGB"),
            np.int64)
        seg_id = rgb[..., 0] + 256 * rgb[..., 1] + 65536 * rgb[..., 2]
        pan = np.full(seg_id.shape, -1, np.int64)
        inst_counter = {}
        for s in ann["segments_info"]:
            if s.get("iscrowd", 0):
                continue
            label = self.cat_to_label[s["category_id"]]
            if label < self.num_things:
                inst = inst_counter.get(label, 0) + 1
                inst_counter[label] = inst
            else:
                inst = 0
            pan[seg_id == s["id"]] = label * INSTANCE_OFFSET + inst
        return img, {"pan": pan}
