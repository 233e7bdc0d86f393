"""Folder-based segmentation datasets (a copy of
`vitadapter/data/datasets.py`, numpy and PIL only).

Parity targets: mmseg ADE20K/Cityscapes/COCO-Stuff/PascalContext datasets plus
the reference's custom `MapillaryDataset` / `PotsdamDataset`
(`segmentation/mmseg_custom/datasets/mapillary.py:6`, `potsdam.py:6`) and the
65->19 class `MapillaryHack` mapping
(`segmentation/mmseg_custom/datasets/pipelines/transform.py:311`).

Host-side: images decoded with PIL into uint8 RGB; labels uint8/int32 with 255
= ignore. Device-side normalization lives in `data/preprocess.py`.
"""

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image


class SegDataset:
    """Generic (img_dir, ann_dir) dataset."""

    NUM_CLASSES = 0
    IMG_SUFFIX = ".jpg"
    SEG_SUFFIX = ".png"
    REDUCE_ZERO_LABEL = False

    def __init__(self, img_dir: str, ann_dir: Optional[str] = None,
                 split: Optional[Sequence[str]] = None):
        self.img_dir = img_dir
        self.ann_dir = ann_dir
        if split is not None:
            self.names = list(split)
        else:
            self.names = sorted(
                os.path.splitext(f)[0] for f in os.listdir(img_dir)
                if f.endswith(self.IMG_SUFFIX))

    def __len__(self):
        return len(self.names)

    def load(self, i: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        name = self.names[i]
        img = np.asarray(Image.open(
            os.path.join(self.img_dir, name + self.IMG_SUFFIX)).convert("RGB"))
        seg = None
        if self.ann_dir is not None:
            seg = np.asarray(Image.open(
                os.path.join(self.ann_dir, name + self.SEG_SUFFIX)),
                dtype=np.int32)
            if self.REDUCE_ZERO_LABEL:
                # 0 = ignore: shift labels down, 0 -> 255
                seg = np.where(seg == 0, 255, seg - 1).astype(np.int32)
        return img, seg


class ADE20KDataset(SegDataset):
    NUM_CLASSES = 150
    REDUCE_ZERO_LABEL = True


class CityscapesDataset(SegDataset):
    NUM_CLASSES = 19
    IMG_SUFFIX = "_leftImg8bit.png"
    SEG_SUFFIX = "_gtFine_labelTrainIds.png"


class COCOStuffDataset(SegDataset):
    NUM_CLASSES = 171
    SEG_SUFFIX = "_labelTrainIds.png"


class PascalContextDataset(SegDataset):
    NUM_CLASSES = 60
    REDUCE_ZERO_LABEL = False


class PotsdamDataset(SegDataset):
    """ISPRS Potsdam (reference `potsdam.py:6`): 6 classes, clutter ignored via
    reduce_zero_label."""
    NUM_CLASSES = 6
    IMG_SUFFIX = ".png"
    REDUCE_ZERO_LABEL = True


class ChaseDB1Dataset(SegDataset):
    NUM_CLASSES = 2
    IMG_SUFFIX = ".png"
    SEG_SUFFIX = "_1stHO.png"


# Mapillary -> Cityscapes-19 grouping (reference MapillaryHack
# `transform.py:311-359`: 65 Vistas classes folded into the 19 train classes,
# everything else 255).
MAPILLARY_TO_CITYS19: List[List[int]] = [
    [13, 24, 41], [2, 15], [17], [6], [3], [45, 47], [48], [50], [30], [29],
    [27], [19], [20, 21, 22], [55], [61], [54], [58], [57], [52],
]


class MapillaryDataset(SegDataset):
    """Mapillary Vistas with the 65-class label space (reference
    `mapillary.py:6`); `to_cityscapes` applies the 19-class fold used for
    Cityscapes pre-training."""
    NUM_CLASSES = 65
    SEG_SUFFIX = ".png"

    @staticmethod
    def to_cityscapes(seg: np.ndarray) -> np.ndarray:
        out = np.full_like(seg, 255)
        for train_id, group in enumerate(MAPILLARY_TO_CITYS19):
            for src in group:
                out[seg == src] = train_id
        return out


DATASETS = {
    "ADE20KDataset": ADE20KDataset,
    "CityscapesDataset": CityscapesDataset,
    "COCOStuffDataset": COCOStuffDataset,
    "PascalContextDataset": PascalContextDataset,
    "PotsdamDataset": PotsdamDataset,
    "ChaseDB1Dataset": ChaseDB1Dataset,
    "MapillaryDataset": MapillaryDataset,
}
