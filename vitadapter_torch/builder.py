"""Registry-style model construction from config dicts (counterpart of
`vitadapter/builder.py`): configs say `dict(type='BEiTAdapter', ...)` and
`build` resolves the class. A detector gets its backbone as a built module
(its neck reads the backbone's `embed_dim`).

Modules are built on the meta device, then allocated on `device` and
initialized from a `torch.Generator`, as `zoo.mask2former_vit_adapter` does.
The port's heads take the backbone's channels (`in_channels`), which the
flax heads infer from their input: `build` supplies `[embed_dim] * 4` to a
segmentor's decode head and `embed_dim` to its auxiliary head, from the
backbone it built.
"""

from typing import Any, Dict, Optional

import torch

from vitadapter_torch.det.cascade import CascadeRCNN
from vitadapter_torch.det.dino_detector import DINO
from vitadapter_torch.det.grounding_dino import GroundingDINO
from vitadapter_torch.det.mask_rcnn import MaskRCNN
from vitadapter_torch.det.single_stage import ATSS
from vitadapter_torch.det.sparse_rcnn import SparseRCNN
from vitadapter_torch.heads.mask2former import Mask2FormerHead
from vitadapter_torch.heads.maskformer import MaskFormerHead
from vitadapter_torch.heads.upernet import FCNHead, UPerHead
from vitadapter_torch.models.baselines import BEiTBaseline, ViTBaseline
from vitadapter_torch.models.beit import BEiT
from vitadapter_torch.models.beit_adapter import BEiTAdapter
from vitadapter_torch.models.mask2former_segmentor import \
    EncoderDecoderMask2Former
from vitadapter_torch.models.segmentor import EncoderDecoder
from vitadapter_torch.models.uniperceiver import UnifiedBertEncoder
from vitadapter_torch.models.uniperceiver_adapter import UniPerceiverAdapter
from vitadapter_torch.models.vit import TIMMVisionTransformer
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.zoo import materialize, resolve_device

REGISTRY: Dict[str, Any] = {
    # backbones
    "ViTAdapter": ViTAdapter,
    "BEiT": BEiT,
    "BEiTAdapter": BEiTAdapter,
    "TIMMVisionTransformer": TIMMVisionTransformer,
    "ViTBaseline": ViTBaseline,
    "BEiTBaseline": BEiTBaseline,
    "UniPerceiverAdapter": UniPerceiverAdapter,
    "UnifiedBertEncoder": UnifiedBertEncoder,
    # segmentation
    "UPerHead": UPerHead,
    "FCNHead": FCNHead,
    "Mask2FormerHead": Mask2FormerHead,
    "MaskFormerHead": MaskFormerHead,
    "EncoderDecoder": EncoderDecoder,
    "EncoderDecoderMask2Former": EncoderDecoderMask2Former,
    # detection
    "MaskRCNN": MaskRCNN,
    "CascadeRCNN": CascadeRCNN,
    "ATSS": ATSS,
    "SparseRCNN": SparseRCNN,
    "DINO": DINO,
    "GroundingDINO": GroundingDINO,
}

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _lookup(name: str):
    if name in REGISTRY:
        return REGISTRY[name]
    raise KeyError(f"unknown component type {name!r}; known: "
                   f"{sorted(REGISTRY)}")


def build(cfg: Dict[str, Any], device="meta"):
    """Recursively build {'type': Name, **kwargs} on `device`: nested dicts
    with a 'type' key become submodules, lists become tuples and `dtype`
    strings torch dtypes. A segmentor's heads get `in_channels` from the
    backbone's `embed_dim` unless they set them: each of the 4 scales for
    the decode head, the one `aux_in_index` scale for the auxiliary head
    (every backbone's scales have `embed_dim` channels)."""
    if not isinstance(cfg, dict) or "type" not in cfg:
        return cfg
    cfg = dict(cfg)
    cls = _lookup(cfg.pop("type"))
    if cls in (EncoderDecoderMask2Former, EncoderDecoder):
        backbone = build(cfg.pop("backbone"), device)
        dim = backbone.embed_dim
        heads = {}
        for key, channels in (("decode_head", [dim] * 4),
                              ("auxiliary_head", dim)):
            if cfg.get(key) is not None:
                head = dict(cfg.pop(key))
                head.setdefault("in_channels", channels)
                heads[key] = build(head, device)
        return cls(backbone, **heads, **cfg)
    kwargs = {}
    for k, v in cfg.items():
        if isinstance(v, dict) and "type" in v:
            v = build(v, device)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        elif k == "dtype" and isinstance(v, str):
            v = DTYPES[v]
        kwargs[k] = v
    return cls(device=device, **kwargs)


def build_model(model_cfg: Dict[str, Any], device=None,
                generator: Optional[torch.Generator] = None):
    """The model of a config's `model` dict on `device` (CUDA when None;
    raises where there is none), initialized from `generator` (seed 0 on
    `device` by default), in eval mode."""
    device = resolve_device(device)
    return materialize(build(model_cfg), device, generator)
