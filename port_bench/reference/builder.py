"""Build a reference model from a configuration's `model` dict: nested
dicts with a `type` key become modules; a segmentor's heads get the
backbone's `embed_dim` as their `in_channels`. `dtype` strings become
torch dtypes, or every one float32 with `all_fp32`."""

from typing import Any, Dict

import torch

from port_bench.reference.heads.mask2former import Mask2FormerHead
from port_bench.reference.heads.upernet import FCNHead, UPerHead
from port_bench.reference.models.beit import (BEiTAttention,
                                              relative_position_index)
from port_bench.reference.models.beit_adapter import BEiTAdapter
from port_bench.reference.models.mask2former_segmentor import \
    EncoderDecoderMask2Former
from port_bench.reference.models.segmentor import EncoderDecoder
from port_bench.reference.models.vit_adapter import ViTAdapter

REGISTRY = {
    "ViTAdapter": ViTAdapter,
    "BEiTAdapter": BEiTAdapter,
    "UPerHead": UPerHead,
    "FCNHead": FCNHead,
    "Mask2FormerHead": Mask2FormerHead,
    "EncoderDecoder": EncoderDecoder,
    "EncoderDecoderMask2Former": EncoderDecoderMask2Former,
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build(cfg: Dict[str, Any], device="meta", all_fp32: bool = False):
    if not isinstance(cfg, dict) or "type" not in cfg:
        return cfg
    cfg = dict(cfg)
    cls = REGISTRY[cfg.pop("type")]
    if cls in (EncoderDecoderMask2Former, EncoderDecoder):
        backbone = build(cfg.pop("backbone"), device, all_fp32)
        dim = backbone.embed_dim
        heads = {}
        for key, channels in (("decode_head", [dim] * 4),
                              ("auxiliary_head", dim)):
            if cfg.get(key) is not None:
                head = dict(cfg.pop(key))
                head.setdefault("in_channels", channels)
                heads[key] = build(head, device, all_fp32)
        return cls(backbone, **heads, **cfg)
    kwargs = {}
    for k, v in cfg.items():
        if isinstance(v, dict) and "type" in v:
            v = build(v, device, all_fp32)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        elif k == "dtype" and isinstance(v, str):
            v = torch.float32 if all_fp32 else DTYPES[v]
        kwargs[k] = v
    return cls(device=device, **kwargs)


def build_model(model_cfg: Dict[str, Any], state: Dict[str, torch.Tensor],
                device, all_fp32: bool = True) -> torch.nn.Module:
    """The model on `device` holding `state` (every parameter and persistent
    buffer), its relative-position indices computed from the
    configuration, in eval mode."""
    model = build(model_cfg, "meta", all_fp32).to_empty(device=device)
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BEiTAttention) and m.rel_pos_grid is not None:
                idx = relative_position_index(*m.rel_pos_grid, m.with_cls)
                m.relative_position_index.copy_(
                    torch.from_numpy(idx.reshape(-1)))
    return model.eval()
