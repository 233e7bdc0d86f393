"""Model zoo (counterpart of `vitadapter/zoo.py`): the ViT-Adapter variants
and the Mask2Former + ViT-Adapter and UperNet + ViT-Adapter segmentors.

Models are built on the meta device, then allocated on `device` and
initialized from `generator` (seed 0 on `device` by default), in eval mode
(`model.train()` selects the training forward).
`device=None` means CUDA, and raises where there is none: pass
`device="cpu"` to run the plain versions of the kernels on the CPU.
"""

from typing import Optional

import torch
from torch import nn

from vitadapter_torch.heads.mask2former import Mask2FormerHead
from vitadapter_torch.heads.upernet import FCNHead, UPerHead
from vitadapter_torch.models.mask2former_segmentor import \
    EncoderDecoderMask2Former
from vitadapter_torch.models.segmentor import EncoderDecoder
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.utils.init import init_weights

# interaction spans for 12-layer (T/S/B) and 24-layer (L) trunks
IDX12 = ((0, 2), (3, 5), (6, 8), (9, 11))
IDX24 = ((0, 5), (6, 11), (12, 17), (18, 23))

VIT_ADAPTER_VARIANTS = {
    "tiny": dict(embed_dim=192, depth=12, num_heads=3, deform_num_heads=6,
                 interaction_indexes=IDX12, drop_path_rate=0.1,
                 deform_ratio=1.0, layer_scale=False),
    "small": dict(embed_dim=384, depth=12, num_heads=6, deform_num_heads=6,
                  interaction_indexes=IDX12, drop_path_rate=0.2,
                  deform_ratio=1.0, layer_scale=False),
    "base": dict(embed_dim=768, depth=12, num_heads=12, deform_num_heads=12,
                 interaction_indexes=IDX12, drop_path_rate=0.3,
                 deform_ratio=0.5, layer_scale=False),
    "large": dict(embed_dim=1024, depth=24, num_heads=16, deform_num_heads=16,
                  interaction_indexes=IDX24, drop_path_rate=0.4,
                  deform_ratio=0.5, layer_scale=True),
}


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when it is None; raises when CUDA is missing."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass "
                           "device='cpu' to run its plain versions")
    return torch.device("cuda")


def materialize(model: nn.Module, device: torch.device,
                 generator: Optional[torch.Generator]) -> nn.Module:
    model = model.to_empty(device=device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    return init_weights(model, generator).eval()


def _vit_adapter_cfg(variant: str, overrides) -> dict:
    cfg = dict(VIT_ADAPTER_VARIANTS[variant])
    cfg.update(overrides)
    return cfg


def vit_adapter(variant: str = "tiny", device=None,
                dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                **overrides) -> ViTAdapter:
    device = resolve_device(device)
    model = ViTAdapter(dtype=dtype, device="meta",
                       **_vit_adapter_cfg(variant, overrides))
    return materialize(model, device, generator)


def mask2former_vit_adapter(variant: str = "large", num_classes: int = 150,
                            num_queries: Optional[int] = None, device=None,
                            dtype: torch.dtype = torch.float32,
                            generator: Optional[torch.Generator] = None,
                            drop_path_rate: Optional[float] = None,
                            **overrides) -> EncoderDecoderMask2Former:
    """Mask2Former + ViT-Adapter segmentor. Head widths follow the reference
    flagship for "large" (1024 wide, 32 heads, FFN 4096, 200 queries) and
    the base config otherwise (256 wide, 8 heads, FFN 2048/1024, 100
    queries). `drop_path_rate` defaults to the variant's (0.4 for "large");
    it acts in training mode only."""
    device = resolve_device(device)
    if drop_path_rate is not None:
        overrides["drop_path_rate"] = drop_path_rate
    backbone = ViTAdapter(dtype=dtype, device="meta",
                          **_vit_adapter_cfg(variant, overrides))
    dim = backbone.embed_dim
    if variant == "large":
        head_cfg = dict(num_queries=num_queries or 200, feat_channels=1024,
                        out_channels=1024, num_heads=32, decoder_ffn_dim=4096,
                        pixel_encoder_ffn_dim=4096, pixel_encoder_heads=32)
    else:
        head_cfg = dict(num_queries=num_queries or 100, feat_channels=256,
                        out_channels=256, num_heads=8, decoder_ffn_dim=2048,
                        pixel_encoder_ffn_dim=1024, pixel_encoder_heads=8)
    head = Mask2FormerHead([dim] * 4, num_classes=num_classes, dtype=dtype,
                           device="meta", **head_cfg)
    model = EncoderDecoderMask2Former(backbone, head)
    return materialize(model, device, generator)


def upernet_vit_adapter(variant: str = "tiny", num_classes: int = 150,
                        channels: int = 512, device=None,
                        dtype: torch.dtype = torch.float32,
                        generator: Optional[torch.Generator] = None,
                        **overrides) -> EncoderDecoder:
    """UperNet + ViT-Adapter segmentor (reference
    `upernet_deit_adapter_tiny_512_160k_ade20k.py`): a `channels`-wide
    `UPerHead` and a 256-wide `FCNHead` on the stride-16 scale, both in
    `dtype`."""
    device = resolve_device(device)
    backbone = ViTAdapter(dtype=dtype, device="meta",
                          **_vit_adapter_cfg(variant, overrides))
    dim = backbone.embed_dim
    model = EncoderDecoder(
        backbone,
        UPerHead([dim] * 4, num_classes=num_classes, channels=channels,
                 dtype=dtype, device="meta"),
        FCNHead(dim, num_classes=num_classes, channels=256, dtype=dtype,
                device="meta"),
        aux_in_index=2)
    return materialize(model, device, generator)
