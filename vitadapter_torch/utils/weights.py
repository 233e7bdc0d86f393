"""Carry the JAX package's flax parameters into the port.

`state_dict_from_flax(params, batch_stats)` turns a flax variable tree (numpy
arrays or anything `np.asarray` takes) into a PyTorch `state_dict` with the
reference's key names: the inverse of the JAX package's checkpoint
converters for the ViT-Adapter and BEiT-Adapter backbones
(`convert_vit_adapter_backbone`, `convert_beit_backbone`) and the
Mask2Former head. Layout rules (flax -> torch):

  Dense kernel (in, out)                 -> Linear weight (out, in)
  Conv kernel (kh, kw, I, O)             -> Conv2d weight (O, I, kh, kw)
  depthwise Conv kernel (kh, kw, 1, C)   -> Conv2d weight (C, 1, kh, kw)
  ConvTranspose kernel (kh, kw, I, O),
    spatially flipped                    -> ConvTranspose2d weight (I, O, kh, kw)
  LayerNorm/GroupNorm scale, bias        -> weight, bias
  BatchNorm scale, bias, mean, var       -> weight, bias, running_mean/var
  q/k/v_proj of an attention             -> packed in_proj_weight/in_proj_bias
  pixel-decoder encoder layers stacked
    on axis 0 (nn.scan)                  -> encoder.layers.N

BatchNorm's `num_batches_tracked` has no flax counterpart and is not
produced; `load_flax` loads such a dict and checks every other key.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

Tree = Mapping[str, Any]
StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x,
                                                            np.float32)))


def _linear(p: Tree) -> StateDict:
    out = {"weight": _t(np.asarray(p["kernel"]).T)}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def _conv(p: Tree) -> StateDict:
    # (kh, kw, I, O) -> (O, I, kh, kw); depthwise (kh, kw, 1, C) likewise
    out = {"weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def _conv_transpose(p: Tree) -> StateDict:
    # undo the converter's spatial flip, then (kh, kw, I, O) -> (I, O, kh, kw)
    k = np.asarray(p["kernel"])[::-1, ::-1]
    return {"weight": _t(k.transpose(2, 3, 0, 1)), "bias": _t(p["bias"])}


def _norm(p: Tree) -> StateDict:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _bn(p: Tree, s: Tree) -> StateDict:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"]),
            "running_mean": _t(s["mean"]), "running_var": _t(s["var"])}


def _prefixed(prefix: str, sd: StateDict) -> StateDict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def msda_from_flax(p: Tree) -> StateDict:
    sd: StateDict = {}
    for name in ("sampling_offsets", "attention_weights", "value_proj",
                 "output_proj"):
        sd.update(_prefixed(name, _linear(p[name])))
    return sd


def block_from_flax(p: Tree) -> StateDict:
    """ViT `Block`."""
    sd = {**_prefixed("norm1", _norm(p["norm1"])),
          **_prefixed("norm2", _norm(p["norm2"])),
          **_prefixed("attn.qkv", _linear(p["attn"]["qkv"])),
          **_prefixed("attn.proj", _linear(p["attn"]["proj"])),
          **_prefixed("mlp.fc1", _linear(p["mlp"]["fc1"])),
          **_prefixed("mlp.fc2", _linear(p["mlp"]["fc2"]))}
    for g in ("gamma1", "gamma2"):
        if g in p:
            sd[g] = _t(p[g])
    return sd


def spm_from_flax(p: Tree, s: Tree) -> StateDict:
    """`SpatialPriorModule`: flax `stemN_conv`/`stemN_bn` -> `stem.<idx>`."""
    sd: StateDict = {}
    for i, name in enumerate(("stem1", "stem2", "stem3")):
        sd.update(_prefixed(f"stem.{3 * i}", _conv(p[f"{name}_conv"])))
        sd.update(_prefixed(f"stem.{3 * i + 1}",
                            _bn(p[f"{name}_bn"], s[f"{name}_bn"])))
    for c in (2, 3, 4):
        sd.update(_prefixed(f"conv{c}.0", _conv(p[f"conv{c}_conv"])))
        sd.update(_prefixed(f"conv{c}.1",
                            _bn(p[f"conv{c}_bn"], s[f"conv{c}_bn"])))
    for f in (1, 2, 3, 4):
        sd.update(_prefixed(f"fc{f}", _conv(p[f"fc{f}"])))
    return sd


def _extractor(p: Tree) -> StateDict:
    sd = {**_prefixed("query_norm", _norm(p["query_norm"])),
          **_prefixed("feat_norm", _norm(p["feat_norm"])),
          **_prefixed("attn", msda_from_flax(p["attn"]))}
    if "ffn_norm" in p:
        sd.update(_prefixed("ffn_norm", _norm(p["ffn_norm"])))
        sd.update(_prefixed("ffn.fc1", _linear(p["ffn"]["fc1"])))
        sd.update(_prefixed("ffn.fc2", _linear(p["ffn"]["fc2"])))
        sd.update(_prefixed("ffn.dwconv.dwconv",
                            _conv(p["ffn"]["dwconv"]["dwconv"])))
    return sd


def interaction_from_flax(p: Tree) -> StateDict:
    """`InteractionBlock`."""
    inj = p["injector"]
    sd = {**_prefixed("injector.query_norm", _norm(inj["query_norm"])),
          **_prefixed("injector.feat_norm", _norm(inj["feat_norm"])),
          **_prefixed("injector.attn", msda_from_flax(inj["attn"])),
          "injector.gamma": _t(inj["gamma"]),
          **_prefixed("extractor", _extractor(p["extractor"]))}
    for j in (0, 1):
        if f"extra_extractors_{j}" in p:
            sd.update(_prefixed(f"extra_extractors.{j}",
                                _extractor(p[f"extra_extractors_{j}"])))
    return sd


def vit_adapter_from_flax(p: Tree, s: Tree) -> StateDict:
    """`ViTAdapter` (flax `vit` subtree flattened, as in the reference)."""
    vit = p["vit"]
    sd = {"pos_embed": _t(vit["pos_embed"]),
          **_prefixed("patch_embed.proj", _conv(vit["patch_embed"]["proj"])),
          **_adapter_from_flax(p, s)}
    i = 0
    while f"blocks_{i}" in vit:
        sd.update(_prefixed(f"blocks.{i}", block_from_flax(vit[f"blocks_{i}"])))
        i += 1
    return sd


def beit_block_from_flax(p: Tree) -> StateDict:
    """`BEiTBlock`: the qkv kernel without bias, q/v biases, the
    relative-position table and the `gamma_1`/`gamma_2` layer scale."""
    attn = p["attn"]
    return {**_prefixed("norm1", _norm(p["norm1"])),
            **_prefixed("norm2", _norm(p["norm2"])),
            **_prefixed("attn.qkv", _linear(attn["qkv"])),
            **_prefixed("attn.proj", _linear(attn["proj"])),
            **_prefixed("mlp.fc1", _linear(p["mlp"]["fc1"])),
            **_prefixed("mlp.fc2", _linear(p["mlp"]["fc2"])),
            **{f"attn.{k}": _t(attn[k]) for k in (
                "q_bias", "v_bias", "relative_position_bias_table")},
            "gamma_1": _t(p["gamma_1"]), "gamma_2": _t(p["gamma_2"])}


def _adapter_from_flax(p: Tree, s: Tree) -> StateDict:
    """The adapter side that ViT-Adapter and BEiT-Adapter share (the JAX
    `convert_adapter_keys`)."""
    sd = {"level_embed": _t(p["level_embed"]),
          **_prefixed("spm", spm_from_flax(p["spm"], s["spm"])),
          **_prefixed("up", _conv_transpose(p["up"]))}
    i = 0
    while f"interactions_{i}" in p:
        sd.update(_prefixed(f"interactions.{i}",
                            interaction_from_flax(p[f"interactions_{i}"])))
        i += 1
    for n in (1, 2, 3, 4):
        sd.update(_prefixed(f"norm{n}", _bn(p[f"norm{n}"], s[f"norm{n}"])))
    return sd


def beit_adapter_from_flax(p: Tree, s: Tree) -> StateDict:
    """`BEiTAdapter` (flax `beit` subtree flattened, as in the reference):
    the inverse of the JAX `convert_beit_backbone`."""
    beit = p["beit"]
    sd = {"cls_token": _t(beit["cls_token"]),
          **_prefixed("patch_embed.proj", _conv(beit["patch_embed"]["proj"])),
          **_adapter_from_flax(p, s)}
    i = 0
    while f"blocks_{i}" in beit:
        sd.update(_prefixed(f"blocks.{i}",
                            beit_block_from_flax(beit[f"blocks_{i}"])))
        i += 1
    return sd


def backbone_from_flax(p: Tree, s: Tree) -> StateDict:
    """A ViT-Adapter or a BEiT-Adapter, by its trunk's subtree."""
    if "beit" in p:
        return beit_adapter_from_flax(p, s)
    return vit_adapter_from_flax(p, s)


def _ffn(fc1: Tree, fc2: Tree) -> StateDict:
    return {**_prefixed("layers.0.0", _linear(fc1)),
            **_prefixed("layers.1", _linear(fc2))}


def _conv_gn(p: Tree) -> StateDict:
    return {**_prefixed("conv", _conv(p["conv"])),
            **_prefixed("gn", _norm(p["gn"]))}


def pixel_decoder_from_flax(p: Tree) -> StateDict:
    """`MSDeformAttnPixelDecoder`; the scan-stacked encoder layers are
    unstacked along axis 0."""
    sd = {"level_encoding.weight": _t(p["level_encoding"]),
          **_prefixed("mask_feature", _conv(p["mask_feature"]))}
    for kind in ("input_conv", "lateral_conv", "output_conv"):
        i = 0
        while f"{kind}_{i}" in p:
            sd.update(_prefixed(f"{kind}s.{i}", _conv_gn(p[f"{kind}_{i}"])))
            i += 1
    stacked = p["encoder_layers"]["layer"]
    n = np.asarray(stacked["norm1"]["scale"]).shape[0]
    for li in range(n):
        lp = _take(stacked, li)
        pre = f"encoder.layers.{li}"
        sd.update(_prefixed(f"{pre}.attentions.0", msda_from_flax(lp["attn"])))
        sd.update(_prefixed(f"{pre}.norms.0", _norm(lp["norm1"])))
        sd.update(_prefixed(f"{pre}.norms.1", _norm(lp["norm2"])))
        sd.update(_prefixed(f"{pre}.ffns.0", _ffn(lp["ffn_fc1"],
                                                   lp["ffn_fc2"])))
    return sd


def _take(tree: Tree, i: int) -> Dict[str, Any]:
    return {k: (_take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i])
            for k, v in tree.items()}


def _mha(p: Tree) -> StateDict:
    names = ("q_proj", "k_proj", "v_proj")
    w = np.concatenate([np.asarray(p[n]["kernel"]).T for n in names], axis=0)
    b = np.concatenate([np.asarray(p[n]["bias"]) for n in names], axis=0)
    return {"attn.in_proj_weight": _t(w), "attn.in_proj_bias": _t(b),
            **_prefixed("attn.out_proj", _linear(p["out_proj"]))}


def mask2former_head_from_flax(p: Tree) -> StateDict:
    """`Mask2FormerHead`."""
    sd = {"query_embed.weight": _t(p["query_embed"]),
          "query_feat.weight": _t(p["query_feat"]),
          "level_embed.weight": _t(p["level_embed"]),
          **_prefixed("cls_embed", _linear(p["cls_embed"])),
          **_prefixed("transformer_decoder.post_norm", _norm(p["post_norm"])),
          **_prefixed("pixel_decoder",
                      pixel_decoder_from_flax(p["pixel_decoder"]))}
    for i, t_idx in enumerate((0, 2, 4)):   # Sequential(Linear, ReLU, ...)
        sd.update(_prefixed(f"mask_embed.{t_idx}",
                            _linear(p[f"mask_embed_{i}"])))
    i = 0
    while f"decoder_layer_{i}" in p:
        lp = p[f"decoder_layer_{i}"]
        pre = f"transformer_decoder.layers.{i}"
        sd.update(_prefixed(f"{pre}.attentions.0", _mha(lp["cross_attn"])))
        sd.update(_prefixed(f"{pre}.attentions.1", _mha(lp["self_attn"])))
        for j in (0, 1, 2):
            sd.update(_prefixed(f"{pre}.norms.{j}", _norm(lp[f"norm{j + 1}"])))
        sd.update(_prefixed(f"{pre}.ffns.0", _ffn(lp["ffn_fc1"],
                                                   lp["ffn_fc2"])))
        i += 1
    return sd


def state_dict_from_flax(params: Tree,
                         batch_stats: Optional[Tree] = None) -> StateDict:
    """A flax variable tree -> the port's `state_dict`. Takes the tree of a
    whole `EncoderDecoderMask2Former` (`backbone`, `decode_head`), or of one
    of its modules: `ViTAdapter`, `BEiTAdapter`, `Mask2FormerHead`, the
    pixel decoder, an `InteractionBlock`, the `SpatialPriorModule`, a ViT
    `Block`, a `BEiTBlock` or an `MSDeformAttn`."""
    s = batch_stats or {}
    if "backbone" in params and "decode_head" in params:
        return {**_prefixed("backbone", backbone_from_flax(
                    params["backbone"], s["backbone"])),
                **_prefixed("decode_head", mask2former_head_from_flax(
                    params["decode_head"]))}
    if "vit" in params or "beit" in params:
        return backbone_from_flax(params, s)
    if "pixel_decoder" in params:
        return mask2former_head_from_flax(params)
    if "encoder_layers" in params:
        return pixel_decoder_from_flax(params)
    if "injector" in params:
        return interaction_from_flax(params)
    if "stem1_conv" in params:
        return spm_from_flax(params, s)
    if "gamma_1" in params:
        return beit_block_from_flax(params)
    if "mlp" in params:
        return block_from_flax(params)
    if "sampling_offsets" in params:
        return msda_from_flax(params)
    raise ValueError(f"unrecognized flax tree with keys {sorted(params)[:8]}")


def load_flax(module: nn.Module, params: Tree,
              batch_stats: Optional[Tree] = None) -> nn.Module:
    """Load a flax tree into `module`; every key must match except
    BatchNorm's `num_batches_tracked`."""
    sd = state_dict_from_flax(params, batch_stats)
    missing, unexpected = module.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"flax tree does not match the module: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")
    return module
