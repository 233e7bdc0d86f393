"""Carry the JAX package's flax parameters into the port.

`state_dict_from_flax(params, batch_stats)` turns a flax variable tree (numpy
arrays or anything `np.asarray` takes) into a PyTorch `state_dict` with the
reference's key names: the inverse of the JAX package's checkpoint
converters for the ViT-Adapter, BEiT-Adapter and UniPerceiver-Adapter
backbones (`convert_vit_adapter_backbone`, `convert_beit_backbone`,
`convert_uniperceiver_backbone`), the Mask2Former head, the UperNet heads
(`convert_upernet_heads`), Mask R-CNN's neck, RPN and RoI heads
(`convert_detector_checkpoint`), ATSS/GFL and Sparse R-CNN (the same
converter), the MaskFormer head (`convert_maskformer_head`) and the DINO
detectors (`convert_grounding_dino_checkpoint`). The
baselines' pyramid and `PatchMerging`, which no JAX converter reads, keep
their flax names (`models/baselines.py`). Layout rules (flax -> torch):

  Dense kernel (in, out)                 -> Linear weight (out, in)
  Conv kernel (kh, kw, I, O)             -> Conv2d weight (O, I, kh, kw)
  depthwise Conv kernel (kh, kw, 1, C)   -> Conv2d weight (C, 1, kh, kw)
  ConvTranspose kernel (kh, kw, I, O),
    spatially flipped                    -> ConvTranspose2d weight (I, O, kh, kw)
  LayerNorm/GroupNorm scale, bias        -> weight, bias
  LayerNorm2d weight, bias               -> weight, bias
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


def residual_from_flax(p: Tree) -> StateDict:
    """`ResBottleneckBlock`: flax `conv{1,2,3}`, `norm{1,2}` and the zero-
    initialised `norm3_weight`/`norm3_bias` -> `convN.weight`,
    `normN.weight`/`.bias`."""
    sd: StateDict = {}
    for j in (1, 2, 3):
        sd.update(_prefixed(f"conv{j}", _conv(p[f"conv{j}"])))
    for j in (1, 2):
        sd.update(_prefixed(f"norm{j}", _ln2d(p[f"norm{j}"])))
    sd["norm3.weight"] = _t(p["norm3_weight"])
    sd["norm3.bias"] = _t(p["norm3_bias"])
    return sd


def block_from_flax(p: Tree) -> StateDict:
    """ViT `Block`, with its `ResBottleneckBlock` where it has one."""
    sd = {**_prefixed("norm1", _norm(p["norm1"])),
          **_prefixed("norm2", _norm(p["norm2"])),
          **_prefixed("attn.qkv", _linear(p["attn"]["qkv"])),
          **_prefixed("attn.proj", _linear(p["attn"]["proj"])),
          **_prefixed("mlp.fc1", _linear(p["mlp"]["fc1"])),
          **_prefixed("mlp.fc2", _linear(p["mlp"]["fc2"]))}
    for g in ("gamma1", "gamma2"):
        if g in p:
            sd[g] = _t(p[g])
    if "residual" in p:
        sd.update(_prefixed("residual", residual_from_flax(p["residual"])))
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


def _blocks(trunk: Tree, convert) -> StateDict:
    sd: StateDict = {}
    i = 0
    while f"blocks_{i}" in trunk:
        sd.update(_prefixed(f"blocks.{i}", convert(trunk[f"blocks_{i}"])))
        i += 1
    return sd


def _vit_trunk(vit: Tree) -> StateDict:
    """The flax `vit` subtree, flattened as in the reference."""
    return {"pos_embed": _t(vit["pos_embed"]),
            **_prefixed("patch_embed.proj", _conv(vit["patch_embed"]["proj"])),
            **_blocks(vit, block_from_flax)}


def beit_block_from_flax(p: Tree) -> StateDict:
    """`BEiTBlock`: the qkv kernel without bias, the q/v biases and the
    relative-position table where the block has them, and the
    `gamma_1`/`gamma_2` layer scale."""
    attn = p["attn"]
    return {**_prefixed("norm1", _norm(p["norm1"])),
            **_prefixed("norm2", _norm(p["norm2"])),
            **_prefixed("attn.qkv", _linear(attn["qkv"])),
            **_prefixed("attn.proj", _linear(attn["proj"])),
            **_prefixed("mlp.fc1", _linear(p["mlp"]["fc1"])),
            **_prefixed("mlp.fc2", _linear(p["mlp"]["fc2"])),
            **{f"attn.{k}": _t(attn[k]) for k in (
                "q_bias", "v_bias", "relative_position_bias_table")
               if k in attn},
            "gamma_1": _t(p["gamma_1"]), "gamma_2": _t(p["gamma_2"])}


def _beit_trunk(beit: Tree) -> StateDict:
    """The flax `beit` subtree, flattened as in the reference: the
    `pos_embed` where there is one, and `patch_embed.proj` as the patchify
    conv or as `HybridEmbed`'s projection (a Dense kernel). A hybrid
    stem's own parameters (flax `hybrid_backbone`, the reference's
    `patch_embed.backbone`) are any module's and are not carried over
    here."""
    proj = beit["patch_embed"]["proj"]
    sd = {"cls_token": _t(beit["cls_token"]),
          **_prefixed("patch_embed.proj", _linear(proj)
                      if np.ndim(proj["kernel"]) == 2 else _conv(proj)),
          **_blocks(beit, beit_block_from_flax)}
    if "pos_embed" in beit:
        sd["pos_embed"] = _t(beit["pos_embed"])
    return sd


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


def vit_adapter_from_flax(p: Tree, s: Tree) -> StateDict:
    """`ViTAdapter`."""
    return {**_vit_trunk(p["vit"]), **_adapter_from_flax(p, s)}


def beit_adapter_from_flax(p: Tree, s: Tree) -> StateDict:
    """`BEiTAdapter`: the inverse of the JAX `convert_beit_backbone`."""
    return {**_beit_trunk(p["beit"]), **_adapter_from_flax(p, s)}


def _ln2d(p: Tree) -> StateDict:
    return {"weight": _t(p["weight"]), "bias": _t(p["bias"])}


def pyramid_from_flax(p: Tree) -> StateDict:
    """`SimpleFeaturePyramid`: flax `out_conv1_N` -> `out_conv1.N`, ..."""
    sd = {**_prefixed("up4_a", _conv_transpose(p["up4_a"])),
          **_prefixed("up4_b", _conv_transpose(p["up4_b"])),
          **_prefixed("up8", _conv_transpose(p["up8"])),
          **_prefixed("up4_norm", _ln2d(p["up4_norm"]))}
    for i in range(4):
        for name in ("out_conv1", "out_conv2"):
            sd.update(_prefixed(f"{name}.{i}", _conv(p[f"{name}_{i}"])))
        for name in ("out_norm1", "out_norm2"):
            sd.update(_prefixed(f"{name}.{i}", _ln2d(p[f"{name}_{i}"])))
    return sd


def vit_baseline_from_flax(p: Tree) -> StateDict:
    """`ViTBaseline`."""
    return {**_vit_trunk(p["vit"]),
            **_prefixed("pyramid", pyramid_from_flax(p["pyramid"]))}


def beit_baseline_from_flax(p: Tree) -> StateDict:
    """`BEiTBaseline`."""
    return {**_beit_trunk(p["beit"]),
            **_prefixed("pyramid", pyramid_from_flax(p["pyramid"]))}


def uniperceiver_layer_from_flax(p: Tree) -> StateDict:
    """`MultiModelBertLayer`."""
    return {**_prefixed("self_attn.in_proj",
                        _linear(p["self_attn"]["in_proj"])),
            **_prefixed("self_attn.out_proj",
                        _linear(p["self_attn"]["out_proj"])),
            **_prefixed("linear1", _linear(p["linear1"])),
            **_prefixed("linear2", _linear(p["linear2"])),
            **_prefixed("norm1", _norm(p["norm1"])),
            **_prefixed("norm2", _norm(p["norm2"])),
            "gamma_1": _t(p["gamma_1"]), "gamma_2": _t(p["gamma_2"])}


def grounding_block_from_flax(p: Tree) -> StateDict:
    """`GroundingCrossAttention`: flax `k_proj` and `v_proj` -> the fused
    `attn.kv` (k rows first), `q_proj` -> `attn.q`, `out_proj` ->
    `attn.proj`, `mlp_fc1`/`mlp_fc2` -> `mlp.fc1`/`mlp.fc2` (the inverse
    of `convert_uniperceiver_backbone`'s `cross_attn` keys)."""
    k, v = _linear(p["k_proj"]), _linear(p["v_proj"])
    return {**_prefixed("norm1", _norm(p["norm1"])),
            **_prefixed("norm2", _norm(p["norm2"])),
            **_prefixed("attn.q", _linear(p["q_proj"])),
            "attn.kv.weight": torch.cat([k["weight"], v["weight"]]),
            "attn.kv.bias": torch.cat([k["bias"], v["bias"]]),
            **_prefixed("attn.proj", _linear(p["out_proj"])),
            **_prefixed("mlp.fc1", _linear(p["mlp_fc1"])),
            **_prefixed("mlp.fc2", _linear(p["mlp_fc2"]))}


def uniperceiver_adapter_from_flax(p: Tree, s: Tree) -> StateDict:
    """`UniPerceiverAdapter`: the flax `trunk` flattened as in the
    reference (`layers.N`, `visual_embed.patch_embed.*`, `token_embed.*`),
    `grounding_N` -> `cross_attn.N`, and the adapter's keys (the inverse of
    `convert_uniperceiver_backbone`)."""
    t = p["trunk"]
    ve, te = t["visual_embed"], t["token_embed"]
    sd = {**_prefixed("visual_embed.patch_embed.proj", _conv(ve["proj"])),
          "visual_embed.patch_embed.spatial_pos_embed.weight":
              _t(ve["spatial_pos_embed"]),
          "visual_embed.patch_embed.temporal_pos_embed.weight":
              _t(ve["temporal_pos_embed"]),
          **_prefixed("visual_embed.embeddings_norm",
                      _norm(ve["embeddings_norm"])),
          "token_embed.embeddings.weight":
              _t(te["embeddings"]["embedding"]),
          "token_embed.embeddings_pos.position_embeddings.weight":
              _t(te["pos_embed"]),
          "token_embed.embeddings_token_type.weight": _t(te["token_type"]),
          **_prefixed("token_embed.embeddings_norm",
                      _norm(te["embeddings_norm"])),
          **_adapter_from_flax(p, s)}
    i = 0
    while f"layers_{i}" in t:
        sd.update(_prefixed(f"layers.{i}",
                            uniperceiver_layer_from_flax(t[f"layers_{i}"])))
        i += 1
    g = 0
    while f"grounding_{g}" in p:
        sd.update(_prefixed(f"cross_attn.{g}",
                            grounding_block_from_flax(p[f"grounding_{g}"])))
        g += 1
    return sd


def backbone_from_flax(p: Tree, s: Tree) -> StateDict:
    """A ViT-Adapter, a BEiT-Adapter, a UniPerceiver-Adapter or one of the
    baselines, by its subtrees."""
    if "trunk" in p:
        return uniperceiver_adapter_from_flax(p, s)
    if "pyramid" in p:
        return (beit_baseline_from_flax(p) if "beit" in p
                else vit_baseline_from_flax(p))
    if "beit" in p:
        return beit_adapter_from_flax(p, s)
    return vit_adapter_from_flax(p, s)


def _conv_bn_relu(p: Tree, s: Tree) -> StateDict:
    return {**_prefixed("conv", _conv(p["conv"])),
            **_prefixed("bn", _bn(p["bn"], s["bn"]))}


def uper_head_from_flax(p: Tree, s: Tree) -> StateDict:
    """`UPerHead`: flax `psp/pool_N` -> `psp_modules.N.1`, `psp_bottleneck`
    -> `bottleneck`, `lateral_N` / `fpn_conv_N` -> `lateral_convs.N` /
    `fpn_convs.N` (the inverse of `convert_upernet_heads`)."""
    sd = {**_prefixed("bottleneck", _conv_bn_relu(p["psp_bottleneck"],
                                                  s["psp_bottleneck"])),
          **_prefixed("fpn_bottleneck", _conv_bn_relu(p["fpn_bottleneck"],
                                                      s["fpn_bottleneck"])),
          **_prefixed("conv_seg", _conv(p["conv_seg"]))}
    i = 0
    while f"pool_{i}" in p["psp"]:
        sd.update(_prefixed(f"psp_modules.{i}.1", _conv_bn_relu(
            p["psp"][f"pool_{i}"], s["psp"][f"pool_{i}"])))
        i += 1
    i = 0
    while f"lateral_{i}" in p:
        sd.update(_prefixed(f"lateral_convs.{i}", _conv_bn_relu(
            p[f"lateral_{i}"], s[f"lateral_{i}"])))
        sd.update(_prefixed(f"fpn_convs.{i}", _conv_bn_relu(
            p[f"fpn_conv_{i}"], s[f"fpn_conv_{i}"])))
        i += 1
    return sd


def fcn_head_from_flax(p: Tree, s: Tree) -> StateDict:
    """`FCNHead`: flax `conv_N` -> `convs.N`."""
    sd = _prefixed("conv_seg", _conv(p["conv_seg"]))
    i = 0
    while f"conv_{i}" in p:
        sd.update(_prefixed(f"convs.{i}", _conv_bn_relu(p[f"conv_{i}"],
                                                        s[f"conv_{i}"])))
        i += 1
    return sd


def patch_merging_from_flax(p: Tree) -> StateDict:
    """`layers/merging.PatchMerging`."""
    return {**_prefixed("norm", _norm(p["norm"])),
            **_prefixed("reduction", _linear(p["reduction"]))}


def head_from_flax(p: Tree, s: Tree) -> StateDict:
    """A decode head: Mask2Former, MaskFormer, UPerHead or FCNHead."""
    if "pixel_decoder" in p and "query_feat" not in p:
        return maskformer_head_from_flax(p)
    if "pixel_decoder" in p:
        return mask2former_head_from_flax(p)
    if "psp" in p:
        return uper_head_from_flax(p, s)
    return fcn_head_from_flax(p, s)


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


def maskformer_head_from_flax(p: Tree) -> StateDict:
    """`MaskFormerHead` with either pixel decoder (the inverse of the JAX
    `convert_maskformer_head`): flax `last_conv` is `last_feat_conv` of the
    plain decoder and `encoder_out_proj` of the encoder variant; the
    decoder layers' `self_attn` is `attentions.0`, `cross_attn`
    `attentions.1`."""
    pd = p["pixel_decoder"]
    dec = {**_prefixed("mask_feature", _conv(pd["mask_feature"]))}
    i = 0
    while f"lateral_{i}" in pd:
        dec.update(_prefixed(f"lateral_convs.{i}", _conv_gn(pd[f"lateral_{i}"])))
        dec.update(_prefixed(f"output_convs.{i}", _conv_gn(pd[f"output_{i}"])))
        i += 1
    if "encoder_in_proj" in pd:
        dec.update(_prefixed("encoder_in_proj", _conv(pd["encoder_in_proj"])))
        dec.update(_prefixed("encoder_out_proj", _conv_gn(pd["last_conv"])))
        i = 0
        while f"enc_attn_{i}" in pd:
            pre = f"encoder.layers.{i}"
            dec.update(_prefixed(f"{pre}.attentions.0",
                                 _mha(pd[f"enc_attn_{i}"])))
            dec.update(_prefixed(f"{pre}.norms.0", _norm(pd[f"enc_norm1_{i}"])))
            dec.update(_prefixed(f"{pre}.norms.1", _norm(pd[f"enc_norm2_{i}"])))
            dec.update(_prefixed(f"{pre}.ffns.0", _ffn(pd[f"enc_fc1_{i}"],
                                                        pd[f"enc_fc2_{i}"])))
            i += 1
    else:
        dec.update(_prefixed("last_feat_conv", _conv_gn(pd["last_conv"])))
    sd = {"query_embed.weight": _t(p["query_embed"]),
          **_prefixed("cls_embed", _linear(p["cls_embed"])),
          **_prefixed("transformer_decoder.post_norm", _norm(p["post_norm"])),
          **_prefixed("pixel_decoder", dec)}
    for i, t_idx in enumerate((0, 2, 4)):
        sd.update(_prefixed(f"mask_embed.{t_idx}",
                            _linear(p[f"mask_embed_{i}"])))
    i = 0
    while f"decoder_layer_{i}" in p:
        lp = p[f"decoder_layer_{i}"]
        pre = f"transformer_decoder.layers.{i}"
        sd.update(_prefixed(f"{pre}.attentions.0", _mha(lp["self_attn"])))
        sd.update(_prefixed(f"{pre}.attentions.1", _mha(lp["cross_attn"])))
        for j in (0, 1, 2):
            sd.update(_prefixed(f"{pre}.norms.{j}", _norm(lp[f"norm{j + 1}"])))
        sd.update(_prefixed(f"{pre}.ffns.0", _ffn(lp["ffn_fc1"],
                                                   lp["ffn_fc2"])))
        i += 1
    return sd


def neck_from_flax(p: Tree) -> StateDict:
    """`FPN` (flax `lateral_N` / `fpn_conv_N` -> `lateral_convs.N.conv` /
    `fpn_convs.N.conv`) or `ChannelMapperWithPooling` (`conv_N` / `gn_N` ->
    `convs.N.conv` / `convs.N.gn`)."""
    sd: StateDict = {}
    for flax_name, name in (("lateral", "lateral_convs"),
                            ("fpn_conv", "fpn_convs"), ("conv", "convs")):
        i = 0
        while f"{flax_name}_{i}" in p:
            sd.update(_prefixed(f"{name}.{i}.conv",
                                _conv(p[f"{flax_name}_{i}"])))
            if f"gn_{i}" in p and name == "convs":
                sd.update(_prefixed(f"convs.{i}.gn", _norm(p[f"gn_{i}"])))
            i += 1
    return sd


def bbox_head_from_flax(p: Tree, roi: int = 7) -> StateDict:
    """`Shared2FCBBoxHead`: flax `fc1`, `fc2` -> `shared_fcs.0`, `.1`. The
    flax fc1 reads the RoI features channel last, mmdet's channel first (the
    inverse of `convert_detector_checkpoint`'s permutation)."""
    k = np.asarray(p["fc1"]["kernel"]).T              # (out, roi*roi*C)
    out = k.shape[0]
    k = k.reshape(out, roi, roi, -1).transpose(0, 3, 1, 2).reshape(out, -1)
    return {"shared_fcs.0.weight": _t(k),
            "shared_fcs.0.bias": _t(p["fc1"]["bias"]),
            **_prefixed("shared_fcs.1", _linear(p["fc2"])),
            **_prefixed("fc_cls", _linear(p["fc_cls"])),
            **_prefixed("fc_reg", _linear(p["fc_reg"]))}


def mask_head_from_flax(p: Tree) -> StateDict:
    """`FCNMaskHead`: flax `conv_N` -> `convs.N.conv`, HTC's
    `conv_res_feat` -> `conv_res_feat.conv`."""
    sd = {**_prefixed("upsample", _conv_transpose(p["upsample"])),
          **_prefixed("conv_logits", _conv(p["conv_logits"]))}
    if "conv_res_feat" in p:
        sd.update(_prefixed("conv_res_feat.conv", _conv(p["conv_res_feat"])))
    i = 0
    while f"conv_{i}" in p:
        sd.update(_prefixed(f"convs.{i}.conv", _conv(p[f"conv_{i}"])))
        i += 1
    return sd


def mask_rcnn_from_flax(p: Tree, s: Tree) -> StateDict:
    """`MaskRCNN` with any backbone `backbone_from_flax` takes: the inverse
    of `convert_detector_checkpoint` for the Mask R-CNN keys."""
    rpn = {f"rpn_head.{n}.{k}": v for n in ("rpn_conv", "rpn_cls", "rpn_reg")
           for k, v in _conv(p["rpn_head"][n]).items()}
    return {**_prefixed("backbone", backbone_from_flax(
                p["backbone"], s.get("backbone", {}))),
            **_prefixed("neck", neck_from_flax(p["neck"])), **rpn,
            **_prefixed("roi_head.bbox_head",
                        bbox_head_from_flax(p["bbox_head"])),
            **_prefixed("roi_head.mask_head",
                        mask_head_from_flax(p["mask_head"]))}


def extra_attention_from_flax(p: Tree) -> StateDict:
    """`ExtraAttention`: flax `norm1_0`, `attn_0`, `ffn_fc1_0`, ... ->
    `norm1`, `attn`, `ffn.fc1`, ... (the inverse of
    `convert_detector_checkpoint`'s `neck.0` keys)."""
    return {**_prefixed("norm1", _norm(p["norm1_0"])),
            **_prefixed("attn.qkv", _linear(p["attn_0"]["qkv"])),
            **_prefixed("attn.proj", _linear(p["attn_0"]["proj"])),
            **_prefixed("norm2", _norm(p["norm2_0"])),
            **_prefixed("ffn.fc1", _linear(p["ffn_fc1_0"])),
            **_prefixed("ffn.fc2", _linear(p["ffn_fc2_0"])),
            **_prefixed("final_norm", _norm(p["final_norm_0"]))}


def semantic_head_from_flax(p: Tree) -> StateDict:
    """HTC's `SemanticHead`: flax `lateral_fuse` (level 1) and `lateral_N`
    -> `lateral_convs.N.conv`, `conv_N` -> `convs.N.conv`, `conv_seg` ->
    `conv_logits`."""
    sd = {**_prefixed("conv_embedding.conv", _conv(p["conv_embedding"])),
          **_prefixed("conv_logits", _conv(p["conv_seg"])),
          **_prefixed("lateral_convs.1.conv", _conv(p["lateral_fuse"]))}
    for name, sub in p.items():
        kind, _, i = name.rpartition("_")
        if kind in ("lateral", "conv") and i.isdigit():
            dst = "lateral_convs" if kind == "lateral" else "convs"
            sd.update(_prefixed(f"{dst}.{i}.conv", _conv(sub)))
    return sd


def cascade_from_flax(p: Tree, s: Tree) -> StateDict:
    """`CascadeRCNN` with any backbone `backbone_from_flax` takes: the
    inverse of `convert_detector_checkpoint` for mmdet's HTC keys (`neck.0`
    the ExtraAttention and `neck.1` the FPN where there is one,
    `roi_head.{bbox,mask}_head.{s}`, `roi_head.semantic_head`)."""
    rpn = {f"rpn_head.{n}.{k}": v for n in ("rpn_conv", "rpn_cls", "rpn_reg")
           for k, v in _conv(p["rpn_head"][n]).items()}
    sd = {**_prefixed("backbone", backbone_from_flax(
              p["backbone"], s.get("backbone", {}))), **rpn}
    if "extra_attn" in p:
        sd.update({**_prefixed("neck.0", extra_attention_from_flax(
                       p["extra_attn"])),
                   **_prefixed("neck.1", neck_from_flax(p["neck"]))})
    else:
        sd.update(_prefixed("neck", neck_from_flax(p["neck"])))
    i = 0
    while f"bbox_head_{i}" in p:
        sd.update(_prefixed(f"roi_head.bbox_head.{i}",
                            bbox_head_from_flax(p[f"bbox_head_{i}"])))
        if f"mask_head_{i}" in p:
            sd.update(_prefixed(f"roi_head.mask_head.{i}",
                                mask_head_from_flax(p[f"mask_head_{i}"])))
        i += 1
    if "semantic_head" in p:
        sd.update(_prefixed("roi_head.semantic_head",
                            semantic_head_from_flax(p["semantic_head"])))
    return sd


def atss_from_flax(p: Tree, s: Tree) -> StateDict:
    """`ATSS` / GFL (the inverse of `convert_detector_checkpoint`'s
    single-stage branch): the FPN with its learned extras, the towers'
    `conv_N`/`gn_N` -> `{cls,reg}_convs.N.conv`/`.gn`, `atss_cls`/`_reg`
    -> `atss_*` or, when the regression has bins, `gfl_*`,
    `atss_centerness`, and `scales` -> `scales.N.scale`."""
    h = p["head"]
    fam = "atss" if np.shape(h["atss_reg"]["kernel"])[-1] == 4 else "gfl"
    head = {**_prefixed(f"{fam}_cls", _conv(h["atss_cls"])),
            **_prefixed(f"{fam}_reg", _conv(h["atss_reg"])),
            **_prefixed("atss_centerness", _conv(h["atss_centerness"]))}
    for tower, name in (("cls_tower", "cls_convs"), ("reg_tower",
                                                     "reg_convs")):
        i = 0
        while f"conv_{i}" in h[tower]:
            head.update(_prefixed(f"{name}.{i}.conv",
                                  _conv(h[tower][f"conv_{i}"])))
            head.update(_prefixed(f"{name}.{i}.gn",
                                  _norm(h[tower][f"gn_{i}"])))
            i += 1
    for i, v in enumerate(np.asarray(h["scales"], np.float32)):
        head[f"scales.{i}.scale"] = _t(v)
    return {**_prefixed("backbone", backbone_from_flax(
                p["backbone"], s.get("backbone", {}))),
            **_prefixed("neck", neck_from_flax(p["neck"])),
            **_prefixed("bbox_head", head)}


def sparse_rcnn_from_flax(p: Tree, s: Tree) -> StateDict:
    """`SparseRCNN` (the inverse of `convert_detector_checkpoint`'s Sparse
    R-CNN branch): the learned proposals under `rpn_head`, each `stage_N`
    under `roi_head.bbox_head.N`, the flax towers' `{cls,reg}_fc_J` /
    `_ln_J` -> `{cls,reg}_fcs.{3J}` / `.{3J+1}`."""
    sd = {**_prefixed("backbone", backbone_from_flax(
              p["backbone"], s.get("backbone", {}))),
          **_prefixed("neck", neck_from_flax(p["neck"])),
          "rpn_head.init_proposal_features.weight":
              _t(p["init_proposal_features"]),
          "rpn_head.init_proposal_bboxes.weight":
              _t(p["init_proposal_boxes"])}
    i = 0
    while f"stage_{i}" in p:
        sp = p[f"stage_{i}"]
        dyn = sp["dynamic_conv"]
        st = {**_prefixed("attention", _mha(sp["self_attn"])),
              **_prefixed("attention_norm", _norm(sp["norm_attn"])),
              **_prefixed("instance_interactive_conv", {
                  **_prefixed("dynamic_layer", _linear(dyn["dynamic_layer"])),
                  **_prefixed("norm_in", _norm(dyn["norm1"])),
                  **_prefixed("norm_out", _norm(dyn["norm2"])),
                  **_prefixed("fc_layer", _linear(dyn["fc_out"])),
                  **_prefixed("fc_norm", _norm(dyn["norm3"]))}),
              **_prefixed("instance_interactive_conv_norm",
                          _norm(sp["norm_inter"])),
              **_prefixed("ffn", _ffn(sp["ffn_fc1"], sp["ffn_fc2"])),
              **_prefixed("ffn_norm", _norm(sp["norm_ffn"])),
              **_prefixed("fc_cls", _linear(sp["fc_cls"])),
              **_prefixed("fc_reg", _linear(sp["fc_reg"]))}
        for tower, n in (("cls", 1), ("reg", 3)):
            for j in range(n):
                st.update(_prefixed(f"{tower}_fcs.{3 * j}",
                                    _linear(sp[f"{tower}_fc_{j}"])))
                st.update(_prefixed(f"{tower}_fcs.{3 * j + 1}",
                                    _norm(sp[f"{tower}_ln_{j}"])))
        sd.update(_prefixed(f"roi_head.bbox_head.{i}", st))
        i += 1
    return sd


def channel_mapper_from_flax(p: Tree) -> StateDict:
    """`ChannelMapper`: flax `conv_N`/`gn_N` -> `convs.N.conv`/`.gn`,
    `extra_conv_N`/`extra_gn_N` -> `extra_convs.N.conv`/`.gn`."""
    sd: StateDict = {}
    for flax_name, name in (("", "convs"), ("extra_", "extra_convs")):
        i = 0
        while f"{flax_name}conv_{i}" in p:
            sd.update(_prefixed(f"{name}.{i}.conv",
                                _conv(p[f"{flax_name}conv_{i}"])))
            sd.update(_prefixed(f"{name}.{i}.gn",
                                _norm(p[f"{flax_name}gn_{i}"])))
            i += 1
    return sd


def dino_transformer_from_flax(p: Tree) -> StateDict:
    """`DinoTransformer` without the label embedding (the inverse of the JAX
    `convert_dino_head`): `transformer.*` and the head's branches, flax
    `reg_branch_N_fc0`/`_fc1`/`_out` -> `reg_branches.N.0`/`.2`/`.4`."""
    tr = {"level_embeds": _t(p["level_embed"]),
          "query_embed.weight": _t(p["query_embed"]),
          **_prefixed("enc_output", _linear(p["enc_output"])),
          **_prefixed("enc_output_norm", _norm(p["enc_output_norm"])),
          **_prefixed("decoder.norm", _norm(p["decoder_norm"])),
          **_prefixed("decoder.ref_point_head.0",
                      _linear(p["ref_point_fc1"])),
          **_prefixed("decoder.ref_point_head.2",
                      _linear(p["ref_point_fc2"]))}
    i = 0
    while f"encoder_layer_{i}" in p:
        lp = p[f"encoder_layer_{i}"]
        pre = f"encoder.layers.{i}"
        tr.update(_prefixed(f"{pre}.attentions.0", msda_from_flax(lp["attn"])))
        tr.update(_prefixed(f"{pre}.norms.0", _norm(lp["norm1"])))
        tr.update(_prefixed(f"{pre}.norms.1", _norm(lp["norm2"])))
        tr.update(_prefixed(f"{pre}.ffns.0", _ffn(lp["ffn_fc1"],
                                                   lp["ffn_fc2"])))
        i += 1
    i = 0
    while f"decoder_layer_{i}" in p:
        lp = p[f"decoder_layer_{i}"]
        pre = f"decoder.layers.{i}"
        tr.update(_prefixed(f"{pre}.attentions.0", _mha(lp["self_attn"])))
        tr.update(_prefixed(f"{pre}.attentions.1",
                            msda_from_flax(lp["cross_attn"])))
        for j in (0, 1, 2):
            tr.update(_prefixed(f"{pre}.norms.{j}",
                                _norm(lp[f"norm{j + 1}"])))
        tr.update(_prefixed(f"{pre}.ffns.0", _ffn(lp["ffn_fc1"],
                                                   lp["ffn_fc2"])))
        i += 1
    sd = _prefixed("transformer", tr)
    i = 0
    while f"cls_branch_{i}" in p:
        sd.update(_prefixed(f"cls_branches.{i}",
                            _linear(p[f"cls_branch_{i}"])))
        for j, name in ((0, "fc0"), (2, "fc1"), (4, "out")):
            sd.update(_prefixed(f"reg_branches.{i}.{j}",
                                _linear(p[f"reg_branch_{i}_{name}"])))
        i += 1
    return sd


def grounding_dino_from_flax(p: Tree, s: Tree) -> StateDict:
    """`GroundingDINO` or `DINO` (the inverse of the JAX
    `convert_grounding_dino_checkpoint`): `backbone`, `neck`, `bbox_head`
    (the transformer, the branches and `label_embedding`) and, where the
    branch is on, `aux_seg_conv_0`/`_1`/`aux_seg_out` ->
    `aux_seg_convs.0`/`.1`/`.2`."""
    sd = {**_prefixed("backbone", backbone_from_flax(
              p["backbone"], s.get("backbone", {}))),
          **_prefixed("neck", channel_mapper_from_flax(p["neck"])),
          **_prefixed("bbox_head",
                      dino_transformer_from_flax(p["transformer"])),
          "bbox_head.label_embedding.weight": _t(p["label_embed"])}
    for i, name in enumerate(("aux_seg_conv_0", "aux_seg_conv_1",
                              "aux_seg_out")):
        if name in p:
            sd.update(_prefixed(f"aux_seg_convs.{i}", _conv(p[name])))
    return sd


def state_dict_from_flax(params: Tree,
                         batch_stats: Optional[Tree] = None) -> StateDict:
    """A flax variable tree -> the port's `state_dict`. Takes the tree of a
    whole `MaskRCNN` (`backbone`, `neck`, `rpn_head`, `bbox_head`,
    `mask_head`), `CascadeRCNN` (`bbox_head_0`, ...), `GroundingDINO` or
    `DINO` (`backbone`, `neck`, `transformer`, `label_embed`), `ATSS`
    (`backbone`, `neck`, `head`), `SparseRCNN` (`stage_0`, ...),
    `EncoderDecoderMask2Former` or `EncoderDecoder`
    (`backbone`, `decode_head`, `auxiliary_head`), or of one of their
    modules:
    `ViTAdapter`, `BEiTAdapter`, `UniPerceiverAdapter`, `ViTBaseline`,
    `BEiTBaseline`, `DinoTransformer`,
    `Mask2FormerHead`, `MaskFormerHead`, `UPerHead`, `FCNHead`, the `SimpleFeaturePyramid`,
    the pixel decoder, an `InteractionBlock`, the `SpatialPriorModule`, a
    ViT `Block`, a `ResBottleneckBlock`, a `BEiTBlock`, an `MSDeformAttn`
    or a `PatchMerging`."""
    s = batch_stats or {}
    if "backbone" in params and "transformer" in params:
        return grounding_dino_from_flax(params, s)
    if "backbone" in params and "stage_0" in params:
        return sparse_rcnn_from_flax(params, s)
    if "backbone" in params and "head" in params:
        return atss_from_flax(params, s)
    if "backbone" in params and "bbox_head_0" in params:
        return cascade_from_flax(params, s)
    if "backbone" in params and "rpn_head" in params:
        return mask_rcnn_from_flax(params, s)
    if "backbone" in params and "decode_head" in params:
        sd = _prefixed("backbone", backbone_from_flax(
            params["backbone"], s.get("backbone", {})))
        for head in ("decode_head", "auxiliary_head"):
            if head in params:
                sd.update(_prefixed(head, head_from_flax(
                    params[head], s.get(head, {}))))
        return sd
    if "vit" in params or "beit" in params or "trunk" in params:
        return backbone_from_flax(params, s)
    if "enc_output" in params:
        return dino_transformer_from_flax(params)
    if "pixel_decoder" in params or "psp" in params or "conv_seg" in params:
        return head_from_flax(params, s)
    if "up4_a" in params:
        return pyramid_from_flax(params)
    if "reduction" in params:
        return patch_merging_from_flax(params)
    if "encoder_layers" in params:
        return pixel_decoder_from_flax(params)
    if "injector" in params:
        return interaction_from_flax(params)
    if "stem1_conv" in params:
        return spm_from_flax(params, s)
    if "norm3_weight" in params:
        return residual_from_flax(params)
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
