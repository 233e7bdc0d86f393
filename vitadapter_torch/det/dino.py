"""DINO: the two-stage deformable transformer with contrastive denoising
(counterpart of `vitadapter/det/dino.py`).

* `DinoTransformer`: 6 deformable encoder layers over 4 scales
  (`heads/pixel_decoder.py::DeformableEncoderLayer`, 4 levels), proposals
  from the encoder output (positions whose proposal box leaves (0.01, 0.99)
  get score logit +inf boxes and zeroed memory), the top `num_queries` as
  the decoder's reference boxes, and 6 decoder layers (self attention, then
  `ops/msda.py::MSDeformAttn` sampling around 4-d reference boxes) with
  look-forward-twice box refinement: layer i predicts on the normed output
  from the un-detached refs that entered it, while the refs passed on are
  detached.
* `cdn_draws` / `cdn_queries`: the denoising groups (label flips and box
  jitter, positives within the box and negatives between 1x and 2x its
  extent) with the block attention mask. The noise is drawn apart from the
  construction, so that a test can feed the JAX package's draws; the JAX
  package draws the flip and its random label from one key, the port from
  one generator in turn: the same distribution, not the same stream.
* `dino_matching_loss` (focal 2.0 + L1 5.0 + GIoU 2.0, Hungarian-matched by
  `ops/matching.py::hungarian_assign`, the auction kernel on the card) and
  `dino_dn_loss` (each denoising query reconstructs its gt).

Parameter names are the reference DINO head's (`transformer.encoder.
layers.N.attentions.0`, `transformer.decoder.layers.N.attentions.{0,1}`,
`transformer.decoder.ref_point_head.{0,2}`, `transformer.level_embeds`,
`cls_branches.N`, `reg_branches.N.{0,2,4}`, `label_embedding`), which the
JAX package's `convert_dino_head` reads.
"""

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from vitadapter_torch.det.boxes import stable_top_k
from vitadapter_torch.det.losses import (bbox_l1_cost, cxcywh_to_xyxy,
                                         focal_cost, giou, giou_cost,
                                         inverse_sigmoid, one_hot,
                                         sigmoid_focal_loss, xyxy_to_cxcywh)
from vitadapter_torch.heads.mask2former import MultiheadAttention
from vitadapter_torch.heads.pixel_decoder import FFN, DeformableEncoder
from vitadapter_torch.layers.linear import Linear
from vitadapter_torch.layers.norm import LayerNorm
from vitadapter_torch.layers.positional import sine_positional_encoding
from vitadapter_torch.ops.matching import hungarian_assign
from vitadapter_torch.ops.msda import MSDeformAttn
from vitadapter_torch.parallel.collectives import global_normalizer

Assigner = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def sine_embed_coords(coords: torch.Tensor, num_feats: int = 128,
                      temperature: float = 10000.0) -> torch.Tensor:
    """DETR sine embedding of normalized coords (..., n) -> (..., n *
    num_feats) fp32: scale 2 pi, interleaved sin/cos per coordinate
    (reference `gen_sineembed_for_position`)."""
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=coords.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_feats)
    x = coords.float()[..., None] * (2 * math.pi) / dim_t
    emb = torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()], dim=-1)
    return emb.reshape(*coords.shape[:-1], coords.shape[-1] * num_feats)


class DinoDecoderLayer(nn.Module):
    """self attention -> LN -> deformable cross attention -> LN -> FFN ->
    LN (the norms in fp32, as the JAX layer's)."""

    def __init__(self, dim: int = 256, num_heads: int = 8,
                 n_levels: int = 4, n_points: int = 4, ffn_dim: int = 2048,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attentions = nn.ModuleList([
            MultiheadAttention(dim, num_heads, **kw),
            MSDeformAttn(dim, n_levels, num_heads, n_points, **kw)])
        self.norms = nn.ModuleList([LayerNorm(dim, eps=1e-5, device=device)
                                    for _ in range(3)])
        self.ffns = nn.ModuleList([FFN(dim, ffn_dim, **kw)])

    def forward(self, query, query_pos, memory, spatial_shapes,
                reference_points, self_attn_mask=None):
        q = query + query_pos
        x = self.norms[0](query + self.attentions[0](q, q, query,
                                                     self_attn_mask))
        ca = self.attentions[1](x + query_pos, reference_points, memory,
                                spatial_shapes)
        x = self.norms[1](x + ca)
        return self.norms[2](x + self.ffns[0](x))


class _Decoder(nn.Module):
    def __init__(self, num_layers: int, dim: int, **layer_kw):
        super().__init__()
        device = layer_kw.get("device")
        dtype = layer_kw.get("dtype", torch.float32)
        self.layers = nn.ModuleList([DinoDecoderLayer(dim, **layer_kw)
                                     for _ in range(num_layers)])
        # the final norm: the predictions run on normed outputs, the box
        # refinement that feeds the next layer on the raw ones
        self.norm = LayerNorm(dim, eps=1e-5, device=device)
        self.ref_point_head = nn.Sequential(
            Linear(2 * dim, dim, dtype=dtype, device=device), nn.ReLU(),
            Linear(dim, dim, dtype=dtype, device=device))


class _Transformer(nn.Module):
    """The reference's `bbox_head.transformer`."""

    def __init__(self, dim: int, num_heads: int, num_encoder_layers: int,
                 num_decoder_layers: int, n_points: int, ffn_dim: int,
                 num_queries: int, dtype: torch.dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.level_embeds = nn.Parameter(torch.zeros(4, dim, device=device))
        self.encoder = DeformableEncoder(
            num_encoder_layers, dim=dim, num_heads=num_heads, n_levels=4,
            n_points=n_points, ffn_dim=ffn_dim, **kw)
        self.decoder = _Decoder(num_decoder_layers, dim, num_heads=num_heads,
                                n_levels=4, n_points=n_points,
                                ffn_dim=ffn_dim, **kw)
        self.enc_output = Linear(dim, dim, **kw)
        self.enc_output_norm = LayerNorm(dim, eps=1e-5, device=device)
        self.query_embed = nn.Embedding(num_queries, dim, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.level_embeds.normal_(0.0, 1.0, generator=generator)
        self.query_embed.weight.normal_(0.0, 1.0, generator=generator)


def _branch_mlp(dim: int, dtype: torch.dtype, device) -> nn.Sequential:
    """A box branch: two ReLU layers in the compute dtype, the 4-wide
    output layer in fp32."""
    return nn.Sequential(Linear(dim, dim, dtype=dtype, device=device),
                         nn.ReLU(),
                         Linear(dim, dim, dtype=dtype, device=device),
                         nn.ReLU(), Linear(dim, 4, device=device))


class DinoTransformer(nn.Module):
    """The DINO head: the deformable transformer, one class and one box
    branch per decoder layer plus one for the encoder's proposals (class
    branches in fp32), and the denoising label embedding.

    forward(feats 4 NHWC maps of `embed_dim` channels, dn_queries (B, n_dn,
    C), dn_refs (B, n_dn, 4), dn_attn_mask (n_total, n_total) bool, True =
    masked) -> {"cls": per decoder layer (B, n_dn + Q, K) fp32, "boxes":
    per layer (B, n_dn + Q, 4) normalized cxcywh, "enc_cls" (B, Q, K),
    "enc_boxes" (B, Q, 4)}."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 n_points: int = 4, ffn_dim: int = 2048,
                 num_queries: int = 900, num_classes: int = 80,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_queries = num_queries
        self.num_classes = num_classes
        self.compute_dtype = dtype
        self.transformer = _Transformer(
            embed_dim, num_heads, num_encoder_layers, num_decoder_layers,
            n_points, ffn_dim, num_queries, dtype, device)
        n_pred = num_decoder_layers + 1
        self.cls_branches = nn.ModuleList([
            Linear(embed_dim, num_classes, device=device)
            for _ in range(n_pred)])
        self.reg_branches = nn.ModuleList([
            _branch_mlp(embed_dim, dtype, device) for _ in range(n_pred)])
        self.label_embedding = nn.Embedding(num_classes, embed_dim,
                                            device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.label_embedding.weight.normal_(0.0, 1.0, generator=generator)

    def _query_pos(self, refs: torch.Tensor) -> torch.Tensor:
        """4-d reference boxes -> positional queries: the sine embedding in
        (y, x, w, h) order, then the two-layer head."""
        emb = sine_embed_coords(refs[..., [1, 0, 2, 3]], self.embed_dim // 2)
        return self.transformer.decoder.ref_point_head(
            emb.to(self.compute_dtype))

    def forward(self, feats: Sequence[torch.Tensor],
                dn_queries: Optional[torch.Tensor] = None,
                dn_refs: Optional[torch.Tensor] = None,
                dn_attn_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, object]:
        tr = self.transformer
        B, C = feats[0].shape[0], self.embed_dim
        dev = feats[0].device
        tokens, pos, shapes, grids, proposals = [], [], [], [], []
        for i, f in enumerate(feats):
            H, W = f.shape[1], f.shape[2]
            tokens.append(f.reshape(B, H * W, C))
            p = sine_positional_encoding((H, W), C // 2, device=dev)
            pos.append((p.reshape(1, H * W, C) + tr.level_embeds[i])
                       .to(f.dtype).expand(B, H * W, C))
            shapes.append((H, W))
            ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
            xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
            yy, xx = torch.meshgrid(ys, xs, indexing="ij")
            grid = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)
            grids.append(grid)
            proposals.append(torch.cat(
                [grid, torch.full_like(grid, 0.05 * 2.0 ** i)], -1))
        memory = torch.cat(tokens, 1)
        pos_all = torch.cat(pos, 1)
        spatial_shapes = tuple(shapes)
        ref = torch.cat(grids)[None, :, None, :]
        memory = tr.encoder(memory, pos_all, ref, spatial_shapes)

        # two-stage proposals in inverse-sigmoid space; positions whose
        # proposal leaves (0.01, 0.99) are +inf and their memory zeroed
        props = torch.cat(proposals)[None]                       # (1, S, 4)
        valid = ((props > 0.01) & (props < 0.99)).all(-1, keepdim=True)
        props_unact = torch.where(valid, torch.log(props / (1 - props)),
                                  torch.full_like(props, math.inf))
        mem_in = torch.where(valid, memory, torch.zeros_like(memory))
        out_memory = tr.enc_output_norm(tr.enc_output(mem_in))
        n_dec = len(tr.decoder.layers)
        enc_cls = self.cls_branches[n_dec](out_memory).float()
        enc_boxes = torch.sigmoid(self.reg_branches[n_dec](out_memory).float()
                                  + props_unact)
        _, top_idx = stable_top_k(enc_cls.amax(-1), self.num_queries)
        idx4 = top_idx[..., None].expand(-1, -1, 4)
        refs = enc_boxes.gather(1, idx4).detach()
        enc_cls_top = enc_cls.gather(
            1, top_idx[..., None].expand(-1, -1, enc_cls.shape[-1]))
        enc_box_top = enc_boxes.gather(1, idx4)

        query = tr.query_embed.weight[None].to(memory.dtype).expand(
            B, self.num_queries, C)
        attn_mask = None
        if dn_queries is not None:
            query = torch.cat([dn_queries.to(query.dtype), query], 1)
            refs = torch.cat([dn_refs.float(), refs], 1)
            attn_mask = dn_attn_mask[None, None].expand(
                B, self.num_heads, *dn_attn_mask.shape)

        cls_list: List[torch.Tensor] = []
        box_list: List[torch.Tensor] = []
        base = refs
        for i, layer in enumerate(tr.decoder.layers):
            qpos = self._query_pos(refs)
            query = layer(query, qpos, memory, spatial_shapes,
                          refs[:, :, None, :].expand(-1, -1, 4, -1),
                          self_attn_mask=attn_mask)
            normed = tr.decoder.norm(query)
            cls_list.append(self.cls_branches[i](normed).float())
            box_list.append(torch.sigmoid(
                self.reg_branches[i](normed).float()
                + inverse_sigmoid(base, eps=1e-3)))
            new_refs = torch.sigmoid(self.reg_branches[i](query).float()
                                     + inverse_sigmoid(refs, eps=1e-3))
            base = new_refs
            refs = new_refs.detach()
        return {"cls": cls_list, "boxes": box_list, "enc_cls": enc_cls_top,
                "enc_boxes": enc_box_top}


class DnDraws(NamedTuple):
    """The random draws of the denoising groups, for (B, n_dn) queries."""
    flip: torch.Tensor        # (B, n_dn) bool: the label is replaced
    rand_label: torch.Tensor  # (B, n_dn) int64: the replacement label
    sign: torch.Tensor        # (B, n_dn, 4) +1 or -1 per corner coordinate
    u: torch.Tensor           # (B, n_dn, 4) uniform jitter magnitude


class DnQueries(NamedTuple):
    queries: torch.Tensor    # (B, n_dn, C)
    refs: torch.Tensor       # (B, n_dn, 4) cxcywh
    attn_mask: torch.Tensor  # (n_total, n_total) bool, True = masked
    labels: torch.Tensor     # (B, n_dn) targets (num_classes = negative)
    boxes: torch.Tensor      # (B, n_dn, 4) target boxes (cxcywh)
    valid: torch.Tensor      # (B, n_dn) contributes to the loss
    is_pos: torch.Tensor     # (B, n_dn) positive (box-reconstructing)


def cdn_draws(generator: Optional[torch.Generator], B: int, G: int,
              num_groups: int, num_classes: int, label_noise: float = 0.5,
              device=None) -> DnDraws:
    """The draws of `cdn_queries` from `generator` (on `device`): flip
    where a uniform is below label_noise / 2, a uniform random label,
    signs where a uniform is above 1/2, uniform magnitudes."""
    n_dn = 2 * G * num_groups

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    flip = rand(B, n_dn) < label_noise * 0.5
    rand_label = torch.randint(0, num_classes, (B, n_dn),
                               generator=generator, device=device)
    sign = torch.where(rand(B, n_dn, 4) > 0.5, 1.0, -1.0)
    return DnDraws(flip, rand_label, sign, rand(B, n_dn, 4))


def cdn_queries(draws: DnDraws, gt_labels: torch.Tensor,
                gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                label_embed: torch.Tensor, num_groups: int, num_classes: int,
                num_matching: int, box_noise: float = 1.0) -> DnQueries:
    """Contrastive denoising queries (reference `CdnQueryGenerator`) on
    `draws`: each group holds G positive and G negative noised copies of
    the gts (normalized cxcywh); the attention mask keeps the groups from
    each other and the matching queries from every group."""
    B, G = gt_labels.shape
    n_dn = 2 * G * num_groups
    dev = gt_boxes.device
    labels = gt_labels.long().repeat(1, 2 * num_groups)
    boxes = gt_boxes.float().repeat(1, 2 * num_groups, 1)
    valid = gt_valid.bool().repeat(1, 2 * num_groups)
    is_pos = torch.cat([torch.ones(G, dtype=torch.bool, device=dev),
                        torch.zeros(G, dtype=torch.bool, device=dev)]
                       ).repeat(num_groups)[None].expand(B, n_dn)

    noisy_labels = torch.where(draws.flip.to(dev), draws.rand_label.to(dev),
                               labels)
    wh = boxes[..., 2:]
    diff = torch.cat([wh / 2, wh / 2], -1)
    u = draws.u.to(dev).float()
    mag = torch.where(is_pos[..., None], u, 1.0 + u)
    noisy = (cxcywh_to_xyxy(boxes) + draws.sign.to(dev).float() * mag * diff
             * box_noise).clamp(0.0, 1.0)
    # corner jitter can invert a box; the reference's inverse_sigmoid(eps
    # 1e-3) + sigmoid round trip is this clamp
    noisy_boxes = xyxy_to_cxcywh(noisy).clamp(1e-3, 1 - 1e-3)

    queries = label_embed[noisy_labels]
    n_total = n_dn + num_matching
    mask = torch.zeros((n_total, n_total), dtype=torch.bool, device=dev)
    mask[n_dn:, :n_dn] = True
    gidx = torch.arange(n_dn, device=dev) // (2 * G)
    mask[:n_dn, :n_dn] = gidx[:, None] != gidx[None, :]
    tgt_labels = torch.where(is_pos, labels,
                             torch.full_like(labels, num_classes))
    return DnQueries(queries, noisy_boxes, mask, tgt_labels, boxes, valid,
                     is_pos & valid)


def dino_matching_loss(cls_logits, pred_boxes, gt_labels, gt_boxes_n,
                       gt_valid, num_classes: int, w_cls: float = 2.0,
                       w_l1: float = 5.0, w_iou: float = 2.0,
                       assigner: Assigner = hungarian_assign
                       ) -> Dict[str, torch.Tensor]:
    """Hungarian-matched focal + L1 + GIoU losses of one decoder layer (or
    of the encoder's proposals): cls_logits (B, Q, K), boxes normalized
    cxcywh. One `assigner` call solves the batch's B (Q, G) matrices."""
    with torch.no_grad():
        cost = (focal_cost(cls_logits, gt_labels, w_cls)
                + bbox_l1_cost(pred_boxes.float(), gt_boxes_n, w_l1)
                + giou_cost(cxcywh_to_xyxy(pred_boxes.float()),
                            cxcywh_to_xyxy(gt_boxes_n), w_iou))
        assign = assigner(cost.float().contiguous(),
                          gt_valid.sum(-1).to(torch.int32))
    pos = assign >= 0
    safe = assign.clamp(min=0)
    labels = torch.where(pos, gt_labels.long().gather(1, safe),
                         torch.full_like(safe, num_classes))
    num_pos = global_normalizer(pos.sum().float())
    loss_cls = sigmoid_focal_loss(cls_logits.float(), one_hot(
        labels, num_classes)).sum() / num_pos * w_cls
    tgt = gt_boxes_n.float().gather(1, safe[..., None].expand(-1, -1, 4))
    l1 = (pred_boxes - tgt).abs().sum(-1)
    zero = torch.zeros_like(l1)
    loss_bbox = torch.where(pos, l1, zero).sum() / num_pos * w_l1
    g = giou(cxcywh_to_xyxy(pred_boxes), cxcywh_to_xyxy(tgt))
    loss_iou = torch.where(pos, 1 - g, zero).sum() / num_pos * w_iou
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
            "loss_iou": loss_iou}


def dino_dn_loss(cls_logits, pred_boxes, dn: DnQueries, num_classes: int,
                 w_cls: float = 2.0, w_l1: float = 5.0, w_iou: float = 2.0
                 ) -> Dict[str, torch.Tensor]:
    """Denoising losses on the fixed assignment: each dn query reconstructs
    its gt (positives) or is background (negatives)."""
    num_pos = global_normalizer(dn.is_pos.sum().float())
    oh = one_hot(torch.where(dn.valid, dn.labels,
                             torch.full_like(dn.labels, num_classes)),
                 num_classes)
    fl = sigmoid_focal_loss(cls_logits.float(), oh)
    loss_cls = torch.where(dn.valid[..., None], fl, torch.zeros_like(fl)
                           ).sum() / num_pos * w_cls
    l1 = (pred_boxes - dn.boxes).abs().sum(-1)
    zero = torch.zeros_like(l1)
    loss_bbox = torch.where(dn.is_pos, l1, zero).sum() / num_pos * w_l1
    g = giou(cxcywh_to_xyxy(pred_boxes), cxcywh_to_xyxy(dn.boxes))
    loss_iou = torch.where(dn.is_pos, 1 - g, zero).sum() / num_pos * w_iou
    return {"loss_cls_dn": loss_cls, "loss_bbox_dn": loss_bbox,
            "loss_iou_dn": loss_iou}


def dino_losses(outs, dn: DnQueries, gt_labels, gt_n, gt_valid,
                num_classes: int, assigner: Assigner = hungarian_assign,
                enc_keys: bool = True) -> Dict[str, torch.Tensor]:
    """Every decoder layer's matching and denoising losses (the last
    layer's unprefixed, layer i's as `d{i}.`), the encoder's matching
    losses (under `enc.` where `enc_keys`; GroundingDINO sums them without
    logging them, as the JAX package does), and their sum as `loss`."""
    n_dn = dn.queries.shape[1]
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    n = len(outs["cls"])
    for i, (cls_l, box_l) in enumerate(zip(outs["cls"], outs["boxes"])):
        m = dino_matching_loss(cls_l[:, n_dn:], box_l[:, n_dn:], gt_labels,
                               gt_n, gt_valid, num_classes,
                               assigner=assigner)
        d = dino_dn_loss(cls_l[:, :n_dn], box_l[:, :n_dn], dn, num_classes)
        total = total + sum(m.values()) + sum(d.values())
        prefix = "" if i == n - 1 else f"d{i}."
        losses.update({prefix + k: v for k, v in (m | d).items()})
    enc = dino_matching_loss(outs["enc_cls"], outs["enc_boxes"], gt_labels,
                             gt_n, gt_valid, num_classes, assigner=assigner)
    total = total + sum(enc.values())
    if enc_keys:
        losses.update({"enc." + k: v for k, v in enc.items()})
    losses["loss"] = total
    return losses


def decode_top_k(outs, img_hw, max_dets: int) -> Dict[str, torch.Tensor]:
    """The flat top-k over the last layer's sigmoid class scores (mmdet
    `DETRHead._get_bboxes_single`): boxes xyxy in pixels of `img_hw`,
    scores, labels."""
    H, W = img_hw
    cls_l, box_l = outs["cls"][-1], outs["boxes"][-1]
    B, Q, K = cls_l.shape
    scores = torch.sigmoid(cls_l).reshape(B, Q * K)
    top_s, top_i = stable_top_k(scores, min(max_dets, Q * K))
    q_idx = torch.div(top_i, K, rounding_mode="floor")
    boxes = box_l.gather(1, q_idx[..., None].expand(-1, -1, 4))
    scale = torch.tensor([W, H, W, H], dtype=torch.float32,
                         device=boxes.device)
    return {"boxes": cxcywh_to_xyxy(boxes) * scale, "scores": top_s,
            "labels": (top_i % K).to(torch.int32)}
