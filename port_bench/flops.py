"""Operations and kernel calls of one image through a configuration's
model, counted once per cell shape from the benchmark's frozen plain
reference on the meta device, so the count is the same whatever
implements the model.

Matrix products, convolutions and attention products are counted by
`torch.utils.flop_counter.FlopCounterMode`; the sampling of multi-scale
deformable attention (`F.grid_sample` and its weighted sum, which the
counter does not see) analytically: 2 operations a channel for each of a
point's 4 corners and 2 for its weight. The reference's deformable and
plain attention calls are recorded with their shapes for the kernels'
bounds."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference import builder
from port_bench.reference.ops import attention as ref_attention
from port_bench.reference.ops import msda as ref_msda
from port_bench.roofline import DTYPES

PARTS = ("backbone", "decode_head", "auxiliary_head")


def msda_flops(call: Dict) -> float:
    points = call["B"] * call["Lq"] * call["M"] * call["L"] * call["P"]
    return points * call["D"] * (4 * 2 + 2)


def part_dtypes(model_cfg: Dict) -> Dict[str, torch.dtype]:
    """The dtype the configuration states for each part (fp32 unless it
    says otherwise)."""
    return {p: DTYPES[model_cfg[p].get("dtype", "float32")]
            for p in PARTS if model_cfg.get(p)}


def count(model_cfg: Dict, hw: Tuple[int, int], train: bool
          ) -> Tuple[Dict[str, float], List[Dict], List[Dict]]:
    """(operations of one image's forward by part, the deformable
    attention calls, the plain attention calls), in training or eval mode
    (a segmentor with an auxiliary head runs it in training)."""
    model = builder.build(model_cfg, "meta", all_fp32=False)
    model.requires_grad_(False).train(train)
    x = torch.empty((1, *hw, 3), device="meta")
    current = {"part": None}
    hooks = []
    for p in PARTS:
        mod = getattr(model, p, None)
        if mod is None:
            continue

        def pre(_m, _a, p=p):
            current["part"] = p
        hooks.append(mod.register_forward_pre_hook(pre))
    msda_calls, attn_calls = [], []

    class Tagged(list):
        def append(self, call):
            call["part"] = current["part"]
            super().append(call)

    ref_msda.RECORD, ref_attention.RECORD = Tagged(), Tagged()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            if model_cfg.get("auxiliary_head") and train:
                model(x, with_aux=True)
            else:
                model(x)
        msda_calls, attn_calls = list(ref_msda.RECORD), \
            list(ref_attention.RECORD)
    finally:
        ref_msda.RECORD = ref_attention.RECORD = None
        for h in hooks:
            h.remove()
    counts = fc.get_flop_counts()
    root = type(model).__name__
    flops = {}
    for p in PARTS:
        key = f"{root}.{p}"
        if key in counts:
            flops[p] = float(sum(counts[key].values()))
    for c in msda_calls:
        flops[c["part"]] += msda_flops(c)
    return flops, msda_calls, attn_calls


def least_seconds_per_image(model_cfg: Dict, flops: Dict[str, float],
                            train: bool) -> float:
    """Least time of one image's model work on the chip: each part's
    operations at the matmul peak of the dtype its configuration states,
    three forwards for a train step (forward, and the backward's two
    products a forward product), one for inference."""
    from port_bench.roofline import MATMUL_PEAK

    dts = part_dtypes(model_cfg)
    t = sum(f / MATMUL_PEAK[dts[p]] for p, f in flops.items())
    return 3 * t if train else t
