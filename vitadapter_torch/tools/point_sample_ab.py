#!/usr/bin/env python3
"""Card time of one checkout's point sampling backward
(`ops.point_sample._kernel_backward`, the `point_sample_bwd` kernel) on
`chip_smoke.py`'s clock, so that two commits can be compared on one card.

Run on a machine with one NVIDIA H100, once per checkout, one after
another on the same card (order A, B, B, A):

    python3 vitadapter_torch/tools/point_sample_ab.py CHECKOUT

CHECKOUT is the root of a checkout of this repository whose
`vitadapter_torch.ops.point_sample` has `_kernel_backward(masks, points,
grad_out)` (this one, or an older commit unpacked with `git archive`); its
kernel builds there. The clock (`chip_smoke.time_ms`) and the inputs (one
seed) are this file's own checkout's, so both commits are timed alike. It
times the flagship's call (`chip_smoke.POINT_GEOMETRIES["loss_pred"]`: 400
masks of 128x128, 12544 points) and the over-line step's
(`chip_smoke.POINT_BWD_LAYOUTS["overline"]`: 200 masks of 448x448), in
bf16 (the masks' dtype on both paths) and fp32, on points sorted by y (as
the loss sorts them) and unsorted, and sums each per step (10 calls).
Prints the card's name and power limit, then one JSON line.
"""

import json
import sys

import torch

ITERS = 10


def main(argv=None):
    # the sibling tool: this directory is on sys.path when this file runs
    from attention_ab import load_checkout

    args = sys.argv[1:] if argv is None else argv
    smoke, ps = load_checkout(args, "ops.point_sample", __doc__)
    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    N, H, W, P, _, calls = smoke.POINT_GEOMETRIES["loss_pred"]
    N2, H2, W2, P2, _, (path, calls2) = smoke.POINT_BWD_LAYOUTS["overline"]
    sums = {}
    for name, (n, h, w, p, c) in (("loss_pred", (N, H, W, P, calls)),
                                  (path, (N2, H2, W2, P2, calls2))):
        for dtype in (torch.bfloat16, torch.float32):
            masks = torch.randn(n, h, w, generator=gen, device="cuda") \
                .to(dtype)
            g = torch.randn(n, p, generator=gen, device="cuda")
            pts = torch.rand(n, p, 2, generator=gen, device="cuda")
            for order, pt in (("sorted", smoke.point_bwd_points(
                    n, p, "sorted", h, w, gen)), ("unsorted", pts)):
                with torch.no_grad():
                    ms = smoke.time_ms(
                        lambda: ps._kernel_backward(masks, pt, g), flush,
                        ITERS)
                sums[f"point_sample_bwd per step, {name} ({n}, {h}, {w}) "
                     f"x {p}, {str(dtype)[6:]}, {order}"] = c * ms
            del masks, g, pts
            torch.cuda.empty_cache()
    print(json.dumps({"checkout": args[0], "sums_ms": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
