#!/usr/bin/env python3
"""Card time of one checkout's point sampling kernels
(`ops.point_sample._kernel_forward` and `_kernel_backward`, the
`point_sample_fwd` and `point_sample_bwd` kernels) on `chip_smoke.py`'s
clock, so that two commits can be compared on one card.

Run on a machine with one NVIDIA H100, once per checkout, one after
another on the same card (order A, B, B, A):

    python3 vitadapter_torch/tools/point_sample_ab.py CHECKOUT

CHECKOUT is the root of a checkout of this repository whose
`vitadapter_torch.ops.point_sample` has `_kernel_forward(masks, points)`
and `_kernel_backward(masks, points, grad_out)` (this one, or an older
commit unpacked with `git archive`); its kernels build there. The clock
(`chip_smoke.time_ms`) and the inputs (one seed) are this file's own
checkout's, so both commits are timed alike.
- The forward at the loss's calls of a train step (bf16 masks:
  `chip_smoke.POINT_GEOMETRIES`, the flagship's, `POINT_CLI` and
  `POINT_PANOPTIC`), summed per step: on the point sets expanded to one a
  mask (what a kernel that takes one set a mask is given), and, where the
  checkout takes points (N / S, P, 2) (it has `masks_per_set`), on the
  shared sets the loss now passes; told, where the checkout's
  `_kernel_forward` takes `sorted_by_y`, which calls' points the loss
  sorted, as the loss tells it.
- The backward at the flagship's call (`POINT_GEOMETRIES["loss_pred"]`: 400
  masks of 128x128, 12544 points) and the over-line step's
  (`POINT_BWD_LAYOUTS["overline"]`: 200 masks of 448x448), in bf16 and
  fp32, on points sorted by y (as the loss sorts them) and unsorted, summed
  per step (10 calls).
Prints the card's name and power limit, then one JSON line.
"""

import inspect
import json
import sys

import torch

ITERS = 10


def forward_sums(smoke, ps, gen, flush):
    """{name: ms per step} of the forward at the three paths' calls."""
    shared = hasattr(ps, "masks_per_set")
    hinted = "sorted_by_y" in inspect.signature(ps._kernel_forward).parameters
    sums = {}
    for path, table in (("flagship", smoke.POINT_GEOMETRIES),
                        ("cli", smoke.POINT_CLI),
                        ("panoptic", smoke.POINT_PANOPTIC)):
        for name, (N, H, W, P, sort, calls, S) in table.items():
            masks = torch.randn(N, H, W, generator=gen, device="cuda") \
                .bfloat16()
            sets = torch.rand(N // S, P, 2, generator=gen, device="cuda")
            if sort:
                sets = ps.sort_points_by_y(sets)
            forms = {"expanded": sets.repeat_interleave(S, 0)}
            if shared:
                forms["shared"] = sets
            kw = {"sorted_by_y": sort} if hinted else {}
            for form, pts in forms.items():
                with torch.no_grad():
                    ms = smoke.time_ms(
                        lambda: ps._kernel_forward(masks, pts, **kw), flush,
                        ITERS)
                key = f"point_sample_fwd per step, {path}, {form}"
                sums[key] = sums.get(key, 0.0) + calls * ms
                sums[f"{key}, {name}"] = calls * ms
            del masks, sets, forms
            torch.cuda.empty_cache()
    return sums


def backward_sums(smoke, ps, gen, flush):
    """{name: ms per step} of the backward at the flagship's and the
    over-line step's calls."""
    N, H, W, P, _, calls, _ = smoke.POINT_GEOMETRIES["loss_pred"]
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
    return sums


def main(argv=None):
    # the sibling tool: this directory is on sys.path when this file runs
    from attention_ab import load_checkout

    args = sys.argv[1:] if argv is None else argv
    smoke, ps = load_checkout(args, "ops.point_sample", __doc__)
    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    sums = forward_sums(smoke, ps, gen, flush)
    sums.update(backward_sums(smoke, ps, gen, flush))
    print(json.dumps({"checkout": args[0], "sums_ms": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
