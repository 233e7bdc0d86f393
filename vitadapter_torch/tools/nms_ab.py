#!/usr/bin/env python3
"""Card time of one checkout's NMS kernel (`csrc/nms.cu`) on
`chip_smoke.py`'s clock, so that two commits can be compared on one card.

Run on a machine with one NVIDIA H100, once per checkout, one after
another on the same card (order A, B, B, A):

    python3 vitadapter_torch/tools/nms_ab.py CHECKOUT

CHECKOUT is the root of a checkout of this repository whose
`vitadapter_torch.ops.nms` has `_kernel_keep` and `nms_keep_plain` (this
one, or an older commit unpacked with `git archive`); its kernel builds
there. The clock (`chip_smoke.time_ms`) and the boxes
(`chip_smoke.nms_inputs` at `chip_smoke.NMS_CASES`: the Mask R-CNN
proposals' 4768 boxes, the detections' 2048 of 80 classes, HTC++'s 5000
proposals, from one seed) are this file's own checkout's, so both commits
are timed alike. For each case it prints the kernel's ms per call (one
launch of the entry point: the IoU bits and the walk) and whether its kept
flags equal the checkout's plain version's. Prints the card's name and
power limit, then one JSON line.
"""

import json
import os
import sys

import torch

ITERS = 20


def main(argv=None):
    # the sibling tool: this directory is on sys.path when this file runs
    from attention_ab import load_checkout

    args = sys.argv[1:] if argv is None else argv
    smoke, nms = load_checkout(args, "ops.nms", __doc__)
    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    result = {"checkout": os.path.abspath(args[0])}
    for case, (n, classes, thr, _) in smoke.NMS_CASES.items():
        boxes, finite = smoke.nms_inputs(n, classes, gen)
        keep = nms._kernel_keep(boxes, finite, thr)
        same = bool(torch.equal(keep, nms.nms_keep_plain(boxes, finite, thr)))
        ms = smoke.time_ms(lambda: nms._kernel_keep(boxes, finite, thr),
                           flush, ITERS)
        result[case] = {"boxes": n, "ms": ms, "same_as_plain": same}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
