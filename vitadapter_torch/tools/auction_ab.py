#!/usr/bin/env python3
"""Card time of one checkout's auction kernel (`csrc/auction.cu`) on
`chip_smoke.py`'s clock, so that two commits can be compared on one card.

Run on a machine with one NVIDIA H100, once per checkout, one after
another on the same card (order A, B, B, A):

    python3 vitadapter_torch/tools/auction_ab.py CHECKOUT

CHECKOUT is the root of a checkout of this repository whose
`vitadapter_torch.ops.matching` has `_kernel_auction` and
`auction_assign_plain` (this one, or an older commit unpacked with `git
archive`); its kernel builds there. The clock (`chip_smoke.time_ms`) and
the costs (`chip_smoke.auction_cases`: the flagship step's 20 contested
matrices of 200 queries x 60 gts, 8 independent ones with 0 to 60 valid
gts, and 20 of tied integer costs, from one seed) are this file's own
checkout's, so both commits are timed alike. For each case it prints the
kernel's ms per launch, the rounds the matrices ran (the most and the
mean), microseconds per round (ms over the most rounds: the blocks run
side by side) and whether the owners and rounds equal the checkout's
plain version's. Prints the card's name and power limit, then one JSON
line.
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
    smoke, mt = load_checkout(args, "ops.matching", __doc__)
    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    result = {"checkout": os.path.abspath(args[0])}
    for case, (cost, n_valid) in smoke.auction_cases(gen).items():
        owner, iters = mt._kernel_auction(cost, n_valid)
        ref, ref_iters = mt.auction_assign_plain(cost, n_valid)
        rounds = iters.long()
        ms = smoke.time_ms(lambda: mt._kernel_auction(cost, n_valid), flush,
                           ITERS)
        most = max(int(rounds.max()), 1)
        result[case] = {
            "shape": list(cost.shape), "ms": ms,
            "rounds_max": int(rounds.max()),
            "rounds_mean": float(rounds.float().mean()),
            "us_per_round": ms * 1e3 / most,
            "same_as_plain": bool((owner.long() == ref).all())
            and bool((rounds == ref_iters).all())}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
