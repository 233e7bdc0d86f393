"""The readings a cell's limits are set from, in one process: the numbers
`check.py` reads for the program on many seeds (the lower readings), for
the control, the reference one precision step lower in the program's
place, and for a training cell's faults on a few (the upper readings):
half of each batch left out, and, where the cell matches, the auction's
matches permuted among the matched queries. Each seed is a whole run of
the cell with a window of one step (training) or 5 s of requests.

    python3 port_bench/readings.py --workload <cell> --seeds 12 \
        --controls 3 [--faults 3] [--permuted 3] --first-seed <n> \
        [--out <file.json>]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from port_bench import spec  # noqa: E402


def half_batch(step):
    """A fault: half of each batch left out, the mean over the rest."""
    def broken(state, batch, gen):
        half = batch["image"].shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch.items()}, gen)
    return broken


def roll_matches(assign: torch.Tensor) -> torch.Tensor:
    """Each matrix's matched queries (assign (M, Q), gt index or -1) given
    the gt of the next matched query: still a matching of every gt to one
    query, but not the one chosen."""
    out = assign.clone()
    for m in range(out.shape[0]):
        q = torch.nonzero(out[m] >= 0).flatten()
        if q.numel() > 1:
            out[m, q] = out[m, q].roll(1)
    return out


@contextlib.contextmanager
def permuted_matches():
    """A fault, inside: the program's Mask2Former loss trains on
    `roll_matches` of the auction's matches."""
    from vitadapter_torch.heads import mask2former_loss as loss

    real = loss.hungarian_assign

    def broken(cost, n_valid, *a, **k):
        return roll_matches(real(cost, n_valid, *a, **k))

    loss.hungarian_assign = broken
    try:
        yield
    finally:
        loss.hungarian_assign = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seconds", type=float,
                    help="each run's window (default: one step, or 5 s of "
                         "requests so that every checked image is served)")
    ap.add_argument("--faults", type=int, default=0,
                    help="seeds of a training cell run with half of each "
                         "batch left out")
    ap.add_argument("--permuted", type=int, default=0,
                    help="seeds of a Mask2Former training cell run with "
                         "the auction's matches permuted")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    run = spec.kind_runner(cell.traffic["kind"])
    device = torch.device("cuda")
    seconds = args.seconds if args.seconds is not None else (
        0.0 if cell.traffic["kind"] == "train" else 5.0)

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sides = ("program", "control", "half_batch", "permuted")
    out = {side: [] for side in sides}
    none = contextlib.nullcontext
    plan = ([("program", {}, none)] * args.seeds
            + [("control", {"lower_control": True}, none)] * args.controls
            + [("half_batch", {"wrap_step": half_batch}, none)] * args.faults
            + [("permuted", {}, permuted_matches)] * args.permuted)
    for k, (side, kw, fault) in enumerate(plan):
        seed = args.first_seed + k
        with fault():
            r = run(cell, seed, seconds, False, device, log=log, **kw)
        row = {"seed": seed, **r["numbers"]}
        out[side].append(row)
        log(json.dumps(row))
        torch.cuda.empty_cache()
    for side in sides:
        rows = out[side]
        if rows:
            keys = [k for k in rows[0] if k != "seed"]
            out[side + "_max"] = {k: max(r[k] for r in rows) for k in keys}
            out[side + "_min"] = {k: min(r[k] for r in rows) for k in keys}
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps({k: v for k, v in out.items() if k.endswith(("max",
                                                                  "min"))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
