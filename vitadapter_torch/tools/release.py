"""Export a training checkpoint for release (the twin of the JAX package's
`tools/release.py`):

    python -m vitadapter_torch.tools.release CKPT_DIR OUT.pth [--use-ema]
        [--step N]

CKPT_DIR is a `tools.train` checkpoint directory (its latest step, or step
N) or one of its step directories. OUT holds `{"state_dict": ...}`: the
model's weights without the optimizer state. With `--use-ema` the EMA
parameters replace the parameters; the buffers (BatchNorm's running
statistics) stay the model's, as the JAX release keeps `batch_stats`.
`tools.test` and the demos read OUT. Nothing runs on a device.
"""

import argparse
import os
from typing import List, Optional

import torch

from vitadapter_torch.utils.checkpoint_io import (MODEL_FILE, latest_step,
                                                  step_dir)


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Release a train checkpoint")
    p.add_argument("ckpt_dir", help="tools.train checkpoint directory")
    p.add_argument("out", help="output .pth")
    p.add_argument("--use-ema", action="store_true",
                   help="release the EMA params instead of the raw params")
    p.add_argument("--step", type=int, default=None)
    return p.parse_args(argv)


def model_file(ckpt_dir: str, step: Optional[int]) -> str:
    """The `model.pt` of step `step` (the latest when None) of a checkpoint
    directory, or of a step directory itself."""
    if step is None and os.path.isfile(os.path.join(ckpt_dir, MODEL_FILE)):
        return os.path.join(ckpt_dir, MODEL_FILE)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise SystemExit(f"no checkpoint found under {ckpt_dir}")
    return os.path.join(step_dir(ckpt_dir, step), MODEL_FILE)


def main(argv: Optional[List[str]] = None, log_fn=print) -> str:
    """Run the command line `argv` (sys.argv[1:] when None); returns OUT."""
    args = parse_args(argv)
    path = model_file(args.ckpt_dir, args.step)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    sd = dict(saved["model"])
    if args.use_ema:
        if saved.get("ema") is None:
            raise SystemExit(f"{path} holds no EMA parameters (train with "
                             "ema_decay > 0)")
        sd.update(saved["ema"])
    torch.save({"state_dict": sd}, args.out)
    n = sum(v.numel() for v in sd.values())
    log_fn(f"released step {saved['step']} ({n / 1e6:.1f}M values"
           f"{', EMA' if args.use_ema else ''}) -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
