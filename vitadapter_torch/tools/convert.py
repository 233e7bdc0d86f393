"""Convert a reference checkpoint for the port (the twin of the JAX
package's `tools/convert_checkpoint.py`):

    python -m vitadapter_torch.tools.convert SRC.pth DST.pth
        [--kind segmentor|backbone|uniperceiver] [--target-grid N]

SRC is a reference `.pth` (its state dict bare or under `state_dict`,
`model` or `module`, keys prefixed `module.` or `encoder.`, EMA copies under
`ema_` names). DST holds `{"state_dict": ...}` with the port's keys (the
reference's): the EMA weights where there are any, an official
Uni-Perceiver release's names mapped (`--kind uniperceiver`), and each BEiT
relative-position table of a segmentor resampled to an N x N patch grid
(`--target-grid`, the model's `img_size // patch_size`).
`utils/checkpoint.py::convert_state_dict` does the work; `tools.test`, the
demos and `utils/checkpoint_io.py::load_model_weights` read the result.
Nothing runs on a device.
"""

import argparse
from typing import List, Optional

import torch

from vitadapter_torch.utils.checkpoint import KINDS, convert_state_dict


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Convert a reference checkpoint")
    p.add_argument("src", help="reference checkpoint (.pth)")
    p.add_argument("dst", help="output .pth for the port")
    p.add_argument("--kind", default="segmentor", choices=KINDS)
    p.add_argument("--target-grid", type=int, default=None,
                   help="resample BEiT rel-pos tables to this grid")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, log_fn=print) -> str:
    """Run the command line `argv` (sys.argv[1:] when None); returns DST."""
    args = parse_args(argv)
    ckpt = torch.load(args.src, map_location="cpu", weights_only=False)
    sd = convert_state_dict(ckpt, args.kind, args.target_grid)
    torch.save({"state_dict": sd}, args.dst)
    log_fn(f"wrote {len(sd)} tensors to {args.dst}")
    return args.dst


if __name__ == "__main__":
    main()
