"""Train a segmentor or a detector from a config file (the port's twin
of the root `train.py`, which sends the detector types to the detection
loop):

    python -m vitadapter_torch.tools.train CONFIG [--work-dir D] [--resume]
        [--max-iters N] [--synthetic-data] [--cfg-options k=v ...]
        [--device cpu] [--multi-host]

The model runs on CUDA unless `--device cpu` is given (the kernels' plain
versions then run on the CPU). On several cards (ROADMAP.md §1 item 5)
launch one process a card with torchrun and pass `--multi-host`:

    python -m torch.distributed.run --nproc_per_node 8 \
        -m vitadapter_torch.tools.train CONFIG --multi-host

Each rank then takes `samples_per_chip` images a step on its card
(`cuda:LOCAL_RANK`; NCCL, or gloo with `--device cpu`), the global batch
of JAX's step over an 8-device mesh.
"""

import argparse
import os
from typing import List, Optional

from vitadapter_torch.parallel.mesh import device_type, distributed
from vitadapter_torch.train.det_loop import DETECTORS, run_det_training
from vitadapter_torch.train.loop import run_training
from vitadapter_torch.utils.config import Config, parse_cfg_options


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Train a model")
    p.add_argument("config", help="config file path")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in work-dir")
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--synthetic-data", action="store_true",
                   help="random data (pipeline smoke test without a dataset)")
    p.add_argument("--cfg-options", nargs="+", default=None,
                   help="override config entries: key.subkey=value")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--multi-host", action="store_true",
                   help="data parallel over the ranks torchrun launched")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, log_fn=print):
    """Run the command line `argv` (sys.argv[1:] when None); returns the
    final `TrainState`."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(parse_cfg_options(args.cfg_options))
    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    run = (run_det_training if cfg.model["type"] in DETECTORS
           else run_training)
    with distributed(args.multi_host, device_type(args.device)):
        return run(cfg, work_dir, resume=args.resume,
                   max_iters=args.max_iters, synthetic=args.synthetic_data,
                   device=args.device, log_fn=log_fn)


if __name__ == "__main__":
    main()
