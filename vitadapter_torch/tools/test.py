"""Evaluate a checkpoint on one GPU (the port's twin of the root
`test.py`):

    python -m vitadapter_torch.tools.test CONFIG CKPT --eval mIoU
        [--aug-test] [--max-images N] [--cfg-options k=v ...] [--device cpu]
    python -m vitadapter_torch.tools.test CONFIG CKPT --eval bbox segm ...
    python -m vitadapter_torch.tools.test CONFIG CKPT --eval IoU ...

CKPT is a checkpoint directory of `tools.train` (its latest step), one of
its step directories, or a `.pth` file holding a `state_dict` with the
reference's keys (those of the port). Only the model's weights are read.
`--eval mIoU` runs the segmentation protocol (slide or whole inference
as the config's `test_cfg` says; `--aug-test` adds the multi-scale and
flip augmentations), `--eval bbox segm` the COCO detection protocol on
the config's `data.val` (`train/det_loop.py::run_det_eval`), `--eval IoU`
the single-box grounding protocol (`run_grounding_eval`: mIoU and
Acc@0.5; `--aug-test` votes over the config's `tta` scales and flips).
The model runs on CUDA unless `--device cpu` is given.
"""

import argparse
from typing import List, Optional

from vitadapter_torch.builder import build_model
from vitadapter_torch.train.det_loop import (build_det_dataset,
                                            run_det_eval, run_grounding_eval)
from vitadapter_torch.train.loop import build_dataset, eval_config, run_eval
from vitadapter_torch.utils.checkpoint_io import load_model_weights
from vitadapter_torch.utils.config import Config, parse_cfg_options

# the root script's metrics, by the ROADMAP.md §1 item that will port the
# ones the port lacks
KNOWN_METRICS = ("mIoU", "bbox", "segm", "PQ", "IoU")
NOT_PORTED = {"PQ": "item 3 (MaskFormerHead and panoptic)"}


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Test a model")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--eval", nargs="+", default=["mIoU"])
    p.add_argument("--aug-test", action="store_true",
                   help="multi-scale + flip TTA")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    unknown = [m for m in args.eval if m not in KNOWN_METRICS]
    if unknown:
        p.error(f"unknown --eval metric(s) {unknown}; "
                f"choose from {list(KNOWN_METRICS)}")
    return args


def main(argv: Optional[List[str]] = None, log_fn=print):
    """Run the command line `argv` (sys.argv[1:] when None); returns the
    metrics: `run_grounding_eval`'s for `IoU`, `run_det_eval`'s for
    `bbox`/`segm`, else `run_eval`'s (aAcc, mIoU, mAcc and the confusion
    matrix)."""
    args = parse_args(argv)
    for m in args.eval:
        if m in NOT_PORTED:
            raise NotImplementedError(f"--eval {m} is not ported yet: "
                                      f"ROADMAP.md §1 {NOT_PORTED[m]}")
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(parse_cfg_options(args.cfg_options))
    model = build_model(dict(cfg.model), device=args.device)
    load_model_weights(args.checkpoint, model)
    if "IoU" in args.eval:
        return run_grounding_eval(
            cfg, model, build_det_dataset(cfg.data, "val", with_masks=False),
            aug_test=args.aug_test, max_images=args.max_images,
            log_fn=log_fn)
    iou_types = tuple(t for t in ("bbox", "segm") if t in args.eval)
    if iou_types:
        return run_det_eval(cfg, model, build_det_dataset(cfg.data, "val"),
                            iou_types, aug_test=args.aug_test,
                            max_images=args.max_images, log_fn=log_fn)
    dataset = build_dataset(cfg.data, "val")
    return run_eval(eval_config(cfg), model, dataset, aug_test=args.aug_test,
                    max_images=args.max_images, log_fn=log_fn)


if __name__ == "__main__":
    main()
