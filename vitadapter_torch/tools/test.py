"""Evaluate a checkpoint (the port's twin of the root `test.py`):

    python -m vitadapter_torch.tools.test CONFIG CKPT --eval mIoU
        [--aug-test] [--max-images N] [--cfg-options k=v ...] [--device cpu]
        [--multi-host]
    python -m vitadapter_torch.tools.test CONFIG CKPT --eval bbox segm ...
    python -m vitadapter_torch.tools.test CONFIG CKPT --eval IoU ...
    python -m vitadapter_torch.tools.test CONFIG CKPT --eval PQ ...

CKPT is a checkpoint directory of `tools.train` (its latest step), one of
its step directories, or a `.pth` file holding a `state_dict` with the
reference's keys (those of the port), bare or as a reference run saves it
(`utils/checkpoint_io.py::unwrap_state_dict`: under `state_dict`, `model`
or `module`, keys prefixed `module.` or `encoder.`). Only the model's
weights are read.
`--eval mIoU` runs the segmentation protocol (slide or whole inference
as the config's `test_cfg` says; `--aug-test` adds the multi-scale and
flip augmentations), `--eval bbox segm` the COCO detection protocol on
the config's `data.val` (`train/det_loop.py::run_det_eval`), `--eval IoU`
the single-box grounding protocol (`run_grounding_eval`: mIoU and
Acc@0.5; `--aug-test` votes over the config's `tta` scales and flips),
`--eval PQ` the panoptic quality of a Mask2Former segmentor on the
config's COCO-panoptic `data.val` (`run_panoptic_eval`; no `--aug-test`,
as in the root script).
The model runs on CUDA unless `--device cpu` is given. Under torchrun
with `--multi-host` (`python -m torch.distributed.run --nproc_per_node 8
-m vitadapter_torch.tools.test CONFIG CKPT --eval ... --multi-host`) each
rank evaluates every W-th image on its card and every rank returns the
metrics of the whole set; rank 0 alone logs.
"""

import argparse
from typing import List, Optional

from vitadapter_torch.builder import build_model
from vitadapter_torch.train.det_loop import (build_det_dataset,
                                            build_panoptic_dataset,
                                            run_det_eval, run_grounding_eval,
                                            run_panoptic_eval)
from vitadapter_torch.parallel.mesh import device_type, distributed
from vitadapter_torch.train.loop import (build_dataset, eval_config,
                                         run_eval, silent)
from vitadapter_torch.utils.checkpoint_io import load_model_weights
from vitadapter_torch.utils.config import Config, parse_cfg_options

# the root script's metrics
KNOWN_METRICS = ("mIoU", "bbox", "segm", "PQ", "IoU")


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
    p.add_argument("--multi-host", action="store_true",
                   help="data parallel over the ranks torchrun launched")
    args = p.parse_args(argv)
    unknown = [m for m in args.eval if m not in KNOWN_METRICS]
    if unknown:
        p.error(f"unknown --eval metric(s) {unknown}; "
                f"choose from {list(KNOWN_METRICS)}")
    if args.aug_test and "PQ" in args.eval:
        p.error("--aug-test is not supported for --eval PQ")
    return args


def main(argv: Optional[List[str]] = None, log_fn=print):
    """Run the command line `argv` (sys.argv[1:] when None); returns the
    metrics: `run_grounding_eval`'s for `IoU`, `run_panoptic_eval`'s for
    `PQ`, `run_det_eval`'s for `bbox`/`segm`, else `run_eval`'s (aAcc,
    mIoU, mAcc and the confusion matrix)."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(parse_cfg_options(args.cfg_options))
    with distributed(args.multi_host, device_type(args.device)) as (rank, *_):
        return _evaluate(args, cfg, log_fn if rank == 0 else silent)


def _evaluate(args, cfg, log_fn):
    model = build_model(dict(cfg.model), device=args.device)
    load_model_weights(args.checkpoint, model)
    if "IoU" in args.eval:
        return run_grounding_eval(
            cfg, model, build_det_dataset(cfg.data, "val", with_masks=False),
            aug_test=args.aug_test, max_images=args.max_images,
            log_fn=log_fn)
    if "PQ" in args.eval:
        return run_panoptic_eval(cfg, model,
                                 build_panoptic_dataset(cfg.data, "val"),
                                 max_images=args.max_images, log_fn=log_fn)
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
