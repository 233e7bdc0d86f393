"""Run a config and a checkpoint on one image and save a picture of the
result (the twin of the root `image_demo.py`):

    python -m vitadapter_torch.tools.image_demo IMG CONFIG CKPT
        [--out-file demo_out.png] [--score-thr 0.3] [--cfg-options k=v ...]
        [--device cpu]

The image is padded at the bottom and right to a multiple of 32
(`data/preprocess.py::pad_to_multiple`), normalized and run through the
model once. A segmentor's argmax over the unpadded area is blended half and
half with a palette drawn from `RandomState(0)`; a detector's boxes scoring
at least `--score-thr` are drawn in red with `label:score` in yellow. CKPT is
anything `tools.test` reads (`utils/checkpoint_io.py::load_model_weights`).
The model runs on CUDA unless `--device cpu` is given. `predict`,
`segment`, `drawn_boxes` and `render` are the steps, for callers that want
the raw output. A GroundingDINO config needs the text and fails at the
model call, as the root script does.
"""

import argparse
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from PIL import Image, ImageDraw

from vitadapter_torch.builder import build_model
from vitadapter_torch.data.preprocess import normalize, pad_to_multiple
from vitadapter_torch.utils.checkpoint_io import load_model_weights
from vitadapter_torch.utils.config import Config, parse_cfg_options


class Result(NamedTuple):
    out: object          # the model's output: logits (1, H, W, K) or a dict
    hw: Tuple[int, int]  # the image's size before padding
    vis: Image.Image


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Single-image demo")
    p.add_argument("img")
    add_common_args(p)
    p.add_argument("--out-file", default="demo_out.png")
    return p.parse_args(argv)


def load_model(config: str, checkpoint: str, cfg_options=None, device=None):
    """The config's model on `device` (CUDA when None) with the
    checkpoint's weights, in eval mode."""
    cfg = Config.fromfile(config)
    cfg.merge_from_options(parse_cfg_options(cfg_options))
    model = build_model(dict(cfg.model), device=device)
    return load_model_weights(checkpoint, model)


def read_image(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


@torch.no_grad()
def predict(model, img: np.ndarray):
    """One model call on an (H, W, 3) uint8 image, padded to a multiple of
    32 and normalized. Returns (the model's output, (H, W))."""
    device = next(model.parameters()).device
    x = torch.as_tensor(np.array(img), device=device)
    x, hw = pad_to_multiple(x.float()[None], 32)
    return model(normalize(x)), hw


def segment(out: torch.Tensor, hw: Tuple[int, int]) -> np.ndarray:
    """A segmentor's argmax over the unpadded area, (H, W) int64."""
    H, W = hw
    return out[0, :H, :W].argmax(-1).cpu().numpy()


def drawn_boxes(out, score_thr: float):
    """A detector's (box, score, label) of the first image, in output
    order, that `render` draws: finite scores of at least `score_thr`."""
    boxes = out["boxes"][0].float().cpu().numpy()
    scores = out["scores"][0].float().cpu().numpy()
    labels = out["labels"][0].cpu().numpy()
    return [(b, s, int(l)) for b, s, l in zip(boxes, scores, labels)
            if np.isfinite(s) and s >= score_thr]


def render(img: np.ndarray, out, hw: Tuple[int, int], score_thr: float,
           with_text: bool = True) -> Image.Image:
    """The picture of one result, as the root script draws it."""
    if isinstance(out, dict):  # detector
        vis = Image.fromarray(img.copy())
        draw = ImageDraw.Draw(vis)
        for b, s, l in drawn_boxes(out, score_thr):
            draw.rectangle([float(v) for v in b], outline=(255, 0, 0),
                           width=2)
            if with_text:
                draw.text((float(b[0]), float(b[1])), f"{l}:{s:.2f}",
                          fill=(255, 255, 0))
        return vis
    pred = segment(out, hw)
    rng = np.random.RandomState(0)
    palette = rng.randint(0, 255, (int(pred.max()) + 1, 3), np.uint8)
    return Image.fromarray((0.5 * img + 0.5 * palette[pred]).astype(np.uint8))


def run(model, img: np.ndarray, score_thr: float,
        with_text: bool = True) -> Result:
    out, hw = predict(model, img)
    return Result(out, hw, render(img, out, hw, score_thr, with_text))


def main(argv: Optional[List[str]] = None, log_fn=print) -> Result:
    """Run the command line `argv` (sys.argv[1:] when None); returns the
    model's output and the picture it saved."""
    args = parse_args(argv)
    model = load_model(args.config, args.checkpoint, args.cfg_options,
                       args.device)
    result = run(model, read_image(args.img), args.score_thr)
    result.vis.save(args.out_file)
    log_fn(f"saved {args.out_file}")
    return result


if __name__ == "__main__":
    main()
