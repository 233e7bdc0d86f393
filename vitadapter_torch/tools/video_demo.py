"""Run a config and a checkpoint over a directory of frames (the twin of
the root `video_demo.py`):

    python -m vitadapter_torch.tools.video_demo FRAMES_DIR CONFIG CKPT
        [--out-dir video_out] [--score-thr 0.3] [--cfg-options k=v ...]
        [--device cpu]

Each frame, in the order of its file name, goes through the model as
`tools/image_demo.py` sends one image (a detector's boxes drawn without
their labels, as the root script draws them) and its picture is written
under the frame's name into OUT_DIR; assemble a video with ffmpeg. The
model runs on CUDA unless `--device cpu` is given.
"""

import argparse
import glob
import os
from typing import Callable, List, Optional

from vitadapter_torch.tools.image_demo import (Result, add_common_args,
                                               load_model, read_image, run)


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Frame-sequence demo")
    p.add_argument("frames_dir", help="directory of ordered frame images")
    add_common_args(p)
    p.add_argument("--out-dir", default="video_out")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, log_fn=print,
         on_frame: Optional[Callable[[int, Result], None]] = None) -> int:
    """Run the command line `argv` (sys.argv[1:] when None); returns the
    number of frames. `on_frame(i, result)`, where given, is called with
    each frame's model output and picture once they are made."""
    args = parse_args(argv)
    model = load_model(args.config, args.checkpoint, args.cfg_options,
                       args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    frames = sorted(glob.glob(os.path.join(args.frames_dir, "*")))
    for i, fp in enumerate(frames):
        result = run(model, read_image(fp), args.score_thr, with_text=False)
        result.vis.save(os.path.join(args.out_dir, os.path.basename(fp)))
        if on_frame is not None:
            on_frame(i, result)
    log_fn(f"wrote {len(frames)} frames to {args.out_dir}")
    return len(frames)


if __name__ == "__main__":
    main()
