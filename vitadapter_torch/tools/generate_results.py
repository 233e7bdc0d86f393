"""Write a grounding submission on one GPU (the port's twin of the root
`generate_results.py`; reference `wsdm2023/generate_results.py:13-50`):

    python -m vitadapter_torch.tools.generate_results CONFIG CKPT INPUT_CSV
        OUT_CSV [--img-root DIR] [--max-sent-len N] [--cfg-options k=v ...]
        [--device cpu]

INPUT_CSV has an `image` column (a path under `--img-root`) and a
`question` column. Each image is zero padded at the bottom and right to a
multiple of 32 (no resize), its question tokenized (the CLIP merge table
from `data.bpe_vocab` or `$VITADAPTER_BPE_VOCAB`) and padded to
`--max-sent-len`, and the top-scoring box is written to OUT_CSV as
`image,left,top,right,bottom` in pixels. CKPT is what `tools.test` takes.
The model runs on CUDA unless `--device cpu` is given.
"""

import argparse
import csv
import os
from typing import List, Optional

import numpy as np
import torch
from PIL import Image

from vitadapter_torch.builder import build_model
from vitadapter_torch.data.preprocess import normalize, pad_to_multiple
from vitadapter_torch.data.tokenization import ClipTokenizer
from vitadapter_torch.utils.checkpoint_io import load_model_weights
from vitadapter_torch.utils.config import Config, parse_cfg_options

FIELDS = ["image", "left", "top", "right", "bottom"]


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Grounding submission")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("input_csv")
    p.add_argument("out_csv")
    p.add_argument("--img-root", default="")
    p.add_argument("--max-sent-len", type=int, default=128)
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, log_fn=print):
    """Run the command line `argv` (sys.argv[1:] when None); returns the
    rows written."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(parse_cfg_options(args.cfg_options))
    model = build_model(dict(cfg.model), device=args.device)
    load_model_weights(args.checkpoint, model)
    device = next(model.parameters()).device
    tok = ClipTokenizer(cfg.data.get("bpe_vocab"))
    rows = []
    with open(args.input_csv) as f, torch.inference_mode():
        for row in csv.DictReader(f):
            img = np.asarray(Image.open(os.path.join(
                args.img_root, row["image"])).convert("RGB"))
            x, _ = pad_to_multiple(
                torch.from_numpy(img.astype(np.float32))[None].to(device), 32)
            ids, mask = tok.tokenize_refer(row.get("question", ""),
                                           args.max_sent_len)
            out = model(normalize(x),
                        torch.tensor([ids], dtype=torch.int32, device=device),
                        torch.tensor([mask], dtype=torch.int32, device=device))
            b = out["boxes"][0, 0].float().cpu().numpy()
            rows.append({"image": row["image"], "left": float(b[0]),
                         "top": float(b[1]), "right": float(b[2]),
                         "bottom": float(b[3])})
    with open(args.out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        w.writerows(rows)
    log_fn(f"wrote {len(rows)} predictions to {args.out_csv}")
    return rows


if __name__ == "__main__":
    main()
