"""Train-state checkpointing: save, find the latest, resume, load the
weights (counterpart of `vitadapter/utils/checkpoint_io.py`, which uses
orbax).

A checkpoint directory holds one `step_<N>` directory per saved step, with
two files: `model.pt` (the step, the model's `state_dict` and the EMA
parameters, if any) and `optim.pt` (the AdamW and LambdaLR states). Only
the model file is read to evaluate: the AdamW moments are twice the model's
size. A step directory is written under a temporary name and renamed, so an
interrupted save leaves no step behind; the oldest steps beyond `max_keep`
are removed.
"""

import os
import re
import shutil
from typing import Dict, Optional

import torch
from torch import nn

STEP_DIR = re.compile(r"^step_(\d+)$")
MODEL_FILE = "model.pt"
OPTIM_FILE = "optim.pt"


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def saved_steps(ckpt_dir: str):
    """The steps saved in `ckpt_dir`, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(STEP_DIR.match,
                                                os.listdir(ckpt_dir)) if m)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = saved_steps(ckpt_dir)
    return steps[-1] if steps else None


def save_checkpoint(ckpt_dir: str, step: int, state,
                    max_keep: int = 1) -> str:
    """Write `state` (a `train.trainer.TrainState`) as step `step`; returns
    the step directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"step": step, "model": state.model.state_dict(),
                "ema": state.ema_params}, os.path.join(tmp, MODEL_FILE))
    torch.save({"adamw": state.optimizer.adamw.state_dict(),
                "scheduler": state.optimizer.scheduler.state_dict()},
               os.path.join(tmp, OPTIM_FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    for old in saved_steps(ckpt_dir)[:-max_keep]:
        shutil.rmtree(step_dir(ckpt_dir, old))
    return final


def _load(path: str, device) -> Dict:
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Load step `step` (the latest by default) into `state` in place: the
    model, the EMA, the AdamW and LambdaLR states and the step count.
    Returns `state`."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    device = next(state.model.parameters()).device
    saved = _load(os.path.join(step_dir(ckpt_dir, step), MODEL_FILE), device)
    optim = _load(os.path.join(step_dir(ckpt_dir, step), OPTIM_FILE), device)
    state.model.load_state_dict(saved["model"])
    state.ema_params = saved["ema"]
    state.optimizer.adamw.load_state_dict(optim["adamw"])
    state.optimizer.scheduler.load_state_dict(optim["scheduler"])
    state.step = saved["step"]
    return state


def unwrap_state_dict(ckpt) -> Dict:
    """The state dict inside a reference checkpoint, as the JAX package's
    `unwrap_state_dict` finds it: the dict under `state_dict`, then under
    `model`, then under `module` (each where present), with a `module.`
    (DDP) and then an `encoder.` prefix stripped from every key."""
    sd = ckpt
    for key in ("state_dict", "model", "module"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    out = {}
    for k, v in sd.items():
        for pre in ("module.", "encoder."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def load_model_weights(path: str, model: nn.Module) -> nn.Module:
    """Load a model's weights for evaluation from `path`: a checkpoint
    directory (its latest step), a step directory, or a `.pth` file holding
    a `state_dict` with the port's keys (the reference's), unwrapped as
    `unwrap_state_dict` does. Every key of the model must be there, but
    BatchNorm's `num_batches_tracked`; keys the model does not have (the
    reference's relative-position indices, which the model recomputes,
    auxiliary heads it does not build) are ignored, as the JAX package's
    converters read only the keys they need."""
    device = next(model.parameters()).device
    if os.path.isdir(path):
        if not os.path.isfile(os.path.join(path, MODEL_FILE)):
            step = latest_step(path)
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {path}")
            path = step_dir(path, step)
        sd = _load(os.path.join(path, MODEL_FILE), device)["model"]
    else:
        sd = unwrap_state_dict(_load(path, device))
    missing, _ = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"checkpoint {path} does not match the model: "
                       f"missing {missing[:5]}")
    return model
