"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (`reference/`) run after the window on the
same weights (remade from the seed) and the same inputs.

Training: the reference follows the program's first three steps from the
same weights, batches and generator seed. Compared: each step's loss; the
first step's gradient as the optimizer got it (its first moment after one
step over 1 - beta1) and the parameters' change after three steps, each
by the worst leaf: the gap between the program's norm of the leaf and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf. The change is read over the elements whose reference
gradient reaches a thousandth of the median leaf's root mean square: the
others (a key's bias under softmax, packed with the query's and value's)
Adam moves by round-off alone.

A Mask2Former step's matches are judged twice: on the reference's own
costs (`match_gap`), and, as a stage by itself, on the costs the
program's auction was given (`auction_gap`, against an exact solve).
The first checked step's forward is judged by itself too: the head's
final logits against the reference's (`logits_gap`), which set the
first step's losses and gradients.

Inference: the logits of a seed-drawn sample of the window's requests
against the reference's forward over the same crops, as the relative
root-mean-square gap of each request, worst over the sample."""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, List, Sequence

import torch

from port_bench.reference import builder as ref_builder
from port_bench.reference.layers import linear as ref_linear
from port_bench.reference.train import optim as ref_optim
from port_bench.reference.train import trainer as ref_trainer

MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
SMALL_GRAD = 1e-3


def normalize(img: torch.Tensor) -> torch.Tensor:
    m = torch.tensor(MEAN, dtype=torch.float32, device=img.device)
    s = torch.tensor(STD, dtype=torch.float32, device=img.device)
    return (img.float() - m) / s


class precision:
    """Inside: the reference at its configuration's precision (`lower`
    False: every product in fp32, TF32 off), or one step below it (`lower`
    True, the control: bf16 products in fp8, fp32 ones in TF32)."""

    def __init__(self, lower: bool):
        self.lower = lower

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32,
                      ref_linear.LOWER_PRECISION)
        torch.backends.cuda.matmul.allow_tf32 = self.lower
        torch.backends.cudnn.allow_tf32 = self.lower
        ref_linear.LOWER_PRECISION = self.lower

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         ref_linear.LOWER_PRECISION) = self.saved


def first_moments(optimizer: torch.optim.Optimizer, names: Dict[int, str],
                  beta1: float):
    """Each leaf's gradient as a one-step-old Adam state holds it
    (exp_avg / (1 - beta1)), by name."""
    return {names[id(p)]: st["exp_avg"].float() / (1 - beta1)
            for p, st in optimizer.state.items() if "exp_avg" in st}


def small_grad_masks(grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """By leaf, the elements whose gradient reaches a thousandth of the
    median leaf's root mean square (the others Adam moves by round-off
    alone)."""
    rms = statistics.median(float(g.norm()) / g.numel() ** 0.5
                            for g in grads.values())
    return {n: g.abs() >= SMALL_GRAD * rms for n, g in grads.items()}


def norms(ts: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.norm()) for n, t in ts.items()}


def difference_norms(prog: Dict[str, torch.Tensor],
                     ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """|prog - ref| / |ref| of each leaf, elementwise; a leaf that `prog`
    lacks reads 1."""
    return {n: (float((prog[n].to(r.device).float() - r).norm())
                / max(float(r.norm()), 1e-30)) if n in prog else 1.0
            for n, r in ref.items()}


def host_copy(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}


def masked_change(after: Dict[str, torch.Tensor],
                  start: Dict[str, torch.Tensor],
                  masks: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Norm of each leaf's change from `start`, over its elements in
    `masks` (leaves with none left out)."""
    out = {}
    for n, m in masks.items():
        if bool(m.any()):
            d = after[n].to(m.device).float() - start[n].float()
            out[n] = float(d[m].norm())
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Sequence[str]) -> Dict[str, float]:
    """|prog - ref| / max(ref, median ref) of each of `leaves`; a leaf one
    side has and the other lacks reads 1."""
    med = statistics.median(ref[n] for n in leaves if n in ref)
    return {n: (1.0 if (n in prog) != (n in ref) else
                abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30))
            for n in leaves}


def worst(gaps: Dict[str, float], log=None, what: str = "") -> float:
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    if log is not None:
        log(f"{what}: worst leaves " + ", ".join(
            f"{n} {v:.3e}" for n, v in top) + f"; median leaf "
            f"{statistics.median(gaps.values()):.3e} of {len(gaps)}")
    return top[0][1] if top else 0.0


@contextlib.contextmanager
def head_logits(model: torch.nn.Module, kept: List, spent: List = None):
    """Inside, each forward of `model.decode_head` appends its final logits
    to `kept`, as float32 on the host: a Mask2Former head's last class
    and mask logits (the last entry of each of its lists), another
    head's logits; `spent[0]` gains the seconds the copies took."""
    def hook(mod, args, out):
        t = time.perf_counter()
        outs = [o[-1] for o in out] if isinstance(out, tuple) else [out]
        kept.append([o.detach().float().cpu() for o in outs])
        if spent is not None:
            spent[0] += time.perf_counter() - t

    handle = model.decode_head.register_forward_hook(hook)
    try:
        yield kept
    finally:
        handle.remove()


def train_readings(cfg: Dict, state: Dict[str, torch.Tensor],
                   batches: List[Dict[str, torch.Tensor]], gen_seed: int,
                   device, lower: bool = False,
                   choices: Dict[str, List] = None) -> Dict:
    """The reference's three checked steps: losses, first-step gradient
    norms by leaf and the elements each change is read over (`masks`),
    the parameters after the three steps (on the host), the first-step
    gradients (`grad_full`) and head logits (`logits`). A Mask2Former
    step k follows `choices["assign"][k]` and `choices["points"][k]`,
    another run's matches and uncertain points, where given, and reads
    how far they lie from its own (`match_gap`, `point_gap`); `choices`
    returns those the steps followed."""
    with precision(lower):
        model = ref_builder.build_model(cfg["model"], state, device,
                                        all_fp32=not lower)
        opt, _ = ref_optim.make_optimizer(
            model, base_lr=cfg["optimizer"]["lr"],
            weight_decay=cfg["optimizer"]["weight_decay"],
            depth=cfg["model"]["backbone"]["depth"],
            layer_decay_rate=cfg["optimizer"].get("layer_decay_rate", 1.0),
            total_steps=cfg["runner"]["max_iters"],
            warmup_steps=cfg["lr_config"].get("warmup_iters", 1500),
            grad_clip=cfg["optimizer"].get("grad_clip"),
            lr_policy=cfg["lr_config"].get("policy", "poly"))
        names = {id(p): n for n, p in model.named_parameters()}
        step = make_reference_step(cfg, model)
        gen = torch.Generator(device).manual_seed(gen_seed)
        out = {"losses": [], "choices": {"assign": [], "points": [],
                                         "cost": [], "n_valid": []},
               "match_gap": 0.0, "point_gap": 0.0}
        for k, b in enumerate(batches):
            kw = ({n: choices[n][k] for n in ("assign", "points")}
                  if choices and choices.get("assign") else {})
            kept: List = []
            with head_logits(model, kept) if k == 0 \
                    else contextlib.nullcontext():
                logs = step(opt, {"image": normalize(b["image"]),
                                  "label": b["label"]}, gen, **kw)
            if k == 0:
                out["logits"] = kept[0]
            out["losses"].append(float(logs["loss"]))
            if "assign" in logs:
                out["choices"]["assign"].append(logs["assign"].cpu())
                out["choices"]["points"].append(
                    [p.cpu() for p in logs["points"]])
                out["choices"]["cost"].append(logs["cost"].float().cpu())
                out["choices"]["n_valid"].append(logs["n_valid"].cpu())
                for n in ("match_gap", "point_gap"):
                    out[n] = max(out[n], float(logs[n]))
            if k == 0:
                g = first_moments(opt.adamw, names,
                                  cfg["optimizer"]["betas"][0])
                out["grads"], out["masks"] = norms(g), small_grad_masks(g)
                out["grad_full"] = g
        out["after"] = host_copy(model)
    del model, opt
    return out


def make_reference_step(cfg: Dict, model):
    if cfg["model"]["type"] == "EncoderDecoderMask2Former":
        tc = cfg.get("train_cfg", {})
        return ref_trainer.make_m2f_train_step(
            model, cfg["model"]["decode_head"]["num_classes"],
            max_instances=tc.get("max_instances", 60),
            num_points=tc.get("num_points", 12544))
    return ref_trainer.make_seg_train_step(model,
                                           cfg.get("aux_loss_weight", 0.4))


def compare_train(prog: Dict, ref: Dict, start: Dict[str, torch.Tensor],
                  log=None) -> Dict[str, float]:
    """The numbers read for a training cell: `prog` and `ref` hold
    `losses`, `grads` and `after`; `ref` the `masks` both changes are
    read over, `grad_full` the first-step gradients; `start` the weights
    both began from, `logits` the first step's head logits. The leaf gaps
    by their worst leaf; `grad_diff` the median leaf's relative norm of
    the first gradients' difference."""
    if log is not None:
        log(f"losses: program {prog['losses']}, reference {ref['losses']}")
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(prog["losses"], ref["losses"])]
    grad = leaf_gaps(prog["grads"], ref["grads"],
                     sorted(set(prog["grads"]) | set(ref["grads"])))
    rc = masked_change(ref["after"], start, ref["masks"])
    pc = masked_change(prog["after"], start, ref["masks"])
    change = leaf_gaps(pc, rc, sorted(rc))
    numbers = {} if not ref["choices"]["assign"] else {
        "match_gap": ref["match_gap"], "point_gap": ref["point_gap"],
        "auction_gap": auction_gap(prog["choices"])}
    diff = difference_norms(prog["grad_full"], ref["grad_full"])
    numbers["grad_diff"] = statistics.median(diff.values())
    numbers["logits_gap"] = logits_gap(prog.get("logits"), ref["logits"])
    return {**numbers, "loss_gap": max(losses),
            "grad_gap": worst(grad, log, "first gradient"),
            "change_gap": worst(change, log, "change after three steps")}


def auction_gap(choices: Dict[str, List]) -> float:
    """How far the matches a run chose lie above the best matches of the
    costs they were chosen from: for each matrix of each step (`assign`
    (M, Q) or (L, B, Q) gt index or -1, `cost` (M, Q, G), `n_valid` (M,)),
    the matched cost less the optimum (an exact solve in float64), in
    units of the auction's bound n_valid * eps (eps = the largest valid
    |cost| / 2000); the worst matrix. Infinite where the matches are not
    a matching of every valid gt to one query."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    worst = 0.0
    for a, c, nv in zip(choices["assign"], choices["cost"],
                        choices["n_valid"]):
        c = c.double().reshape(-1, *c.shape[-2:]).numpy()
        a = a.reshape(c.shape[0], -1).numpy()
        for m in range(c.shape[0]):
            n = int(nv.reshape(-1)[m])
            if n == 0:
                continue
            cm, am = c[m, :, :n], a[m]
            queries = np.nonzero(am >= 0)[0]
            if sorted(am[queries].tolist()) != list(range(n)):
                return float("inf")
            rows, cols = linear_sum_assignment(cm)
            unit = max(n * float(np.abs(cm).max()) / 2000.0, 1e-12)
            gap = (cm[queries, am[queries]].sum() - cm[rows, cols].sum())
            worst = max(worst, float(gap) / unit)
    return worst


def infer_readings(cfg: Dict, state: Dict[str, torch.Tensor],
                   crops: Sequence[torch.Tensor], device,
                   lower: bool = False) -> List[torch.Tensor]:
    """The reference's logits (N, h, w, K) fp32 of each request's uint8
    crops (N, h, w, 3)."""
    with precision(lower), torch.inference_mode():
        model = ref_builder.build_model(cfg["model"], state, device,
                                        all_fp32=not lower)
        out = [model(normalize(c.to(device))).float() for c in crops]
    del model
    return out


def relative_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(b.device).float() - b.float()).norm()
                 / b.float().norm())


def logits_gap(prog, ref: Sequence[torch.Tensor]) -> float:
    """The worst relative root-mean-square gap of the program's tensors to
    the reference's; infinite where the program gave none or another
    shape."""
    if not prog or len(prog) != len(ref) or any(
            p.shape != r.shape for p, r in zip(prog, ref)):
        return float("inf")
    return max(relative_rms(p, r) for p, r in zip(prog, ref))


def compare_infer(prog: Sequence[torch.Tensor],
                  ref: Sequence[torch.Tensor]) -> Dict[str, float]:
    return {"logits_gap": max(relative_rms(p, r)
                              for p, r in zip(prog, ref))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit at or under it (a missing number or a
    NaN fails); numbers without a limit are read, not compared."""
    return all(k in numbers and numbers[k] == numbers[k]
               and numbers[k] <= v for k, v in limits.items())
