"""The rank side of the two-rank CPU tests (`tests/test_torch_ddp.py`,
`tests/test_torch_ddp_det.py`): `spawn_ranks` starts W processes (the
`spawn` context), joins a gloo group through a `file://` rendezvous in the
test's directory, runs one body on each rank and returns what each rank
saved. A rank that raises or hangs fails the call: the children are joined
with a timeout and killed. The children import neither JAX nor the JAX
package (each rank reports what it loaded), and run one torch thread each.

The tiny models and inputs both sides share are defined here, so that the
tests, which import JAX, and the ranks, which do not, build the same
ones."""

import multiprocessing
import os
import pickle
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from torch_port_util import (DET_BACKBONE, DET_HEADS, TINY_TRAIN,
                             TINY_TRAIN_BACKBONE, TINY_TRAIN_HEAD,
                             ReplaySampler)

WORLD = 2
JOIN_TIMEOUT = 300

# the UperNet step of `test_torch_seg_train.py` (one block in one
# interaction) and the Mask2Former step of `test_torch_train_step.py`
UPERNET_BACKBONE = dict(TINY_TRAIN_BACKBONE, depth=1,
                        interaction_indexes=((0, 0),))
UPERNET_K = 5
UPERNET_HEAD = dict(num_classes=UPERNET_K, channels=16, dropout_ratio=0.0)
UPERNET_AUX = dict(num_classes=UPERNET_K, channels=8, dropout_ratio=0.0)
UPERNET_OPT = dict(base_lr=1e-4, depth=UPERNET_BACKBONE["depth"],
                   total_steps=1000, warmup_steps=0, grad_clip=0.01)
M2F_OPT = dict(base_lr=1e-4, depth=TINY_TRAIN_BACKBONE["depth"],
               total_steps=1000, warmup_steps=0, grad_clip=0.01)
M2F_OUTPUTS = TINY_TRAIN_HEAD["num_decoder_layers"] + 1

# the detection steps: Mask R-CNN of `test_torch_det_train.py`, ATSS of
# `test_torch_single_stage.py` and DINO of `test_torch_dino.py`
MRCNN_BACKBONE = dict(DET_BACKBONE, depth=2,
                      interaction_indexes=((0, 0), (1, 1)),
                      window_attn=(True, False), window_size=(3, None))
ATSS_BACKBONE = dict(DET_BACKBONE, depth=1, interaction_indexes=((0, 0),),
                     window_attn=(True,), window_size=(3,))
ATSS_HEADS = dict(num_classes=4, fpn_channels=128, max_dets=10)
DINO_CFG = dict(type="DINO", num_classes=3, num_queries=12, embed_dim=32,
                num_heads=4, ffn_dim=64, num_encoder_layers=1,
                num_decoder_layers=2, dn_groups=1, max_dets=5,
                backbone=dict(type="ViTBaseline", patch_size=16,
                              embed_dim=48, depth=2, num_heads=4))
DET_OPT = dict(base_lr=1e-4, depth=2, total_steps=1000, warmup_steps=0,
               grad_clip=0.01)

# the tiny UperNet config of `test_torch_seg_train.py`, one image a rank,
# on synthetic data with its eval hook
CLI_CFG = """
model = dict(
    type="EncoderDecoder",
    backbone=dict(
        type="ViTAdapter", dtype="float32", patch_size=16, embed_dim=48,
        depth=2, num_heads=4, deform_num_heads=6, conv_inplane=16,
        drop_path_rate=0.1, img_size=64, with_cp=True,
        interaction_indexes=[[0, 0], [1, 1]]),
    decode_head=dict(type="UPerHead", num_classes=4, channels=16,
                     pool_scales=[1, 2, 3, 6], dropout_ratio=0.1),
    auxiliary_head=dict(type="FCNHead", num_classes=4, channels=8,
                        num_convs=1, dropout_ratio=0.1),
    aux_in_index=2,
)
aux_loss_weight = 0.4
data = dict(dataset_type="PascalContextDataset", crop_size=[64, 64],
            samples_per_chip=1, scale=[64, 64])
runner = dict(max_iters=2)
optimizer = dict(lr=3e-3, weight_decay=1e-4, layer_decay_rate=0.9)
lr_config = dict(policy="poly", warmup_iters=4, power=1.0)
log_config = dict(interval=1)
checkpoint_config = dict(interval=2, max_keep_ckpts=1)
evaluation = dict(interval=2, metric="mIoU", save_best="mIoU")
test_cfg = dict(mode="slide", crop_size=[64, 64], stride=[43, 43])
"""

# the step-keyed train batches: a global batch of 2 over 6 images, 3
# steps (one epoch)
SAMPLER_N, SAMPLER_BATCH, SAMPLER_STEPS = 6, 2, 3
SAMPLER_DATA = dict(crop_size=(16, 16), scale=(24, 24),
                    ratio_range=(0.5, 2.0), cat_max_ratio=0.75)


def rows(rank: int, n: int, world: int = WORLD) -> slice:
    s = n // world
    return slice(rank * s, (rank + 1) * s)


def shard(batch, rank):
    return {k: v[rows(rank, len(v))] for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def params_np(model):
    return {k: v.detach().clone().numpy()
            for k, v in model.state_dict().items()}


class ImageSet:
    """(uint8 image, int label) pairs held in memory."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def load(self, i):
        return self.items[i]


def sampler_dataset():
    rs = np.random.RandomState(70)
    return ImageSet([(rs.randint(0, 256, (20 + i, 28, 3)).astype(np.uint8),
                      rs.randint(0, 5, (20 + i, 28)).astype(np.int32))
                     for i in range(SAMPLER_N)])


def eval_images():
    """Three odd-sized images, labels with some ignored pixels: one rank
    of two scores two, the other one."""
    rs = np.random.RandomState(71)
    items = []
    for h, w in ((70, 90), (64, 50), (80, 64)):
        label = rs.randint(0, UPERNET_K, (h, w)).astype(np.int32)
        label[:5] = 255
        items.append((rs.randint(0, 256, (h, w, 3)).astype(np.uint8), label))
    return ImageSet(items)


EVAL_CFG = {"num_classes": UPERNET_K,
            "test_cfg": {"mode": "slide", "crop_size": (64, 64),
                         "stride": (43, 43), "img_scale": (96, 64)},
            "data": {}}


# ------------------------------------------------------------- the models

def upernet_model():
    from vitadapter_torch.heads.upernet import FCNHead, UPerHead
    from vitadapter_torch.models.segmentor import EncoderDecoder
    from vitadapter_torch.models.vit_adapter import ViTAdapter

    dim = UPERNET_BACKBONE["embed_dim"]
    return EncoderDecoder(ViTAdapter(**UPERNET_BACKBONE),
                          UPerHead([dim] * 4, **UPERNET_HEAD),
                          FCNHead(dim, **UPERNET_AUX))


def m2f_model():
    from vitadapter_torch.heads.mask2former import Mask2FormerHead
    from vitadapter_torch.models.mask2former_segmentor import \
        EncoderDecoderMask2Former
    from vitadapter_torch.models.vit_adapter import ViTAdapter

    return EncoderDecoderMask2Former(
        ViTAdapter(**TINY_TRAIN_BACKBONE),
        Mask2FormerHead([TINY_TRAIN_BACKBONE["embed_dim"]] * 4,
                        **TINY_TRAIN_HEAD))


def det_model(kind: str):
    """A detector on the meta device, with the port's initialization from
    seed 0 on the CPU."""
    from vitadapter_torch import zoo
    from vitadapter_torch.builder import build
    from vitadapter_torch.det.mask_rcnn import MaskRCNN
    from vitadapter_torch.det.single_stage import ATSS
    from vitadapter_torch.models.vit_adapter import ViTAdapter

    if kind == "mask_rcnn":
        model = MaskRCNN(ViTAdapter(**MRCNN_BACKBONE, device="meta"),
                         device="meta", **DET_HEADS)
    elif kind == "atss":
        model = ATSS(ViTAdapter(**ATSS_BACKBONE, device="meta"),
                     device="meta", **ATSS_HEADS)
    else:
        model = build(dict(DINO_CFG))
    return zoo.materialize(model, torch.device("cpu"), None)


# ------------------------------------------------------------ the steps

def seg_step(kind: str, state_dict, batch, draws=None):
    """One step of the UperNet or Mask2Former train step on `batch` from
    `state_dict` (drop path 0): (logs, parameters and buffers after the
    step, the clipped gradients)."""
    from vitadapter_torch.train import optim, trainer

    if kind == "upernet":
        model, opt_kw = upernet_model(), UPERNET_OPT
        step = trainer.make_seg_train_step(model, 0.4)
        extra = ()
    else:
        model, opt_kw = m2f_model(), M2F_OPT
        step = trainer.make_m2f_train_step(
            model, TINY_TRAIN_HEAD["num_classes"], **TINY_TRAIN)
        extra = (ReplaySampler(draws),)
    model.load_state_dict(state_dict)
    opt, _ = optim.make_optimizer(model, **opt_kw)
    state = trainer.TrainState.create(model, opt)
    _, logs = step(state, to_torch(batch), torch.Generator().manual_seed(0),
                   *extra)
    if extra:
        assert extra[0].done()
    grads = {n: p.grad.detach().clone().numpy()
             for n, p in model.named_parameters() if p.grad is not None}
    return ({k: float(v) for k, v in logs.items()}, params_np(model), grads)


def m2f_rank_draws(draws, rank: int, world: int = WORLD):
    """Rank `rank`'s share of the loss draws of a global batch, in the
    order its loss asks for them: the assignment's (L, B, P, 2) split
    along B, the per-layer (B * Q, n, 2) along the masks."""
    first, rest = draws[0], draws[1:]
    return ([first[:, rows(rank, first.shape[1], world)]]
            + [d[rows(rank, d.shape[0], world)] for d in rest])


def det_step(kind: str, state_dict, batch, draws=None):
    """One `make_det_train_step` step of a detector from `state_dict`:
    (logs, parameters after the step, the clipped gradients). `draws` are
    Mask R-CNN's sampler draws (or a sampler) or DINO's denoising
    draws."""
    from vitadapter_torch.det.dino import DnDraws
    from vitadapter_torch.train import optim, trainer

    model = det_model(kind)
    model.load_state_dict(state_dict)
    opt, _ = optim.make_optimizer(model, **DET_OPT)
    state = trainer.TrainState.create(model, opt)
    b = to_torch(batch)
    b["gt_labels"] = b["gt_labels"].long()
    kw = {}
    if kind == "mask_rcnn":
        kw["sampler"] = draws if callable(draws) else ReplaySampler(draws)
    if kind == "dino":
        kw["dn_draws"] = DnDraws(*(torch.from_numpy(d) for d in draws))
    _, logs = trainer.make_det_train_step(model)(
        state, b, torch.Generator().manual_seed(0), **kw)
    if isinstance(kw.get("sampler"), ReplaySampler):
        assert kw["sampler"].done()
    grads = {n: p.grad.detach().clone().numpy()
             for n, p in model.named_parameters() if p.grad is not None}
    return ({k: float(v) for k, v in logs.items()}, params_np(model), grads)


def mrcnn_rank_draws(draws, rank: int, world: int = WORLD):
    """The RPN's draws of each image, then the RoI sampler's: rank
    `rank`'s images' draws of each stage."""
    n = len(draws) // 2
    return draws[:n][rows(rank, n, world)] + draws[n:][rows(rank, n, world)]


def syncbn_case(rank=None):
    """BatchNorm on (4, 6, 5, 5) inputs in training mode, the loss a
    random weighting of its output: the output, the input's gradient, the
    weight's and bias's gradients (one rank's share of the loss) and the
    running statistics; the rows `rank` holds, or the whole batch."""
    from vitadapter_torch.layers.norm import BatchNorm

    rs = np.random.RandomState(72)
    x = torch.from_numpy(rs.randn(4, 6, 5, 5).astype(np.float32) * 2 + 0.5)
    w = torch.from_numpy(rs.randn(4, 6, 5, 5).astype(np.float32))
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(1 + 0.1 * rs.randn(6)))
        bn.bias.copy_(torch.from_numpy(0.1 * rs.randn(6)))
        bn.running_mean.copy_(torch.from_numpy(0.3 * rs.randn(6)))
        bn.running_var.copy_(torch.from_numpy(0.5 + rs.rand(6)))
    bn.train()
    if rank is not None:
        x, w = x[rows(rank, 4)], w[rows(rank, 4)]
    x.requires_grad_()
    y = bn(x)
    (y * w).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dweight": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def sampler_batches(steps=SAMPLER_STEPS):
    """The first `steps` batches of `train.loop.step_batches` at a global
    batch of `SAMPLER_BATCH`, and the epoch positions this rank's rows of
    each step take."""
    from vitadapter_torch.data.loader import EpochSampler
    from vitadapter_torch.parallel.mesh import rank_rows
    from vitadapter_torch.train.loop import step_batches

    it = step_batches(sampler_dataset(), SAMPLER_DATA, SAMPLER_BATCH,
                      num_threads=2)
    batches = [next(it) for _ in range(steps)]
    it.close()
    r = rank_rows(SAMPLER_BATCH)
    sampler = EpochSampler(SAMPLER_N)
    taken = [sampler.indices(k * SAMPLER_BATCH + r.start, len(r))
             for k in range(steps)]
    return batches, taken


def seg_eval(state_dict):
    from vitadapter_torch.train.loop import run_eval

    model = upernet_model()
    model.load_state_dict(state_dict)
    return run_eval(EVAL_CFG, model, eval_images(),
                    log_fn=lambda *_: None)["confusion"]


def cli_resume(work: Path):
    """The train CLI with `--multi-host` on the tiny UperNet config and
    synthetic data: two steps (a checkpoint and the eval hook at step 2),
    then `--resume` to step 3. Returns each run's step, parameters and
    log lines, and the saved steps."""
    from vitadapter_torch.tools import train as train_cli
    from vitadapter_torch.utils import checkpoint_io

    cfg = work / "upernet_tiny.py"
    out = {}
    for name, extra in (("first", []), ("resumed", ["--resume",
                                                    "--max-iters", "3"])):
        logs = []
        state = train_cli.main([str(cfg), "--work-dir", str(work / "run"),
                                "--device", "cpu", "--synthetic-data",
                                "--multi-host", *extra], log_fn=logs.append)
        out[name] = (state.step, params_np(state.model), logs)
    out["saved"] = checkpoint_io.saved_steps(str(work / "run" / "ckpt"))
    return out


# ------------------------------------------------------------ the bodies

def seg_body(rank: int, work: Path):
    inputs = load(work / "inputs.pkl")
    up, m2f = inputs["upernet"], inputs["m2f"]
    return {
        "upernet": seg_step("upernet", up["state_dict"],
                            shard(up["batch"], rank)),
        "m2f": seg_step("m2f", m2f["state_dict"], shard(m2f["batch"], rank),
                        m2f_rank_draws(m2f["draws"], rank)),
        "syncbn": syncbn_case(rank),
        "eval": seg_eval(up["state_dict"]),
        "sampler": sampler_batches(),
        "cli": cli_resume(work),
    }


def det_body(rank: int, work: Path):
    inputs = load(work / "inputs.pkl")
    out = {}
    for kind in ("mask_rcnn", "atss", "dino"):
        case = inputs[kind]
        draws = case.get("draws")
        if kind == "mask_rcnn":
            draws = mrcnn_rank_draws(draws, rank)
        elif kind == "dino":
            draws = [d[rows(rank, len(d))] for d in draws]
        out[kind] = det_step(kind, case["state_dict"],
                             shard(case["batch"], rank), draws)
    out["det_eval"] = det_eval(inputs["det_eval"])
    out["det_batches"] = det_batches(inputs["det_eval"]["options"])
    return out


def det_eval(case):
    """`run_det_eval` (bbox and segm) of the tiny Mask R-CNN config on the
    COCO-layout set: the metrics and the per-image records the
    evaluators took, in the order they took them."""
    from vitadapter_torch.builder import build_model
    from vitadapter_torch.det.coco_eval import COCOEvaluator
    from vitadapter_torch.train.det_loop import build_det_dataset, run_det_eval

    cfg = det_config(case["options"])
    model = build_model(dict(cfg.model), device="cpu")
    model.load_state_dict(case["state_dict"])
    taken = []
    add = COCOEvaluator.add_records

    def recording(self, records):
        taken.append((self.iou_type, records))
        add(self, records)

    COCOEvaluator.add_records = recording
    try:
        metrics = run_det_eval(cfg, model, build_det_dataset(cfg.data, "val"),
                               ("bbox", "segm"), log_fn=lambda *_: None)
    finally:
        COCOEvaluator.add_records = add
    metrics.pop("timing")
    return metrics, taken


def det_config(options):
    from vitadapter_torch.utils.config import Config, parse_cfg_options

    cfg = Config.fromfile(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs/mask_rcnn/mask_rcnn_deit_adapter_tiny_fpn_1x_coco.py"))
    cfg.merge_from_options(parse_cfg_options(options))
    return cfg


def det_batches(options, steps=2):
    """The first `steps` batches of `det_step_batches` at a global batch
    of 2 on the COCO-layout train split."""
    from vitadapter_torch.train.det_loop import (build_det_dataset,
                                                 det_step_batches)

    cfg = det_config(options)
    it = det_step_batches(build_det_dataset(cfg.data, "train"), cfg.data, 2,
                          num_threads=2)
    batches = [next(it) for _ in range(steps)]
    it.close()
    return batches


BODIES = {"seg": seg_body, "det": det_body}


# ----------------------------------------------------------- the harness

def save(path: Path, obj) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _rank_main(body: str, work: str, rank: int, world: int) -> None:
    work = Path(work)
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{work}/rdzv",
                                rank=rank, world_size=world)
        out = BODIES[body](rank, work)
        dist.destroy_process_group()
        out["loaded"] = sorted({m.split(".")[0] for m in sys.modules}
                               & {"jax", "jaxlib", "flax", "vitadapter"})
        save(work / f"rank{rank}.pkl", out)
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def spawn_ranks(body: str, work: Path, world: int = WORLD,
                timeout: float = JOIN_TIMEOUT):
    """Start `BODIES[body](rank, work)` on `world` gloo ranks; returns a
    function that joins them and returns each rank's result. It raises
    with the failing rank's traceback, or when a rank has not ended
    `timeout` seconds after the start."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(body, str(work), r, world))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    return lambda: _join(procs, work, world, deadline, timeout)


def _join(procs, work: Path, world: int, deadline: float, timeout: float):
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(work / f"rank{r}.err").read_text() for r in range(world)
              if (work / f"rank{r}.err").exists()]
    if hung or errors or any(p.exitcode for p in procs):
        raise RuntimeError(f"ranks {hung} hung after {timeout} s; exit codes "
                           f"{[p.exitcode for p in procs]}; "
                           + "\n".join(errors))
    return [load(work / f"rank{r}.pkl") for r in range(world)]
