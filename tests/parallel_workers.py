"""The rank side of the tensor, pipeline and sequence parallel CPU tests
(`tests/test_torch_tp.py`, `tests/test_torch_pp_sp.py`), spawned through
`ddp_workers.spawn_ranks` as `parallel_workers:<body>`. Like
`ddp_workers`, it imports neither JAX nor the JAX package: the test saves
the inputs (weights converted to the port's names, batches, loss draws)
and each rank saves what it computed."""

from pathlib import Path

import torch

import ddp_workers as W
from torch_port_util import TINY_TRAIN, TINY_TRAIN_HEAD, ReplaySampler

WORLD = 4
TP = 2           # the (data 2, model 2) grid of the TP step
# heads that a model group of `WORLD` does not divide
BAD_HEADS = 6

# the pipelines of `tests/test_pipeline_pp.py`: 8 MLP layers (dim 16,
# hidden 32) and 8 ViT blocks (dim 48, 4 heads, 4x4 tokens, MLP ratio 2),
# 4 microbatches, over 4 stages
MLP_DEPTH, MLP_DIM, MLP_HIDDEN = 8, 16, 32
VIT_DEPTH, VIT_DIM, VIT_HEADS, VIT_HW = 8, 48, 4, 4
N_MICRO = 4


def tp_step(rank: int, work: Path):
    """The tiny Mask2Former's train step on the (data 2, model 2) grid:
    the rank's data group's rows of the batch and its share of the loss
    draws. Returns the logs, the gathered parameters after the step and
    the gathered clipped gradients, the shapes of the rank's `qkv` shard
    and of its AdamW first moment, the split of the parameters, and
    the refusal of a block of `BAD_HEADS` heads on a model group of
    `WORLD`."""
    from vitadapter_torch.models.vit import Block
    from vitadapter_torch.parallel import mesh as pmesh
    from vitadapter_torch.parallel import tp
    from vitadapter_torch.train import optim, trainer

    inputs = W.load(work / "inputs.pkl")
    model = W.m2f_model()
    model.load_state_dict(inputs["state_dict"])
    specs = tp.partition_specs(model)
    mesh = tp.make_tp_mesh(TP)
    tp.shard_model(model, mesh)
    d, n = mesh.index("data"), mesh.size("data")
    batch = tp.shard_batch_2d(inputs["batch"], mesh)
    draws = W.m2f_rank_draws(inputs["draws"], d, n)
    opt, _ = optim.make_optimizer(model, **W.M2F_OPT)
    state = trainer.TrainState.create(model, opt)
    step = trainer.make_m2f_train_step(
        model, TINY_TRAIN_HEAD["num_classes"], **TINY_TRAIN)
    sampler = ReplaySampler(draws)
    _, logs = step(state, W.to_torch(batch), torch.Generator().manual_seed(0),
                   sampler)
    assert sampler.done()
    qkv = model.backbone.blocks[0].attn.qkv.weight
    shapes = {"qkv": tuple(qkv.shape),
              "exp_avg": tuple(opt.adamw.state[qkv]["exp_avg"].shape),
              "heads": model.backbone.blocks[0].attn.num_heads}
    params = {k: v.numpy() for k, v in tp.gather_state_dict(model,
                                                            mesh).items()}
    grads = {k: v.numpy() for k, v in tp.gather_grads(model, mesh).items()}
    pmesh.use_grid(None)
    try:
        tp.shard_model(Block(48, BAD_HEADS),
                       pmesh.Mesh(("data", "model"), (1, WORLD)))
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"logs": {k: float(v) for k, v in logs.items()},
            "params": params, "grads": grads, "shapes": shapes,
            "specs": specs, "refused": refused}


def mlp_layer(p, x):
    y = torch.tanh(x @ p["w1"] + p["b1"])
    return x + y @ p["w2"] + p["b2"]


def pp_mlp(rank: int, work: Path):
    """`pipeline_apply` of the 8 MLP layers over 4 stages: the outputs and
    the gradients of their sum, rank `rank`'s layers, by global index."""
    from vitadapter_torch.parallel import pp

    inputs = W.load(work / "inputs.pkl")["mlp"]
    mesh = pp.make_pp_mesh()
    layers = [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
              for p in inputs["layers"]]
    S, s = mesh.size("stage"), mesh.index("stage")
    per = len(layers) // S
    mine = layers[s * per:(s + 1) * per]

    def stage(x):
        for p in mine:
            x = mlp_layer(p, x)
        return x

    out = pp.pipeline_apply(stage, torch.from_numpy(inputs["xs"]), mesh,
                            params=[t for p in mine for t in p.values()])
    out.sum().backward()
    return {"out": out.detach().numpy(),
            "grads": {s * per + i: {k: t.grad.numpy() for k, t in p.items()}
                      for i, p in enumerate(mine)}}


def pp_vit(rank: int, work: Path):
    """`pipeline_apply` of the 8 ViT blocks over 4 stages (`split_stages`
    of blocks built from the converted weights): the outputs and each of
    this rank's blocks' gradients, by global index."""
    from vitadapter_torch.models.vit import Block
    from vitadapter_torch.parallel import pp

    inputs = W.load(work / "inputs.pkl")["vit"]
    blocks = []
    for sd in inputs["blocks"]:
        b = Block(VIT_DIM, VIT_HEADS, mlp_ratio=2.0)
        b.load_state_dict(sd)
        blocks.append(b)
    mesh = pp.make_pp_mesh()
    mine = pp.split_stages(blocks, mesh)

    def stage(x):
        for b in mine:
            x = b(x, VIT_HW, VIT_HW)
        return x

    out = pp.pipeline_apply(stage, torch.from_numpy(inputs["xs"]), mesh,
                            params=list(mine.parameters()))
    out.sum().backward()
    first = mesh.index("stage") * len(mine)
    return {"out": out.detach().numpy(),
            "grads": {first + i: {k: p.grad.numpy()
                                  for k, p in b.named_parameters()}
                      for i, b in enumerate(mine)}}


def sp_msda(rank: int, work: Path):
    """`msda_token_sharded` over 4 ranks: this rank's output rows and the
    gradients of the sum of every rank's outputs (the value's summed over
    the ranks); and whether 338 queries were refused."""
    from vitadapter_torch.parallel import pp, sp

    inputs = W.load(work / "inputs.pkl")["sp"]
    mesh = pp.make_pp_mesh(axis="model")
    rows = sp.query_rows(inputs["loc"].shape[1], mesh)
    value = torch.from_numpy(inputs["value"]).requires_grad_()
    loc = torch.from_numpy(inputs["loc"][:, rows]).requires_grad_()
    attn = torch.from_numpy(inputs["attn"][:, rows]).requires_grad_()
    out = sp.msda_token_sharded(value, inputs["shapes"], loc, attn, mesh)
    out.sum().backward()
    try:
        sp.query_rows(inputs["loc"].shape[1] + 2, mesh)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"rows": (rows.start, rows.stop), "out": out.detach().numpy(),
            "dvalue": value.grad.numpy(), "dloc": loc.grad.numpy(),
            "dattn": attn.grad.numpy(), "refused": refused}


def pp_sp(rank: int, work: Path):
    return {"mlp": pp_mlp(rank, work), "vit": pp_vit(rank, work),
            "sp": sp_msda(rank, work)}
