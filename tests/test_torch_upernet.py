"""The port's UperNet path (`vitadapter_torch/heads/upernet.py`,
`models/segmentor.py`, `models/baselines.py`, `layers/merging.py` and their
weight converters) against the JAX package, on the CPU at a tiny size.

Weights go the port's `state_dict()` -> the JAX converters
(`convert_vit_adapter_backbone`, `convert_upernet_heads`), or flax ->
`utils/weights.py` where no JAX converter exists (the baselines' pyramid,
`PatchMerging`). Inputs come from a numpy seed. fp32 comparisons hold each
output within 2e-4 of its scale (its largest |value|); the bf16 one is
stated at its test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitadapter.heads import upernet as jupernet
from vitadapter.layers import merging as jmerging
from vitadapter.models import baselines as jbaselines
from vitadapter.models import segmentor as jseg
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter.utils.checkpoint import (convert_upernet_heads,
                                         convert_vit_adapter_backbone)
from vitadapter_torch.heads.upernet import (FCNHead, UPerHead,
                                            adaptive_avg_pool)
from vitadapter_torch.layers import merging as tmerging
from vitadapter_torch.models import baselines as tbaselines
from vitadapter_torch.models import segmentor as tseg
from vitadapter_torch.models.seg_protocol import slide_grid
from vitadapter_torch.models.vit import TIMMVisionTransformer
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.utils.init import init_weights
from vitadapter_torch.utils.weights import load_flax, state_dict_from_flax

from torch_port_util import (TINY_BACKBONE, TINY_TRAIN_BACKBONE, randomize,
                             randomize_flax, to_np)

TOL = 2e-4
K = 7                                  # classes
HEADS = dict(channels=16, aux_channels=8)
# bf16 against bf16: both sides round every conv, linear and norm output
# to bf16 (8 significant bits, one ulp = 2^-8 of a value's binade), but
# from fp32 sums taken in another order, so a rounding can go the other
# way and the difference then travels through the following layers. Held
# to 4 ulps (2^-6) of each output's scale: logits and the loss (seen: the
# logits 1.8 ulps, the auxiliary logits 0.9, the loss 0.04)
BF16_TOL = 4 * 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make these small eager ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(got, want, tol=TOL, msg=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (msg, err, scale)


def _init(model, seed=None):
    model = init_weights(model.to_empty(device="cpu"),
                         torch.Generator().manual_seed(0))
    if seed is not None:
        randomize(model, seed)
    return model.eval()


def _heads(dropout=0.1, dtype=torch.float32, c=48):
    return (UPerHead([c] * 4, num_classes=K, channels=HEADS["channels"],
                     dropout_ratio=dropout, dtype=dtype, device="meta"),
            FCNHead(c, num_classes=K, channels=HEADS["aux_channels"],
                    dropout_ratio=dropout, dtype=dtype, device="meta"))


def _jheads(dropout=0.1, dtype=jnp.float32):
    return (jupernet.UPerHead(num_classes=K, channels=HEADS["channels"],
                              dropout_ratio=dropout, dtype=dtype),
            jupernet.FCNHead(num_classes=K, channels=HEADS["aux_channels"],
                             dropout_ratio=dropout, dtype=dtype))


def _port_segmentor(seed, dtype=torch.float32, backbone=TINY_BACKBONE):
    head, aux = _heads(dtype=dtype)
    model = tseg.EncoderDecoder(
        ViTAdapter(**backbone, dtype=dtype, device="meta"), head, aux,
        aux_in_index=2)
    return _init(model, seed)


def _jax_segmentor(dtype=jnp.float32, backbone=TINY_BACKBONE):
    head, aux = _jheads(dtype=dtype)
    return jseg.EncoderDecoder(backbone=JViTAdapter(**backbone, dtype=dtype),
                               decode_head=head, auxiliary_head=aux,
                               aux_in_index=2)


def jax_variables(sd):
    """The JAX converters' tree of a port segmentor's `state_dict`."""
    pb, sb = convert_vit_adapter_backbone(sd, "backbone.")
    ph, sh = convert_upernet_heads(sd)
    return {"params": {"backbone": pb, **ph},
            "batch_stats": {"backbone": sb, **sh}}


def _paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


@pytest.mark.parametrize("hw,o", [((6, 6), 1), ((7, 5), 2), ((16, 16), 3),
                                  ((5, 9), 6), ((4, 4), 6)])
def test_adaptive_avg_pool_matches_torch_segments_and_jax(hw, o):
    x = np.random.RandomState(o).randn(2, *hw, 5).astype(np.float32)
    got = adaptive_avg_pool(torch.from_numpy(x), o)
    assert_close(got, jupernet.adaptive_avg_pool(jnp.asarray(x), o))
    seg = torch.nn.AdaptiveAvgPool2d(o)(torch.from_numpy(x).permute(0, 3, 1,
                                                                     2))
    assert_close(got, seg.permute(0, 2, 3, 1))


@pytest.mark.parametrize("train", [False, True])
def test_heads_match_jax(train):
    """`UPerHead` and `FCNHead` on random maps of strides 4-32, in eval mode
    (running statistics) and train mode (batch statistics; the running
    statistics they leave; dropout 0 since JAX's bits cannot be replayed):
    logits and every updated BatchNorm statistic."""
    rs = np.random.RandomState(11)
    feats = [rs.randn(2, s, s + 2, 48).astype(np.float32)
             for s in (16, 8, 4, 2)]
    head, aux = (_init(m, 12 + i) for i, m in enumerate(_heads(dropout=0.0)))
    # copies: the converters' arrays share memory with the tensors, whose
    # running statistics the port's forward moves in place
    sd = {f"{name}.{k}": v.clone() for name, m in (("decode_head", head),
                                                   ("auxiliary_head", aux))
          for k, v in m.state_dict().items()}
    params, stats = convert_upernet_heads(sd)
    tf = [torch.from_numpy(f) for f in feats]
    jf = [jnp.asarray(f) for f in feats]
    head.train(train)
    aux.train(train)
    got = (head(tf), aux(tf[2]))
    jhead, jaux = _jheads(dropout=0.0)

    def fn(params, stats, feats):
        return [m.apply({"params": params[n], "batch_stats": stats[n]}, x,
                        train=train, mutable=["batch_stats"])
                for m, n, x in ((jhead, "decode_head", feats),
                                (jaux, "auxiliary_head", feats[2]))]

    with jax.default_matmul_precision("highest"):
        want = jax.jit(fn)(params, stats, jf)
    for (logits, new), g, m, name in zip(want, got, (head, aux),
                                         ("decode_head", "auxiliary_head")):
        assert g.shape[-1] == K and g.dtype == torch.float32
        assert_close(g.detach(), logits, msg=name)
        back = state_dict_from_flax(params[name], new["batch_stats"])
        for k, t in m.state_dict().items():
            if "running_" in k:
                assert_close(t, back[k], 1e-5, f"{name}.{k}")


def test_weight_round_trip_through_jax_converters():
    """port state_dict -> `convert_vit_adapter_backbone` and
    `convert_upernet_heads` -> `state_dict_from_flax` gives back every key
    bitwise (BatchNorm's num_batches_tracked aside), and the tree is the
    JAX segmentor's own."""
    model = _port_segmentor(21)
    sd = model.state_dict()
    v = jax_variables(sd)
    back = state_dict_from_flax(v["params"], v["batch_stats"])
    want = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert set(back) == want
    for k in want:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, msg=k)
    shapes = jax.eval_shape(lambda x: _jax_segmentor().init(
        jax.random.PRNGKey(0), x, with_aux=True),
        jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    assert _paths(v["params"]) == _paths(shapes["params"])
    assert _paths(v["batch_stats"]) == _paths(shapes["batch_stats"])


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_segmentor_logits_match_jax(hw):
    """A tiny `EncoderDecoder` + `ViTAdapter` (depth 4, embed 48) in eval
    mode: the logits at input size, and with `with_aux` the auxiliary
    logits of `feats[2]`, square and not."""
    model = _port_segmentor(31)
    x = np.random.RandomState(32).randn(2, *hw, 3).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        got_l, got_a = model(torch.from_numpy(x), with_aux=True)
    jm = _jax_segmentor()
    v = jax_variables(model.state_dict())
    with jax.default_matmul_precision("highest"):
        want_l, want_a = jax.jit(lambda v, x: jm.apply(v, x, with_aux=True))(
            v, x)
    assert got.shape == (2, *hw, K)
    assert torch.equal(got, got_l)
    assert_close(got_l, want_l, msg="logits")
    assert_close(got_a, want_a, msg="aux")


def test_bf16_segmentor_and_loss_match_jax_bf16():
    """The tiny segmentor (cut to 2 blocks) with its backbone and heads in
    bf16 on both sides, as the bf16 UperNet configs run them, from the same
    fp32 weights: logits, auxiliary logits and the segmentation loss within
    `BF16_TOL` of each one's scale."""
    model = _port_segmentor(41, torch.bfloat16, TINY_TRAIN_BACKBONE)
    rs = np.random.RandomState(42)
    x = rs.randn(2, 64, 64, 3).astype(np.float32)
    label = rs.randint(0, K, (2, 64, 64)).astype(np.int32)
    label[0, :5] = 255
    with torch.no_grad():
        got_l, got_a = model(torch.from_numpy(x), with_aux=True)
        got_loss, _ = tseg.segmentation_loss(got_l, got_a,
                                             torch.from_numpy(label))
    jm = _jax_segmentor(jnp.bfloat16, TINY_TRAIN_BACKBONE)
    v = jax_variables(model.state_dict())

    def fn(v, x, label):
        logits, aux = jm.apply(v, x, with_aux=True)
        return logits, aux, jseg.segmentation_loss(logits, aux, label)[0]

    want_l, want_a, want_loss = jax.jit(fn)(v, x, label)
    assert got_l.dtype == torch.float32
    assert_close(got_l, want_l, BF16_TOL, "logits")
    assert_close(got_a, want_a, BF16_TOL, "aux")
    assert_close(got_loss, want_loss, BF16_TOL, "loss")


def test_losses_match_jax():
    """`cross_entropy_loss` (with and without class weights) and
    `segmentation_loss` with 255-masked pixels, and an all-ignored batch
    (the mean over at least one pixel: 0)."""
    rs = np.random.RandomState(51)
    logits, aux = (rs.randn(2, 12, 20, K).astype(np.float32) * 3
                   for _ in range(2))
    label = rs.randint(0, K, (2, 12, 20)).astype(np.int32)
    label[rs.rand(2, 12, 20) < 0.3] = 255
    w = (0.5 + rs.rand(K)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (logits, aux, label, w)]
    cases = [
        (tseg.cross_entropy_loss(t[0], t[2]),
         jseg.cross_entropy_loss(logits, label)),
        (tseg.cross_entropy_loss(t[0], t[2], class_weight=t[3]),
         jseg.cross_entropy_loss(logits, label, class_weight=jnp.asarray(w))),
        (tseg.cross_entropy_loss(t[0], torch.full_like(t[2], 255)),
         jseg.cross_entropy_loss(logits, np.full_like(label, 255)))]
    got, logs = tseg.segmentation_loss(t[0], t[1], t[2], 0.4)
    want, jlogs = jseg.segmentation_loss(logits, aux, label, 0.4)
    cases += [(got, want)] + [(logs[k], jlogs[k]) for k in jlogs]
    assert set(logs) == set(jlogs) == {"loss_decode", "loss_aux"}
    for g, w_ in cases:
        np.testing.assert_allclose(float(g), float(w_), rtol=1e-6, atol=1e-7)
    assert float(cases[2][0]) == 0.0


def _logits_fns(rs):
    """The same position-dependent per-pixel map in both frameworks: a
    3 -> K projection plus a cumulative sum along the width, so that where a
    crop starts changes its logits."""
    w = rs.randn(3, K).astype(np.float32)
    v = rs.randn(K).astype(np.float32)

    def jfn(x):
        return x @ w + 0.1 * jnp.cumsum(x.mean(-1), axis=2)[..., None] * v

    def tfn(x):
        return (x @ torch.from_numpy(w)
                + 0.1 * torch.cumsum(x.mean(-1), dim=2)[..., None]
                * torch.from_numpy(v))

    return tfn, jfn


@pytest.mark.parametrize("case", ["slide", "slide_small", "flip",
                                  "ms_input", "ms_img_scale"])
def test_tta_helpers_match_jax(case):
    """`slide_inference` (a grid with overlaps; an image under the crop,
    zero-padded), `flip_tta` and `multi_scale_flip_aug` (ratios of the
    input size; ratios of an `img_scale` canvas, with slide inference where
    a variant exceeds the crop)."""
    rs = np.random.RandomState(61)
    tfn, jfn = _logits_fns(rs)
    hw = (10, 12) if case == "slide_small" else (29, 40)
    x = rs.rand(2, *hw, 3).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if case.startswith("slide"):
        args = ((16, 16), (11, 11), K)
        got = tseg.slide_inference(tfn, tx, *args)
        want = jax.jit(lambda x: jseg.slide_inference(jfn, x, *args))(jx)
    elif case == "flip":
        got = tseg.flip_tta(tfn)(tx)
        want = jax.jit(jseg.flip_tta(jfn))(jx)
    else:
        kw = dict(ratios=(0.5, 1.0, 1.5), size_divisor=8,
                  crop_size=(32, 32), stride=(21, 21))
        if case == "ms_img_scale":
            kw["img_scale"] = (64, 32)
        got = tseg.multi_scale_flip_aug(tfn, tx, K, **kw)
        want = jax.jit(lambda x: jseg.multi_scale_flip_aug(jfn, x, K,
                                                           **kw))(jx)
    assert_close(got, want)
    for size, crop, stride in ((29, 16, 11), (40, 16, 11), (10, 16, 11),
                               (512, 512, 341), (683, 512, 341)):
        assert slide_grid(size, crop, stride) == jseg._slide_grid(
            size, crop, stride)


def _flax_into(port, jmodule, x, seed, **kw):
    """Random flax weights of `jmodule` loaded into `port`; returns the
    flax variables."""
    shapes = jax.eval_shape(lambda x: jmodule.init(jax.random.PRNGKey(0), x,
                                                   **kw), x)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    params = randomize_flax(zeros["params"], seed)
    load_flax(port, params)
    return {"params": params}


@pytest.mark.parametrize("kind", ["vit", "beit", "beit_out_indices"])
def test_baselines_match_jax(kind):
    """`ViTBaseline` and `BEiTBaseline` (all scales from the last block, and
    one block's output a scale by `out_indices`, the cls token riding
    along): the 4 pyramid maps, weights flax -> `utils/weights.py`."""
    x = np.random.RandomState(71).randn(2, 64, 64, 3).astype(np.float32)
    if kind == "vit":
        cfg = dict(embed_dim=32, depth=2, num_heads=4)
        port = tbaselines.ViTBaseline(**cfg, device="meta")
        jm = jbaselines.ViTBaseline(**cfg)
    else:
        cfg = dict(img_size=64, embed_dim=32, depth=4, num_heads=4,
                   out_indices=(0, 1, 2, 3) if kind.endswith("indices")
                   else None)
        port = tbaselines.BEiTBaseline(**cfg, device="meta")
        jm = jbaselines.BEiTBaseline(**cfg)
    port = _init(port)
    v = _flax_into(port, jm, x, 72)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jm.apply)(v, x)
    assert [tuple(g.shape) for g in got] == [
        (2, 16, 16, 32), (2, 8, 8, 32), (2, 4, 4, 32), (2, 2, 2, 32)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, msg=f"scale {i}")


@pytest.mark.parametrize("hw,kernel,stride,mode", [
    ((5, 7), 2, 2, "corner"), ((5, 7), 3, 2, "same"), ((8, 6), 2, 2, "same"),
    ((9, 4), 4, 3, "corner"), ((9, 4), 4, 3, "same")])
def test_adaptive_padding_matches_jax(hw, kernel, stride, mode):
    x = np.random.RandomState(81).randn(2, *hw, 6).astype(np.float32)
    got = tmerging.adaptive_padding(torch.from_numpy(x), kernel, stride, mode)
    want = jmerging.adaptive_padding(jnp.asarray(x), kernel, stride, mode)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("hw", [(5, 7), (8, 6)])
def test_patch_merging_matches_jax(hw):
    """Odd sizes padded at the bottom and right, then merged."""
    x = np.random.RandomState(81).randn(2, *hw, 6).astype(np.float32)
    port = _init(tmerging.PatchMerging(6, 10, device="meta"))
    jm = jmerging.PatchMerging(out_channels=10)
    v = _flax_into(port, jm, x, 82)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jm.apply)(v, x)
    assert got.shape == (2, -(-hw[0] // 2), -(-hw[1] // 2), 10)
    assert_close(got, want)


def _backbone_grads(model, x, seed):
    model.zero_grad()
    model.train()
    feats = model(x, generator=torch.Generator().manual_seed(seed))
    sum(f.square().mean() for f in feats).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_with_cp_replays_drop_path_draws_in_vit_blocks():
    """`with_cp` recomputes the ViT blocks (not the interactions) in the
    backward; with one generator seed and drop path 0.4 the gradients
    equal those of the blocks run plainly, and another seed gives other
    ones, so the masks matter."""
    cfg = dict(TINY_BACKBONE, drop_path_rate=0.4)
    plain = _init(ViTAdapter(**cfg, device="meta"), 91)
    cp = _init(ViTAdapter(**cfg, with_cp=True, device="meta"))
    cp.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.RandomState(92).randn(
        2, 64, 64, 3).astype(np.float32))
    want = _backbone_grads(plain, x, 93)
    got = _backbone_grads(cp, x, 93)
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=1e-6, atol=1e-7,
                                   msg=n)
    other = _backbone_grads(plain, x, 94)
    assert any(not torch.allclose(other[n], want[n]) for n in want
               if ".blocks." in n or n.startswith("blocks."))


@pytest.mark.parametrize("kw", [dict(window_attn=True),
                                dict(window_attn=[False, True]),
                                dict(residual_indices=[1])])
def test_windowed_vit_raises_naming_item_4(kw):
    """Windowed attention and the residual bottleneck blocks are ported:
    the trunks build with them and give their outputs' shapes (on a 64x96
    image, 4x6 tokens in windows of 3; the baseline takes no residual
    blocks, as in JAX)."""
    x = torch.zeros(1, 64, 96, 3)
    for cls in (ViTAdapter, TIMMVisionTransformer, tbaselines.ViTBaseline):
        if "residual_indices" in kw and cls is tbaselines.ViTBaseline:
            continue
        cfg = dict(embed_dim=48, depth=2, num_heads=4, **kw)
        if cls is ViTAdapter:
            cfg.update(deform_num_heads=6, conv_inplane=16,
                       interaction_indexes=((0, 0), (1, 1)))
        model = _init(cls(window_size=3, device="meta", **cfg))
        with torch.no_grad():
            out = model(x)
        shapes = ([tuple(o.shape) for o in out]
                  if isinstance(out, list) else tuple(out.shape))
        assert [b.use_residual for b in model.blocks] == [
            False, "residual_indices" in kw]
        if cls is TIMMVisionTransformer:
            assert shapes == (1, 24, 48)
        else:
            assert shapes == [(1, 16, 24, 48), (1, 8, 12, 48),
                              (1, 4, 6, 48), (1, 2, 3, 48)]
