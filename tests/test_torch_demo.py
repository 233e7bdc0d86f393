"""The port's demos (`vitadapter_torch/tools/image_demo.py`,
`video_demo.py`) on the CPU: the segmentor demo's picture against the JAX
package's root `image_demo.py` on the same `.pth` (a tiny ViT-Adapter +
Mask2Former on a 50x70 image, padded to 64x96), the detector demo's drawn
boxes against the model's own test-path call, the video demo over three
frames, and a GroundingDINO config, which needs its text and fails in both
packages."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from vitadapter_torch.builder import build_model
from vitadapter_torch.data.preprocess import normalize, pad_to_multiple
from vitadapter_torch.tools import image_demo, video_demo
from vitadapter_torch.utils.config import Config, parse_cfg_options

from test_torch_det_cli import OPTIONS as DET_OPTIONS
from test_torch_det_cli import TINY as DET_CONFIG
from test_torch_grounding_cli import TINY as GROUNDING_OPTIONS
from test_torch_grounding_cli import WSDM
from torch_port_util import randomize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(log_fn=lambda *_: None)
# at least this share of the picture's pixels equal JAX's
SAME_PIXELS = 0.999

SEG_CFG = """
model = dict(
    type="EncoderDecoderMask2Former",
    backbone=dict(
        type="ViTAdapter", patch_size=16, embed_dim=48, depth=4,
        num_heads=4, deform_num_heads=6, conv_inplane=16, pretrain_size=224,
        interaction_indexes=[[0, 0], [1, 1], [2, 2], [3, 3]]),
    decode_head=dict(
        type="Mask2FormerHead", num_classes=7, num_queries=5,
        feat_channels=64, out_channels=64, num_heads=4, decoder_ffn_dim=96,
        pixel_encoder_ffn_dim=96, pixel_encoder_heads=4,
        num_decoder_layers=2),
)
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make these small eager ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_image(path, h, w, seed):
    rs = np.random.RandomState(seed)
    img = (rs.rand(h, w, 3) * 255).astype(np.uint8)
    img[h // 3:, : w // 2] = rs.randint(0, 255, 3)
    Image.fromarray(img).save(path)
    return img


def _model_file(tmp, config, options, seed, name, sharpen=1.0):
    """A `.pth` of random port weights of the config's model; a
    Mask2Former's class and mask embeddings multiplied by `sharpen`, so
    that the argmax takes several classes."""
    cfg = Config.fromfile(config)
    cfg.merge_from_options(parse_cfg_options(options))
    model = build_model(dict(cfg.model), device="cpu")
    randomize(model, seed)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.startswith(("decode_head.cls_embed",
                             "decode_head.mask_embed")):
                p.mul_(sharpen)
    path = str(tmp / name)
    torch.save({"state_dict": model.state_dict()}, path)
    return path


@pytest.fixture(scope="module")
def seg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("demo")
    config = str(tmp / "m2f_tiny.py")
    with open(config, "w") as f:
        f.write(SEG_CFG)
    ckpt = _model_file(tmp, config, None, 7, "seg.pth", sharpen=20.0)
    return dict(tmp=tmp, config=config, ckpt=ckpt)


def _jax_demo(monkeypatch, script, argv):
    """The JAX package's root demo script `script`, run on `argv`."""
    spec = importlib.util.spec_from_file_location(
        "jax_" + script[:-3], os.path.join(ROOT, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.syspath_prepend(ROOT)
    monkeypatch.setattr(sys, "argv", [script] + argv)
    mod.main()


def test_segmentor_demo_matches_jax(seg, monkeypatch, capsys):
    tmp = seg["tmp"]
    img_path = str(tmp / "img.png")
    img = _write_image(img_path, 50, 70, 0)
    ours, theirs = str(tmp / "port.png"), str(tmp / "jax.png")
    result = image_demo.main([img_path, seg["config"], seg["ckpt"],
                              "--out-file", ours, "--device", "cpu"],
                             **QUIET)
    assert result.hw == (50, 70) and result.out.shape == (1, 64, 96, 7)
    pred = image_demo.segment(result.out, result.hw)
    assert len(np.unique(pred)) > 1
    _jax_demo(monkeypatch, "image_demo.py",
              [img_path, seg["config"], seg["ckpt"], "--out-file", theirs])
    capsys.readouterr()
    got, want = np.asarray(Image.open(ours)), np.asarray(Image.open(theirs))
    assert got.shape == want.shape == img.shape
    differ = int((got != want).any(-1).sum())
    assert differ <= (1 - SAME_PIXELS) * pred.size, differ


def test_video_demo_over_three_frames(seg):
    tmp = seg["tmp"]
    frames, out_dir = tmp / "frames", tmp / "video_out"
    frames.mkdir()
    imgs = [_write_image(str(frames / f"{i:04d}.png"), 50, 70, 10 + i)
            for i in range(3)]
    seen = []
    n = video_demo.main([str(frames), seg["config"], seg["ckpt"],
                         "--out-dir", str(out_dir), "--device", "cpu"],
                        on_frame=lambda i, r: seen.append((i, r)), **QUIET)
    assert n == 3 and [i for i, _ in seen] == [0, 1, 2]
    assert sorted(os.listdir(out_dir)) == ["0000.png", "0001.png",
                                           "0002.png"]
    model = image_demo.load_model(seg["config"], seg["ckpt"], device="cpu")
    for (i, r), img in zip(seen, imgs):
        want = image_demo.run(model, img, 0.3)
        assert torch.equal(r.out, want.out)
        np.testing.assert_array_equal(
            np.asarray(Image.open(out_dir / f"{i:04d}.png")),
            np.asarray(want.vis))


def test_detector_demo_draws_the_model_call(tmp_path):
    config = os.path.join(ROOT, DET_CONFIG)
    ckpt = _model_file(tmp_path, config, DET_OPTIONS, 8, "det.pth")
    img_path = str(tmp_path / "img.png")
    img = _write_image(img_path, 70, 90, 1)
    out = str(tmp_path / "det.png")
    thr = 0.0
    result = image_demo.main([img_path, config, ckpt, "--out-file", out,
                              "--score-thr", str(thr), "--device", "cpu",
                              "--cfg-options", *DET_OPTIONS], **QUIET)
    model = image_demo.load_model(config, ckpt, DET_OPTIONS, "cpu")
    with torch.no_grad():
        x, hw = pad_to_multiple(torch.from_numpy(img).float()[None], 32)
        want = model(normalize(x))
    assert hw == result.hw == (70, 90) and x.shape[1:3] == (96, 96)
    for k in ("boxes", "scores", "labels"):
        assert torch.equal(result.out[k], want[k]), k
    drawn = image_demo.drawn_boxes(result.out, thr)
    scores = want["scores"][0].numpy()
    keep = np.isfinite(scores) & (scores >= thr)
    assert 0 < len(drawn) == int(keep.sum())
    for (b, s, l), wb, ws, wl in zip(drawn, want["boxes"][0].numpy()[keep],
                                     scores[keep],
                                     want["labels"][0].numpy()[keep]):
        np.testing.assert_array_equal(b, wb)
        assert (s, l) == (ws, wl)
    vis = np.asarray(Image.open(out))
    assert vis.shape == img.shape and (vis != img).any()


def test_grounding_demo_needs_the_text_in_both_packages(tmp_path,
                                                        monkeypatch, capsys):
    config = os.path.join(ROOT, WSDM)
    ckpt = _model_file(tmp_path, config, GROUNDING_OPTIONS, 9, "dino.pth")
    img_path = str(tmp_path / "img.png")
    _write_image(img_path, 64, 64, 2)
    out = str(tmp_path / "g.png")
    with pytest.raises(TypeError, match="refer"):
        image_demo.main([img_path, config, ckpt, "--out-file", out,
                         "--device", "cpu", "--cfg-options",
                         *GROUNDING_OPTIONS], **QUIET)
    with pytest.raises(TypeError, match="refer"):
        _jax_demo(monkeypatch, "image_demo.py",
                  [img_path, config, ckpt, "--out-file", out,
                   "--cfg-options", *GROUNDING_OPTIONS])
    capsys.readouterr()
    assert not os.path.exists(out)
