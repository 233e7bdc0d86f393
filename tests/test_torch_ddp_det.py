"""The port's data-parallel detection on the CPU: two gloo ranks, one
image each, against the port's own one-process step at two images, which
`test_torch_det_train.py`, `test_torch_single_stage.py` and
`test_torch_dino.py` hold to JAX: a Mask R-CNN step (the RPN's loss
normalizer over the global batch; the RPN's and RoI sampler's draws of
each rank's image replayed from the one-process run), an ATSS step and a
DINO step (its matching and denoising normalizers; each rank's share of
the denoising draws). Then `run_det_eval` of the tiny Mask R-CNN config
on three COCO-layout images over the two ranks (the per-image records
gathered into image order, scored once) against one process, and the
step-keyed det train batches.

Tolerances: the logs 1e-4 relative; each clipped gradient leaf within
2e-3 of the leaf's largest; each parameter's change within 1e-2 of the
leaf's largest change where the gradient is at least 5% of the leaf's
largest (the one-process test's rule); the ranks' parameters bitwise
equal; the evaluation's metrics and records and the batches exactly (one
image a model call on both sides, so that batching does not reorder the
CPU's sums). No JAX runs here."""

import numpy as np
import pytest
import torch

import ddp_workers as W
from torch_port_util import DET_HW, write_coco

# the tiny Mask R-CNN config of `test_torch_det_cli.py`
OPTIONS = [
    "model.backbone.depth=2", "model.backbone.embed_dim=48",
    "model.backbone.num_heads=4", "model.backbone.deform_num_heads=4",
    "model.backbone.conv_inplane=16",
    "model.backbone.interaction_indexes=[[0,0],[1,1]]",
    "model.backbone.window_attn=[True,False]",
    "model.backbone.window_size=[3,None]", "model.fpn_channels=32",
    "model.num_classes=3", "model.num_proposals_train=50",
    "model.num_proposals_test=50", "model.num_roi_samples=16",
    "model.max_dets=10", "data.crop_size=[64,96]", "data.max_instances=6",
    "data.det_scales=[56,64,72]", "data.det_scales_small=[40,48]",
    "data.det_crop_range=[32,48]", "data.max_long_edge=112",
    "test_cfg.img_scale=[112,64]", "test_cfg.images_per_device=1"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make these small eager ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class RecordingSampler:
    """Uniform draws from a seed, kept in the order they were asked for."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.draws = []

    def __call__(self, shape):
        d = self.rs.rand(*shape).astype(np.float32)
        self.draws.append(d)
        return torch.from_numpy(d)


def det_batch(seed, G, hw=DET_HW, masks=False, num_classes=5):
    """Two images with G gt boxes of 8-38 px, labels, valid flags (the last
    gt of the first image and all but the first of the second invalid, so
    that the images match different numbers of queries) and, with
    `masks`, the boxes filled."""
    rs = np.random.RandomState(seed)
    H, W_ = hw
    xy = rs.rand(2, G, 2) * np.array([W_ - 40, H - 40])
    wh = rs.rand(2, G, 2) * 30 + 8
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.ones((2, G), bool)
    valid[0, -1] = False
    valid[1, 1:] = False
    b = {"image": rs.randn(2, H, W_, 3).astype(np.float32),
         "gt_boxes": boxes,
         "gt_labels": rs.randint(0, num_classes, (2, G)).astype(np.int32),
         "gt_valid": valid}
    if masks:
        m = np.zeros((2, G, H, W_), bool)
        for i in range(2):
            for g in range(G):
                x1, y1, x2, y2 = boxes[i, g].astype(int)
                m[i, g, y1:y2, x1:x2] = True
        b["gt_masks"] = m
    return b


def dino_draws(seed, n_dn, K):
    """Denoising draws of two images (`det.dino.DnDraws`' fields)."""
    rs = np.random.RandomState(seed)
    return [rs.rand(2, n_dn) < 0.25, rs.randint(0, K, (2, n_dn)),
            np.where(rs.rand(2, n_dn, 4) > 0.5, 1.0, -1.0).astype(np.float32),
            rs.rand(2, n_dn, 4).astype(np.float32)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results and one process's."""
    from vitadapter_torch.builder import build_model

    work = tmp_path_factory.mktemp("ddp_det")
    coco = work / "coco"
    write_coco(str(coco), ((60, 90), (90, 70), (64, 64), (50, 80)), seed=1)
    options = OPTIONS + [f"data.data_root={coco}"]
    det_cfg = W.det_config(options)
    eval_sd = build_model(dict(det_cfg.model), device="cpu").state_dict()

    cases = {
        "mask_rcnn": {"batch": det_batch(5, 5, masks=True)},
        "atss": {"batch": det_batch(7, 4, num_classes=4)},
        "dino": {"batch": det_batch(9, 3, hw=(128, 192), num_classes=3),
                 "draws": dino_draws(10, 2 * 3, 3)}}
    refs = {}
    for kind, case in cases.items():
        case["state_dict"] = W.det_model(kind).state_dict()
        draws = case.get("draws")
        if kind == "mask_rcnn":
            draws = RecordingSampler(6)
        refs[kind] = W.det_step(kind, case["state_dict"], case["batch"],
                                draws)
        if kind == "mask_rcnn":
            case["draws"] = draws.draws
    cases["det_eval"] = {"options": options, "state_dict": eval_sd}
    W.save(work / "inputs.pkl", cases)
    finish = W.spawn_ranks("det", work)
    try:
        refs["det_eval"] = W.det_eval(cases["det_eval"])
        refs["det_batches"] = W.det_batches(options)
    finally:
        ranks = finish()
    return ranks, refs, cases


def test_the_ranks_import_no_jax(run):
    ranks, _, _ = run
    assert [r["loaded"] for r in ranks] == [[], []]


def _floor(grads):
    return 1e-4 * max(float(np.abs(g).max()) for g in grads.values())


@pytest.mark.parametrize("kind", ["mask_rcnn", "atss", "dino"])
def test_two_ranks_take_the_one_process_step(run, kind):
    """The logs (the global batch's loss, each part and the gradient
    norm), the clipped gradients and the update on each rank against one
    process at two images; the ranks' parameters bitwise equal."""
    ranks, refs, cases = run
    ref_logs, ref_params, ref_grads = refs[kind]
    before = {k: v.numpy() for k, v in cases[kind]["state_dict"].items()}
    floor = _floor(ref_grads)
    for rank in ranks:
        logs, params, grads = rank[kind]
        assert set(logs) == set(ref_logs)
        for k in ref_logs:
            np.testing.assert_allclose(logs[k], ref_logs[k], rtol=1e-4,
                                       err_msg=k)
        assert set(grads) == set(ref_grads)
        moved = checked = 0
        for n, g in grads.items():
            w = ref_grads[n]
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-3 * max(
                np.abs(w).max(), floor), err_msg=n)
            got = params[n] - before[n]
            ref = ref_params[n] - before[n]
            sure = np.abs(w) >= 0.05 * max(np.abs(w).max(), floor)
            np.testing.assert_allclose(got[sure], ref[sure], rtol=0,
                                       atol=1e-2 * np.abs(ref).max(),
                                       err_msg=n)
            # a parameter moves where one process moves it (the port's
            # initialization leaves some without gradient: the injectors'
            # gammas are 0)
            assert np.any(got != 0) == np.any(ref != 0), n
            checked += int(sure.sum())
            moved += int(np.any(got != 0))
        assert moved > 0.5 * len(grads)
        assert checked > 0.1 * sum(g.size for g in grads.values())
    p0, p1 = (r[kind][1] for r in ranks)
    for n in p0:
        np.testing.assert_array_equal(p0[n], p1[n], err_msg=n)


def test_run_det_eval_on_two_ranks_equals_one_process(run):
    """The three annotated images over two ranks: the bbox and segm
    records the evaluators take (each image's scores, IoUs and areas by
    category), in image order, and the COCO summary, on each rank exactly
    one process's."""
    ranks, refs, _ = run
    ref_metrics, ref_records = refs["det_eval"]
    assert len(ref_records) == 2 * 3 and ref_metrics["bbox_mAP"] >= 0
    for rank in ranks:
        metrics, records = rank["det_eval"]
        np.testing.assert_equal(metrics, ref_metrics)  # NaN where empty
        assert len(records) == len(ref_records)
        for (t, got), (t_ref, want) in zip(records, ref_records):
            assert t == t_ref and set(got) == set(want)
            for c in want:
                for k in want[c]:
                    np.testing.assert_array_equal(got[c][k], want[c][k])


def test_det_step_batches_split_the_one_process_batches(run):
    """Two steps of the COCO train pipeline at a global batch of 2: rank 0's
    rows then rank 1's are one process's batch, every entry exactly."""
    ranks, refs, _ = run
    for k, ref in enumerate(refs["det_batches"]):
        assert set(ranks[0]["det_batches"][k]) == set(ref)
        for key in ref:
            got = np.concatenate([r["det_batches"][k][key] for r in ranks])
            np.testing.assert_array_equal(got, ref[key], err_msg=key)
