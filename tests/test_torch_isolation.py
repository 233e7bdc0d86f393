"""The port stands alone: `vitadapter_torch` and `chip_smoke.py` import
neither JAX nor the JAX package, entry points do not fall back to the CPU,
and the kernel modules import without a CUDA compiler (building is lazy)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vitadapter")
# the detection and grounding modules, which the walk below must import too
DET_MODULES = {f"vitadapter_torch.{m}" for m in (
    "det.anchors", "det.assign", "det.boxes", "det.coco_eval",
    "det.mask_rcnn", "det.mask_utils", "det.necks", "det.roi_align",
    "det.roi_heads", "det.rpn", "data.coco", "ops.nms", "train.det_loop",
    "det.dino", "det.dino_detector", "det.grounding_dino", "det.losses",
    "data.grounding", "data.tokenization", "models.uniperceiver",
    "models.uniperceiver_adapter", "tools.generate_results",
    "det.single_stage", "det.sparse_rcnn", "det.panoptic_eval",
    "heads.maskformer", "heads.panoptic", "ops.native", "utils.checkpoint",
    "tools.convert", "tools.release", "tools.image_demo",
    "tools.video_demo")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make the small eager ops here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _port_sources():
    return sorted((ROOT / "vitadapter_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_no_jax_or_vitadapter_imports_in_the_sources():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_and_building_a_model_loads_no_jax():
    code = (
        "import pkgutil, sys, importlib, torch\n"
        "import vitadapter_torch\n"
        "names = set()\n"
        "for m in pkgutil.walk_packages(vitadapter_torch.__path__,\n"
        "                               'vitadapter_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    names.add(m.name)\n"
        "assert %r <= names, sorted(names)\n"
        "from vitadapter_torch.det.mask_rcnn import MaskRCNN\n"
        "from vitadapter_torch.models.vit_adapter import ViTAdapter\n"
        "det = MaskRCNN(ViTAdapter(embed_dim=48, depth=2, num_heads=4,\n"
        "    conv_inplane=16, interaction_indexes=((0, 0), (1, 1)),\n"
        "    window_attn=(True, False), window_size=(3, None),\n"
        "    device='meta'), num_classes=3, fpn_channels=16,\n"
        "    device='meta')\n"
        "from vitadapter_torch import zoo\n"
        "m = zoo.vit_adapter('tiny', device='cpu', depth=2, embed_dim=48,\n"
        "                    num_heads=4, conv_inplane=16,\n"
        "                    interaction_indexes=((0, 0), (1, 1)))\n"
        "f = m(torch.zeros(1, 64, 64, 3))\n"
        "assert len(f) == 4\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in %r]\n"
        "assert not bad, bad\n" % (DET_MODULES, FORBIDDEN))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_entry_point_without_device_raises_without_cuda(monkeypatch):
    from vitadapter_torch import zoo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.mask2former_vit_adapter("tiny", depth=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.mask_rcnn_vit_adapter("tiny", depth=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.resolve_device(None)


def test_kernel_modules_import_without_nvcc(monkeypatch, tmp_path):
    """Importing builds nothing; asking for a build without nvcc raises."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_HOME")}
    env["PATH"] = str(tmp_path)        # no nvcc on PATH
    code = ("import vitadapter_torch.ops.msda, vitadapter_torch.ops.attention\n"
            "import vitadapter_torch.ops.point_sample\n"
            "import vitadapter_torch.ops.matching, vitadapter_torch.ops.nms\n"
            "import vitadapter_torch.det.mask_rcnn\n"
            "import vitadapter_torch.train.det_loop\n"
            "import vitadapter_torch.heads.mask2former_loss\n"
            "import vitadapter_torch.train.trainer\n"
            "from vitadapter_torch.ops import cuda_ext\n"
            "assert not cuda_ext._libs and not cuda_ext.launches\n")
    build = ROOT / "vitadapter_torch" / "_build"
    before = sorted(build.iterdir()) if build.exists() else []
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    after = sorted(build.iterdir()) if build.exists() else []
    assert after == before

    from vitadapter_torch.ops import cuda_ext

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_ext.nvcc_path()
