"""The PyTorch port stands alone: it never imports JAX, flax, the JAX
package, triton or PIL."""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "ov3det_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import ov3det_torch
names = [m.name for m in pkgutil.walk_packages(ov3det_torch.__path__, "ov3det_torch.")]
for name in names:
    importlib.import_module(name)
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "ov3det", "triton", "PIL"))
native = sys.modules["ov3det_torch.native"]
jpeg = sys.modules["ov3det_torch.utils.jpeg"]
print(json.dumps({"modules": names, "banned": banned, "native_loaded": bool(native._state),
                  "jpeg_loaded": bool(jpeg._state)}))
"""


def test_importing_every_module_leaves_jax_out():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["banned"] == []
    # every module of the slice was imported
    for name in ("config", "ops.kernels.fps", "ops.kernels.ball_group",
                 "ops.kernels.attention", "models.detr3d", "models.convert",
                 "eval.parse", "engine.infer", "datasets.synthetic",
                 "geometry.iou", "ops.hungarian", "losses.criterion",
                 "engine.schedule", "engine.train", "datasets.dataset_configs",
                 "datasets.augment", "datasets.sunrgbd", "datasets.scannet",
                 "datasets.registry", "datasets.loader", "geometry.iou_np", "native",
                 "eval.voc", "eval.ap_calculator", "utils.meters", "utils.logger",
                 "engine.checkpoint", "engine.runtime", "main", "utils.calibration",
                 "ops.roi_align", "models.clip_resnet", "models.regionclip",
                 "losses.clip_loss", "generate_pseudo_label", "tools", "tools.box3d_np",
                 "tools.label_formatter", "tools.projection_np", "tools.lift_boxes",
                 "tools.scannet_io", "tools.format_tools", "tools.evaluate_box",
                 "tools.seg_metrics", "tools.extract_class_features", "models.clip_text",
                 "models.convert_3detr", "utils.png", "utils.visualize", "parallel",
                 "parallel.mesh", "datasets.image_bank", "utils.jpeg",
                 "datasets.image_utils", "ops.kernels", "ops.kernels.auction",
                 "ops.kernels.nms", "geometry.nms", "ops.kernels.quant_conv",
                 "ops.kernels.points_in_box", "ops.kernels.ball_query",
                 "ops.kernels.roi_align", "ops.kernels.attn_pool", "ops.kernels.normalise",
                 "ops.kernels.add_norm"):
        assert f"ov3det_torch.{name}" in report["modules"]
    # importing the native IoU or the JPEG decoder neither builds nor loads
    # it: that waits for the first IoU of an evaluation, the first dataset
    # with images
    assert report["native_loaded"] is False and report["jpeg_loaded"] is False


def test_no_source_names_the_jax_package():
    """No line of the port or of chip_smoke.py imports JAX, flax, the JAX
    package or PIL, at the top or inside a function (the import-time probe
    above cannot see a lazy import)."""
    pattern = re.compile(r"^\s*(import jax|from jax|import flax|from flax|"
                         r"from ov3det[ .]|import ov3det\b(?!_torch)|import PIL|from PIL)", re.M)
    offenders = [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
                 if pattern.search(p.read_text())]
    smoke = REPO / "chip_smoke.py"
    if pattern.search(smoke.read_text()):
        offenders.append("chip_smoke.py")
    assert offenders == []


# the port's own scripts: those that drive `ov3det_torch` on the card
PORT_SCRIPTS = sorted(p.name for p in (REPO / "scripts").glob("*.py")
                      if "ov3det_torch" in p.read_text())

_SCRIPT_PROBE = """
import importlib, json, sys
sys.path.insert(0, "scripts")
for name in sys.argv[1:]:
    importlib.import_module(name)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "ov3det", "triton", "PIL"))))
"""


def test_the_port_scripts_are_found():
    assert {"nms_parts.py", "pool_quantize_parts.py", "attention_parts.py",
            "quant_conv_designs.py", "feature_grad_parts.py", "auction_parts.py",
            "first_k_parts.py", "points_in_box_parts.py", "teacher_parts.py",
            "roi_head_designs.py", "roi_head_parts.py", "add_norm_parts.py"} <= set(PORT_SCRIPTS)


@pytest.mark.parametrize("script", PORT_SCRIPTS)
def test_port_script_names_no_jax(script):
    """A script of the port imports neither JAX, flax, the JAX package nor
    PIL; importing it (on a machine with no card) loads none of them and
    builds nothing."""
    pattern = re.compile(r"^\s*(import jax|from jax|import flax|from flax|"
                         r"from ov3det[ .]|import ov3det\b(?!_torch)|import PIL|from PIL)", re.M)
    assert not pattern.search((REPO / "scripts" / script).read_text())
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _SCRIPT_PROBE, script[:-3]], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_every_kernel_source_has_its_cu_file():
    """Each name `_build` compiles is a `.cu` file of `ov3det_torch/csrc/`,
    the empty-box test and the first-K query among them, and no `.cu` file
    there is left out of the build."""
    from ov3det_torch.ops.kernels import _build

    names = set(_build.KERNEL_SOURCES)
    assert len(names) == len(_build.KERNEL_SOURCES)
    assert {"points_in_box", "first_k"} <= names
    assert names == {p.stem for p in (PORT / "csrc").glob("*.cu")}
