"""The PyTorch port stands alone: it never imports JAX, flax, the JAX
package, triton or PIL."""
import json
import os
import pathlib
import re
import subprocess
import sys

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
print(json.dumps({"modules": names, "banned": banned, "native_loaded": bool(native._state)}))
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
                 "models.convert_3detr", "utils.png", "utils.visualize"):
        assert f"ov3det_torch.{name}" in report["modules"]
    # importing the native IoU neither builds nor loads it: that waits for
    # the first IoU of an evaluation
    assert report["native_loaded"] is False


def test_no_source_names_the_jax_package():
    pattern = re.compile(r"^\s*(import jax|from jax|import flax|from flax|"
                         r"from ov3det[ .]|import ov3det\b(?!_torch))", re.M)
    offenders = [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
                 if pattern.search(p.read_text())]
    smoke = REPO / "chip_smoke.py"
    if pattern.search(smoke.read_text()):
        offenders.append("chip_smoke.py")
    assert offenders == []
