"""The port's serving path on the CPU against the JAX pipeline:
make_eval_step -> parse_predictions_device -> assemble_predictions, and the
device default of the entry points."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.eval import assemble_predictions as jax_assemble
from ov3det.eval import parse_predictions_device
from ov3det.models import Model3DETR as JModel
from ov3det_torch.config import sunrgbd_quick
from ov3det_torch.engine.infer import Detector, make_eval_step
from ov3det_torch.eval.parse import assemble_predictions, parse_predictions, points_in_box_counts
from ov3det_torch.models.convert import from_flax_variables
from ov3det_torch.models.detr3d import Model3DETR
from tests import torch_parity as tp


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")


def _jax_detections(outputs: dict, point_clouds: np.ndarray):
    keep, cls = parse_predictions_device(
        jnp.asarray(outputs["box_corners"]), jnp.asarray(outputs["sem_cls_prob"]),
        jnp.asarray(outputs["objectness_prob"]), jnp.asarray(point_clouds))
    keep = np.asarray(keep)
    dets = jax_assemble(outputs["box_corners"], outputs["sem_cls_prob"],
                        outputs["objectness_prob"], keep, np.asarray(cls))
    return keep, dets


def _assert_same_detections(got, want, atol=0.0):
    assert len(got) == len(want)
    for (gc, gb, gs), (wc, wb, ws) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=atol)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=atol)


def _crafted_outputs(seed: int):
    """Final-layer outputs whose boxes are jittered copies of the scene's
    GT boxes: many hold points and overlap, so NMS has work to do."""
    from ov3det.geometry.boxes_np import corners_from_upright_depth_param_np

    rng = np.random.default_rng(seed)
    batch = tp.make_batch(seed=seed)
    B, Q, C = batch["point_clouds"].shape[0], 48, 10
    src = rng.integers(0, batch["gt_box_present"].sum(1).min(), size=(B, Q))
    take = lambda a: np.take_along_axis(a, src[..., None], 1)  # noqa: E731
    centers = take(batch["gt_box_centers"]) + rng.normal(0, 0.08, (B, Q, 3))
    sizes = take(batch["gt_box_sizes"]) * rng.uniform(0.7, 1.3, (B, Q, 3))
    angles = rng.uniform(-np.pi, np.pi, (B, Q))
    corners = corners_from_upright_depth_param_np(centers, sizes, angles).astype(np.float32)
    logits = rng.normal(size=(B, Q, C + 1)) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return batch, {
        "box_corners": corners,
        "sem_cls_prob": probs[..., :-1].astype(np.float32),
        "objectness_prob": (1 - probs[..., -1]).astype(np.float32),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_parse_and_assemble_match_jax(seed):
    batch, out = _crafted_outputs(seed)
    want_keep, want = _jax_detections(out, batch["point_clouds"])
    t = {k: torch.from_numpy(v) for k, v in out.items()}
    keep, _ = parse_predictions(t["box_corners"], t["sem_cls_prob"], t["objectness_prob"],
                                torch.from_numpy(batch["point_clouds"]))
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert 0 < want_keep.sum() < want_keep.size  # NMS kept some, dropped some
    got = assemble_predictions(out["box_corners"], out["sem_cls_prob"],
                               out["objectness_prob"], keep.numpy())
    _assert_same_detections(got, want)


def test_points_in_box_counts_matches_jax():
    from ov3det.eval.parse import points_in_box_counts as jax_counts

    batch, out = _crafted_outputs(2)
    want = np.asarray(jax_counts(jnp.asarray(batch["point_clouds"]),
                                 jnp.asarray(out["box_corners"])))
    got = points_in_box_counts(torch.from_numpy(batch["point_clouds"]),
                               torch.from_numpy(out["box_corners"]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 5).any()


def test_detector_on_cpu_returns_the_jax_pipelines_detections():
    batch = tp.make_batch(seed=3)
    jcfg, tcfg = tp.configs("float32")
    jmodel, variables = tp.jax_model_and_variables(jcfg, batch)
    final = {k: (v if k == "query_xyz" else v[-1])
             for k, v in tp.jax_forward(jmodel, variables, batch).items()}
    _, want = _jax_detections(final, batch["point_clouds"])

    det = Detector(tcfg, state_dict=from_flax_variables(variables), device="cpu")
    got = det.detect(batch)
    _assert_same_detections(got, want, atol=1e-4)

    step_out = make_eval_step(det.model)({k: torch.from_numpy(batch[k]) for k in tp.INPUT_KEYS})
    assert step_out["box_corners"].shape == (tp.B, tp.NQUERY, 8, 3)
    assert step_out["query_inds"].shape == (tp.B, tp.NQUERY)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = sunrgbd_quick()
    with pytest.raises(RuntimeError, match="CUDA"):
        Detector(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model3DETR(cfg)
    _, tcfg = tp.configs("float32")
    assert next(Model3DETR(tcfg, device="cpu").parameters()).device.type == "cpu"
