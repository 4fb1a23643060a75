"""The port's evaluation on the CPU against the JAX package.

- the rotated 3D IoU: the numpy path against JAX's `box3d_iou_batch_np`
  within 1e-12, the C++ core against the numpy path within 1e-6;
- `voc_ap`, `eval_det_cls`, `eval_det` against JAX's on random boxes, within
  1e-12 (the same float64 arithmetic in the same order), and `eval_det`'s
  classes in JAX's order;
- `APCalculator`: the same raw outputs through both give the same metrics
  dict within 1e-6 absolute and the same `metrics_to_str`;
- the eval step with the loss against JAX's `make_eval_step(..., loss_cfg)` on
  one batch from the same weights: outputs within 1e-4, each loss within 1e-4
  relative (eval-mode forward in f32; JAX runs the Pallas ball-group in
  interpret mode, as `tests/torch_parity.py` pins it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.eval import voc as jvoc
from ov3det.eval.ap_calculator import APCalculator as JAPCalculator
from ov3det.geometry.iou_np import box3d_iou_batch_np as jax_iou
from ov3det_torch import native
from ov3det_torch.datasets.dataset_configs import ScannetDatasetConfig, SunrgbdDatasetConfig
from ov3det_torch.eval import voc
from ov3det_torch.eval.ap_calculator import APCalculator
from ov3det_torch.geometry import iou_np
from ov3det_torch.geometry.boxes_np import corners_from_upright_depth_param_np
from tests import torch_parity as tp


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")


def _boxes(rng, n, rotated=True, spread=1.5):
    centers = rng.uniform(-spread, spread, (1, n, 3))
    sizes = rng.uniform(0.3, 1.5, (1, n, 3))
    angles = rng.uniform(-np.pi, np.pi, (1, n)) if rotated else np.zeros((1, n))
    return corners_from_upright_depth_param_np(centers, sizes, angles)[0]


# ------------------------------------------------------------ the IoU
@pytest.mark.parametrize("rotated", [True, False])
def test_iou_native_numpy_and_jax_agree(rotated):
    """numpy path against JAX's within 1e-12 (the same float64 formulas); the
    C++ core against the numpy path within 1e-6: it clips in double too, but
    arranges the intersection formula otherwise and is built with
    -O3 -march=native (contracted multiply-adds); 1.3e-7 at most here.
    Identical boxes are left out: their collinear edges are the clip's
    degenerate case in every implementation, the reference's included."""
    rng = np.random.default_rng(0 if rotated else 1)
    a, b = _boxes(rng, 40, rotated), _boxes(rng, 30, rotated)
    b[:10] = a[:10] + rng.normal(0, 0.05, (10, 1, 3)).astype(np.float32)  # heavy overlaps
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    numpy_iou = iou_np.box3d_iou_batch_np(a64, b64, allow_native=False)
    np.testing.assert_allclose(numpy_iou, jax_iou(a64, b64, allow_native=False), rtol=0, atol=1e-12)
    assert (numpy_iou > 0).sum() > 40 and numpy_iou.max() > 0.8
    assert native.native_available(), "g++ is present here: the C++ core must build"
    np.testing.assert_allclose(native.box3d_iou_batch_native(a, b), numpy_iou, rtol=0, atol=1e-6)
    np.testing.assert_allclose(iou_np.box3d_iou_batch_np(a64, b64), numpy_iou, rtol=0, atol=1e-6)


def test_native_builds_into_the_build_directory():
    path = native.library_path()
    assert native.native_available() and path.is_file()
    assert path.parent.name == "_build" and path.parent.parent.name == "ov3det_torch"


# ------------------------------------------------------------ VOC AP
def _dets_and_gts(seed, scans=6, classes=4):
    """Per-scan array triples / pairs of `APCalculator`'s format: GT boxes
    and detections that are jittered copies of them plus some strays."""
    rng = np.random.default_rng(seed)
    preds, gts = {}, {}
    for s in range(scans):
        g = int(rng.integers(0, 6))
        gc = _boxes(rng, g)
        gcls = rng.integers(0, classes, g)
        gts[s] = (gcls.astype(np.int64), gc)
        m = int(rng.integers(0, 12))
        src = rng.integers(0, max(g, 1), m)
        pc = _boxes(rng, m)
        if g:
            pc = np.where((rng.random(m) < 0.7)[:, None, None],
                          gc[src] + rng.normal(0, 0.1, (m, 1, 3)), pc)
        pcls = np.where(rng.random(m) < 0.8, gcls[src] if g else 0, rng.integers(0, classes, m))
        preds[s] = (pcls.astype(np.int64), pc, rng.random(m))
    return preds, gts


@pytest.mark.parametrize("seed", [3, 4])
def test_voc_ap_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(5):
        rec = np.sort(rng.random(20))
        prec = rng.random(20)
        assert abs(voc.voc_ap(rec, prec) - jvoc.voc_ap(rec, prec)) <= 1e-12


@pytest.mark.parametrize("thresh", [0.25, 0.5])
def test_eval_det_cls_matches_jax(thresh):
    preds, gts = _dets_and_gts(4)
    pred = {s: (c, p) for s, (_, c, p) in preds.items()}
    gt = {s: c for s, (_, c) in gts.items()}
    got, want = voc.eval_det_cls(pred, gt, thresh), jvoc.eval_det_cls(pred, gt, thresh)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_eval_det_matches_jax(seed):
    preds, gts = _dets_and_gts(seed)
    got = voc.eval_det(preds, gts, 0.25)
    want = jvoc.eval_det(preds, gts, 0.25)
    for g, w in zip(got, want):  # rec, prec, ap dicts, in the same class order
        assert list(g) == list(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-12, err_msg=str(k))
    assert any(v > 0 for v in want[2].values())


# ------------------------------------------------------------ APCalculator
def detections_near_gt(batch, rng, num_semcls, num_angle_bin, Q=40):
    """Final-layer outputs for `batch` (numpy) whose boxes are jittered
    copies of its GT boxes, so that matching, NMS and AP all have work."""
    B = batch["gt_box_present"].shape[0]
    src = rng.integers(0, batch["gt_box_present"].sum(1).min(), size=(B, Q))
    take = lambda a: np.take_along_axis(a, src[..., None], 1)  # noqa: E731
    centers = take(batch["gt_box_centers"]) + rng.normal(0, 0.06, (B, Q, 3))
    sizes = take(batch["gt_box_sizes"]) * rng.uniform(0.8, 1.2, (B, Q, 3))
    angles = (take(batch["gt_box_angles"][..., None])[..., 0] if num_angle_bin > 1
              else np.zeros((B, Q)))
    corners = corners_from_upright_depth_param_np(centers, sizes, angles).astype(np.float32)
    logits = rng.normal(size=(B, Q, num_semcls + 1)) * 2
    cls = take(batch["gt_box_sem_cls_label"][..., None])[..., 0]
    np.put_along_axis(logits, cls[..., None], 4.0, axis=-1)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {"box_corners": corners,
            "sem_cls_prob": probs[..., :-1].astype(np.float32),
            "objectness_prob": (1 - probs[..., -1]).astype(np.float32)}


def _raw_outputs(seed, num_semcls, num_angle_bin, B=3, Q=40):
    """A synthetic batch and outputs near its GT boxes."""
    from ov3det.datasets import make_batch

    rng = np.random.default_rng(seed)
    batch = make_batch(rng, batch_size=B, num_points=1024, num_semcls=num_semcls,
                       num_angle_bin=num_angle_bin)
    return batch, detections_near_gt(batch, rng, num_semcls, num_angle_bin, Q)


@pytest.mark.parametrize("dataset,exact", [("scannet", True), ("scannet", False),
                                           ("sunrgbd", True)])
def test_ap_calculator_matches_jax(dataset, exact):
    from ov3det.datasets.dataset_configs import ScannetDatasetConfig as JScannet
    from ov3det.datasets.dataset_configs import SunrgbdDatasetConfig as JSunrgbd

    ocfg, jcfg = ((ScannetDatasetConfig(), JScannet()) if dataset == "scannet"
                  else (SunrgbdDatasetConfig(), JSunrgbd()))
    ours = APCalculator(class2type_map=ocfg.class2type, exact_eval=exact)
    theirs = JAPCalculator(jcfg, class2type_map=jcfg.class2type, exact_eval=exact)
    for seed in (0, 1):
        batch, out = _raw_outputs(seed, ocfg.num_semcls, ocfg.num_angle_bin)
        assert (np.abs(out["objectness_prob"] - 0.05) > 1e-5).all()
        ours.step_meter({k: torch.from_numpy(v) for k, v in out.items()},
                        {k: torch.from_numpy(v) for k, v in batch.items()})
        theirs.step_meter({k: jnp.asarray(v) for k, v in out.items()}, batch)
    for s in theirs.pred_map_cls:
        assert len(ours.pred_map_cls[s][0]) == len(theirs.pred_map_cls[s][0]), s
    got, want = ours.compute_metrics(), theirs.compute_metrics()
    assert list(got) == list(want)
    for t in want:
        assert list(got[t]) == list(want[t])
        for k, w in want[t].items():
            assert abs(float(got[t][k]) - float(w)) <= 1e-6, (t, k)
    assert want[0.25]["mAP"] > 0.1  # the jittered boxes are found
    assert ours.metrics_to_str(got) == theirs.metrics_to_str(want)
    assert ours.metrics_to_str(got, per_class=False) == theirs.metrics_to_str(want, per_class=False)
    assert ours.metrics_to_dict(got) == pytest.approx(theirs.metrics_to_dict(want), abs=1e-4)


# ------------------------------------------------------------ the eval step with the loss
def test_eval_step_with_loss_matches_jax():
    import jax

    from ov3det import config as jc
    from ov3det.engine.train import TrainState
    from ov3det.engine.train import make_eval_step as jax_make_eval_step
    from ov3det_torch import config as tc
    from ov3det_torch.engine.infer import make_eval_step
    from ov3det_torch.models.convert import from_flax_variables
    from ov3det_torch.models.detr3d import Model3DETR

    batch = tp.make_batch(seed=7)
    jm, tm = tp.configs("float32")
    jloss, tloss = jc.LossConfig(giou_weight=1.0), tc.LossConfig(giou_weight=1.0)
    model, variables = tp.jax_model_and_variables(jm, batch)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                       frozen=jax.tree_util.tree_map(jnp.asarray, variables["frozen"]),
                       opt_state=None)
    jstep = jax_make_eval_step(model, jloss, jm.num_angle_bin, jm.num_semcls)
    want_out, want_loss = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})

    net = Model3DETR(tm, device="cpu")
    net.load_state_dict(from_flax_variables(variables))
    step = make_eval_step(net, tloss, tm.num_angle_bin, tm.num_semcls)
    got_out, got_loss = step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert not net.training

    assert set(got_loss) == set(want_loss)
    for k, w in want_loss.items():
        np.testing.assert_allclose(float(got_loss[k]), float(w), rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(want_loss["loss_giou"]) > 0
    for k in ("box_corners", "sem_cls_prob", "objectness_prob"):
        np.testing.assert_allclose(got_out[k].numpy(), np.asarray(want_out[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    # without the loss config: the outputs alone, the same final layer
    plain = make_eval_step(net)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert isinstance(plain, dict)
    torch.testing.assert_close(plain["box_corners"], got_out["box_corners"], rtol=0, atol=0)
