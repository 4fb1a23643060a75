"""Every AP setting of the port's evaluation on the CPU against the JAX
package's, and what the graphed eval step asks of its consumers.

- `parse_predictions` under every combination of `remove_empty_box`,
  `use_3d_nms`, `cls_nms` and `no_nms`: masks and classes equal to JAX's
  `parse_predictions_device` on outputs near the GT boxes (rotated and
  overlapping, so that each NMS keeps some boxes and drops some).
- `assemble_predictions`' three branches (per-class proposals, the class
  probability, the objectness) equal to JAX's.
- `APCalculator.compute_metrics` under every NMS mode x the empty-box
  removal x the three proposal modes of `get_ap_config_dict`, with
  `eval_processes` 0 and 2: within 1e-6 of JAX's calculator with the same
  dict; `use_old_type_nms` changes nothing in either package; the default
  arguments give the default dict.
- `voc_ap(use_07_metric=True)`, and `eval_det` on the reference's tuple
  lists (with the 2007 metric and a pool of 2), within 1e-9 of JAX's.
- `axis_aligned_iou_3d` within 1e-6 and `box3d_iou_corners` within 1e-5 of
  JAX's, on rotated boxes, identical boxes (the clip's coincident edges),
  touching faces, zero-size boxes and boxes rotated by 90 degrees.
- The graphed eval step returns static outputs that its next call
  overwrites: with a spy that fills the previous outputs with NaN at each
  call (and after the last), `main.evaluate`'s AP, `LabelFormatter.step`'s
  rows and `Detector.detect`'s detections equal those of a plain run, so
  each consumer copies what it needs before the next call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.eval import assemble_predictions as jax_assemble
from ov3det.eval import parse_predictions_device
from ov3det.eval import voc as jvoc
from ov3det.eval.ap_calculator import APCalculator as JAPCalculator
from ov3det.eval.ap_calculator import get_ap_config_dict as jax_config
from ov3det.geometry import iou as jiou
from ov3det_torch.eval import voc
from ov3det_torch.eval.ap_calculator import APCalculator, get_ap_config_dict
from ov3det_torch.eval.parse import assemble_predictions, parse_predictions
from ov3det_torch.geometry import iou as tiou
from ov3det_torch.geometry.boxes_np import corners_from_upright_depth_param_np
from tests.test_torch_eval import _raw_outputs


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _t(out: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


NMS_MODES = {"3d_cls": dict(use_3d_nms=True, cls_nms=True, no_nms=False),
             "3d": dict(use_3d_nms=True, cls_nms=False, no_nms=False),
             "2d": dict(use_3d_nms=False, cls_nms=True, no_nms=False),
             "no_nms": dict(no_nms=True)}


@pytest.mark.parametrize("remove_empty_box", [True, False], ids=["nonempty", "all"])
@pytest.mark.parametrize("mode", sorted(NMS_MODES))
def test_parse_predictions_matches_jax(mode, remove_empty_box):
    batch, out = _raw_outputs(3, 18, 1, B=4, Q=48)
    flags = dict(NMS_MODES[mode], remove_empty_box=remove_empty_box, nms_iou=0.25)
    want_mask, want_cls = parse_predictions_device(
        *(jnp.asarray(out[k]) for k in ("box_corners", "sem_cls_prob", "objectness_prob")),
        jnp.asarray(batch["point_clouds"]), **flags)
    t = _t(out)
    mask, cls = parse_predictions(t["box_corners"], t["sem_cls_prob"], t["objectness_prob"],
                                  torch.from_numpy(batch["point_clouds"]), **flags)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(want_cls))
    n = int(np.asarray(want_mask).sum())
    assert n > 0 and (mode == "no_nms" or n < want_mask.size)  # an NMS drops some boxes


@pytest.mark.parametrize("per_class,cls_only", [(True, False), (False, True), (False, False)],
                         ids=["per_class", "class_prob", "objectness"])
def test_assemble_predictions_matches_jax(per_class, cls_only):
    batch, out = _raw_outputs(4, 18, 1, B=3, Q=40)
    t = _t(out)
    mask, cls = parse_predictions(t["box_corners"], t["sem_cls_prob"], t["objectness_prob"],
                                  torch.from_numpy(batch["point_clouds"]))
    args = (out["box_corners"], out["sem_cls_prob"], out["objectness_prob"], mask.numpy(),
            cls.numpy())
    kw = dict(conf_thresh=0.05, per_class_proposal=per_class, use_cls_confidence_only=cls_only)
    got, want = assemble_predictions(*args, **kw), jax_assemble(*args, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 3 and len(w[0]) > 0
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    if not per_class:
        with pytest.raises(ValueError, match="pred_sem_cls"):
            assemble_predictions(*args[:4], per_class_proposal=False)


AP_CASES = [(mode, empty, prop) for mode in sorted(NMS_MODES) for empty in (True, False)
            for prop in ("per_class", "class_prob", "objectness")]


@pytest.mark.parametrize("mode,remove_empty_box,proposal", AP_CASES)
def test_ap_calculator_options_match_jax(mode, remove_empty_box, proposal):
    flags = dict(NMS_MODES[mode], remove_empty_box=remove_empty_box,
                 per_class_proposal=proposal == "per_class",
                 use_cls_confidence_only=proposal == "class_prob")
    ours = {p: APCalculator(ap_config_dict=get_ap_config_dict(**flags), eval_processes=p)
            for p in (0, 2)}
    theirs = JAPCalculator(ap_config_dict=jax_config(**flags))
    for seed in (0, 1):
        batch, out = _raw_outputs(seed, 18, 1, B=3, Q=40)
        for calc in ours.values():
            calc.step_meter(_t(out), _t(batch))
        theirs.step_meter({k: jnp.asarray(v) for k, v in out.items()}, batch)
    want = theirs.compute_metrics()
    assert want[0.25]["mAP"] > 0.05
    for p, calc in ours.items():
        got = calc.compute_metrics()
        assert list(got) == list(want)
        for t in want:
            assert list(got[t]) == list(want[t])
            for k, w in want[t].items():
                assert abs(float(got[t][k]) - float(w)) <= 1e-6, (p, t, k)


def test_ap_config_defaults_and_old_type_flag():
    assert get_ap_config_dict() == jax_config()
    calc = APCalculator()
    assert calc.ap_config_dict == get_ap_config_dict() and calc.ap_iou_thresh == [0.25, 0.5]
    assert APCalculator(exact_eval=False).ap_config_dict["remove_empty_box"] is False
    metrics = []
    for old in (False, True):
        calc = APCalculator(ap_config_dict=get_ap_config_dict(use_old_type_nms=old))
        batch, out = _raw_outputs(5, 18, 1)
        calc.step_meter(_t(out), _t(batch))
        metrics.append(calc.compute_metrics())
    assert metrics[0] == metrics[1]


# ------------------------------------------------------------ VOC options
def test_voc_07_metric_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(1, 40))
        rec = np.sort(rng.random(n))
        prec = rng.random(n)
        got = voc.voc_ap(rec, prec, use_07_metric=True)
        assert abs(got - jvoc.voc_ap(rec, prec, use_07_metric=True)) <= 1e-9
        assert got != voc.voc_ap(rec, prec) or n == 1


def _tuple_lists(seed: int):
    """The reference's per-scan lists: preds [(cls, corners, score)], gts
    [(cls, corners)], detections near the GT boxes and some empty scans."""
    rng = np.random.default_rng(seed)
    preds, gts = {}, {}
    for scan in range(6):
        n = int(rng.integers(0, 6))
        centers = rng.uniform(-2, 2, (n, 3))
        sizes = rng.uniform(0.3, 1.2, (n, 3))
        angles = rng.uniform(-np.pi, np.pi, n)
        g = corners_from_upright_depth_param_np(centers[None], sizes[None], angles[None])[0]
        cls = rng.integers(0, 4, n)
        gts[scan] = [(int(c), box) for c, box in zip(cls, g)]
        d = corners_from_upright_depth_param_np((centers + rng.normal(0, 0.1, (n, 3)))[None],
                                                sizes[None], angles[None])[0]
        preds[scan] = [(int(c), box, float(s)) for c, box, s in zip(cls, d, rng.random(n))]
        preds[scan] += [(int(rng.integers(0, 4)), g[0] + 3.0, 0.5)] if n else []
    return preds, gts


@pytest.mark.parametrize("use_07,processes", [(False, 0), (True, 0), (True, 2)])
def test_eval_det_tuple_lists_match_jax(use_07, processes):
    preds, gts = _tuple_lists(1)
    got = voc.eval_det(preds, gts, 0.25, use_07_metric=use_07, processes=processes)
    want = jvoc.eval_det(preds, gts, 0.25, use_07_metric=use_07)
    rec, _, ap = got
    assert list(ap) == list(want[2]) and len(ap) >= 3
    for cls in want[2]:
        assert abs(ap[cls] - want[2][cls]) <= 1e-9, cls
        np.testing.assert_allclose(rec[cls], want[0][cls], rtol=0, atol=1e-9)
    assert max(ap.values()) > 0.3


# ------------------------------------------------------------ IoU helpers
def _pairs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 0.4, (n, 2, 3))
    s = rng.uniform(0.2, 1.5, (n, 2, 3))
    a = rng.uniform(-np.pi, np.pi, (n, 2))
    c[0::5, 1], s[0::5, 1], a[0::5, 1] = c[0::5, 0], s[0::5, 0], a[0::5, 0]  # identical
    s[1::5, 1, 0] = 0.0  # zero width
    a[2::5] = 0.0
    c[2::5, 1] = c[2::5, 0] + np.stack([s[2::5, 0, 0], 0 * s[2::5, 0, 0], 0 * s[2::5, 0, 0]], -1)
    c[3::5, 1], a[3::5, 1] = c[3::5, 0], a[3::5, 0] + np.pi / 2  # rotated by 90 degrees
    return corners_from_upright_depth_param_np(c, s, a).astype(np.float32)


def test_box3d_iou_corners_matches_jax():
    corners = _pairs(0, 60)
    got = np.array([float(tiou.box3d_iou_corners(torch.from_numpy(p[0]), torch.from_numpy(p[1])))
                    for p in corners])
    want = np.array([float(jiou.box3d_iou_corners(jnp.asarray(p[0]), jnp.asarray(p[1])))
                     for p in corners])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[3::5] > 0.05).all()  # the pairs rotated by 90 degrees about one centre


def test_axis_aligned_iou_3d_matches_jax():
    rng = np.random.default_rng(2)
    lo = rng.uniform(-1, 1, (2, 7, 3))
    a = np.concatenate([lo, lo + rng.uniform(0, 1, (2, 7, 3))], -1).astype(np.float32)
    b = a[:, :5] + rng.normal(0, 0.1, (2, 5, 6)).astype(np.float32)
    b[0, 0, 3:] = b[0, 0, :3]  # zero volume
    got = tiou.axis_aligned_iou_3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jiou.axis_aligned_iou_3d(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (2, 7, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.max() > 0.5


# ------------------------------------------------------------ the consumers of a static output
class OverwritingStep:
    """An eval step whose outputs, like a CUDA graph's static ones, are
    overwritten at its next call: each call first fills the previous
    outputs with NaN."""

    def __init__(self, step):
        self.step, self.last = step, []

    def spoil(self) -> None:
        with torch.inference_mode():
            for t in self.last:
                t.fill_(float("nan") if t.is_floating_point() else -1)
        self.last = []

    def __call__(self, batch):
        self.spoil()
        out = self.step(batch)
        tensors = out if isinstance(out, (tuple, list)) else [out]
        for o in tensors:
            self.last += list(o.values()) if isinstance(o, dict) else [o]
        return out


def _tiny_model():
    from tests import torch_parity as tp
    from ov3det_torch.models.detr3d import Model3DETR

    _, tcfg = tp.configs("float32")
    return tcfg, Model3DETR(tcfg, device="cpu", seed=0)


def test_consumers_copy_the_static_outputs(tmp_path):
    from ov3det_torch import main as cli
    from ov3det_torch.datasets.dataset_configs import ScannetDatasetConfig
    from ov3det_torch.datasets.synthetic import make_batch
    from ov3det_torch.engine.infer import Detector, make_eval_step
    from ov3det_torch.engine.train import batch_to_device
    from ov3det_torch.tools.label_formatter import LabelFormatter

    tcfg, model = _tiny_model()
    rng = np.random.default_rng(0)
    batches = [make_batch(rng, batch_size=2, num_points=512, num_semcls=tcfg.num_semcls,
                          num_angle_bin=tcfg.num_angle_bin) for _ in range(3)]
    dcfg = ScannetDatasetConfig()

    def passes(spy: bool):
        step = make_eval_step(model)
        step = OverwritingStep(step) if spy else step
        ap = cli.evaluate(step, batches, dcfg, "cpu")
        fmt = LabelFormatter(str(tmp_path), None, [f"s{i}" for i in range(6)], tcfg.num_semcls)
        for b in batches:
            fmt.step(step(batch_to_device(b, "cpu")), b)
        if spy:
            step.spoil()
        return ap.compute_metrics(), [r.copy() for r in fmt.boxes]

    (m_plain, rows_plain), (m_spy, rows_spy) = passes(False), passes(True)
    assert m_plain == m_spy
    for a, b in zip(rows_plain, rows_spy):
        np.testing.assert_array_equal(a, b)
    assert len(rows_plain) == 3

    det = Detector(tcfg, state_dict=model.state_dict(), device="cpu")
    want = [det.detect(b) for b in batches]
    det.request.fn = OverwritingStep(det.request.fn)
    got = [det.detect(b) for b in batches]
    det.request.fn.spoil()
    for g, w in zip(got, want):
        for (gc, gb, gs), (wc, wb, ws) in zip(g, w):
            np.testing.assert_array_equal(gc, wc)
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gs, ws)
