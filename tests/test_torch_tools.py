"""The port's offline open-vocabulary tools (`ov3det_torch/tools/`,
`utils/visualize.py`, `utils/png.py`) against the JAX package's on the same
seeded inputs: numpy against numpy, every result equal (arrays bit for bit,
written files byte for byte).

- `box3d_np`, `projection_np`, `format_tools`, `seg_metrics`,
  `evaluate_box` (axis-aligned and rotated IoU), `scannet_io` and the PLY
  writers, function by function;
- `lift_scene_scannet` (multi-view frustums, with and without the GSS
  snap) and `lift_scene_sunrgbd` (single view, pseudo and GT labels) on a
  fixture tree whose depth and label PNGs PIL writes: the same boxes, and
  the port's run, in a process of its own, imports no PIL;
- the PNG reader against PIL on images PIL writes (8 and 16 bits) and on
  images written with each of the five scanline filters.
"""
import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same(got, want, path="result"):
    """Equal structure and values: arrays bit for bit (NaNs where NaNs)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


def boxes_vv(rng, n, label_count=4):
    """Rows [x1, y1, z1, x2, y2, z2, score, label, volume, area]."""
    lo = rng.uniform(-2, 2, (n, 3))
    hi = lo + rng.uniform(0.2, 1.5, (n, 3))
    scale = hi - lo
    return np.concatenate([lo, hi, rng.uniform(0, 1, (n, 1)),
                           rng.integers(0, label_count, (n, 1)).astype(np.float64),
                           np.prod(scale, -1, keepdims=True),
                           2 * np.sum(scale * np.roll(scale, 1, -1), -1, keepdims=True)], 1)


# ------------------------------------------------------------ box3d_np
@pytest.mark.parametrize("kw", [dict(), dict(old_type=True), dict(class_wise=True),
                                dict(use_size=True, size_typ="Volume"),
                                dict(use_size_score=True, class_wise=True, size_typ="Area"),
                                dict(lhs=True)])
def test_gss_nms_equals_jax(kw):
    from ov3det.tools import box3d_np as J
    from ov3det_torch.tools import box3d_np as T

    boxes = boxes_vv(np.random.default_rng(1), 60)
    assert_same(T.gss_nms(boxes, 0.25, **kw), J.gss_nms(boxes, 0.25, **kw))


def test_box3d_iou_and_converters_equal_jax():
    from ov3det.tools import box3d_np as J
    from ov3det.tools import label_formatter as JL
    from ov3det_torch.tools import box3d_np as T
    from ov3det_torch.tools import label_formatter as TL

    boxes = boxes_vv(np.random.default_rng(2), 40)
    cs = J.vv2cs(boxes)
    assert_same(T.vv2cs(boxes), cs)
    assert_same(T.cs2vv(cs), J.cs2vv(cs))
    for typ, rows in (("vv", boxes), ("cs", cs)):
        assert_same(T.box_3d_iou(rows[0], rows, typ=typ), J.box_3d_iou(rows[0], rows, typ=typ))
        assert_same(TL.axis_aligned_iou_np(rows[3, :6], rows[:, :6], typ=typ),
                    JL.axis_aligned_iou_np(rows[3, :6], rows[:, :6], typ=typ))


# ------------------------------------------------------------ projection_np
def _camera(rng):
    pose = np.eye(4)
    a = rng.uniform(-0.3, 0.3)
    pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    pose[:3, 3] = rng.uniform(-0.2, 0.2, 3)
    intrinsic = np.array([[400.0, 0, 320, 0], [0, 400.0, 240, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    return pose, intrinsic


@pytest.mark.parametrize("view", ["multi", "single"])
def test_projection_helper_equals_jax(view):
    from ov3det.tools.projection_np import ProjectionHelper as J
    from ov3det_torch.tools.projection_np import ProjectionHelper as T

    rng = np.random.default_rng(3)
    H, W = 240, 320
    jp, tp = J(0.1, 10.0, (H, W)), T(0.1, 10.0, (H, W))
    pose, raw_intrinsic = _camera(rng)
    intrinsic = jp.resize_intrinsic(raw_intrinsic)
    assert_same(tp.resize_intrinsic(raw_intrinsic), intrinsic)
    points = rng.uniform([-1, -1, 1], [1, 1, 4], (3000, 3))
    labels = rng.integers(0, 5, 3000).astype(np.float64)
    depth = rng.uniform(0.5, 4.0, (H, W))
    seg = rng.integers(0, 5, (H, W))
    boxes = np.array([[20, 30, 80, 60, 0.9, 1], [0, 5, 40, 40, 0.8, 2],
                      [150, 100, 90, 120, 0.7, 3], [300, 200, 20, 40, 0.6, 4]], np.float64)
    assert_same(tp.get_edge_mask(boxes), jp.get_edge_mask(boxes))
    align = np.eye(4)
    align[:3, 3] = [0.5, -0.2, 0.1]
    assert_same(tp.project_alignment(points, align), jp.project_alignment(points, align))
    for pseudo in (True, False):
        raw = rng.integers(0, 41, 500)
        assert_same(tp.project_label(raw, pseudo), jp.project_label(raw, pseudo))
    corners = jp.compute_frustum_corners(pose, boxes[0], intrinsic)
    assert_same(tp.compute_frustum_corners(pose, boxes[0], intrinsic), corners)
    normals = jp.compute_frustum_normals(corners)
    assert_same(tp.compute_frustum_normals(corners), normals)
    assert_same(tp.points_in_frustum(corners, normals, points),
                jp.points_in_frustum(corners, normals, points))
    sem = labels if view == "multi" else seg
    lifted = jp.compute_frustum_box(points, depth, pose, boxes, sem, align, intrinsic, view=view)
    assert lifted.shape[0] > 0
    assert_same(tp.compute_frustum_box(points, depth, pose, boxes, sem, align, intrinsic,
                                       view=view), lifted)
    got, want = (h.compute_projection(points, depth, pose, intrinsic, accuracy=1.0)
                 for h in (tp, jp))
    assert want is not None and want[0][0] > 0
    assert_same(got, want)
    feats = rng.normal(size=(3, H, W)).astype(np.float32)
    assert_same(tp.backproject_features(feats, *want, 3000),
                jp.backproject_features(feats, *want, 3000))


def test_sunrgbd_calibration_and_edge_mask_equal_jax(tmp_path):
    from ov3det.tools import projection_np as J
    from ov3det_torch.tools import projection_np as T

    path = tmp_path / "calib.txt"
    path.write_text("0.99 0.01 0.02 -0.01 0.98 0.1 0.0 -0.1 0.99\n529.5 0 0 0 529.5 0 365 265 1\n")
    rng = np.random.default_rng(4)
    uvd = np.concatenate([rng.uniform(0, 700, (400, 2)), rng.uniform(0.5, 5, (400, 1))], 1)
    jc, tc = J.SunrgbdCalibrationNp(str(path)), T.SunrgbdCalibrationNp(str(path))
    assert_same(tc.project_image_to_upright_depth(uvd), jc.project_image_to_upright_depth(uvd))
    labels = rng.integers(0, 38, (50, 60))
    assert_same(T.SunrgbdCalibrationNp.project_label(labels),
                J.SunrgbdCalibrationNp.project_label(labels))
    boxes = np.array([[0, 5, 10, 10, 0.5, 1], [5, 5, 55, 10, 0.5, 1], [5, 5, 10, 45, 0.5, 1],
                      [5, 5, 10, 10, 0.5, 1]], np.float64)
    assert_same(T.get_edge_mask_2d(boxes, (50, 60)), J.get_edge_mask_2d(boxes, (50, 60)))


# ------------------------------------------------------------ format_tools
def test_format_tools_equal_jax(tmp_path):
    from ov3det.tools import format_tools as J
    from ov3det_torch.tools import format_tools as T

    rng = np.random.default_rng(5)
    preds = [{"image_id": f"frame{i}", "instances": [
        {"score": float(rng.uniform()), "category_id": int(rng.integers(0, 20)),
         "bbox": list(rng.uniform(0, 100, 4))} for _ in range(12)]} for i in range(4)]
    preds.append({"file_name": "empty", "instances": []})
    assert T.distribute_boxes(preds, str(tmp_path / "t")) == J.distribute_boxes(
        preds, str(tmp_path / "j"))
    for name in os.listdir(tmp_path / "j"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()

    scans = ["scene0000_00", "scene0001_00"]
    (tmp_path / "in").mkdir()
    for i, scan in enumerate(scans):
        rows = np.concatenate([rng.uniform(-2, 2, (5 * i, 6)),
                               rng.integers(0, 18, (5 * i, 1)), rng.uniform(0, 1, (5 * i, 1))], 1)
        np.save(tmp_path / "in" / f"{scan}_bbox.npy", rows)
    T.adjust_format_to_nyu40(str(tmp_path / "in"), str(tmp_path / "tn"), scans)
    J.adjust_format_to_nyu40(str(tmp_path / "in"), str(tmp_path / "jn"), scans)
    for scan in scans:
        assert ((tmp_path / "tn" / f"{scan}_bbox.npy").read_bytes()
                == (tmp_path / "jn" / f"{scan}_bbox.npy").read_bytes())

    points = rng.uniform(-2, 2, (2000, 3))
    sem = rng.integers(-1, 6, 2000)
    props = np.concatenate([rng.uniform(-1.5, 1.5, (30, 3)), rng.uniform(0.2, 1.5, (30, 3))], 1)
    assert_same(T.assign_box_label_from_gt(props, points, sem),
                J.assign_box_label_from_gt(props, points, sem))
    frames = [(rng.integers(0, 25, (3, 16, 16)), rng.integers(0, 41, (3, 16, 16)))
              for _ in range(3)]
    assert T.label_agreement(*frames[0]) == J.label_agreement(*frames[0])
    assert T.assess_pseudo_labels(frames) == J.assess_pseudo_labels(frames)
    assert T.generate_categories(["chair", "table"]) == J.generate_categories(["chair", "table"])


# ------------------------------------------------------------ seg_metrics
@pytest.mark.parametrize("kw", [dict(), dict(average=False), dict(ignore_background=False),
                                dict(activation="softmax")])
def test_segmentation_metrics_equal_jax(kw):
    from ov3det.tools import seg_metrics as J
    from ov3det_torch.tools import seg_metrics as T

    rng = np.random.default_rng(6)
    gt = rng.integers(0, 5, (2, 12, 14))
    logits = rng.normal(size=(2, 5, 12, 14))
    assert_same(T.SegmentationMetrics(**kw)(gt, logits), J.SegmentationMetrics(**kw)(gt, logits))
    ids = rng.integers(0, 5, (2, 12, 14))
    assert_same(T.SegmentationMetrics(**kw)(gt, ids), J.SegmentationMetrics(**kw)(gt, ids))
    assert_same(T.confusion_counts(gt, ids, 5), J.confusion_counts(gt, ids, 5))


@pytest.mark.parametrize("activation", ["0-1", "sigmoid", None])
def test_binary_metrics_equal_jax(activation):
    from ov3det.tools import seg_metrics as J
    from ov3det_torch.tools import seg_metrics as T

    rng = np.random.default_rng(7)
    gt = rng.integers(0, 2, (2, 10, 11))
    logits = rng.normal(size=(2, 1, 10, 11))
    assert_same(T.BinaryMetrics(activation=activation)(gt, logits),
                J.BinaryMetrics(activation=activation)(gt, logits))


# ------------------------------------------------------------ evaluate_box
@pytest.mark.parametrize("obb", [False, True])
def test_pr_calculator_equals_jax(obb):
    from ov3det.tools.evaluate_box import PRCalculator as J
    from ov3det_torch.tools.evaluate_box import PRCalculator as T

    rng = np.random.default_rng(8)
    jc, tc = J(0.25, obb=obb), T(0.25, obb=obb)
    for _ in range(4):
        preds, gts = [], []
        for _ in range(3):
            gt = [(int(rng.integers(0, 4)), np.concatenate([rng.uniform(-2, 2, 3),
                                                           rng.uniform(0.3, 1, 3)]))
                  for _ in range(int(rng.integers(0, 5)))]
            pred = [(c, b + rng.normal(0, 0.1, 6), float(rng.uniform())) for c, b in gt]
            pred += [(int(rng.integers(0, 4)), np.concatenate([rng.uniform(-2, 2, 3),
                                                              rng.uniform(0.3, 1, 3)]),
                      float(rng.uniform())) for _ in range(3)]
            if obb:  # corner sets for the rotated IoU
                from ov3det.geometry.boxes_np import corners_from_upright_depth_param_np as corners

                gt = [(c, corners(b[None, :3], b[None, 3:], np.zeros(1))[0]) for c, b in gt]
                pred = [(c, corners(b[None, :3], b[None, 3:], np.zeros(1))[0], s)
                        for c, b, s in pred]
            preds.append(pred)
            gts.append(gt)
        jc.step(preds, gts)
        tc.step(preds, gts)
    want = jc.compute_metrics()
    assert want["AR"] > 0
    assert_same(tc.compute_metrics(), want)


def test_evaluate_pseudo_boxes_equals_jax(tmp_path):
    from ov3det.tools.evaluate_box import evaluate_pseudo_boxes as J
    from ov3det_torch.tools.evaluate_box import evaluate_pseudo_boxes as T

    rng = np.random.default_rng(9)
    nyu = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])
    (tmp_path / "pseudo").mkdir()
    (tmp_path / "gt").mkdir()
    scans = [f"scene{i:04d}_00" for i in range(3)]
    for scan in scans:
        geo = np.concatenate([rng.uniform(-2, 2, (6, 3)), rng.uniform(0.3, 1, (6, 3))], 1)
        gt = np.concatenate([geo, rng.choice(np.append(nyu, 40), (6, 1))], 1)
        np.save(tmp_path / "gt" / f"{scan}_bbox.npy", gt)
        cls = np.searchsorted(nyu, gt[:, 6]).clip(0, 17)
        pseudo = np.concatenate([geo + rng.normal(0, 0.1, geo.shape), cls[:, None],
                                 rng.uniform(0, 1, (6, 1))], 1)
        np.save(tmp_path / "pseudo" / f"{scan}_bbox.npy", pseudo)
    want = J(str(tmp_path / "pseudo"), str(tmp_path / "gt"), scans)
    assert want["AR"] > 0
    assert_same(T(str(tmp_path / "pseudo"), str(tmp_path / "gt"), scans), want)


# ------------------------------------------------------------ scannet_io and the PLY writers
def _binary_ply(path, xyz, rgb):
    header = (b"ply\nformat binary_little_endian 1.0\ncomment test\n"
              + b"element vertex %d\n" % len(xyz)
              + b"property float x\nproperty float y\nproperty float z\n"
              + b"property uchar red\nproperty uchar green\nproperty uchar blue\n"
              + b"property float quality\nelement face 1\n"
              + b"property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as fh:
        fh.write(header)
        for p, c in zip(xyz, rgb):
            fh.write(struct.pack("<fffBBBf", *p, *c.astype(np.uint8), 0.5))
        fh.write(struct.pack("<Biii", 3, 0, 1, 2))


def test_scannet_io_equals_jax(tmp_path):
    from ov3det.tools import scannet_io as J
    from ov3det_torch.tools import scannet_io as T

    rng = np.random.default_rng(10)
    xyz = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (50, 3)).astype(np.float32)
    _binary_ply(tmp_path / "b.ply", xyz, rgb)
    assert_same(T.read_ply_vertices(str(tmp_path / "b.ply")),
                J.read_ply_vertices(str(tmp_path / "b.ply")))
    assert_same(T.read_ply_vertices_rgb(str(tmp_path / "b.ply")),
                J.read_ply_vertices_rgb(str(tmp_path / "b.ply")))
    from ov3det_torch.utils.visualize import write_ply

    write_ply(xyz, str(tmp_path / "a.ply"), colors=rgb)
    assert_same(T.read_ply_vertices_rgb(str(tmp_path / "a.ply")),
                J.read_ply_vertices_rgb(str(tmp_path / "a.ply")))

    (tmp_path / "labels.tsv").write_text("raw_category\tnyu40id\tid\nchair\t5\t3\nsofa bed\t6\t9\n")
    for kw in (dict(), dict(label_from="id")):
        assert T.read_label_mapping(str(tmp_path / "labels.tsv"), **kw) == J.read_label_mapping(
            str(tmp_path / "labels.tsv"), **kw)
    (tmp_path / "agg.json").write_text(json.dumps({"segGroups": [
        {"objectId": i, "label": ["chair", "table"][i % 2],
         "segments": [int(s) for s in rng.integers(0, 40, 3)]} for i in range(5)]}))
    assert T.read_aggregation(str(tmp_path / "agg.json")) == J.read_aggregation(
        str(tmp_path / "agg.json"))
    (tmp_path / "segs.json").write_text(json.dumps(
        {"segIndices": [int(s) for s in rng.integers(0, 40, 300)]}))
    assert T.read_segmentation(str(tmp_path / "segs.json")) == J.read_segmentation(
        str(tmp_path / "segs.json"))
    (tmp_path / "meta.txt").write_text("colorWidth = 1296\naxisAlignment = "
                                       + " ".join(str(v) for v in rng.normal(size=16)) + "\n")
    assert_same(T.read_axis_alignment(str(tmp_path / "meta.txt")),
                J.read_axis_alignment(str(tmp_path / "meta.txt")))


def test_visualize_writes_the_same_files(tmp_path):
    from ov3det.utils import visualize as J
    from ov3det_torch.utils import visualize as T

    rng = np.random.default_rng(11)
    points = rng.uniform(-2, 2, (40, 3))
    colors = rng.uniform(0, 1, (40, 3))
    boxes = np.concatenate([rng.uniform(-2, 2, (3, 3)), rng.uniform(0.2, 1, (3, 3))], 1)
    corners = J.boxes_cs_to_corners(boxes)
    assert_same(T.boxes_cs_to_corners(boxes), corners)
    for mod, d in ((T, "t"), (J, "j")):
        mod.write_ply(points, str(tmp_path / d / "pc.ply"), colors.copy())
        mod.write_bbox_ply(corners, str(tmp_path / d / "boxes.ply"))
        mod.write_scene_with_boxes(points, corners, str(tmp_path / d / "scene"))
    for name in ("pc.ply", "boxes.ply", "scene_pc.ply", "scene_boxes.ply"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


# ------------------------------------------------------------ the PNG reader
def write_png(path, image: np.ndarray, filters) -> None:
    """A greyscale PNG of `image` (uint8 or uint16), row y filtered with
    filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    depth = 16 if image.dtype == np.uint16 else 8
    H, W = image.shape
    data = image.astype(">u2").tobytes() if depth == 16 else image.tobytes()
    stride, bpp = W * depth // 8, depth // 8
    rows = [bytearray(data[y * stride:(y + 1) * stride]) for y in range(H)]
    out = bytearray()
    for y, row in enumerate(rows):
        prior = rows[y - 1] if y else bytearray(stride)
        kind = filters[y % len(filters)]
        enc = bytearray(stride)
        for i in range(stride):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            enc[i] = (row[i] - pred) & 0xFF
        out += bytes([kind]) + enc

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, 0, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_reader_equals_pil_for_each_filter(tmp_path, bits, kind):
    from PIL import Image

    from ov3det_torch.utils.png import read_png

    rng = np.random.default_rng(12 + kind)
    dtype = np.uint16 if bits == 16 else np.uint8
    image = rng.integers(0, np.iinfo(dtype).max + 1, (13, 17)).astype(dtype)
    image[5:9] = image[4]  # runs, where the filters' predictions hit
    path = tmp_path / "f.png"
    write_png(path, image, [kind] if kind else [0, kind])
    got = read_png(str(path))
    want = np.array(Image.open(path))
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(dtype))
    np.testing.assert_array_equal(got, image)


@pytest.mark.parametrize("bits", [8, 16])
def test_png_reader_equals_pil_on_what_pil_writes(tmp_path, bits):
    from PIL import Image

    from ov3det_torch.utils.png import read_png

    rng = np.random.default_rng(20)
    # a smooth depth-like ramp with noise: PIL's encoder picks its filters
    ramp = np.add.outer(np.arange(48) * 40, np.arange(64) * 25) + rng.integers(0, 30, (48, 64))
    image = (ramp % 256).astype(np.uint8) if bits == 8 else ramp.astype(np.uint16)
    path = tmp_path / "p.png"
    Image.fromarray(image).save(path)
    np.testing.assert_array_equal(read_png(str(path)), np.array(Image.open(path)))


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    from PIL import Image

    from ov3det_torch.utils.png import read_png

    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "rgb.png")
    with pytest.raises(ValueError):
        read_png(str(tmp_path / "rgb.png"))
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError):
        read_png(str(tmp_path / "not.png"))


# ------------------------------------------------------------ the lifting
F, CX, CY = 400.0, 320.0, 240.0  # 640 x 480 intrinsics; halved to 320 x 240


def scannet_lift_tree(root, seed: int = 0) -> dict:
    """One ScanNet scene of labelled clusters seen from 3 frames (poses
    moved a little), 2D boxes around their projections, depth PNGs that PIL
    writes, a GSS proposal file; returns the keyword arguments of
    `lift_scene_scannet` but `cfg`."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    scan = "scene0000_00"
    frames = root / "frames" / scan
    for sub in ("color", "depth", "pose"):
        (frames / sub).mkdir(parents=True)
    np.savetxt(frames / "intrinsic_depth.txt",
               np.array([[F, 0, CX, 0], [0, F, CY, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
    clusters = [(rng.uniform([-0.2, -0.2, 1.9], [0.2, 0.2, 2.1], (200, 3)), 5),
                (rng.uniform([0.7, -0.15, 2.4], [1.0, 0.15, 2.6], (150, 3)), 7),
                (rng.uniform([-1.0, 0.2, 2.8], [-0.6, 0.5, 3.1], (120, 3)), 2)]
    decoys = [(rng.uniform([5.0, 5.0, 2.0], [5.5, 5.5, 2.5], (50, 3)), 5),
              (rng.uniform([-0.1, -0.1, 1.95], [0.1, 0.1, 2.05], (50, 3)), 3)]
    pts = np.concatenate([c for c, _ in clusters + decoys])
    labels = np.concatenate([np.full(len(c), float(lbl)) for c, lbl in clusters + decoys])
    (root / "det").mkdir()
    np.save(root / "det" / f"{scan}_vert.npy", pts.astype(np.float32))
    np.save(root / f"{scan}_sem.npy", np.concatenate([pts, labels[:, None]], 1))

    def box2d(cluster):
        u = cluster[:, 0] * (F / 2) / cluster[:, 2] + CX / 2
        v = cluster[:, 1] * (F / 2) / cluster[:, 2] + CY / 2
        x, y = np.floor(u.min()) - 3, np.floor(v.min()) - 3
        return [x, y, np.ceil(u.max()) - x + 3, np.ceil(v.max()) - y + 3]

    b2d = root / "boxes2d" / scan / "color"
    b2d.mkdir(parents=True)
    for fid in range(3):
        rows = [box2d(c) + [float(rng.uniform(0.5, 1.0)), lbl] for c, lbl in clusters]
        np.save(b2d / f"{fid}.npy", np.array(rows))
        (frames / "color" / f"{fid}.jpg").touch()
        depth = rng.integers(500, 4000, (240, 320)).astype(np.uint16)
        Image.fromarray(depth).save(frames / "depth" / f"{fid}.png")
        pose = np.eye(4)
        pose[:3, 3] = rng.normal(0, 0.01, 3)
        np.savetxt(frames / "pose" / f"{fid}.txt", pose)
    np.save(root / f"{scan}_gss.npy", np.array([[0.0, 0.0, 2.0, 0.5, 0.5, 0.3],
                                                 [0.85, 0.0, 2.5, 0.4, 0.4, 0.3],
                                                 [-3.0, -3.0, 8.0, 0.4, 0.4, 0.4]]))
    meta = root / "scans" / scan
    meta.mkdir(parents=True)
    align = np.eye(4)
    align[:3, 3] = [0.01, -0.01, 0.0]  # small: the 2D boxes keep their clusters
    (meta / f"{scan}.txt").write_text("axisAlignment = " + " ".join(map(str, align.ravel())) + "\n")
    return dict(scan_name=scan, detection_data_dir=str(root / "det") + "/",
                frames_dir=str(root / "frames"), label_path_fmt=str(root / "{}_sem.npy"),
                boxes2d_dir=str(root / "boxes2d"), out_dir=str(root / "out"),
                gss_path_fmt=str(root / "{}_gss.npy"),
                scans_meta_fmt=str(root / "scans" / "{}" / "{}.txt"))


def sunrgbd_lift_tree(root, seed: int = 0) -> dict:
    """Two SUN RGB-D frames: calibration, 16-bit depth and 8-bit GT label
    PNGs that PIL writes, pseudo-label .npy maps, 2D boxes; returns the
    keyword arguments of `lift_scene_sunrgbd` but the scan, labels and cfg."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    H, W = 60, 80
    for sub in ("calib", "depth", "label", "seg", "boxes2d"):
        (root / sub).mkdir()
    for name in ("000001", "000002"):
        (root / "calib" / f"{name}.txt").write_text(
            "0.99 0.01 0.02 -0.01 0.98 0.1 0.0 -0.1 0.99\n40 0 0 0 40 0 40 30 1\n")
        Image.fromarray(rng.integers(1950, 2050, (H, W)).astype(np.uint16)).save(
            root / "depth" / f"{name}.png")
        seg = rng.integers(0, 5, (H, W)).astype(np.uint8)
        seg[10:30, 12:40] = 3
        Image.fromarray(seg).save(root / "seg" / f"{name}.png")
        np.save(root / "label" / f"{name}.npy", seg.astype(np.int64) - 1)
        np.save(root / "boxes2d" / f"{name}.npy",
                np.array([[12, 10, 28, 20, 0.9, 2], [5, 5, 20, 20, 0.7, 1],
                          [30, 20, 30, 25, 0.8, 3], [0, 4, 10, 10, 0.6, 2]], np.float64))
    # a proposal on the label-2 box's lift (depth about 2 m), one on nothing
    np.save(root / "000001_gss.npy", np.array([[-0.73, 1.9, 0.69, 1.42, 0.18, 1.03],
                                                [2.0, 2.0, 2.0, 0.3, 0.3, 0.3]]))
    return dict(calib_path_fmt=str(root / "calib" / "{}.txt"),
                depth_path_fmt=str(root / "depth" / "{}.png"),
                boxes2d_dir=str(root / "boxes2d"), out_dir=str(root / "out"),
                gss_path_fmt=str(root / "{}_gss.npy"))


@pytest.mark.parametrize("use_gss", [False, True])
def test_lift_scene_scannet_equals_jax(tmp_path, use_gss):
    from ov3det.tools.lift_boxes import LiftConfig as JCfg
    from ov3det.tools.lift_boxes import lift_scene_scannet as J
    from ov3det_torch.tools.lift_boxes import LiftConfig as TCfg
    from ov3det_torch.tools.lift_boxes import lift_scene_scannet as T

    kw = scannet_lift_tree(tmp_path)
    if not use_gss:
        kw["gss_path_fmt"] = None
    scan = kw.pop("scan_name")
    out = kw.pop("out_dir")
    n_j = J(scan, out_dir=out + "_j", cfg=JCfg(use_gss=use_gss, image_dims=(240, 320)), **kw)
    n_t = T(scan, out_dir=out + "_t", cfg=TCfg(use_gss=use_gss, image_dims=(240, 320)), **kw)
    assert n_t == n_j and n_j >= 2
    assert (open(f"{out}_t/{scan}_bbox.npy", "rb").read()
            == open(f"{out}_j/{scan}_bbox.npy", "rb").read())


@pytest.mark.parametrize("gt_labels", [False, True])
def test_lift_scene_sunrgbd_equals_jax(tmp_path, gt_labels):
    from ov3det.tools.lift_boxes import LiftConfig as JCfg
    from ov3det.tools.lift_boxes import lift_scene_sunrgbd as J
    from ov3det.tools.lift_boxes import run_pool as jax_run_pool
    from ov3det_torch.tools.lift_boxes import LiftConfig as TCfg
    from ov3det_torch.tools.lift_boxes import lift_scene_sunrgbd as T
    from ov3det_torch.tools.lift_boxes import run_pool

    kw = sunrgbd_lift_tree(tmp_path)
    kw["label_path_fmt"] = str(tmp_path / ("seg/{}.png" if gt_labels else "label/{}.npy"))
    out = kw.pop("out_dir")
    scans = ["000001", "000002"]
    want = jax_run_pool(J, scans, processes=0, out_dir=out + "_j", cfg=JCfg(),
                        use_gt_labels=gt_labels, **kw)
    got = run_pool(T, scans, out_dir=out + "_t", cfg=TCfg(),
                   use_gt_labels=gt_labels, **kw)
    assert got == want and want[0] >= 1 and sum(want) >= 2
    for scan in scans:
        assert (open(f"{out}_t/{scan}_bbox.npy", "rb").read()
                == open(f"{out}_j/{scan}_bbox.npy", "rb").read())


_NO_PIL = """
import json, sys
from ov3det_torch.tools.lift_boxes import LiftConfig, lift_scene_scannet, lift_scene_sunrgbd
kw, skw = json.loads(sys.argv[1]), json.loads(sys.argv[2])
n = lift_scene_scannet(cfg=LiftConfig(image_dims=(240, 320)), **kw)
m = lift_scene_sunrgbd("000001", use_gt_labels=True, **skw)
print(json.dumps({"n": n, "m": m, "pil": sorted(k for k in sys.modules if k.split(".")[0] == "PIL")}))
"""


def test_lifting_imports_no_pil(tmp_path):
    for sub in ("scannet", "sun"):
        (tmp_path / sub).mkdir()
    kw = scannet_lift_tree(tmp_path / "scannet")
    skw = sunrgbd_lift_tree(tmp_path / "sun")
    skw["label_path_fmt"] = str(tmp_path / "sun" / "seg" / "{}.png")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _NO_PIL, json.dumps(kw), json.dumps(skw)],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["n"] >= 2 and report["m"] >= 1
    assert report["pil"] == []

