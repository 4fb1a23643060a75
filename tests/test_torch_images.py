"""The real datasets' image branches on the CPU against the JAX package.

`resize_crop_image` against JAX's (PIL's NEAREST resize and crop), the SUN
RGB-D canvases and calibration and the ScanNet frames batch against JAX's
datasets on fixture trees that PIL writes (every key, dtype and value), and
the CLI: `--dataset_name sunrgbd --use_image` trains with and without
`--image_bank`, and ScanNet's `--use_image` batch stops at the teacher's
build in both packages.
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ov3det import main as jmain
from ov3det.config import DataConfig as JDataConfig
from ov3det.datasets import registry as jregistry
from ov3det.datasets.dataset_configs import SunrgbdDatasetConfig as JSunrgbdConfig
from ov3det.datasets.image_utils import resize_crop_image as jax_resize_crop
from ov3det.datasets.sunrgbd import SunrgbdDetectionDataset as JSunrgbd
from ov3det_torch import main as cli
from ov3det_torch.config import DataConfig
from ov3det_torch.datasets.dataset_configs import SunrgbdDatasetConfig
from ov3det_torch.datasets.image_utils import nearest_indices, resize_crop_image
from ov3det_torch.datasets.registry import build_dataset
from ov3det_torch.datasets.sunrgbd import SunrgbdDetectionDataset
from ov3det_torch.datasets.synthetic import write_sunrgbd_tree
from ov3det_torch.utils import jpeg
from tests.test_datasets import scannet_tree, sunrgbd_tree  # noqa: F401  (fixtures)
from tests.test_torch_data import assert_same_sample
from tests.test_torch_ov import tiny_teacher  # noqa: F401  (a fixture)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


# ------------------------------------------------------------ resize and crop
# (source width, height) -> (width, height) of the crop; the resize is to the
# crop's height, the width kept in proportion: 342 x 256, 341 x 256, 42 x 32,
# 341 x 256, 42 x 32, 407 x 256, 685 x 512 and 329 x 256
RESIZES = [((1296, 968), (328, 256)), ((64, 48), (328, 256)), ((64, 48), (41, 32)),
           ((320, 240), (328, 256)), ((1296, 968), (41, 32)), ((97, 61), (328, 256)),
           ((1296, 968), (656, 512)), ((1001, 777), (328, 256))]


@pytest.mark.parametrize("source,dims", RESIZES)
def test_resize_crop_equals_pil(source, dims):
    rng = np.random.default_rng(source[0] + dims[1])
    width, height = source
    images = [rng.integers(0, 256, (height, width, 3), dtype=np.uint8),
              rng.integers(0, 65536, (height, width)).astype(np.uint16),
              rng.integers(0, 65536, (height, width)).astype(np.int32)]
    for img in images:
        want = jax_resize_crop(img, dims)
        got = resize_crop_image(img, dims)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=str(img.dtype))


def test_pil_accumulates_its_nearest_positions():
    """The trap: at 1296 -> 342 (ScanNet's colour frame to JAX's image
    height 256) PIL's accumulated positions and the closed form
    floor((x + 0.5) * 1296 / 342) pick other columns 14 times; PIL takes the
    closed form for 16-bit images only."""
    summed, closed = nearest_indices(1296, 342, True), nearest_indices(1296, 342, False)
    assert int((summed != closed).sum()) == 14
    np.testing.assert_array_equal(closed, np.floor((np.arange(342) + 0.5) * 1296 / 342))
    img = np.random.default_rng(0).integers(0, 256, (968, 1296, 3), dtype=np.uint8)
    rows = nearest_indices(968, 256, True)
    want = jax_resize_crop(img, (342, 256))  # no crop: the resize alone
    np.testing.assert_array_equal(want, img[rows[:, None], summed[None, :]])
    assert not np.array_equal(want, img[rows[:, None], closed[None, :]])


# ------------------------------------------------------------ SUN RGB-D
def write_sunrgbd_images(root, sizes, subsampling=2):
    """calib/ and image/ of the scans 000000..000002 under `root` (the raw
    data dir, which the registries take from --meta_data_dir): one PIL JPEG
    each, of the given (width, height), and a seeded calibration."""
    rng = np.random.default_rng(5)
    (root / "calib").mkdir(exist_ok=True)
    (root / "image").mkdir(exist_ok=True)
    for i, (width, height) in enumerate(sizes):
        name = f"{i:06d}"
        img = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / "image" / f"{name}.jpg", quality=90,
                                  subsampling=subsampling)
        rtilt, k = rng.normal(size=9), rng.uniform(1, 600, size=9)
        (root / "calib" / f"{name}.txt").write_text(
            " ".join(map(str, rtilt)) + "\n" + " ".join(map(str, k)) + "\n")


def test_sunrgbd_image_batch_matches_jax(sunrgbd_tree):  # noqa: F811
    write_sunrgbd_images(sunrgbd_tree, [(730, 530), (640, 480), (730, 530)])
    base = str(sunrgbd_tree / "sunrgbd_pc_bbox_50k_v1")
    kw = dict(root_dir=base, raw_data_dir=str(sunrgbd_tree), num_points=1024, use_image=True)
    ours = SunrgbdDetectionDataset(SunrgbdDatasetConfig(), "val", **kw)
    theirs = JSunrgbd(JSunrgbdConfig(), "val", **kw)
    for i in range(len(ours)):
        item = ours[i]
        assert {"image", "image_height", "image_width", "calib_Rtilt", "calib_K"} <= set(item)
        assert_same_sample(item, theirs[i])
        np.testing.assert_array_equal(ours.get_image(i), theirs.get_image(i))
    assert ours[1]["image"].dtype == np.uint8 and ours[1]["image_width"] == 640
    # through the registries, with --meta_data_dir as the raw data dir
    splits = ("train", "test", "inference")
    cfg = dict(dataset_name="sunrgbd", root_dir=base, meta_data_dir=str(sunrgbd_tree),
               num_points=1024, use_image=True)
    ours, _ = build_dataset(DataConfig(**cfg), splits)
    theirs, _ = jregistry.build_dataset(JDataConfig(**cfg), splits)
    for split in ("test", "inference"):
        assert_same_sample(ours[split][2], theirs[split][2])
    np.testing.assert_array_equal(ours["train"].get_image(0), theirs["train"].get_image(0))


@pytest.mark.parametrize("case", ["greyscale", "oversized"])
def test_sunrgbd_image_that_fits_no_canvas_raises(sunrgbd_tree, case):  # noqa: F811
    write_sunrgbd_images(sunrgbd_tree, [(730, 530), (640, 480), (730, 530)])
    path = sunrgbd_tree / "image" / "000001.jpg"
    if case == "greyscale":
        Image.fromarray(np.full((480, 640), 99, np.uint8)).save(path)
    else:
        Image.fromarray(np.full((531, 730, 3), 99, np.uint8)).save(path)
    base = str(sunrgbd_tree / "sunrgbd_pc_bbox_50k_v1")
    kw = dict(root_dir=base, raw_data_dir=str(sunrgbd_tree), num_points=1024, use_image=True)
    with pytest.raises(ValueError):  # JAX's canvas assignment
        JSunrgbd(JSunrgbdConfig(), "val", **kw).get_image(1)
    with pytest.raises(ValueError, match="scan 000001: image of shape"):
        SunrgbdDetectionDataset(SunrgbdDatasetConfig(), "val", **kw).get_image(1)


def test_the_decoder_is_built_by_the_constructing_process(sunrgbd_tree, monkeypatch):  # noqa: F811
    """`use_image=True` builds and loads the decoder in the constructor, so
    that the loader's worker processes only load the built file."""
    monkeypatch.setattr(jpeg, "_state", {})
    base = str(sunrgbd_tree / "sunrgbd_pc_bbox_50k_v1")
    SunrgbdDetectionDataset(SunrgbdDatasetConfig(), "val", root_dir=base, num_points=1024)
    assert jpeg._state == {}
    SunrgbdDetectionDataset(SunrgbdDatasetConfig(), "val", root_dir=base, num_points=1024,
                            raw_data_dir=str(sunrgbd_tree), use_image=True)
    assert "lib" in jpeg._state


# ------------------------------------------------------------ ScanNet frames
def write_frames(root, names):
    """JAX's own frames case (tests/test_datasets.py:155-199): two 64 x 48
    frames a scene with depth PNGs in mode "I"; and a third, ScanNet's
    1296 x 968 colour frame with a 640 x 480 depth map."""
    frames = root / "frames_square"
    rng = np.random.default_rng(3)
    for name in names:
        for sub in ("color", "depth", "pose"):
            (frames / name / sub).mkdir(parents=True)
        for fid, (cw, ch, dw, dh) in enumerate([(64, 48, 64, 48), (64, 48, 64, 48),
                                                (1296, 968, 640, 480)]):
            img = rng.integers(0, 256, size=(ch, cw, 3)).astype(np.uint8)
            Image.fromarray(img).save(frames / name / "color" / f"{fid}.jpg")
            depth = rng.integers(0, 5000, size=(dh, dw)).astype(np.int32)
            Image.fromarray(depth, mode="I").save(frames / name / "depth" / f"{fid}.png")
            pose = np.eye(4) + rng.normal(0, 0.01, (4, 4))
            np.savetxt(frames / name / "pose" / f"{fid}.txt", pose)
    return frames


def test_scannet_frames_batch_matches_jax(scannet_tree):  # noqa: F811
    frames = write_frames(scannet_tree, [f"scene{i:04d}_00" for i in range(3)])
    cfg = dict(dataset_name="scannet", root_dir=str(scannet_tree / "scannet_train_detection_data"),
               meta_data_dir=str(scannet_tree / "meta_data"), num_points=2048, use_image=True,
               frames_dir=str(frames), max_frames=4)
    splits = ("train", "test", "inference")
    ours, _ = build_dataset(DataConfig(**cfg), splits)
    theirs, _ = jregistry.build_dataset(JDataConfig(**cfg), splits)
    assert (ours["train"].frames_dir, ours["train"].max_frames) == (str(frames), 4)
    assert_same_sample(ours["test"][0], theirs["test"][0])
    assert_same_sample(ours["inference"][1], theirs["inference"][1])
    # the train split is augmented at random; its frames are not
    got, want = ours["train"][0], theirs["train"][0]
    for k in ("images", "depths", "poses", "frame_mask"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    item = ours["test"][0]
    assert item["images"].shape == (4, 3, 256, 328) and item["depths"].shape == (4, 32, 41)
    np.testing.assert_array_equal(item["frame_mask"], [1, 1, 1, 0])
    np.testing.assert_array_equal(item["poses"][3], np.eye(4))
    assert item["images"][3].sum() == 0 and item["images"][2].std() > 0


# ------------------------------------------------------------ the CLI
TINY_SUN = ["--dataset_name", "sunrgbd", "--device", "cpu", "--dataset_num_workers", "0",
            "--max_epoch", "1", "--eval_every_epoch", "1", "--batchsize_per_gpu", "4",
            "--num_points", "512", "--preenc_npoints", "128", "--enc_nlayers", "2",
            "--enc_dim", "64", "--enc_ffn_dim", "64", "--dec_nlayers", "2", "--dec_dim", "64",
            "--dec_ffn_dim", "64", "--nqueries", "32", "--mlp_dropout", "0.0",
            "--log_every", "1", "--log_metrics_every", "100", "--use_image",
            "--loss_2dalignment_weight", "1"]


def _first_step(run: str) -> dict:
    with open(os.path.join(run, "scalars.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    first = min((r for r in rows if "Train_details/loss_2dalignment" in r),
                key=lambda r: r["step"])
    return {k: v for k, v in first.items() if k.startswith("Train_details/")}


def test_sunrgbd_use_image_cli_trains_with_and_without_the_bank(
        tmp_path, tiny_teacher, capsys, monkeypatch):  # noqa: F811
    # the train split augments from fresh entropy (default_rng(None)), as
    # the reference does; seed it so that both runs see the same batches
    fresh = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: fresh(1234 if seed is None else seed))
    images = sorted(os.path.join(FIXTURES, f) for f in os.listdir(FIXTURES)
                    if f.startswith("sun_"))
    tree = write_sunrgbd_tree(str(tmp_path / "data"), 8, 4, images, num_points=2048)
    argv = TINY_SUN + ["--dataset_root_dir", tree["root_dir"],
                       "--meta_data_dir", tree["meta_data_dir"]]
    runs = {}
    for bank in (False, True):
        run = str(tmp_path / f"run_bank{int(bank)}")
        training = cli.main(argv + ["--checkpoint_dir", run] + (["--image_bank"] if bank else []))
        out = capsys.readouterr().out
        assert training.teacher is not None and training.teacher.compute_dtype == "int8"
        assert "saved new best checkpoint" in out and "mAP0.25" in out
        assert os.path.isfile(os.path.join(run, "checkpoint"))
        assert os.path.isfile(os.path.join(run, "final_eval.txt"))
        payload = torch.load(os.path.join(run, "checkpoint"), weights_only=True)
        assert set(payload["model"]) == set(training.model.state_dict())
        if bank:
            bank_rows, hw = training.image_bank
            assert hw == (530, 730) and bank_rows.shape[0] == 8
        runs[bank] = _first_step(run)
    plain, banked = runs[False], runs[True]
    assert set(plain) == set(banked) and plain["Train_details/loss_2dalignment"] > 0
    for k, v in plain.items():
        # the bank holds the canvases' 4:2:0 round trip, which reaches only
        # the teacher's targets: the point losses are equal, the alignment
        # losses and the total moved by 1e-4 and grad_norm by 4e-3
        rtol = (1e-3 if "loss_2dalignment" in k or k == "Train_details/loss"
                else 2e-2 if k == "Train_details/grad_norm" else 0)
        np.testing.assert_allclose(banked[k], v, rtol=rtol, atol=0, err_msg=k)


def test_scannet_use_image_stops_at_the_teacher_in_both_packages(
        scannet_tree, tmp_path):  # noqa: F811
    """ScanNet's --use_image batch holds frames and no `image` canvas, so
    no teacher is built from it: JAX's run stops there (KeyError 'image',
    ov3det/main.py:313) and the port's says why."""
    frames = write_frames(scannet_tree, [f"scene{i:04d}_00" for i in range(3)])
    argv = ["--dataset_name", "scannet", "--dataset_root_dir",
            str(scannet_tree / "scannet_train_detection_data"), "--meta_data_dir",
            str(scannet_tree / "meta_data"), "--use_image", "--frames_dir", str(frames),
            "--max_frames", "3", "--dataset_num_workers", "0", "--batchsize_per_gpu", "1",
            "--num_points", "512", "--preenc_npoints", "64", "--enc_dim", "32",
            "--enc_ffn_dim", "32", "--dec_dim", "32", "--dec_ffn_dim", "32", "--nqueries", "16"]
    args = cli.make_args_parser().parse_args(argv + ["--device", "cpu"])
    datasets, _ = build_dataset(cli.config_from_args(args).data)
    assert (datasets["test"].frames_dir, datasets["test"].max_frames) == (str(frames), 3)
    assert datasets["test"][0]["images"].shape == (3, 3, 256, 328)
    with pytest.raises(KeyError, match="image"):
        jmain.main(argv + ["--checkpoint_dir", str(tmp_path / "jax")])
    with pytest.raises(ValueError, match="no 'image' canvas, so it feeds no teacher"):
        cli.main(argv + ["--device", "cpu", "--checkpoint_dir", str(tmp_path / "port")])
