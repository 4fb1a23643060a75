"""The port's datasets and loader on the CPU against the JAX package.

Everything here is exact: the same numpy draws in the same order, so every
array is compared bit for bit (values and dtype).  Samples come from
`SyntheticDataset` and from the SUN RGB-D and ScanNet fixture trees of
`tests/test_datasets.py`; the augmentations are held against JAX's from the
same generator state; the loader's batches against
`ov3det.datasets.loader.DataLoader(..., transfer="tree", sharding=None)`.
"""
import numpy as np
import pytest
import torch

from ov3det.datasets import augment as jaug
from ov3det.datasets import registry as jregistry
from ov3det.datasets.dataset_configs import ScannetDatasetConfig as JScannetConfig
from ov3det.datasets.dataset_configs import SunrgbdDatasetConfig as JSunrgbdConfig
from ov3det.datasets.loader import DataLoader as JDataLoader
from ov3det.datasets.scannet import ScannetDetectionDataset as JScannet
from ov3det.datasets.sunrgbd import SunrgbdDetectionDataset as JSunrgbd
from ov3det.datasets.synthetic import SyntheticDataset as JSynthetic
from ov3det_torch.config import DataConfig
from ov3det_torch.datasets import augment as taug
from ov3det_torch.datasets.dataset_configs import ScannetDatasetConfig, SunrgbdDatasetConfig
from ov3det_torch.datasets.loader import DataLoader, slice_valid, valid_count
from ov3det_torch.datasets.registry import build_dataset
from ov3det_torch.datasets.scannet import ScannetDetectionDataset
from ov3det_torch.datasets.sunrgbd import SunrgbdDetectionDataset
from ov3det_torch.datasets.synthetic import SyntheticDataset
from tests.test_datasets import scannet_tree, sunrgbd_tree  # noqa: F401  (fixtures)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def assert_same_sample(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        w = np.asarray(w)
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


# ------------------------------------------------------------ the datasets
@pytest.mark.parametrize("use_color", [False, True])
def test_synthetic_dataset_matches_jax(use_color):
    kw = dict(size=5, seed=2, num_points=1000, num_semcls=18, num_angle_bin=1, use_color=use_color)
    ours, theirs = SyntheticDataset(**kw), JSynthetic(**kw)
    assert len(ours) == len(theirs) and ours.scan_names == theirs.scan_names
    for i in (0, 3, 4):
        assert_same_sample(ours[i], theirs[i])


def _sunrgbd_pair(root, split, **kw):
    base = str(root / "sunrgbd_pc_bbox_50k_v1")
    return (SunrgbdDetectionDataset(SunrgbdDatasetConfig(), split, root_dir=base, **kw),
            JSunrgbd(JSunrgbdConfig(), split, root_dir=base, **kw))


@pytest.mark.parametrize("split,kw", [
    ("val", dict(num_points=1024)),
    ("val", dict(num_points=1024, use_color=True, use_height=True)),
    ("train", dict(num_points=1024)),
    ("train", dict(num_points=4000, use_pbox=True)),  # more points than the scene: with replacement
])
def test_sunrgbd_matches_jax(sunrgbd_tree, split, kw):  # noqa: F811
    if kw.get("use_pbox"):
        kw = dict(kw, pseudo_box_dir=str(sunrgbd_tree / "pseudo"))
    ours, theirs = _sunrgbd_pair(sunrgbd_tree, split, **kw)
    assert ours.scan_names == theirs.scan_names
    for i in range(len(ours)):
        assert_same_sample(ours[i], theirs[i])


def test_sunrgbd_train_split_keeps_only_support_classes(sunrgbd_tree):  # noqa: F811
    ours, _ = _sunrgbd_pair(sunrgbd_tree, "train", num_points=1024)
    support = SunrgbdDatasetConfig().support_class
    for i in range(len(ours)):
        item = ours[i]
        n = int(item["gt_box_present"].sum())
        assert n == 3 and np.isin(item["gt_box_sem_cls_label"][:n], support).all()
    val, _ = _sunrgbd_pair(sunrgbd_tree, "val", num_points=1024)
    assert int(val[0]["gt_box_present"].sum()) == 5


@pytest.mark.parametrize("split,kw", [
    ("val", dict(num_points=2048)),
    ("train", dict(num_points=2048, use_color=True)),
])
def test_scannet_matches_jax(scannet_tree, split, kw):  # noqa: F811
    base = dict(root_dir=str(scannet_tree / "scannet_train_detection_data"),
                meta_data_dir=str(scannet_tree / "meta_data"), **kw)
    ours = ScannetDetectionDataset(ScannetDatasetConfig(), split, **base)
    theirs = JScannet(JScannetConfig(), split, **base)
    assert ours.scan_names == theirs.scan_names and len(ours) > 0
    for i in range(len(ours)):
        assert_same_sample(ours[i], theirs[i])


def test_registry_matches_jax(scannet_tree):  # noqa: F811
    from ov3det.config import DataConfig as JDataConfig

    for name, kw in (("synthetic", dict(num_points=512)),
                     ("scannet", dict(num_points=1024,
                                      root_dir=str(scannet_tree / "scannet_train_detection_data"),
                                      meta_data_dir=str(scannet_tree / "meta_data")))):
        splits = ("train", "test", "inference")
        ours, ocfg = build_dataset(DataConfig(dataset_name=name, **kw), splits)
        theirs, tcfg = jregistry.build_dataset(JDataConfig(dataset_name=name, **kw), splits)
        assert ocfg.class2type == tcfg.class2type
        for split in splits:
            assert len(ours[split]) == len(theirs[split])
            assert getattr(ours[split], "augment", False) == getattr(theirs[split], "augment", False)
            if not getattr(ours[split], "augment", False):
                assert_same_sample(ours[split][len(ours[split]) - 1], theirs[split][len(theirs[split]) - 1])
    synth, _ = build_dataset(DataConfig(dataset_name="synthetic", num_points=512), splits)
    # 64 train scenes, 16 test, and (as in the JAX package) 16 in the
    # inference view of the train seed
    assert [(len(synth[s]), synth[s].seed) for s in splits] == [(64, 1), (16, 2), (16, 1)]


# ------------------------------------------------------------ augmentations
def _state(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _scene(seed, n=600, k=5):
    rng = np.random.default_rng(seed)
    pc = rng.uniform(-3, 3, (n, 6))
    pc[:, 3:] = rng.uniform(0, 1, (n, 3))
    boxes = np.zeros((k, 8))
    boxes[:, :3] = rng.uniform(-2, 2, (k, 3))
    boxes[:, 3:6] = rng.uniform(0.2, 0.8, (k, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, k)
    return pc, boxes


def test_rotz_and_sampling_match_jax():
    np.testing.assert_array_equal(taug.rotz(0.7), jaug.rotz(0.7))
    pc, _ = _scene(0)
    for n, ret in ((100, False), (1000, True)):
        a, b = _state(3)
        got, want = taug.random_sampling(pc, n, a, ret), jaug.random_sampling(pc, n, b, ret)
        for g, w in zip(got if ret else (got,), want if ret else (want,)):
            np.testing.assert_array_equal(g, w)


def test_flips_rotation_scale_and_color_match_jax():
    pc, boxes = _scene(1)
    out = [f(pc.copy(), boxes.copy()) for f in (taug.flip_yz_plane, jaug.flip_yz_plane)]
    for g, w in zip(*out):
        np.testing.assert_array_equal(g, w)
    out = [f(pc.copy(), boxes.copy(), 0.3) for f in (taug.rotate_z, jaug.rotate_z)]
    for g, w in zip(*out):
        np.testing.assert_array_equal(g, w)
    a, b = _state(5)
    np.testing.assert_array_equal(taug.jitter_color(pc[:, 3:].copy(), a),
                                  jaug.jitter_color(pc[:, 3:].copy(), b))
    for height in (False, True):
        a, b = _state(6)
        got = taug.random_scale(pc.copy(), boxes.copy(), a, 0.85, 1.15, height)
        want = jaug.random_scale(pc.copy(), boxes.copy(), b, 0.85, 1.15, height)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,min_points", [(7, 100), (8, 500), (9, 10_000)])
def test_random_cuboid_matches_jax(seed, min_points):
    pc, boxes = _scene(seed)
    a, b = _state(seed)
    labels = [np.arange(len(pc))]
    got = taug.RandomCuboid(min_points, 0.75, 0.75, 1.0)(pc, boxes, a, labels)
    want = jaug.RandomCuboid(min_points, 0.75, 0.75, 1.0)(pc, boxes, b, labels)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2][0], want[2][0])
    assert a.random() == b.random()  # the generators advanced alike


# ------------------------------------------------------------ the loader
def _loader_pair(dataset, jdataset, num_workers=0, **kw):
    return (DataLoader(dataset, num_workers=num_workers, **kw),
            JDataLoader(jdataset, num_workers=1, transfer="tree", sharding=None, **kw))


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_shuffled_epochs_match_jax(num_workers):
    kw = dict(size=16, seed=1, num_points=256, num_semcls=18, num_angle_bin=1)
    ours, theirs = _loader_pair(SyntheticDataset(**kw), JSynthetic(**kw), num_workers,
                                batch_size=4, shuffle=True, seed=3)
    assert len(ours) == len(theirs) == 4
    orders = []
    for epoch in (0, 1, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert "valid_mask" not in g
            assert_same_sample(g, w)
        orders.append(np.concatenate([b["scan_idx"].numpy() for b in got]).tolist())
    assert len({tuple(o) for o in orders}) == 3  # each epoch has its own order
    assert all(sorted(o) == list(range(16)) for o in orders)


def test_loader_padded_tail_matches_jax():
    kw = dict(size=16, seed=2, num_points=256, num_semcls=18, num_angle_bin=1)
    ours, theirs = _loader_pair(SyntheticDataset(**kw), JSynthetic(**kw), batch_size=6,
                                shuffle=False, drop_last=False)
    got, want = list(ours), list(theirs)
    assert len(ours) == len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_same_sample(g, w)
    tail = got[-1]
    np.testing.assert_array_equal(tail["scan_idx"].numpy(), [12, 13, 14, 15, 15, 15])
    np.testing.assert_array_equal(tail["valid_mask"].numpy(), [1, 1, 1, 1, 0, 0])
    assert valid_count(tail) == 4
    assert slice_valid(tail, 4)["point_clouds"].shape == (4, 256, 3)
    seen = np.concatenate([slice_valid(b, valid_count(b))["scan_idx"].numpy() for b in got])
    np.testing.assert_array_equal(seen, np.arange(16))


def test_loader_pins_memory_only_when_asked():
    kw = dict(size=4, seed=0, num_points=64, num_semcls=18, num_angle_bin=1)
    batch = next(iter(DataLoader(SyntheticDataset(**kw), batch_size=2, num_workers=0)))
    assert all(isinstance(v, torch.Tensor) and not v.is_pinned() for v in batch.values())
