"""Dataset registry: name -> (splits dict, dataset_config).

A copy of `ov3det/datasets/registry.py:17-89` (reference
datasets/__init__.py:12-50): the train split augmented, test = val
un-augmented, an "inference" view of the train split without augmentation,
and the "synthetic" dataset (64 train / 16 test scenes, seeds 1 / 2 / 1).
`use_image` picks `SyntheticOVDataset` (canvases and calibration) for
"synthetic", as `ov3det/datasets/registry.py:72-77` does; the real
datasets' constructors raise on it (their image branches are ROADMAP Queue 1
item 9).
"""
from __future__ import annotations

from ov3det_torch.config import DataConfig
from ov3det_torch.datasets.dataset_configs import ScannetDatasetConfig, SunrgbdDatasetConfig
from ov3det_torch.datasets.scannet import ScannetDetectionDataset
from ov3det_torch.datasets.sunrgbd import SunrgbdDetectionDataset
from ov3det_torch.datasets.synthetic import SyntheticDataset, SyntheticOVDataset


def build_dataset(cfg: DataConfig, splits=("train", "test")):
    name = cfg.dataset_name
    datasets = {}
    if name == "sunrgbd":
        dataset_config = SunrgbdDatasetConfig()

        def make(split, augment):
            return SunrgbdDetectionDataset(
                dataset_config,
                split_set=split,
                root_dir=cfg.root_dir,
                raw_data_dir=cfg.meta_data_dir,
                pseudo_box_dir=cfg.pseudo_label_dir,
                feature_2d_dir=cfg.feature_2d_dir,
                num_points=cfg.num_points,
                use_color=cfg.use_color,
                augment=augment,
                use_pbox=cfg.use_pbox,
                use_2d_feature=cfg.use_2d_feature,
                use_image=cfg.use_image,
            )
    elif name == "scannet":
        dataset_config = ScannetDatasetConfig()

        def make(split, augment):
            return ScannetDetectionDataset(
                dataset_config,
                split_set=split,
                root_dir=cfg.root_dir,
                meta_data_dir=cfg.meta_data_dir,
                pseudo_box_dir=cfg.pseudo_label_dir,
                feature_2d_dir=cfg.feature_2d_dir,
                num_points=cfg.num_points,
                use_color=cfg.use_color,
                augment=augment,
                use_pbox=cfg.use_pbox,
                use_2d_feature=cfg.use_2d_feature,
                use_image=cfg.use_image,
            )
    elif name == "synthetic":
        dataset_config = ScannetDatasetConfig()
        cls = SyntheticOVDataset if cfg.use_image else SyntheticDataset
        for split, seed in (("train", 1), ("test", 2), ("inference", 1)):
            if split in splits:
                datasets[split] = cls(
                    size=64 if split == "train" else 16,
                    seed=seed,
                    num_points=cfg.num_points,
                    num_semcls=dataset_config.num_semcls,
                    num_angle_bin=dataset_config.num_angle_bin,
                )
        return datasets, dataset_config
    else:
        raise ValueError(f"unknown dataset {name}")
    for split, source, augment in (("train", "train", True), ("test", "val", False),
                                   ("inference", "train", False)):
        if split in splits:
            datasets[split] = make(source, augment)
    return datasets, dataset_config
