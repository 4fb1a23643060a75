"""Pseudo-label generation of the port: `python -m ov3det_torch.generate_pseudo_label`.

Counterpart of `ov3det/generate_pseudo_label.py:26-96` (reference
generate_pseudo_label.py:27-283): runs the trained detector over the TRAIN
split without augmentation, accumulates its final-layer predictions through
the `LabelFormatter`, thresholds them per class, keeps the boxes whose
contained points' modal semantic label matches (with `--label_dir`), and
writes the `{scan}_bbox.npy` files that `--use_pbox` trains on (ScanNet
reads them after `tools.format_tools.adjust_format_to_nyu40`).  The flags
are those of `ov3det_torch.main` plus `--out_dir --label_dir --topk
--conf_thresh --obj_thresh`; `--device` defaults to `cuda`, which raises
without a card.
"""
from __future__ import annotations

import os

from ov3det_torch.datasets.loader import DataLoader, slice_valid, valid_count
from ov3det_torch.datasets.registry import build_dataset
from ov3det_torch.device import resolve_device
from ov3det_torch.engine.checkpoint import restore_eval_checkpoint
from ov3det_torch.engine.infer import make_eval_step
from ov3det_torch.engine.train import batch_to_device
from ov3det_torch.main import config_from_args, make_args_parser
from ov3det_torch.models.detr3d import Model3DETR
from ov3det_torch.tools.label_formatter import LabelFormatter


def make_pseudo_label_parser():
    p = make_args_parser()
    p.add_argument("--out_dir", type=str, required=False, default=None)
    p.add_argument("--label_dir", type=str, required=False, default=None,
                   help="per-scan point+semantic-label npy files")
    p.add_argument("--topk", default=100, type=int)
    p.add_argument("--conf_thresh", default=0.6, type=float)
    p.add_argument("--obj_thresh", default=0.9, type=float)
    return p


def run_inference(cfg, args, device=None) -> LabelFormatter:
    """The eval forward over the "inference" split (the train split,
    un-augmented) from `--test_ckpt` or the checkpoint directory's latest
    checkpoint; returns the formatter holding every real sample's rows."""
    device = resolve_device(device)
    datasets, _ = build_dataset(cfg.data, splits=("inference",))
    dataset = datasets["inference"]
    loader = DataLoader(dataset, batch_size=cfg.data.batch_size_per_device, shuffle=False,
                        drop_last=False, num_workers=cfg.data.num_workers,
                        pin_memory=device.type == "cuda")
    model = Model3DETR(cfg.model, device=device, seed=cfg.seed)
    epoch = restore_eval_checkpoint(model, args.test_ckpt, cfg.checkpoint_dir)
    print(f"loaded checkpoint from epoch {epoch}")
    eval_step = make_eval_step(model)

    formatter = LabelFormatter(
        output_path=args.out_dir,
        label_path=args.label_dir,
        scene_list=dataset.scan_names,
        num_classes=cfg.model.num_semcls,
    )
    for batch in loader:
        # strip the tail pad of the final partial batch: a duplicated pad
        # sample would write its predictions twice into the same scan's rows
        n = valid_count(batch)
        outputs = eval_step(batch_to_device(batch, device, non_blocking=True))
        formatter.step(slice_valid(outputs, n), slice_valid(batch, n))
    return formatter


def main(argv=None) -> int:
    """Runs the pass on `argv`; returns the number of boxes written."""
    args = make_pseudo_label_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    if not args.out_dir:
        raise ValueError("set --out_dir")
    os.makedirs(args.out_dir, exist_ok=True)
    formatter = run_inference(cfg, args, device)
    return formatter.process(args.topk, args.conf_thresh, args.obj_thresh)


if __name__ == "__main__":
    main()
