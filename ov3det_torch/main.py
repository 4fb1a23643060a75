"""Training / evaluation entry point of the port: `python -m ov3det_torch.main`.

Counterpart of `ov3det/main.py:50-717` (reference main.py:28-506,
engine.py:47-302): the same argparse surface, cosine-warmup schedule,
latest / best / periodic checkpoints, resume-on-restart, idempotent
final_eval guard, approximate train-time AP and exact eval AP, and a
NaN-loss abort, with the same printed lines and `scalars.jsonl` keys.
`--device` (default `cuda`, which raises without a card; `cpu` on request).

`--ngpus N` trains the global batch `--batchsize_per_gpu x N` over N ranks,
one process a device (rank i on `cuda:i`, or N CPU processes over gloo with
`--device cpu`), as the JAX package's mesh step trains it (`ov3det_torch
.parallel`); `--coordinator_address host:port --num_processes M
--process_id I` places N / M of them on each of M hosts, and torchrun's
environment is honoured (`engine.runtime.plan_ranks`).  A process group the
caller has initialised already is used as it is.  Each rank loads its rows
of every global batch; rank 0 alone prints, logs and writes checkpoints;
every rank resumes from the same file; an eval gathers the detections of
every rank, in the global batch order, before the AP.  A rank that fails
fails the run.  `--image_bank` (with `--use_image`) puts every train
scene's canvas on the device once (`datasets.image_bank`); every rank holds
the whole bank.

`--use_image` trains the open-vocabulary step: the frozen RegionCLIP
RN50x4 teacher (`--teacher_compute_dtype`, int8 by default, calibrated on
the first canvas of the test split; seeded random weights unless
`--region_clip_ckpt_path` names a checkpoint) feeds the 2D-alignment loss
(`--loss_2dalignment_weight`).  The dropout masks of training step `i`
come from a generator on the device seeded from `(seed, i)`, as the JAX
package builds its key from `[seed, i]`, so a resume needs no RNG state.

On one process the train loader ships each batch packed (JAX's default
transfer on one device, `ov3det/main.py:395-436`): one uint8 row in JAX's
layout, `--quantize_points` (q16 point clouds) and `--yuv_images` (yuv420
canvases) as its codecs, `--super_batch G` batches a copy to the device,
and `engine.train.PackedStep` runs the step, on a card one CUDA-graph
replay a batch (`--debug_nans` runs it eagerly).  A group's steps are
seeded as the ungrouped loop seeds their iterations, so `--super_batch G`
trains bit for bit as G = 1 and a resume stays exact (JAX folds the row
into its group's key instead; the two packages' dropout streams differ
anyway).  Iteration bookkeeping, logs and the train-time AP refer to a
group's last batch, as in JAX (`ov3det/main.py:484-600`).  Under `--ngpus`
the train loader keeps the tree transfer and the three flags have no
effect, as in JAX; evals and the pseudo-label round always take the tree
transfer.  On a card the eval step is one CUDA-graph replay a batch as well
(`engine.infer.GraphedEval`; eager under `--debug_nans` and `--ngpus`).
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import pickle
import sys
import time
from typing import Optional

import numpy as np
import torch

from ov3det_torch.config import (
    DataConfig,
    DecoderConfig,
    EncoderConfig,
    LossConfig,
    MatcherConfig,
    ModelConfig,
    OptimConfig,
    TeacherConfig,
    TrainConfig,
)
from ov3det_torch.datasets.image_bank import BankRefDataset, build_image_bank
from ov3det_torch.datasets.loader import DataLoader, slice_valid, valid_count
from ov3det_torch.datasets.registry import build_dataset
from ov3det_torch.device import resolve_device
from ov3det_torch.engine.checkpoint import CheckpointManager, restore_eval_checkpoint
from ov3det_torch.engine.infer import make_eval_step
from ov3det_torch.engine.runtime import (
    PreemptionGuard,
    init_multihost,
    plan_ranks,
    profile_steps,
)
from ov3det_torch.engine.train import PackedStep, batch_to_device, build_training, step_seed
from ov3det_torch.eval.ap_calculator import APCalculator
from ov3det_torch.models.detr3d import Model3DETR
from ov3det_torch.models.regionclip import (
    RegionCLIPTeacher,
    calibration_boxes,
    convert_torch_checkpoint,
    init_teacher_state,
    quantize_teacher_params,
)
from ov3det_torch.parallel.mesh import data_group, gather_objects, leave_data_group
from ov3det_torch.utils.logger import Logger
from ov3det_torch.utils.meters import SmoothedValue

def make_args_parser():
    p = argparse.ArgumentParser("Open-vocabulary 3D detection (PyTorch port)")
    # Optimizer (reference main.py:31-41)
    p.add_argument("--base_lr", default=5e-4, type=float)
    p.add_argument("--warm_lr", default=1e-6, type=float)
    p.add_argument("--warm_lr_epochs", default=9, type=int)
    p.add_argument("--final_lr", default=1e-6, type=float)
    p.add_argument("--weight_decay", default=0.1, type=float)
    p.add_argument("--filter_biases_wd", default=False, action="store_true")
    p.add_argument("--clip_gradient", default=0.1, type=float)
    # Encoder (reference main.py:52-62)
    p.add_argument("--enc_type", default="vanilla", choices=["masked", "vanilla"])
    p.add_argument("--enc_nlayers", default=3, type=int)
    p.add_argument("--enc_dim", default=256, type=int)
    p.add_argument("--enc_ffn_dim", default=128, type=int)
    p.add_argument("--enc_dropout", default=0.1, type=float)
    p.add_argument("--enc_nhead", default=4, type=int)
    p.add_argument("--enc_activation", default="relu", type=str)
    # Decoder (reference main.py:64-69)
    p.add_argument("--dec_nlayers", default=8, type=int)
    p.add_argument("--dec_dim", default=256, type=int)
    p.add_argument("--dec_ffn_dim", default=256, type=int)
    p.add_argument("--dec_dropout", default=0.1, type=float)
    p.add_argument("--dec_nhead", default=4, type=int)
    # Other model params (reference main.py:71-86)
    p.add_argument("--mlp_dropout", default=0.3, type=float)
    p.add_argument("--preenc_npoints", default=2048, type=int)
    p.add_argument("--pos_embed", default="fourier", choices=["fourier", "sine"])
    p.add_argument("--nqueries", default=256, type=int)
    p.add_argument("--use_color", default=False, action="store_true")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    # Matcher / losses (reference main.py:89-105)
    p.add_argument("--matcher_giou_cost", default=2, type=float)
    p.add_argument("--matcher_cls_cost", default=1, type=float)
    p.add_argument("--matcher_center_cost", default=0, type=float)
    p.add_argument("--matcher_objectness_cost", default=0, type=float)
    p.add_argument("--loss_giou_weight", default=0, type=float)
    p.add_argument("--matcher_giou", default="rotated", choices=["rotated", "axis_aligned"],
                   help="GIoU flavor for the matcher COST matrix on rotated-box datasets; the "
                   "GIoU loss stays exact either way")
    p.add_argument("--loss_sem_cls_weight", default=1, type=float)
    p.add_argument("--loss_no_object_weight", default=0.2, type=float)
    p.add_argument("--loss_angle_cls_weight", default=0.1, type=float)
    p.add_argument("--loss_angle_reg_weight", default=0.5, type=float)
    p.add_argument("--loss_center_weight", default=5.0, type=float)
    p.add_argument("--loss_size_weight", default=1.0, type=float)
    p.add_argument("--loss_2dalignment_weight", default=0.0, type=float,
                   help="weight of the 2D-alignment loss against the teacher (needs --use_image)")
    # Dataset (reference main.py:107-176)
    p.add_argument("--dataset_name", required=True, choices=["scannet", "sunrgbd", "synthetic"])
    p.add_argument("--dataset_root_dir", type=str, default=None)
    p.add_argument("--meta_data_dir", type=str, default=None)
    p.add_argument("--dataset_num_workers", default=4, type=int,
                   help="worker processes of the data loader (0: none)")
    p.add_argument("--batchsize_per_gpu", default=8, type=int)
    p.add_argument("--super_batch", default=1, type=int,
                   help="train batches a host-to-device copy (one process)")
    p.add_argument("--quantize_points", default=False, action="store_true",
                   help="ship point clouds as per-sample-scaled uint16 (one process)")
    p.add_argument("--yuv_images", default=False, action="store_true",
                   help="ship canvases as 4:2:0 YUV (one process)")
    p.add_argument("--image_bank", default=False, action="store_true",
                   help="every train scene's canvas on the device once, as yuv420 (needs "
                   "--use_image)")
    p.add_argument("--num_points", default=None, type=int)
    p.add_argument("--pseudo_label_dir", type=str, default=None)
    p.add_argument("--clip_embed_path", type=str, default=None,
                   help="the frozen CLIP text-embedding matrix (.npy, or a torch file)")
    p.add_argument("--region_clip_ckpt_path", type=str, default=None,
                   help="RegionCLIP or CLIP checkpoint of the teacher (default: seeded random "
                   "weights)")
    p.add_argument("--teacher_compute_dtype", type=str, default="int8",
                   choices=["int8", "bfloat16", "float32"],
                   help="compute dtype of the frozen RegionCLIP tower (int8: W8A8 trunk convs "
                   "with exact int32 products, calibrated at load)")
    p.add_argument("--feature_2d_dir", type=str, default=None)
    p.add_argument("--use_pbox", default=False, action="store_true")
    p.add_argument("--use_2d_feature", default=False, action="store_true",
                   help="load per-point 2D features with the scenes; NOTE: no training path "
                   "consumes them (faithful to the reference, which also loads and drops them)")
    p.add_argument("--use_image", default=False, action="store_true",
                   help="train the open-vocabulary step: image canvases and the frozen 2D "
                   "teacher (SUN RGB-D or synthetic; ScanNet loads its frames from "
                   "--frames_dir, which no teacher reads)")
    p.add_argument("--frames_dir", type=str, default=None,
                   help="ScanNet frames tree for --use_image")
    p.add_argument("--max_frames", default=64, type=int)
    # Training (reference main.py:178-196)
    p.add_argument("--start_epoch", default=-1, type=int)
    p.add_argument("--max_epoch", default=720, type=int)
    p.add_argument("--eval_every_epoch", default=10, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--test_only", default=False, action="store_true")
    p.add_argument("--test_ckpt", default=None, type=str)
    p.add_argument("--checkpoint_dir", default=None, type=str)
    p.add_argument("--log_every", default=10, type=int)
    p.add_argument("--log_metrics_every", default=20, type=int)
    p.add_argument("--save_separate_checkpoint_every_epoch", default=100, type=int)
    p.add_argument("--ngpus", default=1, type=int,
                   help="data-parallel ranks, one a device (CPU processes with --device cpu)")
    # Observability
    p.add_argument("--profile_dir", default=None, type=str,
                   help="write a torch.profiler trace (Chrome format) of the first "
                   "--profile_steps train iterations here")
    p.add_argument("--profile_steps", default=5, type=int)
    p.add_argument("--eval_loss", default=False, action="store_true",
                   help="compute the criterion during in-training evals and log Test_details/ "
                   "losses (reference engine.py:198-206)")
    p.add_argument("--debug_nans", default=False, action="store_true",
                   help="torch.autograd.set_detect_anomaly for the run (slows every step)")
    # Multi-host
    p.add_argument("--coordinator_address", default=None, type=str,
                   help="host:port of the multi-host rendezvous (process 0's host)")
    p.add_argument("--num_processes", default=None, type=int, help="hosts of a multi-host run")
    p.add_argument("--process_id", default=None, type=int, help="this host's index")
    # The port
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device of the run; cuda raises without a card")
    return p


def config_from_args(args) -> TrainConfig:
    if args.super_batch < 1:
        raise ValueError(f"--super_batch {args.super_batch}: at least 1")
    if args.image_bank and not args.use_image:
        raise ValueError("--image_bank needs --use_image (the bank feeds the 2D teacher)")
    num_semcls = {"scannet": 18, "sunrgbd": 20, "synthetic": 18}[args.dataset_name]
    num_angle_bin = {"scannet": 1, "sunrgbd": 12, "synthetic": 1}[args.dataset_name]
    num_points = args.num_points or {"scannet": 40000, "sunrgbd": 20000,
                                     "synthetic": 2048}[args.dataset_name]
    return TrainConfig(
        model=ModelConfig(
            encoder=EncoderConfig(
                kind=args.enc_type,
                num_layers=args.enc_nlayers,
                dim=args.enc_dim,
                ffn_dim=args.enc_ffn_dim,
                num_heads=args.enc_nhead,
                dropout=args.enc_dropout,
                activation=args.enc_activation,
            ),
            decoder=DecoderConfig(
                num_layers=args.dec_nlayers,
                dim=args.dec_dim,
                ffn_dim=args.dec_ffn_dim,
                num_heads=args.dec_nhead,
                dropout=args.dec_dropout,
            ),
            preenc_npoints=args.preenc_npoints,
            num_queries=args.nqueries,
            mlp_dropout=args.mlp_dropout,
            pos_embed=args.pos_embed,
            use_color=args.use_color,
            num_semcls=num_semcls,
            num_angle_bin=num_angle_bin,
            compute_dtype=args.compute_dtype,
        ),
        loss=LossConfig(
            matcher=MatcherConfig(
                cost_class=args.matcher_cls_cost,
                cost_objectness=args.matcher_objectness_cost,
                cost_center=args.matcher_center_cost,
                cost_giou=args.matcher_giou_cost,
            ),
            giou_weight=args.loss_giou_weight,
            matcher_giou=args.matcher_giou,
            sem_cls_weight=args.loss_sem_cls_weight,
            no_object_weight=args.loss_no_object_weight,
            angle_cls_weight=args.loss_angle_cls_weight,
            angle_reg_weight=args.loss_angle_reg_weight,
            center_weight=args.loss_center_weight,
            size_weight=args.loss_size_weight,
            alignment_2d_weight=args.loss_2dalignment_weight,
        ),
        optim=OptimConfig(
            base_lr=args.base_lr,
            warm_lr=args.warm_lr,
            warm_lr_epochs=args.warm_lr_epochs,
            final_lr=args.final_lr,
            weight_decay=args.weight_decay,
            filter_biases_wd=args.filter_biases_wd,
            clip_gradient=args.clip_gradient,
        ),
        data=DataConfig(
            dataset_name=args.dataset_name,
            root_dir=args.dataset_root_dir,
            meta_data_dir=args.meta_data_dir,
            pseudo_label_dir=args.pseudo_label_dir,
            feature_2d_dir=args.feature_2d_dir,
            num_points=num_points,
            use_color=args.use_color,
            use_pbox=args.use_pbox,
            use_2d_feature=args.use_2d_feature,
            use_image=args.use_image,
            frames_dir=args.frames_dir,
            max_frames=args.max_frames,
            num_workers=args.dataset_num_workers,
            batch_size_per_device=args.batchsize_per_gpu,
            image_bank=args.image_bank,
            super_batch=args.super_batch,
            quantize_points=args.quantize_points,
            yuv_images=args.yuv_images,
        ),
        teacher=TeacherConfig(
            enabled=args.use_image,
            checkpoint_path=args.region_clip_ckpt_path,
            text_embed_path=args.clip_embed_path,
            compute_dtype=args.teacher_compute_dtype,
        ),
        max_epoch=args.max_epoch,
        eval_every_epoch=args.eval_every_epoch,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        log_every=args.log_every,
        log_metrics_every=args.log_metrics_every,
        save_separate_checkpoint_every_epoch=args.save_separate_checkpoint_every_epoch,
        num_devices=args.ngpus,
        profile_dir=args.profile_dir,
        profile_steps=args.profile_steps,
        debug_nans=args.debug_nans,
        eval_loss=args.eval_loss,
    )


def load_text_embed(model: Model3DETR, path) -> None:
    """Copy the frozen CLIP text-embedding matrix (reference
    models/model_3detr.py:417-419 loads a torch file; .npy accepted too) into
    the model."""
    if path is None:
        return
    if path.endswith(".npy"):
        emb = torch.from_numpy(np.load(path))
    else:
        emb = torch.load(path, map_location="cpu", weights_only=True)
    if tuple(emb.shape) != tuple(model.text_embed.shape):
        raise ValueError(f"{path}: shape {tuple(emb.shape)}, expected {tuple(model.text_embed.shape)}")
    with torch.no_grad():
        model.text_embed.copy_(emb.float())


def build_teacher(cfg: TrainConfig, example: dict, device=None) -> RegionCLIPTeacher:
    """The frozen RegionCLIP teacher of the 2D-alignment loss, loaded on
    `device`: CUDA unless the caller passes "cpu", and raises when CUDA is
    asked for and absent (`ov3det/main.py:293-341`, `build_teacher_fn`; the
    port's step makes its hook from the teacher, `build_training(...,
    teacher=)`).

    Its weights: `cfg.teacher.checkpoint_path` converted, else seeded random
    ones (seed 0).  In int8, the activation scales are calibrated on
    `example`'s canvas (one sample of the schema: the first of the test
    split) with eight `default_rng(0)` boxes inside its image, as JAX
    calibrates on its example batch's first canvas; all of it is
    deterministic, so a resumed run rebuilds the same teacher."""
    if "image" not in example:
        raise ValueError(f"--use_image on {cfg.data.dataset_name}: its batch has no 'image' "
                         "canvas, so it feeds no teacher (ScanNet's batch holds frames: "
                         "images, depths, poses; the JAX package stops here too, "
                         "ov3det/main.py:313)")
    device = resolve_device(device)
    dtype = cfg.teacher.compute_dtype
    teacher = RegionCLIPTeacher(embed_dim=cfg.model.clip_embed_dim,
                                compute_dtype=None if dtype == "float32" else dtype,
                                device=device)
    if cfg.teacher.checkpoint_path:
        state = convert_torch_checkpoint(cfg.teacher.checkpoint_path, teacher.hparams["layers"])
    else:
        print("WARNING: no --region_clip_ckpt_path; teacher runs with random "
              "weights (distillation targets are meaningless)")
        state = init_teacher_state(teacher, seed=0)
    calib = None
    if dtype == "int8":
        image = np.asarray(example["image"], np.float32)[None]
        boxes = calibration_boxes(np.random.default_rng(0), float(example["image_height"]),
                                  float(example["image_width"]))
        calib = (image, boxes)
    state = {k: v.to(device) for k, v in state.items()}
    return teacher.load(quantize_teacher_params(state, dtype, teacher=teacher, calib=calib))


def gather_ap(ap: APCalculator, counts: list) -> APCalculator:
    """Under a data group, a calculator over the scans of every rank in the
    global batch order (batch by batch, rank by rank), on every rank (rank 0
    scores it); `ap` itself without one.  counts: the scans `ap` took from
    each batch."""
    parts = gather_objects((ap.pred_map_cls, ap.gt_map_cls, counts))
    if len(parts) == 1:
        return ap
    merged = APCalculator(ap_iou_thresh=ap.ap_iou_thresh, class2type_map=ap.class2type_map,
                          exact_eval=ap.exact_eval, ap_config_dict=ap.ap_config_dict,
                          eval_processes=ap.eval_processes)
    taken = [0] * len(parts)
    for j in range(len(counts)):
        for r, (pred, gt, cnt) in enumerate(parts):
            scans = range(taken[r], taken[r] + cnt[j])
            merged.accumulate([pred[i] for i in scans], [gt[i] for i in scans])
            taken[r] += cnt[j]
    return merged


def evaluate(eval_step, loader, dataset_config, device, logger=None, curr_iter=0,
             eval_processes: int = 0):
    """The eval pass over `loader` (`ov3det/main.py:344-376`): the AP
    calculator of its detections (gathered over a data group), the loss
    logged with `--eval_loss`.  `eval_processes` > 0 scores the classes in
    a process pool."""
    ap = APCalculator(class2type_map=dataset_config.class2type, eval_processes=eval_processes)
    loss_meter = SmoothedValue(10)
    last_loss_dict = None
    counts = []
    for batch in loader:
        # partial final batch: the loader padded it to the full batch size
        # by repeating the last sample; strip the pad so each scan scores once
        # (under a data group a rank's rows may all be pad)
        n = valid_count(batch)
        batch = batch_to_device(batch, device, non_blocking=True)
        outputs = eval_step(batch)
        if isinstance(outputs, tuple):  # --eval_loss: (outputs, loss_dict)
            outputs, last_loss_dict = outputs
            loss_meter.update(float(last_loss_dict["loss"]))
        if n:
            ap.step_meter(slice_valid(outputs, n), slice_valid(batch, n))
        counts.append(n)
    if logger is not None and last_loss_dict is not None:
        # the reference logs the last batch's loss breakdown under
        # Test_details/ and the smoothed total under Test/ (engine.py:226-229)
        logger.log_scalars({k: float(v) for k, v in last_loss_dict.items()}, curr_iter,
                           prefix="Test_details/")
        logger.log_scalars({"loss": loss_meter.avg}, curr_iter, prefix="Test/")
    return gather_ap(ap, counts)


def crossed(curr_iter: int, g: int, every: int) -> bool:
    """Whether the item of `g` batches ending at `curr_iter` holds a
    multiple of `every` (`curr_iter % every == 0` when g is 1)."""
    return curr_iter // every > (curr_iter - g) // every


def _host_scalars(metrics: dict) -> dict:
    """Device scalars -> floats, in one device-to-host copy."""
    values = torch.stack([v.detach().float().reshape(()) for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


def eval_graph_flag(cfg: TrainConfig) -> Optional[bool]:
    """The eval step's `graph`: False under `--debug_nans` (eager, for its
    per-op tracebacks), else None (a CUDA graph on a card)."""
    return False if cfg.debug_nans else None


def _ranks() -> tuple:
    """(rank, world) of the data group, (0, 1) without one."""
    group = data_group()
    return (group.rank, group.world) if group is not None else (0, 1)


def _quiet(*args, **kwargs) -> None:
    """`print` of a rank other than 0."""


def do_train(cfg: TrainConfig, device=None):
    device = resolve_device(device)
    pin = device.type == "cuda"
    rank, world = _ranks()
    lead = rank == 0
    say = print if lead else _quiet
    datasets, dataset_config = build_dataset(cfg.data)
    image_bank = None
    if cfg.data.image_bank:
        # the canvases on the device once; train batches carry image_ref
        image_bank = build_image_bank(datasets["train"], device)
        datasets = {**datasets, "train": BankRefDataset(datasets["train"])}
        say(f"image bank: {image_bank[0].shape[0]} canvases of {image_bank[1][0]} x "
            f"{image_bank[1][1]} as yuv420, {image_bank[0].numel()} bytes on {device}")
    batch_size = cfg.data.batch_size_per_device * world  # the global batch
    loader_kw = dict(num_workers=cfg.data.num_workers, pin_memory=pin, process_index=rank,
                     process_count=world)
    # one process: the packed transfer and its codecs (JAX's main.py:395-436)
    packed = world == 1
    quantize = (("point_clouds",) if cfg.data.quantize_points else ()) + (
        ("image",) if cfg.data.yuv_images else ())
    train_loader = DataLoader(
        datasets["train"], batch_size=batch_size, shuffle=True, seed=cfg.seed,
        **(dict(transfer="packed", super_batch=cfg.data.super_batch, quantize=quantize,
                encode_cache=("image",) if cfg.data.yuv_images else (), device=device)
           if packed else {}),
        **loader_kw)
    test_loader = DataLoader(datasets["test"], batch_size=batch_size, shuffle=False,
                             drop_last=False, **loader_kw)
    iters_per_epoch = len(train_loader)
    teacher = build_teacher(cfg, datasets["test"][0], device) if cfg.teacher.enabled else None
    training = build_training(cfg, iters_per_epoch, device=device, seed=cfg.seed,
                              eval_loss=cfg.eval_loss, teacher=teacher, image_bank=image_bank,
                              eval_graph=eval_graph_flag(cfg))
    model, optimizer = training.model, training.optimizer
    train_step, eval_step, schedule = training.train_step, training.eval_step, training.schedule
    load_text_embed(model, cfg.teacher.text_embed_path)
    # captured at its first call, after the restore below (in-place copies)
    packed_step = (PackedStep(training, cfg.seed, device,
                              graph=device.type == "cuda" and not cfg.debug_nans)
                   if packed else None)

    if not cfg.checkpoint_dir:
        raise ValueError("set --checkpoint_dir")
    ckpt = CheckpointManager(cfg.checkpoint_dir)
    restored, loaded_epoch, extra = ckpt.restore(model, optimizer)
    # the reference persists best_val_metrics inside checkpoint.pth and
    # restores it on resume (utils/io.py:33-58), so that a preemption-resume
    # never lets a worse eval overwrite checkpoint_best
    best_ap25 = float((extra or {}).get("best_ap25", -1.0))
    if restored is not None:
        say(f"resumed from epoch {loaded_epoch} (best AP25 {best_ap25:.4f})")
    start_epoch = loaded_epoch + 1

    final_eval = os.path.join(cfg.checkpoint_dir, "final_eval.txt")
    final_eval_pkl = os.path.join(cfg.checkpoint_dir, "final_eval.pkl")
    if os.path.isfile(final_eval):
        say(f"Found final eval file {final_eval}. Skipping training.")
        return training

    # rank 0 alone logs and writes checkpoints
    logger = Logger(cfg.checkpoint_dir if lead else None)
    guard = PreemptionGuard()
    generator = torch.Generator(device=device)
    best_metrics = {}
    max_iters = cfg.max_epoch * iters_per_epoch
    profiled = profile_done = False
    try:
        for epoch in range(start_epoch, cfg.max_epoch):
            train_loader.set_epoch(epoch)
            time_meter, loss_meter = SmoothedValue(10), SmoothedValue(10)
            train_ap = APCalculator(class2type_map=dataset_config.class2type, exact_eval=False)
            train_ap_counts = []
            it = 0  # batch index within the epoch (a packed item may carry G batches)
            with contextlib.ExitStack() as profiling:
                for item in train_loader:
                    if guard.stop_requested():
                        # preemption: persist the latest state and exit cleanly
                        if lead:
                            ckpt.save_latest(model, optimizer, epoch - 1,
                                             extra={"best_ap25": best_ap25})
                        say("preemption signal received; checkpoint saved, exiting")
                        return training
                    t0 = time.time()
                    g = item[0].shape[0] if packed else 1
                    # the bookkeeping refers to the LAST batch the item carries
                    curr_iter = epoch * iters_per_epoch + it + g - 1
                    global_it = curr_iter - start_epoch * iters_per_epoch
                    if cfg.profile_dir and not profiled and global_it >= 1:  # skip the warm-up
                        profiling.enter_context(profile_steps(cfg.profile_dir))
                        profiled = True
                    if packed:
                        metrics, batch = packed_step(item[0], item[1], curr_iter - g + 1)
                    else:
                        batch = batch_to_device(item, device, non_blocking=True)
                        generator.manual_seed(step_seed(cfg.seed, curr_iter))
                        metrics = train_step(batch, generator)
                    if profiled and not profile_done and global_it >= cfg.profile_steps:
                        profiling.close()
                        profile_done = True
                        say(f"profiler trace written to {cfg.profile_dir}")
                    if crossed(curr_iter, g, cfg.log_metrics_every):
                        outputs = eval_step(batch)  # the item's last batch
                        if isinstance(outputs, tuple):  # --eval_loss variant
                            outputs = outputs[0]
                        train_ap.step_meter(outputs, batch)
                        train_ap_counts.append(int(batch["point_clouds"].shape[0]))
                    if crossed(curr_iter, g, cfg.log_every):
                        scalars = _host_scalars(metrics)
                        loss = scalars["loss"]
                        if not math.isfinite(loss):
                            say("Loss is not finite. Training stopped.")
                            sys.exit(1)
                        loss_meter.update(loss)
                        time_meter.update((time.time() - t0) / g)
                        lr = schedule(curr_iter)
                        eta = (max_iters - curr_iter) * time_meter.avg
                        say(
                            f"Epoch [{epoch}/{cfg.max_epoch}]; Iter [{curr_iter}/{max_iters}]; "
                            f"Loss {loss_meter.avg:0.2f}; LR {lr:0.2e}; "
                            f"Iter time {time_meter.avg:0.2f}; ETA {eta:0.0f}s"
                        )
                        logger.log_scalars(scalars, curr_iter, prefix="Train_details/")
                        logger.log_scalars(
                            {"lr": lr, "loss": loss_meter.avg, "batch_time": time_meter.avg},
                            curr_iter,
                            prefix="Train/",
                        )
                    it += g

            if lead:
                ckpt.save_latest(model, optimizer, epoch, extra={"best_ap25": best_ap25})
                if (
                    epoch > 0
                    and cfg.save_separate_checkpoint_every_epoch > 0
                    and epoch % cfg.save_separate_checkpoint_every_epoch == 0
                ):
                    ckpt.save_periodic(model, optimizer, epoch)

            # the APs: the ranks' detections gathered, scored by rank 0
            train_ap = gather_ap(train_ap, train_ap_counts)
            if lead:
                metrics_all = train_ap.compute_metrics()
                print(f"Epoch [{epoch}/{cfg.max_epoch}] train "
                      + train_ap.metrics_to_str(metrics_all, per_class=False))
                logger.log_scalars(train_ap.metrics_to_dict(metrics_all),
                                   epoch * iters_per_epoch, prefix="Train/")

            if epoch % cfg.eval_every_epoch == 0 or epoch == cfg.max_epoch - 1:
                ap = evaluate(eval_step, test_loader, dataset_config, device,
                              logger=logger, curr_iter=epoch * iters_per_epoch)
                if lead:
                    m = ap.compute_metrics()
                    ap25 = m[0.25]["mAP"]
                    print(f"Evaluate Epoch [{epoch}/{cfg.max_epoch}]")
                    print(ap.metrics_to_str(m, per_class=True))
                    logger.log_scalars(ap.metrics_to_dict(m), epoch * iters_per_epoch,
                                       prefix="Test/")
                    if ap25 > best_ap25:
                        best_ap25 = ap25
                        best_metrics = m
                        ckpt.save_best(model, optimizer, epoch, extra={"best_ap25": best_ap25})
                        # refresh the latest checkpoint's bookkeeping too: it was
                        # written before this eval, and resume reads best_ap25 from it
                        ckpt.write_extra({"best_ap25": best_ap25})
                        print(f"saved new best checkpoint (AP25 {ap25:.4f})")

        # final eval
        ap = evaluate(eval_step, test_loader, dataset_config, device)
        if lead:
            m = ap.compute_metrics()
            with open(final_eval, "w") as fh:
                fh.write("Training Finished.\nFinal Eval Numbers.\n")
                fh.write(ap.metrics_to_str(m))
                fh.write("\nBest Eval Numbers.\n")
                fh.write(ap.metrics_to_str(best_metrics) if best_metrics else "n/a")
            with open(final_eval_pkl, "wb") as fh:
                pickle.dump(m, fh)
    finally:
        logger.close()
        guard.restore()
    return training


def test_model(cfg: TrainConfig, test_ckpt: str | None = None, device=None):
    device = resolve_device(device)
    rank, world = _ranks()
    datasets, dataset_config = build_dataset(cfg.data, splits=("test",))
    test_loader = DataLoader(datasets["test"], batch_size=cfg.data.batch_size_per_device * world,
                             shuffle=False, drop_last=False, num_workers=cfg.data.num_workers,
                             pin_memory=device.type == "cuda", process_index=rank,
                             process_count=world)
    model = Model3DETR(cfg.model, device=device, seed=cfg.seed)
    epoch = restore_eval_checkpoint(model, test_ckpt, cfg.checkpoint_dir)
    ap = evaluate(make_eval_step(model, graph=eval_graph_flag(cfg)), test_loader, dataset_config,
                  device)
    if rank != 0:  # rank 0 scores the gathered detections
        return None
    m = ap.compute_metrics()
    print(f"Test model (epoch {epoch}); Metrics:")
    print(ap.metrics_to_str(m))
    return m


def run(args, cfg: TrainConfig, device):
    """`test_model` or `do_train` on `device`, in this process."""
    np.random.seed(cfg.seed)
    # --debug_nans: per-op NaN tracebacks (the reference's always-on
    # torch.autograd.set_detect_anomaly, as an opt-in)
    with torch.autograd.set_detect_anomaly(cfg.debug_nans):
        if args.test_only:
            return test_model(cfg, test_ckpt=args.test_ckpt, device=device)
        return do_train(cfg, device)


def run_rank(local_rank: int, argv, plan) -> None:
    """One rank of a data-parallel run (a spawned process, or this one under
    torchrun): join the group, run, leave it."""
    import torch.distributed as dist

    args = make_args_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank)
    else:  # the host's cores shared among its ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // plan.local))
    init_multihost(plan, local_rank, device)
    try:
        run(args, cfg, device)
        # leave together: no rank closes its gloo pairs while another still
        # holds them (a failed rank skips this, so that none waits for it)
        dist.barrier()
    finally:
        leave_data_group()


def main(argv=None):
    """Runs the CLI on `argv`; returns `test_model`'s metrics or
    `do_train`'s `Training`, in this process.  `--ngpus` > 1 spawns a
    process a rank of this host, waits for them and returns None (a rank
    that fails raises here); a data group initialised by the caller runs in
    this process."""
    args = make_args_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    if data_group() is not None:
        return run(args, cfg, device)
    plan = plan_ranks(args.ngpus, args.coordinator_address, args.num_processes, args.process_id)
    if device.type == "cuda" and plan.local > torch.cuda.device_count():
        raise ValueError(f"--ngpus {args.ngpus}: {plan.local} ranks on this host, "
                         f"{torch.cuda.device_count()} CUDA devices visible")
    if plan.world == 1:
        return run(args, cfg, device)
    argv = sys.argv[1:] if argv is None else list(argv)
    if plan.init_method == "env://":  # torchrun started this rank
        return run_rank(int(os.environ.get("LOCAL_RANK", 0)), argv, plan)
    import torch.multiprocessing as mp

    mp.start_processes(run_rank, args=(argv, plan), nprocs=plan.local, start_method="spawn")
    return None


if __name__ == "__main__":
    main()
