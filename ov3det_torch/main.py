"""Training / evaluation entry point of the port: `python -m ov3det_torch.main`.

Counterpart of `ov3det/main.py:50-717` (reference main.py:28-506,
engine.py:47-302): the same argparse surface, cosine-warmup schedule,
latest / best / periodic checkpoints, resume-on-restart, idempotent
final_eval guard, approximate train-time AP and exact eval AP, and a
NaN-loss abort, with the same printed lines and `scalars.jsonl` keys.  One
process on one device: `--device` (default `cuda`, which raises without a
card; `cpu` on request).

`--use_image` trains the open-vocabulary step: the frozen RegionCLIP
RN50x4 teacher (`--teacher_compute_dtype`, int8 by default, calibrated on
the first canvas of the test split; seeded random weights unless
`--region_clip_ckpt_path` names a checkpoint) feeds the 2D-alignment loss
(`--loss_2dalignment_weight`).  Flags the port cannot honour yet raise
`NotImplementedError` naming the ROADMAP item that brings them; none is
ignored.  The dropout masks of
training step `i` come from a generator on the device seeded from
`(seed, i)`, as the JAX package builds its key from `[seed, i]`, so a resume
needs no RNG state.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import pickle
import sys
import time

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
from ov3det_torch.datasets.loader import DataLoader, slice_valid, valid_count
from ov3det_torch.datasets.registry import build_dataset
from ov3det_torch.device import resolve_device
from ov3det_torch.engine.checkpoint import CheckpointManager, restore_eval_checkpoint
from ov3det_torch.engine.infer import make_eval_step
from ov3det_torch.engine.runtime import PreemptionGuard, profile_steps
from ov3det_torch.engine.train import batch_to_device, build_training
from ov3det_torch.eval.ap_calculator import APCalculator
from ov3det_torch.models.detr3d import Model3DETR
from ov3det_torch.models.regionclip import (
    RegionCLIPTeacher,
    calibration_boxes,
    convert_torch_checkpoint,
    init_teacher_state,
    quantize_teacher_params,
)
from ov3det_torch.utils.logger import Logger
from ov3det_torch.utils.meters import SmoothedValue

_IMAGE_BANK = "ROADMAP Queue 1 item 8 (the device image bank and its yuv420 codec)"
_DDP = "ROADMAP Queue 1 item 6 (multi-GPU)"
_TRANSPORT = ("ROADMAP Queue 3 item 1 (the TPU transport's packed steps; their counterpart on "
              "the card is graph capture of the step, see PERF.md)")

# (flag, the test that it was given, the item that brings it)
REFUSED = (
    ("--ngpus", lambda a: a.ngpus > 1, _DDP),
    ("--coordinator_address", lambda a: a.coordinator_address is not None, _DDP),
    ("--num_processes", lambda a: a.num_processes is not None, _DDP),
    ("--image_bank", lambda a: a.image_bank, _IMAGE_BANK),
    ("--super_batch", lambda a: a.super_batch > 1, _TRANSPORT),
    ("--quantize_points", lambda a: a.quantize_points, _TRANSPORT),
    ("--yuv_images", lambda a: a.yuv_images, _TRANSPORT),
)


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
    p.add_argument("--super_batch", default=1, type=int, help=f"> 1 is refused: {_TRANSPORT}")
    p.add_argument("--quantize_points", default=False, action="store_true",
                   help=f"refused: {_TRANSPORT}")
    p.add_argument("--yuv_images", default=False, action="store_true",
                   help=f"refused: {_TRANSPORT}")
    p.add_argument("--image_bank", default=False, action="store_true",
                   help=f"not ported yet: {_IMAGE_BANK}")
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
                   "teacher (synthetic data only; the real datasets' image branches are "
                   "ROADMAP Queue 1 item 9)")
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
    p.add_argument("--ngpus", default=1, type=int, help=f"> 1 is not ported yet: {_DDP}")
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
                   help=f"not ported yet: {_DDP}")
    p.add_argument("--num_processes", default=None, type=int, help=f"not ported yet: {_DDP}")
    p.add_argument("--process_id", default=None, type=int)
    # The port
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device of the run; cuda raises without a card")
    return p


def refuse_unported(args) -> None:
    """Raise NotImplementedError for the first flag the port cannot honour."""
    for flag, given, item in REFUSED:
        if given(args):
            raise NotImplementedError(f"{flag} is not ported: {item}")


def config_from_args(args) -> TrainConfig:
    refuse_unported(args)
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
            num_workers=args.dataset_num_workers,
            batch_size_per_device=args.batchsize_per_gpu,
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


def step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed of training step `step`: the JAX
    package's key `[seed, step]` as one 64-bit integer."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def evaluate(eval_step, loader, dataset_config, device, logger=None, curr_iter=0):
    ap = APCalculator(class2type_map=dataset_config.class2type)
    loss_meter = SmoothedValue(10)
    last_loss_dict = None
    for batch in loader:
        # partial final batch: the loader padded it to the full batch size
        # by repeating the last sample; strip the pad so each scan scores once
        n = valid_count(batch)
        batch = batch_to_device(batch, device, non_blocking=True)
        outputs = eval_step(batch)
        if isinstance(outputs, tuple):  # --eval_loss: (outputs, loss_dict)
            outputs, last_loss_dict = outputs
            loss_meter.update(float(last_loss_dict["loss"]))
        ap.step_meter(slice_valid(outputs, n), slice_valid(batch, n))
    if logger is not None and last_loss_dict is not None:
        # the reference logs the last batch's loss breakdown under
        # Test_details/ and the smoothed total under Test/ (engine.py:226-229)
        logger.log_scalars({k: float(v) for k, v in last_loss_dict.items()}, curr_iter,
                           prefix="Test_details/")
        logger.log_scalars({"loss": loss_meter.avg}, curr_iter, prefix="Test/")
    return ap


def _host_scalars(metrics: dict) -> dict:
    """Device scalars -> floats, in one device-to-host copy."""
    values = torch.stack([v.detach().float().reshape(()) for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


def do_train(cfg: TrainConfig, device=None):
    device = resolve_device(device)
    pin = device.type == "cuda"
    datasets, dataset_config = build_dataset(cfg.data)
    batch_size = cfg.data.batch_size_per_device
    train_loader = DataLoader(datasets["train"], batch_size=batch_size, shuffle=True,
                              num_workers=cfg.data.num_workers, seed=cfg.seed, pin_memory=pin)
    test_loader = DataLoader(datasets["test"], batch_size=batch_size, shuffle=False,
                             drop_last=False, num_workers=cfg.data.num_workers, pin_memory=pin)
    iters_per_epoch = len(train_loader)
    teacher = build_teacher(cfg, datasets["test"][0], device) if cfg.teacher.enabled else None
    training = build_training(cfg, iters_per_epoch, device=device, seed=cfg.seed,
                              eval_loss=cfg.eval_loss, teacher=teacher)
    model, optimizer = training.model, training.optimizer
    train_step, eval_step, schedule = training.train_step, training.eval_step, training.schedule
    load_text_embed(model, cfg.teacher.text_embed_path)

    if not cfg.checkpoint_dir:
        raise ValueError("set --checkpoint_dir")
    ckpt = CheckpointManager(cfg.checkpoint_dir)
    restored, loaded_epoch, extra = ckpt.restore(model, optimizer)
    # the reference persists best_val_metrics inside checkpoint.pth and
    # restores it on resume (utils/io.py:33-58), so that a preemption-resume
    # never lets a worse eval overwrite checkpoint_best
    best_ap25 = float((extra or {}).get("best_ap25", -1.0))
    if restored is not None:
        print(f"resumed from epoch {loaded_epoch} (best AP25 {best_ap25:.4f})")
    start_epoch = loaded_epoch + 1

    final_eval = os.path.join(cfg.checkpoint_dir, "final_eval.txt")
    final_eval_pkl = os.path.join(cfg.checkpoint_dir, "final_eval.pkl")
    if os.path.isfile(final_eval):
        print(f"Found final eval file {final_eval}. Skipping training.")
        return training

    logger = Logger(cfg.checkpoint_dir)
    guard = PreemptionGuard()
    generator = torch.Generator(device=device)
    best_metrics = {}
    max_iters = cfg.max_epoch * iters_per_epoch
    try:
        for epoch in range(start_epoch, cfg.max_epoch):
            train_loader.set_epoch(epoch)
            time_meter, loss_meter = SmoothedValue(10), SmoothedValue(10)
            train_ap = APCalculator(class2type_map=dataset_config.class2type, exact_eval=False)
            with contextlib.ExitStack() as profiling:
                for it, batch in enumerate(train_loader):
                    if guard.should_stop:
                        # preemption: persist the latest state and exit cleanly
                        ckpt.save_latest(model, optimizer, epoch - 1,
                                         extra={"best_ap25": best_ap25})
                        print("preemption signal received; checkpoint saved, exiting")
                        return training
                    t0 = time.time()
                    curr_iter = epoch * iters_per_epoch + it
                    global_it = curr_iter - start_epoch * iters_per_epoch
                    if cfg.profile_dir and global_it == 1:  # skip the first, warm-up step
                        profiling.enter_context(profile_steps(cfg.profile_dir))
                    batch = batch_to_device(batch, device, non_blocking=True)
                    generator.manual_seed(step_seed(cfg.seed, curr_iter))
                    metrics = train_step(batch, generator)
                    if cfg.profile_dir and global_it == cfg.profile_steps:
                        profiling.close()
                        print(f"profiler trace written to {cfg.profile_dir}")
                    if curr_iter % cfg.log_metrics_every == 0:
                        outputs = eval_step(batch)
                        if isinstance(outputs, tuple):  # --eval_loss variant
                            outputs = outputs[0]
                        train_ap.step_meter(outputs, batch)
                    if curr_iter % cfg.log_every == 0:
                        scalars = _host_scalars(metrics)
                        loss = scalars["loss"]
                        if not math.isfinite(loss):
                            print("Loss is not finite. Training stopped.")
                            sys.exit(1)
                        loss_meter.update(loss)
                        time_meter.update(time.time() - t0)
                        lr = schedule(curr_iter)
                        eta = (max_iters - curr_iter) * time_meter.avg
                        print(
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

            ckpt.save_latest(model, optimizer, epoch, extra={"best_ap25": best_ap25})
            if (
                epoch > 0
                and cfg.save_separate_checkpoint_every_epoch > 0
                and epoch % cfg.save_separate_checkpoint_every_epoch == 0
            ):
                ckpt.save_periodic(model, optimizer, epoch)

            metrics_all = train_ap.compute_metrics()
            print(f"Epoch [{epoch}/{cfg.max_epoch}] train "
                  + train_ap.metrics_to_str(metrics_all, per_class=False))
            logger.log_scalars(train_ap.metrics_to_dict(metrics_all), epoch * iters_per_epoch,
                               prefix="Train/")

            if epoch % cfg.eval_every_epoch == 0 or epoch == cfg.max_epoch - 1:
                ap = evaluate(eval_step, test_loader, dataset_config, device,
                              logger=logger, curr_iter=epoch * iters_per_epoch)
                m = ap.compute_metrics()
                ap25 = m[0.25]["mAP"]
                print(f"Evaluate Epoch [{epoch}/{cfg.max_epoch}]")
                print(ap.metrics_to_str(m, per_class=True))
                logger.log_scalars(ap.metrics_to_dict(m), epoch * iters_per_epoch, prefix="Test/")
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
    datasets, dataset_config = build_dataset(cfg.data, splits=("test",))
    test_loader = DataLoader(datasets["test"], batch_size=cfg.data.batch_size_per_device,
                             shuffle=False, drop_last=False, num_workers=cfg.data.num_workers,
                             pin_memory=device.type == "cuda")
    model = Model3DETR(cfg.model, device=device, seed=cfg.seed)
    epoch = restore_eval_checkpoint(model, test_ckpt, cfg.checkpoint_dir)
    ap = evaluate(make_eval_step(model), test_loader, dataset_config, device)
    m = ap.compute_metrics()
    print(f"Test model (epoch {epoch}); Metrics:")
    print(ap.metrics_to_str(m))
    return m


def main(argv=None):
    """Runs the CLI on `argv`; returns `test_model`'s metrics or
    `do_train`'s `Training`."""
    args = make_args_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    np.random.seed(cfg.seed)
    # --debug_nans: per-op NaN tracebacks (the reference's always-on
    # torch.autograd.set_detect_anomaly, as an opt-in)
    with torch.autograd.set_detect_anomaly(cfg.debug_nans):
        if args.test_only:
            return test_model(cfg, test_ckpt=args.test_ckpt, device=device)
        return do_train(cfg, device)


if __name__ == "__main__":
    main()
