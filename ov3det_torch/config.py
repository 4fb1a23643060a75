"""Configuration of the PyTorch port.

Copies of the JAX package's config tree (`ov3det/config.py:15-134,
191-251`): model, matcher, loss, optimiser, the data fields the training
step reads, and the run config.  They are kept here so that the port
imports nothing of the JAX package.  Field names and defaults are the same.

Two fields of the JAX `ModelConfig` have no counterpart: `fps_shards` and
`query_fps_shards` select an approximate strided FPS on non-TPU backends.
The port always runs exact greedy FPS, as the TPU kernel does.

Configurations outside the ported slices raise `NotImplementedError`: the
`first_k` ball query.  The open-vocabulary step is ported: `TeacherConfig`,
`LossConfig.teacher_per_layer` and `DataConfig.use_image` are copies;
`use_image` gives the teacher SUN RGB-D's or the synthetic set's canvases,
and ScanNet's frames (`frames_dir`, `max_frames`).  `TrainConfig.num_devices`
(`--ngpus`, the ranks of data parallelism), `DataConfig.image_bank` (the
device image bank) and the packed transfer's `DataConfig.super_batch`,
`quantize_points` and `yuv_images` are copies too.  The masked encoder (3DETR-m) is
built from `scannet_quick()` with `dataclasses.replace`, as
`scripts/scannet_masked_timing.py` builds it; there is no function of its
own, in either package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class EncoderConfig:
    """Transformer encoder (reference main.py:52-62)."""

    kind: str = "vanilla"  # "vanilla" | "masked"
    num_layers: int = 3
    dim: int = 256
    ffn_dim: int = 128
    num_heads: int = 4
    dropout: float = 0.1
    activation: str = "relu"
    # Distance thresholds of the masked layers, kept as the reference has
    # them: it squares [0.4, 0.8, 1.2] and compares the unsquared distance
    # with the result, so the squared radii in effect are r * r =
    # 0.0256 / 0.4096 / 2.0736.
    masking_radius: tuple[float, ...] = (0.4**2, 0.8**2, 1.2**2)


@dataclass(frozen=True)
class DecoderConfig:
    """Transformer decoder (reference main.py:64-69)."""

    num_layers: int = 8
    dim: int = 256
    ffn_dim: int = 256
    num_heads: int = 4
    dropout: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    """3DETR detector (reference main.py:43-86, models/model_3detr.py)."""

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    preenc_npoints: int = 2048
    num_queries: int = 256
    mlp_dropout: float = 0.3
    pos_embed: str = "fourier"  # "fourier" | "sine"
    use_color: bool = False
    num_semcls: int = 18
    num_angle_bin: int = 1
    clip_embed_dim: int = 640
    preenc_radius: float = 0.2
    preenc_nsample: int = 64
    preenc_mlp: tuple[int, ...] = (64, 128, 256)
    # the masked encoder's interim set abstraction after its layer 0
    interim_radius: float = 0.4
    interim_nsample: int = 32
    interim_mlp: tuple[int, ...] = (256, 256, 256)
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    ball_query_method: str = "bucketed"  # "bucketed" | "first_k" (reference checkpoints)

    def __post_init__(self):
        if self.encoder.kind not in ("vanilla", "masked"):
            raise ValueError(f"unknown encoder kind {self.encoder.kind!r}")
        if self.encoder.kind == "masked" and len(self.encoder.masking_radius) != self.encoder.num_layers:
            raise ValueError("masking_radius needs one radius per encoder layer")
        if self.ball_query_method not in ("bucketed", "first_k"):
            raise ValueError(f"unknown ball_query_method {self.ball_query_method!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.pos_embed not in ("fourier", "sine"):
            raise ValueError(f"unknown pos_embed {self.pos_embed!r}")


@dataclass(frozen=True)
class MatcherConfig:
    """Hungarian matcher costs (reference main.py:89-93)."""

    cost_class: float = 1.0
    cost_objectness: float = 0.0
    cost_center: float = 0.0
    cost_giou: float = 2.0


@dataclass(frozen=True)
class LossConfig:
    """Loss weights (reference main.py:95-105)."""

    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    giou_weight: float = 0.0
    sem_cls_weight: float = 1.0
    no_object_weight: float = 0.2
    angle_cls_weight: float = 0.1
    angle_reg_weight: float = 0.5
    center_weight: float = 5.0
    size_weight: float = 1.0
    alignment_2d_weight: float = 0.0
    giou_compute_dtype: str = "float32"  # "float32" | "bfloat16"
    matcher_giou: str = "rotated"  # "rotated" | "axis_aligned"
    # run the frozen 2D teacher on every decoder layer's boxes (the
    # reference's criterion.py:434-442, L times the teacher's cost) instead
    # of once on the final layer's, shared by the aux losses
    teacher_per_layer: bool = False

    def __post_init__(self):
        if self.giou_compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown giou_compute_dtype {self.giou_compute_dtype!r}")
        if self.matcher_giou not in ("rotated", "axis_aligned"):
            raise ValueError(f"unknown matcher_giou {self.matcher_giou!r}")


@dataclass(frozen=True)
class OptimConfig:
    """AdamW + cosine schedule (reference main.py:31-41, engine.py:22-44)."""

    base_lr: float = 5e-4
    warm_lr: float = 1e-6
    warm_lr_epochs: int = 9
    final_lr: float = 1e-6
    weight_decay: float = 0.1
    filter_biases_wd: bool = False
    clip_gradient: float = 0.1


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection and paths (`ov3det/config.py:137-171`, reference
    main.py:107-176)."""

    dataset_name: str = "scannet"  # "scannet" | "sunrgbd" | "synthetic"
    root_dir: Optional[str] = None
    meta_data_dir: Optional[str] = None
    pseudo_label_dir: Optional[str] = None
    feature_2d_dir: Optional[str] = None
    num_points: int = 40000
    use_color: bool = False
    use_pbox: bool = False
    use_2d_feature: bool = False
    # RGB canvases and calibration in each sample, for the 2D teacher
    use_image: bool = False
    # ScanNet multi-frame image loading (reference datasets/scannet.py:276-285
    # hardcodes SCANNET_FRAMES_ROOT; here the frames tree is a config path)
    frames_dir: Optional[str] = None
    max_frames: int = 64
    num_workers: int = 4
    batch_size_per_device: int = 8
    max_num_obj: int = 64
    # every train scene's canvas encoded once (yuv420) into a bank on the
    # device; batches carry an int32 image_ref (datasets/image_bank.py)
    image_bank: bool = False
    # G batches a host-to-device copy on the single-device packed path; the
    # step replays once a batch (datasets/loader.py, engine/train.py)
    super_batch: int = 1
    # point clouds as per-sample-scaled uint16 on the packed path (q16)
    quantize_points: bool = False
    # uint8 RGB canvases as 4:2:0 YUV on the packed path (yuv420)
    yuv_images: bool = False


@dataclass(frozen=True)
class TeacherConfig:
    """The frozen RegionCLIP 2D teacher (`ov3det/config.py:174-187`,
    reference main.py:144-156).  compute_dtype "int8" (the default: W8A8
    trunk convs with exact int32 products), "bfloat16" or "float32"; the
    weights are quantised or cast once at load
    (`models.regionclip.quantize_teacher_params`).  JAX's `image_size` has
    no copy: nothing reads it, the canvases' size comes from the data."""

    enabled: bool = False
    checkpoint_path: Optional[str] = None
    # the frozen CLIP text-embedding matrix of the detector's classifier
    # (--clip_embed_path), read with or without the teacher
    text_embed_path: Optional[str] = None
    compute_dtype: str = "int8"

    def __post_init__(self):
        if self.compute_dtype not in ("int8", "bfloat16", "float32"):
            raise ValueError(f"unknown teacher compute_dtype {self.compute_dtype!r}")


@dataclass(frozen=True)
class TrainConfig:
    """Top-level run config (`ov3det/config.py:191-218`, reference
    main.py:178-196)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    teacher: TeacherConfig = field(default_factory=TeacherConfig)
    max_epoch: int = 720
    eval_every_epoch: int = 10
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    log_metrics_every: int = 20
    save_separate_checkpoint_every_epoch: int = 100
    # data parallelism: the ranks (devices) of the run, 1 = one device
    num_devices: int = 1
    # a torch.profiler trace of the first profile_steps training iterations,
    # written under profile_dir
    profile_dir: Optional[str] = None
    profile_steps: int = 5
    # torch.autograd.set_detect_anomaly for the run
    debug_nans: bool = False
    # compute the criterion during in-training evals and log Test_details/
    # losses (reference engine.py:198-206, 226-229)
    eval_loss: bool = False


def scannet_quick() -> TrainConfig:
    """reference scripts/scannet_quick.sh, as the JAX package's
    `scannet_quick()` sets it: 18 classes, axis-aligned boxes (1 angle bin),
    256 queries, GIoU loss weight 1; batch 8 of 40 000 points."""
    return TrainConfig(
        model=ModelConfig(num_semcls=18, num_angle_bin=1, num_queries=256,
                          compute_dtype="bfloat16"),
        loss=LossConfig(giou_weight=1.0),
        data=DataConfig(dataset_name="scannet", num_points=40000),
        max_epoch=90,
    )


def sunrgbd_quick() -> TrainConfig:
    """reference scripts/sunrgbd_quick.sh, as the JAX package's
    `sunrgbd_quick()` sets it: GIoU weight 0, matcher objectness and center
    costs 5; batch 8 of 20 000 points."""
    return TrainConfig(
        model=ModelConfig(num_semcls=20, num_angle_bin=12, num_queries=128,
                          compute_dtype="bfloat16"),
        loss=LossConfig(
            matcher=MatcherConfig(cost_class=1.0, cost_objectness=5.0, cost_center=5.0,
                                  cost_giou=3.0),
            giou_weight=0.0,
        ),
        data=DataConfig(dataset_name="sunrgbd", num_points=20000),
        max_epoch=90,
    )
