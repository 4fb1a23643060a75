"""Model configuration of the PyTorch port.

Copies of the model part of the JAX package's config tree
(`ov3det/config.py:15-76, 238-251`), kept here so that the port imports
nothing of the JAX package.  Field names and defaults are the same.

Two fields of the JAX `ModelConfig` have no counterpart: `fps_shards` and
`query_fps_shards` select an approximate strided FPS on non-TPU backends.
The port always runs exact greedy FPS, as the TPU kernel does.

Configurations outside the eval-mode vanilla-encoder slice raise
`NotImplementedError`: the masked encoder and the `first_k` ball query.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class EncoderConfig:
    """Transformer encoder (reference main.py:52-62)."""

    kind: str = "vanilla"  # only "vanilla" is ported
    num_layers: int = 3
    dim: int = 256
    ffn_dim: int = 128
    num_heads: int = 4
    dropout: float = 0.1
    activation: str = "relu"


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
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    ball_query_method: str = "bucketed"  # only "bucketed" is ported

    def __post_init__(self):
        if self.encoder.kind != "vanilla":
            raise NotImplementedError(
                f"encoder kind {self.encoder.kind!r} is not ported yet; "
                "only the vanilla encoder is"
            )
        if self.ball_query_method != "bucketed":
            raise NotImplementedError(
                f"ball_query_method {self.ball_query_method!r} is not ported "
                "yet; only the bucketed ball query is"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.pos_embed not in ("fourier", "sine"):
            raise ValueError(f"unknown pos_embed {self.pos_embed!r}")


def sunrgbd_quick() -> ModelConfig:
    """Model part of reference scripts/sunrgbd_quick.sh, as the JAX package's
    `sunrgbd_quick()` sets it.  Its data part is batch 8 of 20 000 points."""
    return ModelConfig(num_semcls=20, num_angle_bin=12, num_queries=128,
                       compute_dtype="bfloat16")
