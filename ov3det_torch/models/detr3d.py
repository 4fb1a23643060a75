"""3DETR open-vocabulary detector in PyTorch.

Counterpart of `ov3det/models/detr3d.py:57-288`:

  pre-encoder SA (N points -> 2048 tokens: FPS + ball-group kernels)
  -> transformer encoder (attention kernel on the 2048 x 2048 self-attention)
     or the masked encoder (3DETR-m: the attention kernel with the radius
     bias, and the interim SA 2048 -> 1024 tokens after its layer 0)
  -> encoder->decoder projection (two hidden layers; one for the masked
     encoder) -> FPS query seeds + position embeddings
  -> decoder (every layer's state kept, stacked on a leading L axis)
  -> MLP heads -> box decode.

Class logits are the predicted visual embedding times a frozen CLIP
text-embedding matrix (`text_embed`, a buffer), the intended logits of the
JAX package (not the reference's query-class scrambled ones).  Outputs keep
the JAX dtypes: at bf16 compute the heads' outputs are bf16, the logits,
boxes and coordinates f32.

Training mode (`model.train()`) is the forward of `make_train_step`:
BatchNorm on batch statistics (updating the running ones), the dropout sites
of the encoder, the decoder and the heads (`mlp_dropout`), each mask drawn
from the `torch.Generator` given to `forward`.  The class probabilities
(`objectness_prob`, `sem_cls_prob`) carry no gradient, as at
`ov3det/models/detr3d.py:259`.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ov3det_torch.config import ModelConfig
from ov3det_torch.device import resolve_device
from ov3det_torch.geometry.boxes import (
    bin_to_angle,
    corners_from_upright_depth_param,
    shift_scale_points,
)
from ov3det_torch.models.mlp import GenericMLP
from ov3det_torch.models.pointnet import PointnetSAModule
from ov3det_torch.models.pos_embed import PositionEmbeddingCoords
from ov3det_torch.models.transformer import (
    MaskedTransformerEncoder,
    TransformerDecoder,
    TransformerEncoder,
)
from ov3det_torch.ops.pointcloud import furthest_point_sample, gather_points

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def decode_boxes(*, center_offset, size_normalized, angle_logits, angle_residual,
                 query_xyz, pc_min, pc_max, num_angle_bin: int):
    """Head outputs -> boxes (the reference BoxProcessor, model_3detr.py:19-69).

    center_offset, size_normalized (L, B, Q, 3); angle_logits, angle_residual
    (L, B, Q, nbins); query_xyz (B, Q, 3); pc_min, pc_max (B, 3).
    Returns (center_norm, center_unnorm, size_unnorm, angle, corners).
    """
    L, B, Q, _ = center_offset.shape
    center_unnorm = query_xyz[None] + center_offset
    flat = center_unnorm.reshape(L * B, Q, 3)
    rng = (pc_min.repeat(L, 1), pc_max.repeat(L, 1))
    center_norm = shift_scale_points(flat, rng).reshape(L, B, Q, 3)
    scene_scale = torch.clamp(pc_max - pc_min, min=1e-1)
    size_unnorm = size_normalized * scene_scale[None, :, None, :]
    if num_angle_bin > 1:
        pred_bin = torch.argmax(angle_logits, dim=-1)
        residual = torch.gather(angle_residual, -1, pred_bin[..., None])[..., 0]
        angle = bin_to_angle(pred_bin, residual, num_angle_bin, to_label_format=True)
    else:
        angle = torch.zeros(angle_logits.shape[:-1], dtype=angle_logits.dtype,
                            device=angle_logits.device)
    corners = corners_from_upright_depth_param(center_unnorm, size_unnorm, angle)
    return center_norm, center_unnorm, size_unnorm, angle, corners


class Model3DETR(nn.Module):
    """The detector.  Built on `device` (CUDA unless the caller passes
    "cpu"; raises when CUDA is asked for and absent) with weights drawn from
    a `torch.Generator` seeded with `seed`, on the CPU, so one seed gives the
    same weights on every device.  Built in eval mode; `.train()` switches to
    the training forward."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dtype = _DTYPES[cfg.compute_dtype]
        enc, dec = cfg.encoder, cfg.decoder
        self.pre_encoder = PointnetSAModule(
            npoint=cfg.preenc_npoints, radius=cfg.preenc_radius,
            nsample=cfg.preenc_nsample, in_channels=3 if cfg.use_color else 0,
            mlp_dims=tuple(cfg.preenc_mlp[:-1]) + (enc.dim,), compute_dtype=dtype,
            ball_query_method=cfg.ball_query_method,
        )
        if enc.kind == "masked":
            # registered here, not under `encoder`: the flax tree has it in
            # the detector's scope (detr3d.py:123-132)
            self.interim_downsample = PointnetSAModule(
                npoint=cfg.preenc_npoints // 2, radius=cfg.interim_radius,
                nsample=cfg.interim_nsample, in_channels=enc.dim,
                mlp_dims=tuple(cfg.interim_mlp[:-1]) + (enc.dim,), compute_dtype=dtype,
                ball_query_method=cfg.ball_query_method,
            )
            self.encoder = MaskedTransformerEncoder(
                enc.num_layers, enc.dim, enc.masking_radius, enc.num_heads, enc.ffn_dim,
                enc.dropout, enc.activation, dtype)
        else:
            self.encoder = TransformerEncoder(enc.num_layers, enc.dim, enc.num_heads,
                                              enc.ffn_dim, enc.dropout, enc.activation, dtype)
        self.encoder_to_decoder_projection = GenericMLP(
            enc.dim, [enc.dim] if enc.kind == "masked" else [enc.dim, enc.dim], dec.dim,
            norm="bn", output_use_activation=True, output_use_norm=True,
            output_use_bias=False,
        )
        self.pos_embedding = PositionEmbeddingCoords(dec.dim, pos_type=cfg.pos_embed)
        self.query_projection = GenericMLP(
            dec.dim, [dec.dim], dec.dim, hidden_use_bias=True, output_use_activation=True,
        )
        self.decoder = TransformerDecoder(dec.num_layers, dec.dim, dec.num_heads,
                                          dec.ffn_dim, dec.dropout, dtype)

        def head(out_dim):
            return GenericMLP(dec.dim, [dec.dim, dec.dim], out_dim, norm="bn",
                              dropout=cfg.mlp_dropout, compute_dtype=dtype)

        self.visual_embed_head = head(cfg.clip_embed_dim)
        self.center_head = head(3)
        self.size_head = head(3)
        self.angle_cls_head = head(cfg.num_angle_bin)
        self.angle_residual_head = head(cfg.num_angle_bin)
        self.register_buffer("text_embed", torch.zeros(cfg.num_semcls + 1, cfg.clip_embed_dim))
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random initialisation of every weight (no trained weights
        ship with the repository)."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        with torch.no_grad():
            self.text_embed.normal_(generator=generator).div_(math.sqrt(self.cfg.clip_embed_dim))

    def forward(self, inputs: dict, generator: torch.Generator | None = None) -> dict:
        """inputs: point_clouds (B, N, 3 [+3 color]), point_cloud_dims_min/max
        (B, >=3).  Returns the outputs of `ov3det/models/detr3d.py:260-276`,
        stacked (L, B, Q, ...), plus query_xyz (B, Q, 3) and query_inds (B, Q).
        `generator` (on the inputs' device) draws the dropout masks of the
        training forward; eval mode draws nothing."""
        cfg = self.cfg
        pc = inputs["point_clouds"]
        expected = 6 if cfg.use_color else 3
        if pc.shape[-1] != expected:
            raise ValueError(f"point_clouds has {pc.shape[-1]} channels, expected {expected}")
        pc_min = inputs["point_cloud_dims_min"][..., :3]
        pc_max = inputs["point_cloud_dims_max"][..., :3]
        xyz = pc[..., :3]
        feats = pc[..., 3:] if cfg.use_color else None

        pre_xyz, pre_feats, _ = self.pre_encoder(xyz, feats)
        if cfg.encoder.kind == "masked":
            enc_xyz, enc_feats, _ = self.encoder(pre_feats, pre_xyz, self.interim_downsample,
                                                 generator=generator)
        else:
            enc_xyz, enc_feats, _ = self.encoder(pre_feats, pre_xyz, generator=generator)
        enc_feats = self.encoder_to_decoder_projection(enc_feats)

        query_inds = furthest_point_sample(enc_xyz, cfg.num_queries)
        query_xyz = gather_points(enc_xyz, query_inds)
        query_embed = self.query_projection(self.pos_embedding(query_xyz, (pc_min, pc_max)))
        enc_pos = self.pos_embedding(enc_xyz, (pc_min, pc_max))
        box_features = self.decoder(torch.zeros_like(query_embed), enc_feats,
                                    query_pos=query_embed, mem_pos=enc_pos, generator=generator)

        visual_embeds = self.visual_embed_head(box_features, generator)
        cls_logits = torch.matmul(visual_embeds.float(), self.text_embed.t())
        center_offset = torch.sigmoid(self.center_head(box_features, generator)) - 0.5
        size_normalized = torch.sigmoid(self.size_head(box_features, generator))
        angle_logits = self.angle_cls_head(box_features, generator)
        angle_residual_normalized = self.angle_residual_head(box_features, generator)
        angle_residual = angle_residual_normalized * (math.pi / cfg.num_angle_bin)

        center_norm, center_unnorm, size_unnorm, angle, corners = decode_boxes(
            center_offset=center_offset, size_normalized=size_normalized,
            angle_logits=angle_logits, angle_residual=angle_residual,
            query_xyz=query_xyz, pc_min=pc_min, pc_max=pc_max,
            num_angle_bin=cfg.num_angle_bin,
        )
        probs = torch.softmax(cls_logits.detach(), dim=-1)
        return {
            "visual_embeds": visual_embeds,
            "sem_cls_logits": cls_logits,
            "center_normalized": center_norm,
            "center_unnormalized": center_unnorm,
            "size_normalized": size_normalized,
            "size_unnormalized": size_unnorm,
            "angle_logits": angle_logits,
            "angle_residual": angle_residual,
            "angle_residual_normalized": angle_residual_normalized,
            "angle_continuous": angle,
            "objectness_prob": 1.0 - probs[..., -1],
            "sem_cls_prob": probs[..., :-1],
            "box_corners": corners,
            "query_xyz": query_xyz,
            "query_inds": query_inds,
        }


_UNSTACKED = ("query_xyz", "query_inds")


def last_layer_outputs(outputs: dict) -> dict:
    """The final decoder layer's predictions (reference model_3detr.py:308-315)."""
    return {k: (v if k in _UNSTACKED else v[-1]) for k, v in outputs.items()}
