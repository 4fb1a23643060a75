"""The 3DETR detector as plain PyTorch, in float32.

A frozen copy of the port's model code (`ov3det_torch/models/detr3d.py`,
`transformer.py`, `pointnet.py`, `mlp.py`, `pos_embed.py`) with every call
into a kernel replaced by the plain version that kernel is held to
(`plain.py`), and every product computed in float32 whatever the
configuration's compute dtype (`Precision.operand`).  The modules keep the
port's names, so one state dict fits both.  The dropout masks are drawn
from the generator given to `forward` in the port's order and with its
calls, so that the same seed gives the same masks on the same device; the
fused attention's mask is the hash of its int32 seed (`plain.drop_mask`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .precision import FLOAT32, Precision
from .boxes import bin_to_angle, corners_from_upright_depth_param, shift_scale_points
from .plain import (
    _RADIUS_NEG,
    _scale,
    _scatter,
    add_norm_plain,
    ball_group_plain,
    drop_mask,
    dropped,
    fps_plain,
    layer_norm_plain,
    radius_mask,
    slot_sources_plain,
)


# ------------------------------------------------------------ mlp.py
def dropout_mask(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
                 batch_dim: int = 0) -> Optional[torch.Tensor]:
    """flax `nn.Dropout`'s keep mask for a tensor like x, one process."""
    if rate <= 0.0:
        return None
    if generator is None:
        raise ValueError("training-mode dropout needs a torch.Generator")
    return torch.rand(list(x.shape), generator=generator, device=x.device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            batch_dim: int = 0) -> torch.Tensor:
    return dropped(x, dropout_mask(x, rate, generator, batch_dim), 1.0 - rate)


class Dense(nn.Linear):
    """flax `nn.Dense`, computed in float32 (or the control's precision)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 prec: Precision = FLOAT32):
        super().__init__(in_features, out_features, bias=bias)
        self.prec = prec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.float()
        return F.linear(self.prec.operand(x), self.prec.operand(self.weight), bias)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` (fast variance, eps 1e-5), the module expression."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_plain(x, self.weight, self.bias, self.eps)[0]

    def add(self, x, branch, keep=None, keep_prob: float = 1.0) -> tuple:
        return add_norm_plain(x, self.weight, self.bias, self.eps, branch, keep, keep_prob)[:2]


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` (momentum 0.9, eps 1e-5, the fast biased
    variance) over all leading axes, one process."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            count = float(x.numel() // x.shape[-1])
            mean, mean2 = (torch.stack([x.sum(axes), (x * x).sum(axes)]) / count).unbind(0)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + (1 - 0.9) * mean)
                self.running_var.copy_(0.9 * self.running_var + (1 - 0.9) * var)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class GenericMLP(nn.Module):
    def __init__(self, in_dim: int, hidden_dims: Sequence[int], output_dim: int,
                 norm: Optional[str] = None, dropout: float = 0.0,
                 hidden_use_bias: bool = False, output_use_bias: bool = True,
                 output_use_activation: bool = False, output_use_norm: bool = False,
                 batch_dim: int = 0, prec: Precision = FLOAT32):
        super().__init__()
        self.dropout = dropout
        self.batch_dim = batch_dim
        self.output_use_activation = output_use_activation
        dims = [in_dim, *hidden_dims]
        self.layers = nn.ModuleList(Dense(a, b, hidden_use_bias, prec)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.layers.append(Dense(dims[-1], output_dim, output_use_bias, prec))
        norm_dims = list(hidden_dims) if norm else []
        if norm and output_use_norm:
            norm_dims.append(output_dim)
        self.norms = nn.ModuleList(BatchNorm(d) for d in norm_dims)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n_hidden = len(self.layers) - 1
        for i in range(n_hidden):
            x = self.layers[i](x)
            if self.norms:
                x = self.norms[i](x)
            x = F.relu(x)
            if self.training:
                x = dropout(x, self.dropout, generator, self.batch_dim)
        x = self.layers[-1](x)
        if len(self.norms) > n_hidden:
            x = self.norms[-1](x)
        if self.output_use_activation:
            x = F.relu(x)
        return x


# ------------------------------------------------------------ transformer.py
ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.1),
}


def fused_attention_eligible(NQ: int, NK: int, D: int) -> bool:
    """Where the port takes its fused attention: the hashed dropout mask
    and the radius bias belong to that path."""
    return NQ % 128 == 0 and NK % 128 == 0 and D % 8 == 0 and NQ * NK >= 1024 * 1024


def hashed_attention(q, k, v, rate: float, seed, radius, prec: Precision) -> torch.Tensor:
    """(BH, N, D) attention as the fused path defines it: scores scaled by
    f32(1/sqrt(D)), the radius bias, softmax, the normalised weights times
    the hashed mask, then the value product; differentiable."""
    s = torch.matmul(prec.operand(q), prec.operand(k).transpose(1, 2)) * _scale(q.shape[-1])
    if radius is not None:
        q_xyz, k_xyz, r2 = radius
        B = q_xyz.shape[0]
        bias = torch.where(radius_mask(q_xyz, k_xyz, r2), 0.0, _RADIUS_NEG)
        s = (s.view(B, -1, *s.shape[1:]) + bias[:, None]).view(s.shape)
    a = torch.softmax(s, dim=-1)
    if rate > 0.0:
        a = a * drop_mask(seed, *s.shape, rate)
    return torch.matmul(prec.operand(a), prec.operand(v))


def dot_product_attention(q, k, v, dropout_rate: float, generator: Optional[torch.Generator],
                          mask: Optional[torch.Tensor], prec: Precision) -> torch.Tensor:
    """flax `nn.dot_product_attention` in float32, with one (NQ, NK)
    dropout mask broadcast over batch and heads."""
    q = q / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", prec.operand(q), prec.operand(k))
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    w = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        keep_prob = 1.0 - dropout_rate
        keep = torch.rand(w.shape[-2:], generator=generator, device=w.device) < keep_prob
        w = w * (keep.to(w.dtype) / torch.tensor(keep_prob, dtype=w.dtype))
    return torch.einsum("bhqk,bkhd->bqhd", prec.operand(w), prec.operand(v))


class MultiheadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dropout: float, prec: Precision):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.prec = prec
        self.q_proj = Dense(dim, dim, prec=prec)
        self.k_proj = Dense(dim, dim, prec=prec)
        self.v_proj = Dense(dim, dim, prec=prec)
        self.out_proj = Dense(dim, dim, prec=prec)

    def forward(self, q_in, k_in, v_in, generator=None, mask=None, radius=None):
        B, NQ, _ = q_in.shape
        NK = k_in.shape[1]
        H = self.num_heads
        q = self.q_proj(q_in).view(B, NQ, H, -1)
        k = self.k_proj(k_in).view(B, NK, H, -1)
        v = self.v_proj(v_in).view(B, NK, H, -1)
        D = q.shape[-1]
        rate = self.dropout if self.training else 0.0
        if fused_attention_eligible(NQ, NK, D) and mask is None:
            def heads(x, n):
                return x.transpose(1, 2).reshape(B * H, n, D)

            seed = None
            if rate > 0.0:  # the port's draw, so that the generator advances alike
                seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                     device=q.device, dtype=torch.int32)
            out = hashed_attention(heads(q, NQ), heads(k, NK), heads(v, NK), rate, seed, radius,
                                   self.prec)
            out = out.view(B, H, NQ, D).transpose(1, 2)
        else:
            out = dot_product_attention(q, k, v, rate, generator, mask, self.prec)
        return self.out_proj(out.reshape(B, NQ, H * D))


def _with_pos(x, pos):
    return x if pos is None else x + pos


class TransformerEncoderLayer(nn.Module):
    def __init__(self, dim, num_heads, ffn_dim, dropout, activation, prec: Precision):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.dropout = dropout
        self.norm1 = LayerNorm(dim)
        self.self_attn = MultiheadAttention(dim, num_heads, dropout, prec)
        self.norm2 = LayerNorm(dim)
        self.linear1 = Dense(dim, ffn_dim, prec=prec)
        self.linear2 = Dense(ffn_dim, dim, prec=prec)

    def forward(self, x, pos=None, generator=None, mask=None, radius=None):
        rate = self.dropout if self.training else 0.0
        y = self.norm1(x)
        qk = _with_pos(y, pos)
        attn = self.self_attn(qk, qk, y, generator, mask, radius)
        x, y = self.norm2.add(x, attn, dropout_mask(attn, rate, generator), 1.0 - rate)
        y = dropout(self.act(self.linear1(y)), rate, generator)
        return x + dropout(self.linear2(y), rate, generator)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers, dim, num_heads, ffn_dim, dropout, activation, prec: Precision):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(dim, num_heads, ffn_dim, dropout,
                                                            activation, prec)
                                    for _ in range(num_layers))

    def forward(self, feats, xyz, pos=None, generator=None):
        for layer in self.layers:
            feats = layer(feats, pos=pos, generator=generator)
        return xyz, feats, None


class MaskedTransformerEncoder(nn.Module):
    def __init__(self, num_layers, dim, masking_radius, num_heads, ffn_dim, dropout, activation,
                 prec: Precision):
        super().__init__()
        self.masking_radius = tuple(masking_radius)
        self.head_dim = dim // num_heads
        self.layers = nn.ModuleList(TransformerEncoderLayer(dim, num_heads, ffn_dim, dropout,
                                                            activation, prec)
                                    for _ in range(num_layers))

    def forward(self, feats, xyz, interim_downsample, pos=None, generator=None):
        inds = None
        for idx, layer in enumerate(self.layers):
            r = self.masking_radius[idx]
            N = feats.shape[1]
            mask = radius = None
            if fused_attention_eligible(N, N, self.head_dim):
                radius = (xyz, xyz, r * r)
            else:
                diff = xyz[:, :, None, :] - xyz[:, None, :, :]
                d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
                      + diff[..., 2] * diff[..., 2])
                mask = (d2 < r * r)[:, None]
            feats = layer(feats, pos=pos, generator=generator, mask=mask, radius=radius)
            if idx == 0:
                xyz, feats, inds = interim_downsample(xyz, feats)
        return xyz, feats, inds


class TransformerDecoderLayer(nn.Module):
    def __init__(self, dim, num_heads, ffn_dim, dropout, prec: Precision):
        super().__init__()
        self.dropout = dropout
        self.norm1 = LayerNorm(dim)
        self.self_attn = MultiheadAttention(dim, num_heads, dropout, prec)
        self.norm2 = LayerNorm(dim)
        self.cross_attn = MultiheadAttention(dim, num_heads, dropout, prec)
        self.norm3 = LayerNorm(dim)
        self.linear1 = Dense(dim, ffn_dim, prec=prec)
        self.linear2 = Dense(ffn_dim, dim, prec=prec)

    def forward(self, tgt, memory, query_pos=None, mem_pos=None, generator=None):
        rate = self.dropout if self.training else 0.0
        y = self.norm1(tgt)
        qk = _with_pos(y, query_pos)
        sa = self.self_attn(qk, qk, y, generator)
        tgt, y = self.norm2.add(tgt, sa, dropout_mask(sa, rate, generator), 1.0 - rate)
        ca = self.cross_attn(_with_pos(y, query_pos), _with_pos(memory, mem_pos), memory,
                             generator)
        tgt, y = self.norm3.add(tgt, ca, dropout_mask(ca, rate, generator), 1.0 - rate)
        y = dropout(torch.relu(self.linear1(y)), rate, generator)
        return tgt + dropout(self.linear2(y), rate, generator)


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers, dim, num_heads, ffn_dim, dropout, prec: Precision):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.layers = nn.ModuleList(TransformerDecoderLayer(dim, num_heads, ffn_dim, dropout, prec)
                                    for _ in range(num_layers))

    def forward(self, tgt, memory, query_pos=None, mem_pos=None, generator=None):
        inter = []
        for layer in self.layers:
            tgt = layer(tgt, memory, query_pos=query_pos, mem_pos=mem_pos, generator=generator)
            inter.append(self.norm(tgt))
        return torch.stack(inter, dim=0)


# ------------------------------------------------------------ pointnet.py
def furthest_point_sample(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    return fps_plain(xyz.detach().float().contiguous(), num_samples)


def gather_points(points: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    return torch.gather(points, 1, inds[..., None].expand(-1, -1, points.shape[-1]))


class BallGroup(torch.autograd.Function):
    """The bucketed ball-group with the port's custom gradient: the
    features' cotangent summed onto the points that the expanded-distance
    picks name (the TPU kernel's VJP), not onto the forward's picks."""

    @staticmethod
    def forward(ctx, xyz, features, centers, radius: float, nsample: int):
        ctx.save_for_backward(xyz, centers)
        ctx.radius, ctx.nsample = radius, nsample
        ctx.num_channels = 0 if features is None else features.shape[-1]
        return ball_group_plain(xyz, features, centers, radius, nsample)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[1]:
            return None, None, None, None, None
        xyz, centers = ctx.saved_tensors
        src = slot_sources_plain(xyz, centers, ctx.radius, ctx.nsample)
        return None, _scatter(src, grad_out, xyz.shape[1], ctx.num_channels), None, None, None


class PointnetSAModule(nn.Module):
    def __init__(self, npoint: int, radius: float, nsample: int, in_channels: int,
                 mlp_dims: Sequence[int], prec: Precision):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        dims = [3 + in_channels, *mlp_dims]
        self.layers = nn.ModuleList(Dense(a, b, False, prec) for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(BatchNorm(d) for d in mlp_dims)

    def forward(self, xyz, features=None):
        inds = furthest_point_sample(xyz, self.npoint)
        new_xyz = gather_points(xyz, inds)
        feats = None if features is None else features.float().contiguous()
        h = BallGroup.apply(xyz.detach().float().contiguous(), feats,
                            new_xyz.detach().float().contiguous(), self.radius, self.nsample)
        last = len(self.layers) - 1
        for i, (layer, norm) in enumerate(zip(self.layers, self.norms)):
            h = torch.relu(norm(layer(h)))
            if i == last:
                h = h.amax(dim=1)
        return new_xyz, h, inds


# ------------------------------------------------------------ pos_embed.py
class PositionEmbeddingCoords(nn.Module):
    """Fourier features of the coordinates normalised to the scene's box."""

    def __init__(self, d_pos: int):
        super().__init__()
        self.gauss_B = nn.Parameter(torch.zeros(3, d_pos // 2))

    def forward(self, xyz, input_range):
        xyz = shift_scale_points(xyz.detach(), src_range=input_range)
        feat = torch.matmul(xyz * (2.0 * math.pi), self.gauss_B.detach())
        return torch.cat([torch.sin(feat), torch.cos(feat)], dim=-1)


# ------------------------------------------------------------ detr3d.py
def decode_boxes(*, center_offset, size_normalized, angle_logits, angle_residual,
                 query_xyz, pc_min, pc_max, num_angle_bin: int):
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
    """The detector from a config's `model` dict (the port's `ModelConfig`
    fields), computing in `prec`; built in eval mode, weights at
    placeholders (load a state dict)."""

    def __init__(self, m: dict, prec: Precision = FLOAT32):
        super().__init__()
        self.m, self.prec = m, prec
        enc, dec = m["encoder"], m["decoder"]
        mlp = tuple(m["preenc_mlp"][:-1]) + (enc["dim"],)
        self.pre_encoder = PointnetSAModule(m["preenc_npoints"], m["preenc_radius"],
                                            m["preenc_nsample"], 3 if m["use_color"] else 0, mlp,
                                            prec)
        if enc["kind"] == "masked":
            self.interim_downsample = PointnetSAModule(
                m["preenc_npoints"] // 2, m["interim_radius"], m["interim_nsample"], enc["dim"],
                tuple(m["interim_mlp"][:-1]) + (enc["dim"],), prec)
            self.encoder = MaskedTransformerEncoder(
                enc["num_layers"], enc["dim"], enc["masking_radius"],
                enc["num_heads"], enc["ffn_dim"], enc["dropout"], enc["activation"], prec)
        else:
            self.encoder = TransformerEncoder(enc["num_layers"], enc["dim"], enc["num_heads"],
                                              enc["ffn_dim"], enc["dropout"], enc["activation"],
                                              prec)
        self.encoder_to_decoder_projection = GenericMLP(
            enc["dim"], [enc["dim"]] if enc["kind"] == "masked" else [enc["dim"], enc["dim"]],
            dec["dim"], norm="bn", output_use_activation=True, output_use_norm=True,
            output_use_bias=False, prec=prec)
        self.pos_embedding = PositionEmbeddingCoords(dec["dim"])
        self.query_projection = GenericMLP(dec["dim"], [dec["dim"]], dec["dim"],
                                           hidden_use_bias=True, output_use_activation=True,
                                           prec=prec)
        self.decoder = TransformerDecoder(dec["num_layers"], dec["dim"], dec["num_heads"],
                                          dec["ffn_dim"], dec["dropout"], prec)

        def head(out_dim):
            return GenericMLP(dec["dim"], [dec["dim"], dec["dim"]], out_dim, norm="bn",
                              dropout=m["mlp_dropout"], batch_dim=1, prec=prec)

        self.visual_embed_head = head(m["clip_embed_dim"])
        self.center_head = head(3)
        self.size_head = head(3)
        self.angle_cls_head = head(m["num_angle_bin"])
        self.angle_residual_head = head(m["num_angle_bin"])
        self.register_buffer("text_embed", torch.zeros(m["num_semcls"] + 1, m["clip_embed_dim"]))
        self.eval()

    def forward(self, inputs: dict, generator: Optional[torch.Generator] = None) -> dict:
        m = self.m
        pc = inputs["point_clouds"]
        pc_min = inputs["point_cloud_dims_min"][..., :3]
        pc_max = inputs["point_cloud_dims_max"][..., :3]
        xyz = pc[..., :3]
        feats = pc[..., 3:] if m["use_color"] else None
        pre_xyz, pre_feats, _ = self.pre_encoder(xyz, feats)
        if m["encoder"]["kind"] == "masked":
            enc_xyz, enc_feats, _ = self.encoder(pre_feats, pre_xyz, self.interim_downsample,
                                                 generator=generator)
        else:
            enc_xyz, enc_feats, _ = self.encoder(pre_feats, pre_xyz, generator=generator)
        enc_feats = self.encoder_to_decoder_projection(enc_feats)
        query_inds = furthest_point_sample(enc_xyz, m["num_queries"])
        query_xyz = gather_points(enc_xyz, query_inds)
        query_embed = self.query_projection(self.pos_embedding(query_xyz, (pc_min, pc_max)))
        enc_pos = self.pos_embedding(enc_xyz, (pc_min, pc_max))
        box_features = self.decoder(torch.zeros_like(query_embed), enc_feats,
                                    query_pos=query_embed, mem_pos=enc_pos, generator=generator)
        visual_embeds = self.visual_embed_head(box_features, generator)
        cls_logits = torch.matmul(self.prec.operand(visual_embeds),
                                  self.prec.operand(self.text_embed).t())
        center_offset = torch.sigmoid(self.center_head(box_features, generator)) - 0.5
        size_normalized = torch.sigmoid(self.size_head(box_features, generator))
        angle_logits = self.angle_cls_head(box_features, generator)
        angle_residual_normalized = self.angle_residual_head(box_features, generator)
        angle_residual = angle_residual_normalized * (math.pi / m["num_angle_bin"])
        center_norm, center_unnorm, size_unnorm, angle, corners = decode_boxes(
            center_offset=center_offset, size_normalized=size_normalized,
            angle_logits=angle_logits, angle_residual=angle_residual, query_xyz=query_xyz,
            pc_min=pc_min, pc_max=pc_max, num_angle_bin=m["num_angle_bin"])
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


def last_layer_outputs(outputs: dict) -> dict:
    return {k: (v if k in ("query_xyz", "query_inds") else v[-1]) for k, v in outputs.items()}
