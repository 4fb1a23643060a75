"""CLIP ModifiedResNet image tower and attention pooling: the frozen
RegionCLIP teacher's trunk.

A copy of `ov3det/models/clip_resnet.py` (the RN50x4 visual backbone of
RegionCLIP's CLIPFastRCNN, reference models/model_regionclip.py:15-22): a
3-conv stem with avgpool, anti-aliased downsampling (stride-1 convs, then
avgpool), bottlenecks of expansion 4 and an AttentionPool2d head.  Inference
only: every weight is a buffer (nothing here is a parameter, nothing takes
a gradient) and BatchNorm always uses its running statistics.

Activations are channels-last (B, H, W, C), as in JAX; a plain conv runs as
`conv2d` on the NCHW view of that tensor, whose memory is channels-last,
with weights stored channels-last too.  A float32 conv on the card follows
`torch.backends.cudnn.allow_tf32` (PyTorch's default is TF32).

`QuantConv`, the W8A8 trunk conv, has the two modes of the JAX module that
`RegionCLIPTeacher` reaches (`ov3det/models/regionclip.py:70-72`):
  * "folded" (production): a static calibrated activation scale `a_scale`
    and the frozen BatchNorm folded into the dequant (`scale`, `bias`);
  * "dynamic" (calibration): an abs-max activation scale per call, whose
    maximum over calls is recorded in `a_max` for
    `regionclip.quantize_teacher_params`.
The JAX module's third mode, "static" (static scale, separate BatchNorm),
has no caller there and is not ported.

The int8 product is exact int32, as XLA's is: `torch._int_mm` over an
im2col of the int8 activations (nine shifted views of the padded tensor for
a 3 x 3 conv) against the int8 kernel, stored once at load as (C_out, K)
with K in (kh, kw, C_in) order, the layout the product reads.  A float conv
over int8 values would not do: past 2**24 an f32 sum rounds, and cuDNN's
default TF32 keeps 10 bits.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

_CHANNELS_LAST = torch.channels_last


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """flax `nn.avg_pool(x, (k, k), strides=(k, k))` (VALID) on (B, H, W, C)."""
    return _nhwc(F.avg_pool2d(_nchw(x), k, k))


class FrozenBatchNorm(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * scale + bias, the affine computed
    in f32 from the stored statistics and applied in the compute dtype."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None, epsilon: float = 1e-5):
        super().__init__()
        self.dtype, self.epsilon = dtype, epsilon
        for name, fill in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0), ("var", 1.0)):
            self.register_buffer(name, torch.full((channels,), fill))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + self.epsilon)
        w = self.scale * inv
        b = self.bias - self.mean * inv * self.scale
        if self.dtype is not None:
            w, b, x = w.to(self.dtype), b.to(self.dtype), x.to(self.dtype)
        return x * w + b


class Conv(nn.Module):
    """A bias-free conv (flax `nn.Conv(use_bias=False, dtype=...)`): the
    input and weight are cast to `dtype` when it is set."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1, padding: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        weight = torch.zeros(cout, cin, kernel_size, kernel_size)
        self.register_buffer("weight", weight.contiguous(memory_format=_CHANNELS_LAST))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
        elif x.dtype != w.dtype:
            x = x.to(w.dtype)
        return _nhwc(F.conv2d(_nchw(x), w, stride=self.stride, padding=self.padding))


def im2col_int8(xq: torch.Tensor, kernel_size: int, padding: int) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B * H * W, k * k * C), stride 1, K in (kh, kw,
    C) order, zero padding (the quantized zero)."""
    B, H, W, C = xq.shape
    if kernel_size == 1:
        return xq.reshape(B * H * W, C)
    p = padding
    xp = F.pad(xq, (0, 0, p, p, p, p))
    Ho, Wo = H + 2 * p - kernel_size + 1, W + 2 * p - kernel_size + 1
    views = [xp[:, i:i + Ho, j:j + Wo, :] for i in range(kernel_size) for j in range(kernel_size)]
    return torch.stack(views, dim=3).reshape(B * Ho * Wo, kernel_size * kernel_size * C)


def int8_conv(xq: torch.Tensor, kernel_q: torch.Tensor, kernel_size: int,
              padding: int) -> torch.Tensor:
    """Exact int32 conv of int8 (B, H, W, C) with the int8 (C_out, K) kernel
    -> (B, H', W', C_out), as `torch._int_mm(im2col, kernel_q.t())`.  On the
    card `_int_mm` takes more than 16 rows and K, C_out multiples of 8: the
    trunk's channels are, and fewer rows are padded with zero rows."""
    B = xq.shape[0]
    a = im2col_int8(xq, kernel_size, padding).contiguous()
    M = a.shape[0]
    if a.is_cuda and M <= 16:
        a = F.pad(a, (0, 0, 0, 17 - M))
    y = torch._int_mm(a, kernel_q.t())[:M]
    Ho = xq.shape[1] + 2 * padding - kernel_size + 1
    return y.view(B, Ho, -1, kernel_q.shape[0])


class QuantConv(nn.Module):
    """W8A8 trunk conv (`ov3det/models/clip_resnet.py:57-128`), stride 1.

    In JAX's order: xq = clip(round(x / s_x), -127, 127) in f32 with round
    half to even; y = the exact int32 conv; out = y * (s_x * scale) (+ bias
    in "folded" mode), cast to the compute dtype at the end.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int, padding: int = 0,
                 dtype: Optional[torch.dtype] = None, mode: str = "folded"):
        super().__init__()
        if mode not in ("folded", "dynamic"):
            raise ValueError(f"QuantConv mode {mode!r}: 'folded' or 'dynamic'")
        self.kernel_size, self.padding, self.dtype, self.mode = kernel_size, padding, dtype, mode
        self.register_buffer("kernel_q", torch.zeros(cout, kernel_size * kernel_size * cin,
                                                     dtype=torch.int8))
        self.register_buffer("scale", torch.ones(cout))
        if mode == "folded":
            self.register_buffer("a_scale", torch.ones(()))
            self.register_buffer("bias", torch.zeros(cout))
        self.a_max: Optional[torch.Tensor] = None  # "dynamic": the largest |x| seen

    def quantize(self, x: torch.Tensor):
        """x -> (int8 x, its f32 scale s_x)."""
        xf = x.float()
        if self.mode == "folded":
            s_x = self.a_scale
        else:
            a_max = xf.abs().amax()
            self.a_max = a_max if self.a_max is None else torch.maximum(self.a_max, a_max)
            s_x = torch.clamp(a_max, min=1e-6) / 127.0
        return torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8), s_x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, s_x = self.quantize(x)
        y = int8_conv(xq, self.kernel_q, self.kernel_size, self.padding)
        out = y.float() * (s_x * self.scale)
        if self.mode == "folded":
            out = out + self.bias
        return out.to(self.dtype) if self.dtype is not None else out


def trunk_conv(quant: Optional[str], dtype, cin: int, cout: int, kernel_size: int,
               padding: int = 0) -> nn.Module:
    """The trunk's conv: `QuantConv` in mode `quant` ("folded" | "dynamic"),
    a plain `Conv` when `quant` is None."""
    if quant:
        return QuantConv(cin, cout, kernel_size, padding, dtype, quant)
    return Conv(cin, cout, kernel_size, padding=padding, dtype=dtype)


def _bn(quant, channels: int, dtype) -> nn.Module:
    """The BatchNorm after a trunk conv; folded into the conv's dequant under
    quant "folded", so no module there."""
    return nn.Identity() if quant == "folded" else FrozenBatchNorm(channels, dtype)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dtype=None, quant=None):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = trunk_conv(quant, dtype, inplanes, planes, 1)
        self.bn1 = _bn(quant, planes, dtype)
        self.conv2 = trunk_conv(quant, dtype, planes, planes, 3, padding=1)
        self.bn2 = _bn(quant, planes, dtype)
        self.conv3 = trunk_conv(quant, dtype, planes, out, 1)
        self.bn3 = _bn(quant, out, dtype)
        self.has_downsample = stride > 1 or inplanes != out
        if self.has_downsample:
            self.downsample_conv = trunk_conv(quant, dtype, inplanes, out, 1)
            self.downsample_bn = _bn(quant, out, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:  # anti-aliased: avgpool instead of a strided conv
            out = avg_pool(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.has_downsample:
            if self.stride > 1:
                identity = avg_pool(x, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return torch.relu(out + identity)


class ModifiedResNetStem(nn.Module):
    """conv1 stays a plain conv in the compute dtype even in int8 mode (its
    3-channel normalised input has a per-channel std that no per-tensor
    scale folds), so its bn1 stays a live module under quant "folded"."""

    def __init__(self, width: int, dtype=None, quant=None):
        super().__init__()
        w = width
        self.conv1 = Conv(3, w // 2, 3, stride=2, padding=1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(w // 2, dtype)
        self.conv2 = trunk_conv(quant, dtype, w // 2, w // 2, 3, padding=1)
        self.bn2 = _bn(quant, w // 2, dtype)
        self.conv3 = trunk_conv(quant, dtype, w // 2, w, 3, padding=1)
        self.bn3 = _bn(quant, w, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        x = torch.relu(self.bn3(self.conv3(x)))
        return avg_pool(x, 2)


class ResNetStage(nn.Module):
    def __init__(self, inplanes: int, planes: int, blocks: int, stride: int = 1, dtype=None,
                 quant=None):
        super().__init__()
        self.blocks = blocks
        self.add_module("block0", Bottleneck(inplanes, planes, stride, dtype, quant))
        for i in range(1, blocks):
            self.add_module(f"block{i}", Bottleneck(planes * 4, planes, 1, dtype, quant))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class CLIPResNetBackbone(nn.Module):
    """Stem + res2..res4 (stride 16): (B, H, W, 3) -> (B, H/16, W/16, 16 width)."""

    def __init__(self, width: int = 80, layers: Sequence[int] = (4, 6, 10, 6), dtype=None,
                 quant=None):
        super().__init__()
        w = width
        self.stem = ModifiedResNetStem(w, dtype, quant)
        self.layer1 = ResNetStage(w, w, layers[0], 1, dtype, quant)
        self.layer2 = ResNetStage(4 * w, 2 * w, layers[1], 2, dtype, quant)
        self.layer3 = ResNetStage(8 * w, 4 * w, layers[2], 2, dtype, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer3(self.layer2(self.layer1(self.stem(x))))


class _Proj(nn.Module):
    """The weight (out, in) and bias of a frozen dense projection."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros(cout, cin))
        self.register_buffer("bias", torch.zeros(cout))


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of `jax.image.resize(..., "bilinear")` along one
    axis (`jax/_src/image/scale.py` `compute_weight_mat`: the triangle
    kernel, widened when downsampling (antialias), normalised, in f32)."""
    inv_scale = torch.tensor(n_in / n_out, dtype=torch.float32, device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    grid = torch.arange(n_in, dtype=torch.float32, device=device)
    x = (sample_f[None, :] - grid[:, None]).abs() / kernel_scale
    weights = torch.clamp(1 - x, min=0)
    total = weights.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_bilinear(grid: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(h, w, C) -> (H, W, C) as `jax.image.resize(grid, (H, W, C), "bilinear")`."""
    h, w, _ = grid.shape
    if h != H:
        grid = torch.einsum("hwc,hH->Hwc", grid, _resize_weights(h, H, grid.device))
    if w != W:
        grid = torch.einsum("hwc,wW->hWc", grid, _resize_weights(w, W, grid.device))
    return grid


class AttentionPool2d(nn.Module):
    """CLIP's attention pool with the JAX package's single-query folding
    (`ov3det/models/clip_resnet.py:203-281`): the one query is the mean
    token, so the key projection folds into u_h = K_h q_h, attention runs
    over the raw tokens, and V projects the one pooled token per head.
    Tokens stay in the compute dtype; the mean token, the logits, the
    softmax and the pooled token are f32, and the products accumulate in f32."""

    def __init__(self, embed_dim: int, num_heads: int, spacial_dim: int, output_dim: int,
                 dtype=None):
        super().__init__()
        C = embed_dim
        self.num_heads, self.dtype = num_heads, dtype
        self.register_buffer("positional_embedding", torch.zeros(spacial_dim ** 2 + 1, C))
        self.q_proj = _Proj(C, C)
        self.k_proj = _Proj(C, C)
        self.v_proj = _Proj(C, C)
        self.c_proj = _Proj(C, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> (B, output_dim), f32."""
        B, H, W, C = x.shape
        tokens = x.reshape(B, H * W, C)
        mean_tok = tokens.float().mean(dim=1, keepdim=True)
        tokens = torch.cat([mean_tok.to(tokens.dtype), tokens], dim=1)  # (B, 1 + HW, C)
        pos = self.positional_embedding
        if pos.shape[0] != H * W + 1:  # a checkpoint's grid at another resolution
            side = int(round((pos.shape[0] - 1) ** 0.5))
            grid = resize_bilinear(pos[1:].float().reshape(side, side, C), H, W)
            pos = torch.cat([pos[:1], grid.reshape(H * W, C).to(pos.dtype)], dim=0)
        tokens = tokens + pos[None].to(tokens.dtype)

        nh = self.num_heads
        hd = C // nh
        q_w, q_b = self.q_proj.weight, self.q_proj.bias
        k_w, v_w, v_b = self.k_proj.weight, self.v_proj.weight, self.v_proj.bias
        if self.dtype is not None:
            q_w, q_b, k_w, v_w, v_b = (t.to(self.dtype) for t in (q_w, q_b, k_w, v_w, v_b))
        q = F.linear(tokens[:, :1], q_w, q_b).reshape(B, nh, hd)
        u = torch.einsum("bhd,hdc->bhc", q.float(), k_w.float().reshape(nh, hd, C))
        u = u.to(tokens.dtype)
        tokens_f = tokens.float()
        attn = torch.einsum("bkc,bhc->bhk", tokens_f, u.float()) / math.sqrt(hd)
        attn = torch.softmax(attn, dim=-1)
        z = torch.einsum("bhk,bkc->bhc", attn, tokens_f)
        out = torch.einsum("bhc,hdc->bhd", z.to(v_w.dtype).float(), v_w.float().reshape(nh, hd, C))
        out = (out + v_b.reshape(nh, hd)).reshape(B, C)
        return F.linear(out, self.c_proj.weight, self.c_proj.bias)


class CLIPResNetRes5Head(nn.Module):
    """res5 + attention pooling: (R, P, P, 16 width) pooled RoI features ->
    (R, embed_dim)."""

    def __init__(self, width: int = 80, blocks: int = 6, embed_dim: int = 640,
                 image_resolution: int = 288, dtype=None, quant=None):
        super().__init__()
        self.layer4 = ResNetStage(16 * width, 8 * width, blocks, 2, dtype, quant)
        self.attnpool = AttentionPool2d(32 * width, 32 * width // 64, image_resolution // 32,
                                        embed_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attnpool(self.layer4(x))
