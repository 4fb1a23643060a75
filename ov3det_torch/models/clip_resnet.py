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

`QuantConv`, the W8A8 trunk conv, has the three modes of the JAX module
(`ov3det/models/clip_resnet.py:57-139`, `_trunk_conv`):
  * "folded" (production, `RegionCLIPTeacher`'s "int8"): a static
    calibrated activation scale `a_scale` and the frozen BatchNorm folded
    into the dequant (`scale`, `bias`);
  * "static": the calibrated `a_scale`, with the frozen BatchNorm a module
    of its own after the conv (no bias); no teacher dtype of either
    package selects it, the tower takes it as `quant="static"`;
  * "dynamic" (calibration, "int8_calib"): an abs-max activation scale per
    call, whose maximum over calls is recorded in `a_max` for
    `regionclip.quantize_teacher_params`.

The int8 product is exact int32, as XLA's is: `ops.kernels.quant_conv`'s
implicit-GEMM kernel on the card, an im2col and `torch._int_mm` in its
plain version (the CPU path), against the int8 kernel stored once at load
as (C_out, K) with K in (kh, kw, C_in) order.  A float conv over int8
values would not do: past 2**24 an f32 sum rounds, and cuDNN's default TF32
keeps 10 bits.

With `fused` (the default) a "folded" tower runs as a chain
(`run_blocks`): each conv's kernel epilogue carries its block's residual
and ReLU and quantises its output for the next conv, and `pool_quantize`
quantises what no epilogue can (the stem's conv1 output, with bn1 and the
ReLU in the same pass, the pooled inputs of the anti-aliased blocks and the
RoI features), so that no activation
passes between convs in bf16 that only a quantise reads.  Every op is the
unfused path's in the same order, so both give the same bits.  `fused=False`
keeps the unfused module path (`QuantConv.forward` on each conv: torch's
quantise, the plain product, the elementwise ops) for comparison; the
"static" and "dynamic" modes take the kernel for their product alone.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ov3det_torch.ops.kernels.attn_pool import pool_attend, pool_tokens
from ov3det_torch.ops.kernels.quant_conv import (  # noqa: F401  (im2col_int8, int8_conv: re-exported)
    avg_pool,
    im2col_int8,
    int8_conv,
    pool_quantize,
    quant_conv,
    quant_conv_plain,
    quantize_plain,
)

_CHANNELS_LAST = torch.channels_last


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class FrozenBatchNorm(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * scale + bias, the affine computed
    in f32 from the stored statistics and applied in the compute dtype."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None, epsilon: float = 1e-5):
        super().__init__()
        self.dtype, self.epsilon = dtype, epsilon
        for name, fill in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0), ("var", 1.0)):
            self.register_buffer(name, torch.full((channels,), fill))

    def affine(self) -> tuple:
        """(w, b), computed in f32 from the statistics and cast once to the
        compute dtype: the module path's and the stem's folded pass's."""
        inv = torch.rsqrt(self.var + self.epsilon)
        w = self.scale * inv
        b = self.bias - self.mean * inv * self.scale
        if self.dtype is not None:
            w, b = w.to(self.dtype), b.to(self.dtype)
        return w, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.affine()
        if self.dtype is not None:
            x = x.to(self.dtype)
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


class QuantConv(nn.Module):
    """W8A8 trunk conv (`ov3det/models/clip_resnet.py:57-128`), stride 1.

    In JAX's order: xq = clip(round(x / s_x), -127, 127) in f32 with round
    half to even; y = the exact int32 conv; out = y * (s_x * scale) (+ bias
    in "folded" mode), cast to the compute dtype at the end.  `fused`: the
    quantise and the conv are `pool_quantize` and `quant_conv` (the kernels
    on the card), else their plain versions.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int, padding: int = 0,
                 dtype: Optional[torch.dtype] = None, mode: str = "folded", fused: bool = True):
        super().__init__()
        if mode not in ("folded", "static", "dynamic"):
            raise ValueError(f"QuantConv mode {mode!r}: 'folded', 'static' or 'dynamic'")
        self.kernel_size, self.padding, self.dtype, self.mode = kernel_size, padding, dtype, mode
        self.fused = fused
        self.register_buffer("kernel_q", torch.zeros(cout, kernel_size * kernel_size * cin,
                                                     dtype=torch.int8))
        self.register_buffer("scale", torch.ones(cout))
        if mode != "dynamic":
            self.register_buffer("a_scale", torch.ones(()))
        if mode == "folded":
            self.register_buffer("bias", torch.zeros(cout))
        self.a_max: Optional[torch.Tensor] = None  # "dynamic": the largest |x| seen

    def act_scale(self, x: torch.Tensor) -> torch.Tensor:
        """The f32 activation scale s_x of input x: `a_scale`, or in
        "dynamic" mode max|x| / 127 (recorded in `a_max`)."""
        if self.mode != "dynamic":
            return self.a_scale
        a_max = x.float().abs().amax()
        self.a_max = a_max if self.a_max is None else torch.maximum(self.a_max, a_max)
        return torch.clamp(a_max, min=1e-6) / 127.0

    def quantize(self, x: torch.Tensor):
        """x -> (int8 x, its f32 scale s_x), as torch ops."""
        s_x = self.act_scale(x)
        return quantize_plain(x, s_x), s_x

    def conv(self, xq: torch.Tensor, s_x: torch.Tensor, residual=None, relu: bool = False,
             s_next=None, out: bool = True) -> tuple:
        """The int8 product of `xq` (quantised at `s_x`) and its epilogue
        (`quant_conv`'s arguments): -> (output in the compute dtype or
        None, int8 output at `s_next` or None)."""
        fn = quant_conv if self.fused else quant_conv_plain
        bias = self.bias if self.mode == "folded" else None
        return fn(xq, self.kernel_q, self.kernel_size, self.padding, s_x, self.scale, bias,
                  residual, relu, s_next, out, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            s_x = self.act_scale(x)
            xq = pool_quantize(x, 1, (s_x,))[0]
        else:
            xq, s_x = self.quantize(x)
        return self.conv(xq, s_x)[0]


def trunk_conv(quant: Optional[str], dtype, cin: int, cout: int, kernel_size: int,
               padding: int = 0, fused: bool = True) -> nn.Module:
    """The trunk's conv: `QuantConv` in mode `quant` ("folded" | "static" |
    "dynamic"), a plain `Conv` when `quant` is None."""
    if quant:
        return QuantConv(cin, cout, kernel_size, padding, dtype, quant, fused)
    return Conv(cin, cout, kernel_size, padding=padding, dtype=dtype)


def _bn(quant, channels: int, dtype) -> nn.Module:
    """The BatchNorm after a trunk conv; folded into the conv's dequant under
    quant "folded", so no module there."""
    return nn.Identity() if quant == "folded" else FrozenBatchNorm(channels, dtype)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dtype=None, quant=None,
                 fused: bool = True):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.chained = quant == "folded" and fused
        conv = functools.partial(trunk_conv, quant, dtype, fused=fused)
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = _bn(quant, planes, dtype)
        self.conv2 = conv(planes, planes, 3, padding=1)
        self.bn2 = _bn(quant, planes, dtype)
        self.conv3 = conv(planes, out, 1)
        self.bn3 = _bn(quant, out, dtype)
        self.has_downsample = stride > 1 or inplanes != out
        if self.has_downsample:
            self.downsample_conv = conv(inplanes, out, 1)
            self.downsample_bn = _bn(quant, out, dtype)

    def in_scales(self) -> list:
        """The scales the block's input is quantised at, in one pass:
        conv1's, and the downsample conv's when it reads the input unpooled."""
        scales = [self.conv1.a_scale]
        if self.has_downsample and self.stride == 1:
            scales.append(self.downsample_conv.a_scale)
        return scales

    def chain(self, x: Optional[torch.Tensor], xq: list, next_scales: Sequence) -> tuple:
        """The "folded" block on its quantised input.  x: the input in the
        compute dtype (None when only its int8 forms are read: a stride-1
        downsample); xq: one int8 form per `in_scales()`; next_scales: the
        next block's `in_scales()`, empty after the last block.  Returns
        (the output in the compute dtype, its int8 forms at next_scales):
        one form comes from conv3's epilogue, two from a quantise pass."""
        if x is None and not (self.has_downsample and self.stride == 1):
            raise ValueError("Bottleneck.chain: this block reads its input in the compute dtype")
        c1, c2, c3 = self.conv1, self.conv2, self.conv3
        _, h = c1.conv(xq[0], c1.a_scale, relu=True, s_next=c2.a_scale, out=False)
        if self.stride > 1:  # anti-aliased: the avgpool between conv2 and conv3
            h, _ = c2.conv(h, c2.a_scale, relu=True)
            h = pool_quantize(h, self.stride, (c3.a_scale,))[0]
        else:
            _, h = c2.conv(h, c2.a_scale, relu=True, s_next=c3.a_scale, out=False)
        identity = x
        if self.has_downsample:
            ds = self.downsample_conv
            dq = xq[1] if self.stride == 1 else pool_quantize(x, self.stride, (ds.a_scale,))[0]
            identity, _ = ds.conv(dq, ds.a_scale)
        one = next_scales[0] if len(next_scales) == 1 else None
        y, yq = c3.conv(h, c3.a_scale, residual=identity, relu=True, s_next=one)
        if len(next_scales) > 1:
            return y, pool_quantize(y, 1, next_scales)
        return y, [yq] if one is not None else []

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.chained:
            return run_blocks([self], x)
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


def run_blocks(blocks: Sequence[Bottleneck], x: Optional[torch.Tensor],
               xq: Optional[list] = None) -> torch.Tensor:
    """Chained "folded" bottlenecks (`Bottleneck.chain`): each block's last
    epilogue quantises for the next block.  xq: the input's int8 forms at
    `blocks[0].in_scales()`, quantised from x here when None."""
    if xq is None:
        xq = pool_quantize(x, 1, blocks[0].in_scales())
    for i, block in enumerate(blocks):
        x, xq = block.chain(x, xq, blocks[i + 1].in_scales() if i + 1 < len(blocks) else ())
    return x


class ModifiedResNetStem(nn.Module):
    """conv1 stays a plain conv in the compute dtype even in int8 mode (its
    3-channel normalised input has a per-channel std that no per-tensor
    scale folds), so its bn1 stays a live module under quant "folded".  In
    the chain (`chained`: quant "folded", fused) bn1 and the ReLU run inside
    the quantise pass that feeds conv2 (`pool_quantize(..., affine=)`):
    `first` is conv1 alone there."""

    def __init__(self, width: int, dtype=None, quant=None, fused: bool = True):
        super().__init__()
        w = width
        self.chained = quant == "folded" and fused
        self.conv1 = Conv(3, w // 2, 3, stride=2, padding=1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(w // 2, dtype)
        self.conv2 = trunk_conv(quant, dtype, w // 2, w // 2, 3, padding=1, fused=fused)
        self.bn2 = _bn(quant, w // 2, dtype)
        self.conv3 = trunk_conv(quant, dtype, w // 2, w, 3, padding=1, fused=fused)
        self.bn3 = _bn(quant, w, dtype)

    def first(self, x: torch.Tensor) -> torch.Tensor:
        """The stem's part outside the int8 chain: conv1, then bn1 and the
        ReLU unless `chained` (the chain's first pass runs them)."""
        h = self.conv1(x)
        return h if self.chained else torch.relu(self.bn1(h))

    def chain(self, h: torch.Tensor, next_scales: Sequence) -> list:
        """The "folded" stem after `first` (h conv1's output): bn1 and the
        ReLU in conv2's quantise pass, then the pooled output quantised at
        each of `next_scales` (layer1's first block's `in_scales()`)."""
        c2, c3 = self.conv2, self.conv3
        hq = pool_quantize(h, 1, (c2.a_scale,), affine=self.bn1.affine())[0]
        _, hq = c2.conv(hq, c2.a_scale, relu=True, s_next=c3.a_scale, out=False)
        h, _ = c3.conv(hq, c3.a_scale, relu=True)
        return pool_quantize(h, 2, next_scales)

    def rest(self, h: torch.Tensor) -> torch.Tensor:
        """The unfused stem after `first` (h its output)."""
        x = torch.relu(self.bn2(self.conv2(h)))
        x = torch.relu(self.bn3(self.conv3(x)))
        return avg_pool(x, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rest(self.first(x))


class ResNetStage(nn.Module):
    def __init__(self, inplanes: int, planes: int, blocks: int, stride: int = 1, dtype=None,
                 quant=None, fused: bool = True):
        super().__init__()
        self.blocks = blocks
        self.add_module("block0", Bottleneck(inplanes, planes, stride, dtype, quant, fused))
        for i in range(1, blocks):
            self.add_module(f"block{i}", Bottleneck(planes * 4, planes, 1, dtype, quant, fused))

    def bottlenecks(self) -> list:
        return [getattr(self, f"block{i}") for i in range(self.blocks)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.block0.chained:
            return run_blocks(self.bottlenecks(), x)
        for block in self.bottlenecks():
            x = block(x)
        return x


class CLIPResNetBackbone(nn.Module):
    """Stem + res2..res4 (stride 16): (B, H, W, 3) -> (B, H/16, W/16, 16 width)."""

    def __init__(self, width: int = 80, layers: Sequence[int] = (4, 6, 10, 6), dtype=None,
                 quant=None, fused: bool = True):
        super().__init__()
        w = width
        self.stem = ModifiedResNetStem(w, dtype, quant, fused)
        self.layer1 = ResNetStage(w, w, layers[0], 1, dtype, quant, fused)
        self.layer2 = ResNetStage(4 * w, 2 * w, layers[1], 2, dtype, quant, fused)
        self.layer3 = ResNetStage(8 * w, 4 * w, layers[2], 2, dtype, quant, fused)

    def trunk(self, h: torch.Tensor) -> torch.Tensor:
        """Everything after the stem's `first` (h its output): the int8
        chain, or the module path."""
        if self.layer1.block0.chained:
            blocks = [*self.layer1.bottlenecks(), *self.layer2.bottlenecks(),
                      *self.layer3.bottlenecks()]
            xq = self.stem.chain(h, blocks[0].in_scales())
            return run_blocks(blocks, None, xq)
        return self.layer3(self.layer2(self.layer1(self.stem.rest(h))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(self.stem.first(x))


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
    softmax and the pooled token are f32.  The token work is two kernels on
    the card (`ops/kernels/attn_pool.py`: `pool_tokens`, the mean token
    plus pos[0]; `pool_attend`, the logits, softmax and pooled token z),
    their plain versions on the CPU; q, the fold u, v and c are library
    products, as in JAX.  The teacher casts the projections once a forward
    (`cast_weights`) and hands them to each chunk's call."""

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

    def cast_weights(self) -> tuple:
        """The projections as a call uses them: q's weight and bias in the
        compute dtype, the key weight in f32 from the compute dtype as
        (heads, hd, C), z's dtype (the v projection's), the value weight as
        the key's and v's bias in the compute dtype.  In f32 nothing is
        copied."""
        q_w, q_b = self.q_proj.weight, self.q_proj.bias
        k_w, v_w, v_b = self.k_proj.weight, self.v_proj.weight, self.v_proj.bias
        if self.dtype is not None:
            q_w, q_b, k_w, v_w, v_b = (t.to(self.dtype) for t in (q_w, q_b, k_w, v_w, v_b))
        C = k_w.shape[1]
        nh = self.num_heads
        return (q_w, q_b, k_w.float().reshape(nh, C // nh, C), v_w.dtype,
                v_w.float().reshape(nh, C // nh, C), v_b)

    def forward(self, x: torch.Tensor, weights: tuple | None = None) -> torch.Tensor:
        """x (B, H, W, C) -> (B, output_dim), f32; `weights` what
        `cast_weights` returns, cast here when None."""
        B, H, W, C = x.shape
        tokens = x.reshape(B, H * W, C)
        pos = self.positional_embedding
        if pos.shape[0] != H * W + 1:  # a checkpoint's grid at another resolution
            side = int(round((pos.shape[0] - 1) ** 0.5))
            grid = resize_bilinear(pos[1:].float().reshape(side, side, C), H, W)
            pos = torch.cat([pos[:1], grid.reshape(H * W, C).to(pos.dtype)], dim=0)
        pos = pos.to(tokens.dtype)

        nh = self.num_heads
        hd = C // nh
        q_w, q_b, k_f, z_dtype, v_f, v_b = self.cast_weights() if weights is None else weights
        token0 = pool_tokens(tokens, pos[0])  # (B, C): the mean token + pos[0]
        q = F.linear(token0, q_w, q_b).reshape(B, nh, hd)
        u = torch.einsum("bhd,hdc->bhc", q.float(), k_f)
        z = pool_attend(tokens, pos, token0, u.to(tokens.dtype), hd, z_dtype)
        out = torch.einsum("bhc,hdc->bhd", z.float(), v_f)
        out = (out + v_b.reshape(nh, hd)).reshape(B, C)
        return F.linear(out, self.c_proj.weight, self.c_proj.bias)


class CLIPResNetRes5Head(nn.Module):
    """res5 + attention pooling: (R, P, P, 16 width) pooled RoI features ->
    (R, embed_dim)."""

    def __init__(self, width: int = 80, blocks: int = 6, embed_dim: int = 640,
                 image_resolution: int = 288, dtype=None, quant=None, fused: bool = True):
        super().__init__()
        self.layer4 = ResNetStage(16 * width, 8 * width, blocks, 2, dtype, quant, fused)
        self.attnpool = AttentionPool2d(32 * width, 32 * width // 64, image_resolution // 32,
                                        embed_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attnpool(self.layer4(x))
