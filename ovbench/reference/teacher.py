"""The frozen RegionCLIP RN50x4 teacher as plain PyTorch.

A frozen copy of the port's unfused module path (`ov3det_torch/models/
regionclip.py`, `clip_resnet.py`, `ops/roi_align.py`) at the precision the
configuration states for it: W8A8 trunk convs (an int8 kernel and an f32
scale per output channel, a calibrated activation scale per conv, the
frozen BatchNorm folded into the dequant), their products exact in integers
(`plain.int8_conv`), and everything else in float32 where the port keeps
bf16.  The reference quantises and calibrates the float weights itself
(`quantize_teacher_params`); nothing of the port's quantised state is read.
In the control (`precision.CONTROL`) the grid is W4A4.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .precision import FLOAT32, Precision
from .calibration import SunrgbdCalibration, project_boxes_to_image
from .plain import avg_pool, int8_conv, normalise_plain, pool_attend_plain, pool_tokens_plain, \
    roi_align_plain

_PIXEL_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32) * 255.0
_PIXEL_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32) * 255.0


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def quantize(x: torch.Tensor, s: torch.Tensor, L: int) -> torch.Tensor:
    """clip(round(x / s), -L, L) as int8, L the grid's largest code."""
    return torch.clamp(torch.round(x.float() / s), -L, L).to(torch.int8)


class FrozenBatchNorm(nn.Module):
    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        for name, fill in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0), ("var", 1.0)):
            self.register_buffer(name, torch.full((channels,), fill))

    def forward(self, x):
        inv = torch.rsqrt(self.var + self.epsilon)
        return x.float() * (self.scale * inv) + (self.bias - self.mean * inv * self.scale)


class Conv(nn.Module):
    def __init__(self, cin, cout, kernel_size, stride=1, padding=0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.register_buffer("weight", torch.zeros(cout, cin, kernel_size, kernel_size))

    def forward(self, x):
        return _nhwc(F.conv2d(_nchw(x.float()), self.weight.float(), stride=self.stride,
                              padding=self.padding))


class QuantConv(nn.Module):
    """The W8A8 conv, stride 1: "folded" (the served teacher) or "dynamic"
    (the calibration pass, which records each input's abs-max)."""

    def __init__(self, cin, cout, kernel_size, padding=0, mode="folded", levels=127):
        super().__init__()
        self.kernel_size, self.padding, self.mode, self.levels = kernel_size, padding, mode, levels
        self.register_buffer("kernel_q", torch.zeros(cout, kernel_size * kernel_size * cin,
                                                     dtype=torch.int8))
        self.register_buffer("scale", torch.ones(cout))
        if mode == "folded":
            self.register_buffer("a_scale", torch.ones(()))
            self.register_buffer("bias", torch.zeros(cout))
        self.a_max = None

    def forward(self, x):
        if self.mode == "dynamic":
            a_max = x.float().abs().amax()
            self.a_max = a_max if self.a_max is None else torch.maximum(self.a_max, a_max)
            s_x = torch.clamp(a_max, min=1e-6) / self.levels
        else:
            s_x = self.a_scale
        y = int8_conv(quantize(x, s_x, self.levels), self.kernel_q, self.kernel_size, self.padding)
        out = y.float() * (s_x * self.scale)
        return out + self.bias if self.mode == "folded" else out


def _bn(quant: str, channels: int) -> nn.Module:
    return nn.Identity() if quant == "folded" else FrozenBatchNorm(channels)


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride, quant, levels):
        super().__init__()
        out = planes * 4
        self.stride = stride
        self.conv1 = QuantConv(inplanes, planes, 1, 0, quant, levels)
        self.bn1 = _bn(quant, planes)
        self.conv2 = QuantConv(planes, planes, 3, 1, quant, levels)
        self.bn2 = _bn(quant, planes)
        self.conv3 = QuantConv(planes, out, 1, 0, quant, levels)
        self.bn3 = _bn(quant, out)
        self.has_downsample = stride > 1 or inplanes != out
        if self.has_downsample:
            self.downsample_conv = QuantConv(inplanes, out, 1, 0, quant, levels)
            self.downsample_bn = _bn(quant, out)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = avg_pool(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.has_downsample:
            if self.stride > 1:
                identity = avg_pool(x, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return torch.relu(out + identity)


class ModifiedResNetStem(nn.Module):
    def __init__(self, w, quant, levels):
        super().__init__()
        self.conv1 = Conv(3, w // 2, 3, stride=2, padding=1)
        self.bn1 = FrozenBatchNorm(w // 2)
        self.conv2 = QuantConv(w // 2, w // 2, 3, 1, quant, levels)
        self.bn2 = _bn(quant, w // 2)
        self.conv3 = QuantConv(w // 2, w, 3, 1, quant, levels)
        self.bn3 = _bn(quant, w)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = torch.relu(self.bn3(self.conv3(h)))
        return avg_pool(h, 2)


class ResNetStage(nn.Module):
    def __init__(self, inplanes, planes, blocks, stride, quant, levels):
        super().__init__()
        self.blocks = blocks
        self.add_module("block0", Bottleneck(inplanes, planes, stride, quant, levels))
        for i in range(1, blocks):
            self.add_module(f"block{i}", Bottleneck(planes * 4, planes, 1, quant, levels))

    def forward(self, x):
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class CLIPResNetBackbone(nn.Module):
    def __init__(self, width, layers, quant, levels):
        super().__init__()
        w = width
        self.stem = ModifiedResNetStem(w, quant, levels)
        self.layer1 = ResNetStage(w, w, layers[0], 1, quant, levels)
        self.layer2 = ResNetStage(4 * w, 2 * w, layers[1], 2, quant, levels)
        self.layer3 = ResNetStage(8 * w, 4 * w, layers[2], 2, quant, levels)

    def forward(self, x):
        return self.layer3(self.layer2(self.layer1(self.stem(x))))


class _Proj(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.register_buffer("weight", torch.zeros(cout, cin))
        self.register_buffer("bias", torch.zeros(cout))


class AttentionPool2d(nn.Module):
    """CLIP's attention pool, folded to its single query (the mean token),
    in float32."""

    def __init__(self, embed_dim, num_heads, spacial_dim, output_dim):
        super().__init__()
        C = embed_dim
        self.num_heads = num_heads
        self.register_buffer("positional_embedding", torch.zeros(spacial_dim ** 2 + 1, C))
        self.q_proj = _Proj(C, C)
        self.k_proj = _Proj(C, C)
        self.v_proj = _Proj(C, C)
        self.c_proj = _Proj(C, output_dim)

    def forward(self, x):
        B, H, W, C = x.shape
        tokens = x.reshape(B, H * W, C).float()
        pos = self.positional_embedding.float()
        nh = self.num_heads
        hd = C // nh
        token0 = pool_tokens_plain(tokens, pos[0])
        q = F.linear(token0, self.q_proj.weight, self.q_proj.bias).reshape(B, nh, hd)
        u = torch.einsum("bhd,hdc->bhc", q, self.k_proj.weight.float().reshape(nh, hd, C))
        z = pool_attend_plain(tokens, pos, token0, u, hd, torch.float32)
        out = torch.einsum("bhc,hdc->bhd", z.float(), self.v_proj.weight.float().reshape(nh, hd, C))
        out = (out + self.v_proj.bias.reshape(nh, hd)).reshape(B, C)
        return F.linear(out, self.c_proj.weight, self.c_proj.bias)


class CLIPResNetRes5Head(nn.Module):
    def __init__(self, width, blocks, embed_dim, image_resolution, quant, levels):
        super().__init__()
        self.layer4 = ResNetStage(16 * width, 8 * width, blocks, 2, quant, levels)
        self.attnpool = AttentionPool2d(32 * width, 32 * width // 64, image_resolution // 32,
                                        embed_dim)


class RegionCLIPTeacher(nn.Module):
    """image -> stem..res4 -> RoIAlign 18 x 18 at 1/16 -> res5 ->
    attention pool, the regions in chunks of `roi_chunk_regions`."""

    def __init__(self, width=80, layers=(4, 6, 10, 6), embed_dim=640, pooler_resolution=18,
                 pooler_scale=1.0 / 16.0, image_resolution=288, roi_chunk_regions=256,
                 quant="folded", prec: Precision = FLOAT32):
        super().__init__()
        self.hparams = dict(width=width, layers=tuple(layers), embed_dim=embed_dim,
                            pooler_resolution=pooler_resolution, pooler_scale=pooler_scale,
                            image_resolution=image_resolution,
                            roi_chunk_regions=roi_chunk_regions)
        self.pooler_resolution, self.pooler_scale = pooler_resolution, pooler_scale
        self.roi_chunk_regions = roi_chunk_regions
        self.backbone = CLIPResNetBackbone(width, layers, quant, prec.int_levels)
        self.roi_head = CLIPResNetRes5Head(width, layers[3], embed_dim, image_resolution, quant,
                                           prec.int_levels)
        self.register_buffer("pixel_mean", torch.from_numpy(_PIXEL_MEAN), persistent=False)
        self.register_buffer("inv_std", torch.from_numpy(np.float32(1.0) / _PIXEL_STD),
                             persistent=False)

    def load(self, state: dict) -> "RegionCLIPTeacher":
        own = self.state_dict()
        if set(own) != set(state):
            raise KeyError(f"teacher state: missing {sorted(set(own) - set(state))[:3]}, "
                           f"unexpected {sorted(set(state) - set(own))[:3]}")
        for key, v in state.items():
            module, leaf = key.rsplit(".", 1)
            self.get_submodule(module).register_buffer(leaf, v.to(own[key].device))
        return self

    def quant_convs(self) -> dict:
        return {name: m for name, m in self.named_modules() if isinstance(m, QuantConv)}

    @torch.no_grad()
    def forward(self, images, boxes):
        """images (B, H, W, 3) in [0, 255]; boxes (B, Q, 4) pixels -> (B, Q, C) f32."""
        B, Q = boxes.shape[:2]
        x = normalise_plain(images, self.pixel_mean, self.inv_std)
        feat = self.backbone(x)
        P = self.pooler_resolution
        chunk_q = max(1, min(Q, self.roi_chunk_regions // max(B, 1)))
        embs = []
        for q0 in range(0, Q, chunk_q):
            boxes_c = boxes[:, q0:q0 + chunk_q]
            qc = boxes_c.shape[1]
            pooled = roi_align_plain(feat, boxes_c.reshape(B * qc, 4), None, self.pooler_scale,
                                     P, per_image=qc)
            res5 = self.roi_head.layer4(pooled)
            embs.append(self.roi_head.attnpool(res5).reshape(B, qc, -1))
        return torch.cat(embs, dim=1)


def calibration_boxes(rng, h: float, w: float, n: int = 8) -> np.ndarray:
    """(1, n, 4) boxes inside the image: corners uniform in the top-left
    quarter, sides 8 to half the image (the port's calibration boxes)."""
    x1 = rng.uniform(0, w * 0.5, size=(1, n)).astype(np.float32)
    y1 = rng.uniform(0, h * 0.5, size=(1, n)).astype(np.float32)
    return np.stack([x1, y1, np.minimum(x1 + rng.uniform(8, w * 0.5, (1, n)), w - 1.0),
                     np.minimum(y1 + rng.uniform(8, h * 0.5, (1, n)), h - 1.0)],
                    axis=-1).astype(np.float32)


def quantize_teacher_params(state: dict, hparams: dict, images, boxes, prec: Precision,
                            calib_margin: float = 1.25) -> dict:
    """The float state -> the folded W8A8 state, as the configuration
    defines it: each trunk conv but the stem's conv1 quantised per output
    channel on a symmetric abs-max grid; the activation scales calibrated
    by one forward in "dynamic" mode on (images, boxes), a_scale = a_max *
    calib_margin / L; each conv's BatchNorm folded into its dequant."""
    L = prec.int_levels
    modules: dict = {}
    for key, v in state.items():
        module, leaf = key.rsplit(".", 1)
        modules.setdefault(module, {})[leaf] = v
    q = {}
    for module, leaves in modules.items():
        w = leaves.get("weight")
        if set(leaves) == {"weight"} and w.dim() == 4 and module != "backbone.stem.conv1":
            flat = w.float().permute(0, 2, 3, 1).reshape(w.shape[0], -1)
            s = torch.clamp(flat.abs().amax(dim=1) / L, min=1e-12)
            q[f"{module}.kernel_q"] = torch.clamp(torch.round(flat / s[:, None]), -L, L
                                                  ).to(torch.int8).contiguous()
            q[f"{module}.scale"] = s
        else:
            q.update({f"{module}.{leaf}": v.float() for leaf, v in leaves.items()})
    device = next(iter(state.values())).device
    calib = RegionCLIPTeacher(**hparams, quant="dynamic", prec=prec).to(device).load(q)
    calib(torch.as_tensor(np.asarray(images, np.float32)).to(device),
          torch.as_tensor(np.asarray(boxes, np.float32)).to(device))
    eps = 1e-5
    for name, conv in calib.quant_convs().items():
        a_max = float(conv.a_max)
        q[f"{name}.a_scale"] = torch.tensor(max(a_max, 1e-6) * calib_margin / L,
                                            dtype=torch.float32, device=device)
        parent, leaf = name.rsplit(".", 1)
        bn = f"{parent}.{'downsample_bn' if leaf == 'downsample_conv' else 'bn' + leaf[-1]}"
        stats = {k: q.pop(f"{bn}.{k}").float() for k in ("scale", "bias", "mean", "var")}
        w = stats["scale"] / torch.sqrt(stats["var"] + eps)
        q[f"{name}.scale"] = q[f"{name}.scale"] * w
        q[f"{name}.bias"] = stats["bias"] - stats["mean"] * w
    return q


def build_teacher(state: dict, hparams: dict, images, boxes,
                  prec: Precision = FLOAT32) -> RegionCLIPTeacher:
    """The served teacher from the float state, quantised and calibrated here."""
    device = next(iter(state.values())).device
    q = quantize_teacher_params(state, hparams, images, boxes, prec)
    return RegionCLIPTeacher(**hparams, prec=prec).to(device).load(q)


def teacher_features(teacher: RegionCLIPTeacher, batch: dict, outputs: dict) -> tuple:
    """The criterion's hook: the final layer's predicted boxes, detached,
    projected into each canvas and clamped to it -> (those boxes (B, Q, 4),
    the region features (B, Q, C))."""
    calib = SunrgbdCalibration(batch["calib_Rtilt"], batch["calib_K"])
    boxes = project_boxes_to_image(
        calib, outputs["center_unnormalized"][-1].detach().float(),
        outputs["size_unnormalized"][-1].detach().float(),
        outputs["angle_continuous"][-1].detach().float(),
        image_hw=torch.stack([batch["image_height"], batch["image_width"]], -1))
    return boxes, teacher(batch["image"], boxes)

