"""Seeded random weights, made on the device in one draw.

Both sides of a run get the same tensors: the program loads them before
its first step, the reference after the window.  Names and shapes come
from the reference's modules (`reference.detector.Model3DETR`) and from
the teacher's float layout (`teacher_layout`), which are the port's; the
values from one `torch.randn` of a generator seeded with the run's seed,
scaled by a rule of each leaf's name and shape:

  * a matrix or conv kernel: LeCun normal, std 1/sqrt(fan_in);
  * a norm's scale 1 + 0.05 z, a bias or a norm's shift 0.02 z (the
    detector; the frozen teacher's BatchNorm stays at scale 1, shift 0,
    mean 0, var 1, as the port initialises it);
  * the Fourier features' `gauss_B` z; the class text embeddings
    z / sqrt(width); the teacher's positional grid z / sqrt(width);
  * BatchNorm running statistics mean 0, var 1.
"""
from __future__ import annotations

import math

import torch

_FILLS = {"running_mean": 0.0, "running_var": 1.0, "num_batches_tracked": 0.0}
_TEACHER_BN = {"scale": 1.0, "bias": 0.0, "mean": 0.0, "var": 1.0}


def _scale_of(name: str, shape: tuple) -> tuple:
    """(std, offset) of a detector leaf."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "gauss_B":
        return 1.0, 0.0
    if leaf == "text_embed":
        return 1.0 / math.sqrt(shape[-1]), 0.0
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if leaf == "weight":  # a 1-D weight is a norm's scale
        return 0.05, 1.0
    return 0.02, 0.0


def _draw(layout: list, rule, seed: int, device) -> dict:
    """{name: tensor} for [(name, shape)], drawn in one call."""
    drawn = [(n, s) for n, s in layout if rule(n, s) is not None]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in layout:
        r = rule(name, shape)
        if r is None:
            leaf = name.rsplit(".", 1)[-1]
            fill = _FILLS.get(leaf, _TEACHER_BN.get(leaf, 0.0))
            out[name] = torch.full(shape, fill, dtype=torch.float32, device=device)
            continue
        n = math.prod(shape)
        std, offset = r
        out[name] = (flat[off:off + n].view(shape) * std + offset).contiguous()
        off += n
    return out


def detector_state(layout: list, seed: int, device) -> dict:
    """The detector's state dict: [(name, shape)] of its parameters and
    buffers, in state-dict order."""
    def rule(name, shape):
        leaf = name.rsplit(".", 1)[-1]
        return None if leaf in _FILLS else _scale_of(name, shape)

    return _draw(layout, rule, seed, device)


def teacher_layout(width: int, layers, embed_dim: int, image_resolution: int) -> list:
    """[(name, shape)] of the float teacher's state, in the port's order
    (`RegionCLIPTeacher` with no compute dtype: a conv's `weight`, its
    BatchNorm's `scale`, `bias`, `mean`, `var`)."""
    out = []

    def conv(prefix, cin, cout, k):
        out.append((f"{prefix}.weight", (cout, cin, k, k)))

    def bn(prefix, c):
        out.extend((f"{prefix}.{leaf}", (c,)) for leaf in _TEACHER_BN)

    w = width
    conv("backbone.stem.conv1", 3, w // 2, 3)
    bn("backbone.stem.bn1", w // 2)
    conv("backbone.stem.conv2", w // 2, w // 2, 3)
    bn("backbone.stem.bn2", w // 2)
    conv("backbone.stem.conv3", w // 2, w, 3)
    bn("backbone.stem.bn3", w)

    def stage(scope, inplanes, planes, blocks, stride):
        for i in range(blocks):
            cin = inplanes if i == 0 else planes * 4
            p = f"{scope}.block{i}"
            conv(f"{p}.conv1", cin, planes, 1)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3", planes, planes * 4, 1)
            bn(f"{p}.bn3", planes * 4)
            if i == 0 and (stride > 1 or cin != planes * 4):
                conv(f"{p}.downsample_conv", cin, planes * 4, 1)
                bn(f"{p}.downsample_bn", planes * 4)

    stage("backbone.layer1", w, w, layers[0], 1)
    stage("backbone.layer2", 4 * w, 2 * w, layers[1], 2)
    stage("backbone.layer3", 8 * w, 4 * w, layers[2], 2)
    stage("roi_head.layer4", 16 * w, 8 * w, layers[3], 2)
    C = 32 * w
    out.append(("roi_head.attnpool.positional_embedding", ((image_resolution // 32) ** 2 + 1, C)))
    for proj, cout in (("q_proj", C), ("k_proj", C), ("v_proj", C), ("c_proj", embed_dim)):
        out.append((f"roi_head.attnpool.{proj}.weight", (cout, C)))
        out.append((f"roi_head.attnpool.{proj}.bias", (cout,)))
    return out


def teacher_state(layout: list, seed: int, device) -> dict:
    """The float teacher's state from the seed (another stream than the
    detector's: the seed's complement)."""
    def rule(name, shape):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _TEACHER_BN and len(shape) == 1 and ".attnpool." not in name:
            return None
        if leaf == "positional_embedding":
            return 1.0 / math.sqrt(shape[-1]), 0.0
        if leaf == "bias":
            return None
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0

    return _draw(layout, rule, (~seed) & 0x7FFFFFFFFFFFFFFF, device)
