"""The frozen RegionCLIP 2D teacher: CLIP-space features of image regions.

A copy of `ov3det/models/regionclip.py` (reference models/model_regionclip.py:
15-22, invoked from the criterion at criterion.py:363-399): given the full
canvases and per-query projected 2D boxes,

    image -> ModifiedResNet stem..res4 (stride 16)
          -> RoIAlign (pooler 18 x 18, scale 1/16) on the boxes
          -> res5 -> AttentionPool2d -> (B, Q, 640)

The teacher holds its weights as buffers and takes no gradient; the
2D-alignment loss aligns the detector's `visual_embeds` with its output.
Its weights live in a flat state dict with torch layouts and the JAX tree's
names (`backbone.stem.conv1.weight`, `roi_head.attnpool.q_proj.bias`, ...):
`init_teacher_state` draws them from a seed, `convert_torch_checkpoint`
reads a RegionCLIP or CLIP checkpoint, `models.convert.
from_flax_teacher_variables` maps the JAX package's trees, and
`cast_teacher_params` / `quantize_teacher_params` turn an f32 state into
the bf16 or int8 one its compute dtype runs.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ov3det_torch.device import resolve_device
from ov3det_torch.models.clip_resnet import CLIPResNetBackbone, CLIPResNetRes5Head, QuantConv
from ov3det_torch.ops.roi_align import roi_align_batched
from ov3det_torch.utils.calibration import SunrgbdCalibration, project_boxes_to_image

# CLIP RGB normalisation (the scale detectron2's CLIP models use)
_PIXEL_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32) * 255.0
_PIXEL_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32) * 255.0
_INV_STD = np.float32(1.0) / _PIXEL_STD

COMPUTE_DTYPES = (None, "bfloat16", "int8", "int8_calib")


class RegionCLIPTeacher(nn.Module):
    """compute_dtype: None (f32), "bfloat16" (bf16 trunk and
    attnpool projections), "int8" (the folded W8A8 trunk of
    `quantize_teacher_params`, everything else bf16) or "int8_calib" (the
    calibration mode: dynamic activation scales, BatchNorm live).  The
    region head runs in chunks of at most `roi_chunk_regions` regions.
    `fused` (int8): the trunk as a chain of `quant_conv` kernels whose
    epilogues carry the residuals, ReLUs and next quantises
    (`clip_resnet.run_blocks`); False keeps the unfused module path, the
    same bits, for comparison.  Built on `device`: CUDA unless the caller passes "cpu"; raises when
    CUDA is asked for and absent."""

    def __init__(self, width: int = 80, layers: tuple = (4, 6, 10, 6), embed_dim: int = 640,
                 pooler_resolution: int = 18, pooler_scale: float = 1.0 / 16.0,
                 image_resolution: int = 288, compute_dtype: Optional[str] = None,
                 roi_chunk_regions: int = 256, fused: bool = True, device=None):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown teacher compute_dtype {compute_dtype!r}")
        self.hparams = dict(width=width, layers=tuple(layers), embed_dim=embed_dim,
                            pooler_resolution=pooler_resolution, pooler_scale=pooler_scale,
                            image_resolution=image_resolution, compute_dtype=compute_dtype,
                            roi_chunk_regions=roi_chunk_regions, fused=fused)
        self.compute_dtype = compute_dtype
        self.quant = {"int8": "folded", "int8_calib": "dynamic"}.get(compute_dtype)
        self.dtype = torch.bfloat16 if compute_dtype in ("bfloat16", "int8", "int8_calib") else None
        self.roi_chunk_regions = roi_chunk_regions
        self.pooler_resolution, self.pooler_scale = pooler_resolution, pooler_scale
        self.image_resolution = image_resolution
        self.backbone = CLIPResNetBackbone(width, layers, self.dtype, self.quant, fused)
        self.roi_head = CLIPResNetRes5Head(width, layers[3], embed_dim, image_resolution,
                                           self.dtype, self.quant, fused)
        # the CLIP normalisation, copied to the device once with the
        # weights, not on every forward; not weights, so not in state_dict
        self.register_buffer("pixel_mean", torch.from_numpy(_PIXEL_MEAN), persistent=False)
        self.register_buffer("inv_std", torch.from_numpy(_INV_STD), persistent=False)
        self.eval()
        self.to(resolve_device(device))

    def clone(self, **changes) -> "RegionCLIPTeacher":
        """A new teacher (weights at their placeholders) with these
        hyperparameters, on this one's device."""
        device = next(self.buffers()).device
        return RegionCLIPTeacher(**{**self.hparams, **changes}, device=device)

    def load(self, state: dict) -> "RegionCLIPTeacher":
        """Take `state`'s tensors as the weights, with their dtypes (a bf16
        weight stays bf16, unlike `load_state_dict`, which casts to the
        placeholder's): the keys and shapes must be the teacher's own."""
        own = self.state_dict()
        if set(own) != set(state):
            raise KeyError(f"teacher state: missing {sorted(set(own) - set(state))[:3]}, "
                           f"unexpected {sorted(set(state) - set(own))[:3]}")
        for key, v in state.items():
            if tuple(v.shape) != tuple(own[key].shape):
                raise ValueError(f"{key}: shape {tuple(v.shape)}, expected {tuple(own[key].shape)}")
            module, leaf = key.rsplit(".", 1)
            v = v.to(own[key].device)
            if v.dim() == 4:
                v = v.contiguous(memory_format=torch.channels_last)
            self.get_submodule(module).register_buffer(leaf, v)
        return self

    def quant_convs(self) -> dict:
        return {name: m for name, m in self.named_modules() if isinstance(m, QuantConv)}

    def forward(self, images: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) RGB in [0, 255] (uint8 or float); boxes
        (B, Q, 4) [x1, y1, x2, y2] pixels -> (B, Q, embed_dim) f32.  Its parts
        are profiler ranges: "normalise", "stem conv1" (conv1, bn1, ReLU),
        "trunk" (the rest of the backbone), and a chunk's "roi_align", "res5"
        and "attnpool"."""
        B, Q = boxes.shape[:2]
        with record_function("normalise"):
            # straight into the compute dtype: the canvas batch is the
            # largest tensor the step reads
            x = (images.float() - self.pixel_mean) * self.inv_std
            if self.dtype is not None:
                x = x.to(self.dtype)
        with record_function("stem conv1"):
            h = self.backbone.stem.first(x)
        with record_function("trunk"):
            feat = self.backbone.trunk(h)
        P = self.pooler_resolution
        chunk_q = max(1, min(Q, self.roi_chunk_regions // max(B, 1)))
        with record_function("attnpool"):  # the projections cast once, not a chunk
            pool_weights = self.roi_head.attnpool.cast_weights()
        embs = []
        for q0 in range(0, Q, chunk_q):
            boxes_c = boxes[:, q0:q0 + chunk_q]
            qc = boxes_c.shape[1]
            with record_function("roi_align"):
                pooled = roi_align_batched(feat, boxes_c, self.pooler_scale, P)
            with record_function("res5"):
                res5 = self.roi_head.layer4(pooled.reshape(B * qc, P, P, -1))
            with record_function("attnpool"):
                embs.append(self.roi_head.attnpool(res5, pool_weights).reshape(B, qc, -1))
        return torch.cat(embs, dim=1) if len(embs) > 1 else embs[0]


# ------------------------------------------------------------ weights
def _module_of(key: str) -> str:
    return key.rsplit(".", 1)[0]


def init_teacher_state(teacher: RegionCLIPTeacher, seed: int = 0) -> dict:
    """Seeded random f32 weights (flax's default initialisers: conv and
    dense kernels LeCun-normal, truncated at 2 sigma; BatchNorm scale 1,
    bias 0, mean 0, var 1; the positional grid normal with std C^-0.5),
    drawn on the CPU in key order so that every device gets the same
    numbers, then moved to the teacher's device."""
    f32 = RegionCLIPTeacher(**{**teacher.hparams, "compute_dtype": None}, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    device = next(teacher.buffers()).device
    state = {}
    for key, buf in f32.state_dict().items():
        leaf = key.rsplit(".", 1)[1]
        if leaf == "weight":
            fan_in = buf[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncated-normal correction
            w = torch.empty(buf.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
        elif leaf == "positional_embedding":
            w = torch.randn(buf.shape, generator=gen) * buf.shape[1] ** -0.5
        else:
            w = buf.clone()  # BatchNorm statistics and affine, biases: their fills
        state[key] = w.to(device)
    return state


def cast_teacher_params(state: dict, compute_dtype: Optional[str] = "bfloat16") -> dict:
    """Cast the frozen tower's weights to bf16 once, at load
    (`ov3det/models/regionclip.py:128-169`).  Kept f32: BatchNorm
    statistics and affine (folded in f32 at apply), the attnpool c_proj and
    the positional grid (resized in f32 at apply); a quantized conv's int8
    kernel and f32 scales stay as they are.  Other dtypes: unchanged."""
    if compute_dtype != "bfloat16":
        return state
    quantized = {_module_of(k) for k in state if k.endswith(".kernel_q")}
    out = {}
    for key, v in state.items():
        parts = key.split(".")
        module = parts[-2] if len(parts) > 1 else ""
        keep = (_module_of(key) in quantized or "c_proj" in parts
                or parts[-1] == "positional_embedding"
                or module.startswith("bn") or module == "downsample_bn"
                or v.dtype != torch.float32)
        out[key] = v if keep else v.to(torch.bfloat16)
    return out


def _bilinear_upsample_np(low: np.ndarray, H: int, W: int) -> np.ndarray:
    """(h, w, C) -> (H, W, C) separable bilinear resize in numpy."""

    def axis_lerp(a, n_out, axis):
        n_in = a.shape[axis]
        pos = np.linspace(0.0, n_in - 1.0, n_out, dtype=np.float32)
        i0 = np.floor(pos).astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        t = (pos - i0).astype(np.float32)
        lo = np.take(a, i0, axis=axis)
        hi = np.take(a, i1, axis=axis)
        shape = [1] * a.ndim
        shape[axis] = n_out
        return lo + (hi - lo) * t.reshape(shape)

    return axis_lerp(axis_lerp(low.astype(np.float32), H, 0), W, 1)


def _smooth_calibration_images(rng, B: int, H: int, W: int) -> np.ndarray:
    """The default calibration content: a low-frequency bilinear base and
    +-30 per-pixel luma detail, the activation range camera images drive
    (uniform noise would drive the early convs far wider)."""
    low = rng.uniform(30.0, 225.0, size=(B, H // 8 + 1, W // 8 + 1, 3))
    base = np.stack([_bilinear_upsample_np(low[b], H, W) for b in range(B)])
    luma = rng.uniform(-30.0, 30.0, size=(B, H, W, 1))
    return np.clip(base + luma, 0.0, 255.0).astype(np.float32)


def calibration_boxes(rng, h: float, w: float, n: int = 8) -> np.ndarray:
    """(1, n, 4) boxes: corners uniform in the top-left quarter, sides 8 to
    half the image, inside the image."""
    x1 = rng.uniform(0, w * 0.5, size=(1, n)).astype(np.float32)
    y1 = rng.uniform(0, h * 0.5, size=(1, n)).astype(np.float32)
    return np.stack([x1, y1, np.minimum(x1 + rng.uniform(8, w * 0.5, (1, n)), w - 1.0),
                     np.minimum(y1 + rng.uniform(8, h * 0.5, (1, n)), h - 1.0)],
                    axis=-1).astype(np.float32)


def quantize_teacher_params(state: dict, compute_dtype: Optional[str] = "int8",
                            teacher: Optional[RegionCLIPTeacher] = None,
                            calib: Optional[tuple] = None, calib_margin: float = 1.25) -> dict:
    """Post-training W8A8 quantisation of the frozen trunk, at load
    (`ov3det/models/regionclip.py:202-357`).

    Every trunk conv but the stem's conv1 gets an int8 kernel and an f32
    scale per output channel (symmetric abs-max grid); the rest is cast as
    `cast_teacher_params` does; one forward in "int8_calib" mode on the
    teacher's own device records each conv input's abs-max, and
    a_scale = a_max * calib_margin / 127; then each conv's BatchNorm is
    folded into its dequant (scale *= w, bias = b) and removed.  `calib` is
    an (images, boxes) pair, else a deterministic smooth synthetic batch.
    With any other compute_dtype this is `cast_teacher_params`.
    """
    if compute_dtype != "int8":
        return cast_teacher_params(state, compute_dtype)
    if teacher is None:
        raise ValueError("int8 quantisation calibrates activation scales with one forward "
                         "pass: pass the RegionCLIPTeacher")
    modules: dict[str, dict] = {}
    for key, v in state.items():
        module, leaf = key.rsplit(".", 1)
        modules.setdefault(module, {})[leaf] = v
    q = {}
    for module, leaves in modules.items():
        w = leaves.get("weight")
        if set(leaves) == {"weight"} and w.dim() == 4 and module != "backbone.stem.conv1":
            flat = w.float().permute(0, 2, 3, 1).reshape(w.shape[0], -1)  # (out, kh kw in)
            s = torch.clamp(flat.abs().amax(dim=1) / 127.0, min=1e-12)
            q[f"{module}.kernel_q"] = torch.clamp(torch.round(flat / s[:, None]), -127, 127
                                                  ).to(torch.int8).contiguous()
            q[f"{module}.scale"] = s
        else:
            q.update({f"{module}.{leaf}": v for leaf, v in leaves.items()})
    q = cast_teacher_params(q, "bfloat16")

    device = next(teacher.buffers()).device
    if calib is None:
        rng = np.random.default_rng(0)
        ih = iw = max(64, int(teacher.image_resolution))
        images = _smooth_calibration_images(rng, 1, ih, iw)
        boxes = calibration_boxes(rng, ih, iw)
    else:
        images, boxes = calib
    calib_teacher = teacher.clone(compute_dtype="int8_calib").load(q)
    with torch.no_grad():
        calib_teacher(torch.as_tensor(np.asarray(images, np.float32)).to(device),
                      torch.as_tensor(np.asarray(boxes, np.float32)).to(device))
    for name, conv in calib_teacher.quant_convs().items():
        a_max = float(conv.a_max)
        q[f"{name}.a_scale"] = torch.tensor(max(a_max, 1e-6) * calib_margin / 127.0,
                                            dtype=torch.float32, device=device)

    eps = 1e-5  # FrozenBatchNorm.epsilon
    for name in calib_teacher.quant_convs():
        parent, conv = name.rsplit(".", 1)
        bn = f"{parent}.{'downsample_bn' if conv == 'downsample_conv' else 'bn' + conv[-1]}"
        stats = {leaf: q.pop(f"{bn}.{leaf}").float() for leaf in ("scale", "bias", "mean", "var")}
        w = stats["scale"] / torch.sqrt(stats["var"] + eps)
        q[f"{name}.scale"] = q[f"{name}.scale"] * w
        q[f"{name}.bias"] = stats["bias"] - stats["mean"] * w
    return q


# ------------------------------------------------------------ the criterion's hook
def make_teacher_fn(teacher: RegionCLIPTeacher, per_layer: bool = False) -> Callable:
    """`teacher_fn(batch, outputs)` -> frozen region features, without
    gradient (`ov3det/models/regionclip.py:360-422`).

    The detector's predicted boxes (`center_unnormalized`,
    `size_unnormalized`, `angle_continuous`, detached) are projected into
    each canvas with the batch's calibration and clamped to its image
    size.  per_layer=False (the default, hoisted) runs the teacher once on
    the final decoder layer's boxes: (B, Q, C), shared by every aux loss;
    per_layer=True runs it on every layer's boxes, as the reference does
    (criterion.py:434-442): (L, B, Q, C), L times the cost.
    """

    def project(batch: dict, outputs: dict, layer: int) -> torch.Tensor:
        calib = SunrgbdCalibration(batch["calib_Rtilt"], batch["calib_K"])
        return project_boxes_to_image(
            calib,
            outputs["center_unnormalized"][layer].detach().float(),
            outputs["size_unnormalized"][layer].detach().float(),
            outputs["angle_continuous"][layer].detach().float(),
            image_hw=torch.stack([batch["image_height"], batch["image_width"]], -1))

    @torch.no_grad()
    def teacher_fn(batch: dict, outputs: dict) -> torch.Tensor:
        if not per_layer:
            return teacher(batch["image"], project(batch, outputs, -1))
        L = outputs["center_unnormalized"].shape[0]
        return torch.stack([teacher(batch["image"], project(batch, outputs, l))
                            for l in range(L)])

    return teacher_fn


# ------------------------------------------------------------ checkpoints
def _bn(v: dict, prefix: str, out_prefix: str) -> dict:
    return {f"{out_prefix}.scale": v[f"{prefix}.weight"], f"{out_prefix}.bias": v[f"{prefix}.bias"],
            f"{out_prefix}.mean": v[f"{prefix}.running_mean"],
            f"{out_prefix}.var": v[f"{prefix}.running_var"]}


def _block(v: dict, prefix: str, out: str) -> dict:
    d = {}
    for i in (1, 2, 3):
        d[f"{out}.conv{i}.weight"] = v[f"{prefix}.conv{i}.weight"]
        d.update(_bn(v, f"{prefix}.bn{i}", f"{out}.bn{i}"))
    if f"{prefix}.downsample.0.weight" in v:
        d[f"{out}.downsample_conv.weight"] = v[f"{prefix}.downsample.0.weight"]
        d.update(_bn(v, f"{prefix}.downsample.1", f"{out}.downsample_bn"))
    return d


def convert_torch_checkpoint(path: str, layers=(4, 6, 10, 6),
                             visual_prefix: Optional[str] = None) -> dict:
    """A RegionCLIP or CLIP checkpoint -> the teacher's f32 state
    (`ov3det/models/regionclip.py:425-514`): a raw CLIP state dict (keys
    `visual.*`) or a detectron2 RegionCLIP checkpoint ({"model":
    {"backbone.visual.*": ...}}).  The port keeps torch's layouts, so this
    is a renaming."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    sd = {k: torch.as_tensor(v) for k, v in sd.items() if hasattr(v, "shape")}
    if visual_prefix is None:
        for cand in ("backbone.visual", "visual", "backbone"):
            if any(k.startswith(cand + ".conv1") for k in sd):
                visual_prefix = cand
                break
    if visual_prefix is None:
        raise ValueError(f"{path}: no visual tower found in {list(sd)[:5]}")
    v = {k[len(visual_prefix) + 1:]: a.float() for k, a in sd.items()
         if k.startswith(visual_prefix + ".")}
    state = {}
    for i in (1, 2, 3):
        state[f"backbone.stem.conv{i}.weight"] = v[f"conv{i}.weight"]
        state.update(_bn(v, f"bn{i}", f"backbone.stem.bn{i}"))
    for stage, n in zip(("layer1", "layer2", "layer3", "layer4"), layers):
        scope = "roi_head" if stage == "layer4" else "backbone"
        for b in range(n):
            state.update(_block(v, f"{stage}.{b}", f"{scope}.{stage}.block{b}"))
    state["roi_head.attnpool.positional_embedding"] = v["attnpool.positional_embedding"]
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        for leaf in ("weight", "bias"):
            state[f"roi_head.attnpool.{proj}.{leaf}"] = v[f"attnpool.{proj}.{leaf}"]
    return state
