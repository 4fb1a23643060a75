"""Image, depth and pose loading of ScanNet's frames.

A copy of `ov3det/datasets/image_utils.py` (reference
utils/image_util.py:17-99): the aspect-preserving NEAREST resize and centre
crop, the normalisation with the reference's ScanNet statistics, depth maps
in metres, 4 x 4 camera poses and a scene's frames padded to a fixed count.
The JAX package reads and resizes with PIL; the port reads JPEGs with
`utils/jpeg.py`, PNGs with `utils/png.py`, and resizes at PIL's sample
positions, so that every value is the JAX package's.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

from ov3det_torch.utils.jpeg import read_jpeg
from ov3det_torch.utils.png import read_png

# normalization constants from the reference (utils/image_util.py:41)
SCANNET_IMAGE_MEAN = np.array([0.496342, 0.466664, 0.440796], np.float32)
SCANNET_IMAGE_STD = np.array([0.277856, 0.28623, 0.291129], np.float32)


def nearest_indices(size_in: int, size_out: int, accumulate: bool) -> np.ndarray:
    """The source index of each of `size_out` samples of PIL's NEAREST
    resize, the integer part of a position in double precision.

    Pillow takes two routes.  For 8-bit and 32-bit images
    (ImagingScaleAffine, `accumulate`) the position starts at half a step and
    grows by one step, `size_in / size_out`, one output sample at a time;
    for 16-bit ("I;16") images (ImagingGenericTransform) it is the closed
    form (x + 0.5) * step.  The two differ at some sizes: 14 of 342 columns
    at 1296 -> 342."""
    step = float(size_in) / size_out
    if not accumulate:
        return ((np.arange(size_out) + 0.5) * step).astype(np.int64)
    pos = np.empty(size_out, np.float64)
    acc = step * 0.5
    for i in range(size_out):
        pos[i] = acc
        acc += step
    return pos.astype(np.int64)


def resize_crop_image(image: np.ndarray, new_dims: tuple[int, int]) -> np.ndarray:
    """Aspect-preserving NEAREST resize to height, then center-crop width,
    as `ov3det/datasets/image_utils.py` does with PIL.

    new_dims: (width, height) like the reference (utils/image_util.py:24-33).
    image: uint8 (H, W, 3), or a uint16 or int32 (H, W) depth map.
    """
    w, h = image.shape[1], image.shape[0]
    new_w, new_h = new_dims
    if (w, h) == (new_w, new_h):
        return image
    resize_width = int(math.floor(new_h * float(w) / float(h)))
    accumulate = image.dtype != np.uint16
    rows = nearest_indices(h, new_h, accumulate)
    cols = nearest_indices(w, resize_width, accumulate)
    # PIL's crop box: columns outside the resized image are zeros
    left = (resize_width - new_w) // 2
    out = np.zeros((new_h, new_w) + image.shape[2:], image.dtype)
    lo, hi = max(left, 0), min(left + new_w, resize_width)
    out[:, lo - left:hi - left] = image[rows[:, None], cols[None, lo:hi]]
    return out


def load_image(path: str, dims: tuple[int, int]) -> np.ndarray:
    """RGB image -> (3, H, W) float32, normalized."""
    img = read_jpeg(path)
    if img.ndim == 2:  # greyscale, widened as PIL's convert("RGB")
        img = np.repeat(img[:, :, None], 3, axis=2)
    img = resize_crop_image(img, dims)
    img = img.astype(np.float32) / 255.0
    img = (img - SCANNET_IMAGE_MEAN) / SCANNET_IMAGE_STD
    return img.transpose(2, 0, 1)


def load_depth(path: str, dims: tuple[int, int]) -> np.ndarray:
    """16-bit depth PNG -> (H, W) float32 meters."""
    depth = read_png(path)
    depth = resize_crop_image(depth, dims)
    return depth.astype(np.float32) / 1000.0


def load_pose(path: str) -> np.ndarray:
    with open(path) as fh:
        lines = fh.read().splitlines()
    return np.array([[float(v) for v in ln.split(" ")] for ln in lines[:4]], np.float32)


def load_scene_frames(
    frames_dir: str,
    scan_name: str,
    image_dims: tuple[int, int] = (328, 256),
    depth_dims: tuple[int, int] = (41, 32),
    max_frames: Optional[int] = None,
):
    """Load all frames of one scene (reference datasets/scannet.py:276-285).

    Returns (images (F,3,H,W), depths (F,h,w), poses (F,4,4), mask (F,));
    when max_frames is given, pads/truncates to a FIXED frame count (the
    reference leaves F ragged, which cannot batch): zero images and depths,
    identity poses, mask 0.
    """
    frame_dir = os.path.join(frames_dir, scan_name, "color")
    frame_list = sorted(x.split(".")[0] for x in os.listdir(frame_dir))
    if max_frames is not None:
        frame_list = frame_list[:max_frames]
    images, depths, poses = [], [], []
    for fid in frame_list:
        images.append(load_image(
            os.path.join(frames_dir, scan_name, "color", f"{fid}.jpg"), image_dims))
        depths.append(load_depth(
            os.path.join(frames_dir, scan_name, "depth", f"{fid}.png"), depth_dims))
        poses.append(load_pose(
            os.path.join(frames_dir, scan_name, "pose", f"{fid}.txt")))
    F = len(frame_list)
    images = np.stack(images) if F else np.zeros((0, 3, image_dims[1], image_dims[0]), np.float32)
    depths = np.stack(depths) if F else np.zeros((0, depth_dims[1], depth_dims[0]), np.float32)
    poses = np.stack(poses) if F else np.zeros((0, 4, 4), np.float32)
    if max_frames is None:
        return images, depths, poses, np.ones(F, np.float32)
    pad = max_frames - F
    mask = np.concatenate([np.ones(F, np.float32), np.zeros(pad, np.float32)])
    if pad > 0:
        images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], np.float32)])
        depths = np.concatenate([depths, np.zeros((pad,) + depths.shape[1:], np.float32)])
        poses = np.concatenate([poses, np.tile(np.eye(4, dtype=np.float32)[None], (pad, 1, 1))])
    return images, depths, poses, mask
