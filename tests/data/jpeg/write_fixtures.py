"""Write the committed JPEG fixtures and their manifest with PIL.

    python tests/data/jpeg/write_fixtures.py

The card's machine has no PIL, so these files and the digests of what PIL
decodes from them are the oracle that `chip_smoke.py` holds the port's
decoder (`ov3det_torch/utils/jpeg.py`) against there;
`tests/test_torch_jpeg.py` checks the manifest against PIL and the port.
Each image is drawn from a seed: smooth colour fields with a little noise,
at SUN RGB-D's sensor sizes (730 x 530, 640 x 480, 681 x 441) and ScanNet's
colour frames (1296 x 968).  `manifest.json` holds, for each file, how it
was written, the shape of the decoded array, the sha256 of
`np.asarray(PIL.Image.open(path))` and of its `resize_crop_image` to
ScanNet's image dims (328, 256) in the JAX package, and the Pillow and
libjpeg versions that wrote and read them.
"""
import hashlib
import json
import os
import sys

import numpy as np
import PIL
from PIL import Image, features

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.abspath(os.path.join(HERE, "..", "..", "..")))
from ov3det.datasets.image_utils import resize_crop_image  # noqa: E402

RESIZE_DIMS = (328, 256)  # (width, height): ScanNet's image_dims

# name, (width, height), seed, save options
FIXTURES = [
    ("sun_730x530_q75_420.jpg", (730, 530), 1, dict(quality=75, subsampling=2)),
    ("sun_730x530_q95_444.jpg", (730, 530), 2, dict(quality=95, subsampling=0)),
    ("sun_640x480_q75_420.jpg", (640, 480), 3, dict(quality=75, subsampling=2)),
    ("sun_640x480_q75_420_rst.jpg", (640, 480), 4,
     dict(quality=75, subsampling=2, restart_marker_blocks=3)),
    ("sun_681x441_q75_420.jpg", (681, 441), 5, dict(quality=75, subsampling=2)),
    ("sun_681x441_q75_420_opt.jpg", (681, 441), 6, dict(quality=75, subsampling=2, optimize=True)),
    ("scannet_1296x968_q75_a.jpg", (1296, 968), 7, dict(quality=75, subsampling=2)),
    ("scannet_1296x968_q75_b.jpg", (1296, 968), 8, dict(quality=75, subsampling=2)),
    ("progressive_64x48.jpg", (64, 48), 9, dict(quality=75, progressive=True)),
]


def smooth_image(seed: int, width: int, height: int) -> np.ndarray:
    """uint8 (height, width, 3): a few low-frequency waves a channel, a
    seeded phase each, and noise of 4 levels."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width] / max(height, width)
    img = np.zeros((height, width, 3))
    for c in range(3):
        for _ in range(3):
            fx, fy, phase = rng.uniform(1, 8), rng.uniform(1, 8), rng.uniform(0, 2 * np.pi)
            img[..., c] += np.sin(fx * x + fy * y + phase) * rng.uniform(20, 40)
    img += 128 + rng.normal(0, 4, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> None:
    entries = []
    for name, (width, height), seed, options in FIXTURES:
        path = os.path.join(HERE, name)
        Image.fromarray(smooth_image(seed, width, height)).save(path, "JPEG", **options)
        entry = {"file": name, "width": width, "height": height, "seed": seed, **options}
        if options.get("progressive"):
            entry["raises"] = True
        else:
            decoded = np.asarray(Image.open(path))
            resized = resize_crop_image(decoded, RESIZE_DIMS)
            entry.update(shape=list(decoded.shape), sha256=digest(decoded),
                         resized_shape=list(resized.shape), resized_sha256=digest(resized))
        entries.append(entry)
    manifest = {"pillow": PIL.__version__, "libjpeg_turbo": features.version("libjpeg_turbo"),
                "jpeg_api": features.version("jpg"), "resize_dims": list(RESIZE_DIMS),
                "files": entries}
    with open(os.path.join(HERE, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
