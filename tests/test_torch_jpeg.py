"""The port's JPEG decoder (`ov3det_torch/utils/jpeg.py`,
`native/jpeg_decode.cpp`) against PIL's libjpeg-turbo, uint8-equal.

Files are written by PIL under `tmp_path`: every combination of chroma
subsampling (4:4:4, 4:2:2, 4:2:0), quality (75, 95), optimised Huffman
tables and restart intervals, each at SUN RGB-D's sensor sizes, odd sizes
and 1 x 1, with smooth content and with uniform noise (noise at q95 drives
the IDCT's output past the sample range, where libjpeg's range-limit table
decides); greyscale files; and the committed fixtures of `tests/data/jpeg/`,
whose manifest holds the digests the card checks.  Progressive, CMYK and
truncated files raise.
"""
import hashlib
import itertools
import json
import os

import numpy as np
import pytest
from PIL import Image, ImageFile

from ov3det.datasets.image_utils import resize_crop_image as jax_resize_crop
from ov3det_torch.datasets.image_utils import resize_crop_image
from ov3det_torch.utils.jpeg import read_jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
SIZES = [(730, 530), (640, 480), (681, 441), (37, 29), (17, 1), (1, 1)]  # (width, height)
RESTARTS = {"none": {}, "rows": {"restart_marker_rows": 1}, "blocks": {"restart_marker_blocks": 3}}


@pytest.fixture(autouse=True)
def _big_buffer(monkeypatch):
    # PIL guesses the encoder's buffer for optimize=True at width x height
    # bytes, which a 4:4:4 file can outgrow
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 24)


def smooth(rng, height: int, width: int, channels: int = 3) -> np.ndarray:
    y, x = np.mgrid[0:height, 0:width] / max(height, width)
    waves = [np.sin(rng.uniform(1, 9) * x + rng.uniform(1, 7) * y + rng.uniform(0, 6))
             for _ in range(channels)]
    img = np.stack(waves, -1) * 100 + 128 + rng.normal(0, 3, (height, width, channels))
    return np.clip(img, 0, 255).astype(np.uint8)


def save(tmp_path, name: str, img: np.ndarray, **options) -> str:
    path = str(tmp_path / name)
    Image.fromarray(img).save(path, "JPEG", **options)
    return path


def assert_decodes_as_pil(path: str):
    want = np.asarray(Image.open(path))
    got = read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == want.shape, (path, got.shape, want.shape)
    bad = np.argwhere(got != want)
    assert len(bad) == 0, f"{path}: {len(bad)} values differ, first at {bad[:3].tolist()}"


@pytest.mark.parametrize("subsampling,quality,optimize,restart", itertools.product(
    (0, 1, 2), (75, 95), (False, True), sorted(RESTARTS)))
def test_decoder_equals_pil(tmp_path, subsampling, quality, optimize, restart):
    rng = np.random.default_rng(subsampling * 100 + quality + 7 * optimize)
    options = dict(subsampling=subsampling, quality=quality, optimize=optimize,
                   **RESTARTS[restart])
    for width, height in SIZES:
        for content in ("smooth", "noise"):
            img = (smooth(rng, height, width) if content == "smooth"
                   else rng.integers(0, 256, (height, width, 3), dtype=np.uint8))
            assert_decodes_as_pil(save(tmp_path, f"{content}_{width}x{height}.jpg", img,
                                       **options))


@pytest.mark.parametrize("quality", [75, 95])
def test_greyscale_equals_pil(tmp_path, quality):
    rng = np.random.default_rng(quality)
    for width, height in SIZES:
        for img in (smooth(rng, height, width, 1)[..., 0],
                    rng.integers(0, 256, (height, width), dtype=np.uint8)):
            path = save(tmp_path, f"grey_{width}x{height}.jpg", img, quality=quality)
            assert read_jpeg(path).ndim == 2
            assert_decodes_as_pil(path)


def test_refused_files_raise_naming_the_file(tmp_path):
    rng = np.random.default_rng(0)
    img = smooth(rng, 48, 64)
    path = save(tmp_path, "progressive.jpg", img, progressive=True)
    with pytest.raises(ValueError, match="progressive.jpg: progressive"):
        read_jpeg(path)
    path = str(tmp_path / "cmyk.jpg")
    Image.fromarray(np.concatenate([img, img[..., :1]], -1), "CMYK").save(path, "JPEG")
    with pytest.raises(ValueError, match="cmyk.jpg: .*CMYK"):
        read_jpeg(path)
    path = str(tmp_path / "plain.txt")
    with open(path, "wb") as fh:
        fh.write(b"not a jpeg")
    with pytest.raises(ValueError, match="not a JPEG"):
        read_jpeg(path)


@pytest.mark.parametrize("restart", sorted(RESTARTS))
def test_truncated_files_raise(tmp_path, restart):
    """Cut anywhere after the headers, a file raises: the entropy-coded data
    runs out before the last MCU, or a marker segment is cut."""
    rng = np.random.default_rng(1)
    whole = save(tmp_path, "whole.jpg", rng.integers(0, 256, (96, 128, 3), dtype=np.uint8),
                 quality=90, **RESTARTS[restart])
    with open(whole, "rb") as fh:
        data = fh.read()
    for keep in (40, 300, len(data) // 3, len(data) // 2, len(data) - 40, len(data) - 4):
        path = str(tmp_path / f"cut_{keep}.jpg")
        with open(path, "wb") as fh:
            fh.write(data[:keep])
        with pytest.raises(ValueError, match=f"cut_{keep}.jpg: .*(truncated|corrupt)"):
            read_jpeg(path)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_committed_fixtures_match_their_manifest():
    """The manifest's digests are PIL's here, and the port decodes (and
    resizes) every fixture to them: they are the card's oracle."""
    with open(os.path.join(FIXTURES, "manifest.json")) as fh:
        manifest = json.load(fh)
    dims = tuple(manifest["resize_dims"])
    sizes = {(f["width"], f["height"]) for f in manifest["files"]}
    assert {(730, 530), (640, 480), (681, 441), (1296, 968)} <= sizes
    assert sum(os.path.getsize(os.path.join(FIXTURES, f["file"]))
               for f in manifest["files"]) < 600_000
    for entry in manifest["files"]:
        path = os.path.join(FIXTURES, entry["file"])
        if entry.get("raises"):
            with pytest.raises(ValueError, match="progressive"):
                read_jpeg(path)
            continue
        pil = np.asarray(Image.open(path))
        assert list(pil.shape) == entry["shape"] and _digest(pil) == entry["sha256"], path
        assert _digest(jax_resize_crop(pil, dims)) == entry["resized_sha256"], path
        got = read_jpeg(path)
        assert _digest(got) == entry["sha256"], path
        resized = resize_crop_image(got, dims)
        assert list(resized.shape) == entry["resized_shape"]
        assert _digest(resized) == entry["resized_sha256"], path
