"""The teacher's RoIAlign as the Hopper kernel computes it, on the CPU.

`roi_align_plain` (`ov3det_torch/ops/roi_align.py`) is the kernel's oracle:
the same slots, weights and sum order as `csrc/roi_align.cu`, which runs only
on the card (`chip_smoke.py` holds the two bit for bit there).  Here it is
held against the JAX package's `roi_align_batched` and `roi_align` at the
tolerances of tests/test_torch_teacher.py (f32 1e-5 absolute, bf16 1e-2 of
the largest value: the tent weights and each contraction rounded to bf16),
and against the two-einsum form it replaces (`roi_align_einsum`): bf16
within 2 bf16 ulps at every element (the einsum's sums run in a library's
order, so a contraction's bf16 rounding may fall the other way), f32 within
1e-6 of the largest value.  On crafted boxes (taps clipped at every border,
a box whose width clamps to 1e-6, an inverted box, a box on the canvas edge,
NaN and infinite coordinates) the NaN positions are the einsum's.

The routed design's order (`roi_align_rows`: each map row's columns formed
once a region and kept in a ring of `RING`, output rows summed from there)
is emulated in numpy and equals `roi_align_plain` bit for bit, with each
live map row formed exactly once; `_impl` is checked.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ov3det.ops import roi_align as jroi
from ov3det_torch.ops import roi_align as troi
from ov3det_torch.ops.kernels import roi_align as kroi

SCALE = 0.25  # feature pixels an input pixel
IMG_H, IMG_W = 48, 64  # input pixels: a 12 x 16 map


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _boxes(rng, B: int, Q: int) -> np.ndarray:
    x1 = rng.uniform(-4, IMG_W * 0.7, (B, Q))
    y1 = rng.uniform(-4, IMG_H * 0.7, (B, Q))
    return np.stack([x1, y1, x1 + rng.uniform(1, IMG_W * 0.6, (B, Q)),
                     y1 + rng.uniform(1, IMG_H * 0.6, (B, Q))], -1).astype(np.float32)


def _crafted(B: int, Q: int) -> np.ndarray:
    """(B, Q, 4) boxes, the crafted ones first, then seeded ones."""
    nan, inf = np.float32("nan"), np.float32("inf")
    crafted = [[-6.0, -4.0, 90.0, 70.0],  # taps clipped at every border
               [5.0, 5.0, 5.0 + 1e-7, 6.5],  # width clamped to 1e-6
               [30.0, 20.0, 10.0, 4.0],  # inverted: both sides clamped
               [IMG_W - 1.0, IMG_H - 1.0, IMG_W + 8.0, IMG_H + 6.0],  # on the canvas edge
               [0.0, 0.0, 2.0, 2.0],  # two input pixels: the taps share map pixels
               [nan, 4.0, 20.0, 30.0],  # a NaN coordinate
               [4.0, 4.0, 20.0, nan],
               [-inf, 4.0, inf, 30.0],  # -inf + inf: NaN taps
               [4.0, 4.0, inf, 30.0],  # an infinite bin: every tap on the border
               [-inf, -inf, 10.0, 10.0]]
    boxes = _boxes(np.random.default_rng(11), B, Q).reshape(-1, 4)
    boxes[:len(crafted)] = np.asarray(crafted, np.float32)
    return boxes.reshape(B, Q, 4)


def _features(rng, B: int, C: int, dtype: torch.dtype) -> torch.Tensor:
    f = rng.normal(size=(B, int(IMG_H * SCALE), int(IMG_W * SCALE), C)).astype(np.float32)
    return torch.from_numpy(f).to(dtype)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| over the bf16 ulp at the larger magnitude."""
    a, b = a.float().numpy(), b.float().numpy()
    m = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7)
    return float((np.abs(a - b) / ulp).max())


def _same_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(torch.isnan(a), torch.isnan(b))


SHAPES = [(4, 8), (4, 64), (18, 8), (18, 64)]  # (output size, C)


@pytest.mark.parametrize("out,C", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax(dtype, out, C):
    rng = np.random.default_rng(out * 100 + C)
    B, Q = 3, 5
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    feats = _features(rng, B, C, tdt)
    boxes = _boxes(rng, B, Q)
    boxes[0, 0] = [-6.0, -4.0, 90.0, 70.0]
    boxes[1, 1] = [5.0, 5.0, 5.5, 6.5]
    jf = jnp.asarray(feats.float().numpy(), jdt)
    want_b = np.asarray(jroi.roi_align_batched(jf, jnp.asarray(boxes), spatial_scale=SCALE,
                                               output_size=out), np.float32)
    flat = boxes.reshape(-1, 4)
    index = np.repeat(np.arange(B), Q).astype(np.int32)
    want_g = np.asarray(jroi.roi_align(jf, jnp.asarray(flat), jnp.asarray(index),
                                       spatial_scale=SCALE, output_size=out), np.float32)
    got_b = troi.roi_align_plain(feats, torch.from_numpy(flat), None, SCALE, out, per_image=Q)
    got_g = troi.roi_align_plain(feats, torch.from_numpy(flat), torch.from_numpy(index), SCALE, out)
    assert got_b.dtype == tdt and got_b.shape == (B * Q, out, out, C)
    assert torch.equal(got_b, got_g)  # the index form and r // Q read the same images
    for got, want in ((got_b, want_b.reshape(B * Q, out, out, C)), (got_g, want_g)):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        else:
            assert _rel(got.float().numpy(), want) <= 1e-2


@pytest.mark.parametrize("out,C", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_einsum(dtype, out, C):
    rng = np.random.default_rng(7 + out + C)
    B, Q = 2, 12
    feats = _features(rng, B, C, dtype)
    boxes = torch.from_numpy(_crafted(B, Q))
    want = troi.roi_align_einsum(feats, boxes, SCALE, out).reshape(B * Q, out, out, C)
    got = troi.roi_align_plain(feats, boxes.reshape(-1, 4), None, SCALE, out, per_image=Q)
    assert got.dtype == dtype
    assert _same_nan(got, want)
    nan_regions = torch.isnan(got).flatten(1).any(dim=1)
    # the NaN coordinates and the -inf + inf one: whole regions, nothing else
    assert nan_regions[:10].tolist() == [False] * 5 + [True] * 3 + [False, True]
    assert not nan_regions[10:].any()
    finite = ~torch.isnan(want)
    assert torch.isfinite(got[finite]).all()
    if dtype == torch.bfloat16:
        assert _bf16_ulps(got[finite], want[finite]) <= 2
    else:
        err = (got[finite] - want[finite]).abs().max() / want[finite].abs().max()
        assert err <= 1e-6


def test_routes_cpu_tensors_to_plain():
    rng = np.random.default_rng(3)
    B, Q, out, C = 2, 5, 6, 16
    feats = _features(rng, B, C, torch.bfloat16)
    boxes = torch.from_numpy(_crafted(B, Q))
    got = troi.roi_align_batched(feats, boxes, SCALE, out)
    want = troi.roi_align_plain(feats, boxes.reshape(-1, 4), None, SCALE, out, per_image=Q)
    assert got.shape == (B, Q, out, out, C)
    assert torch.equal(torch.nan_to_num(got.reshape(want.shape)), torch.nan_to_num(want))
    index = torch.tensor([1, 0, 1, 1, 0, 0, 1, 0, 0, 1])
    generic = troi.roi_align(feats, boxes.reshape(-1, 4), index, SCALE, out)
    plain = troi.roi_align_plain(feats, boxes.reshape(-1, 4), index, SCALE, out)
    assert torch.equal(torch.nan_to_num(generic), torch.nan_to_num(plain))
    assert kroi.roi_align.launches == 0  # CPU tensors never count a launch


def test_slots_cover_every_nonzero_weight():
    """The four slots of a row hold every pixel where the einsum's tent
    weights are not 0, with the same f32 weight, ascending and distinct."""
    rng = np.random.default_rng(5)
    size, out = 13, 18
    lo = torch.from_numpy(np.concatenate([rng.uniform(-3, size + 2, 400),
                                          [0.0, -0.5, size - 1.0, 3.0]]).astype(np.float32))
    bins = torch.from_numpy(np.concatenate([rng.uniform(1e-7, 3.0, 400),
                                            [1e-6 / out, 0.5, 0.25, 4.0]]).astype(np.float32))
    pixel, weight, live, nan = troi._axis_slots(lo, bins, size, out)
    dense = troi._interp(lo[None], bins[None], size, out, 2)[0]  # (R, out, size)
    assert not nan.any()
    rebuilt = torch.zeros_like(dense)
    rebuilt.scatter_add_(-1, pixel, torch.where(live, weight, torch.zeros_like(weight)))
    assert torch.equal(rebuilt, dense)
    lp = torch.where(live, pixel, torch.full_like(pixel, -1))
    for k in range(1, 4):  # live pixels ascend and never repeat
        earlier = torch.where(live[..., :k], lp[..., :k], torch.full_like(lp[..., :k], -1))
        assert (~live[..., k] | (lp[..., k] > earlier.max(dim=-1).values)).all()


def test_argument_checks():
    f = torch.zeros(2, 3, 4, 8)
    b = torch.zeros(6, 4)
    with pytest.raises(ValueError, match="sampling_ratio"):
        troi.roi_align(f, b, torch.zeros(6, dtype=torch.long), 1.0, 4, sampling_ratio=3)
    with pytest.raises(ValueError, match="f32 or bf16 features"):
        kroi.roi_align(f.half(), b, None, 1.0, 4, per_image=3)
    with pytest.raises(ValueError, match="f32 or bf16 features"):
        kroi.roi_align(f[0], b, None, 1.0, 4, per_image=3)
    with pytest.raises(ValueError, match=r"\(R, 4\) float boxes"):
        kroi.roi_align(f, b[:, :3], None, 1.0, 4, per_image=3)
    with pytest.raises(ValueError, match="integer"):
        kroi.roi_align(f, b, torch.zeros(6), 1.0, 4)
    with pytest.raises(ValueError, match="integer"):
        kroi.roi_align(f, b, torch.zeros(5, dtype=torch.long), 1.0, 4)
    with pytest.raises(ValueError, match="per_image"):
        kroi.roi_align(f, b, None, 1.0, 4)
    with pytest.raises(ValueError, match="6 boxes for 2 images of 2"):
        kroi.roi_align(f, b, None, 1.0, 4, per_image=2)
    with pytest.raises(ValueError, match="output_size"):
        kroi.roi_align(f, b, None, 1.0, 0, per_image=3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kroi.roi_align(f.to("meta"), b.to("meta"), None, 1.0, 4, per_image=3)
    # what the kernel alone refuses: C not a multiple of 8, outputs past 18
    with pytest.raises(ValueError, match="multiple of 8"):
        kroi.check_kernel_args(torch.zeros(2, 3, 4, 12), 4)
    with pytest.raises(ValueError, match="up to 18"):
        kroi.check_kernel_args(f, kroi.MAX_OUTPUT + 1)
    kroi.check_kernel_args(f, kroi.MAX_OUTPUT)
    assert troi.roi_align(f, b, torch.zeros(6, dtype=torch.int32), 1.0, 4).shape == (6, 4, 4, 8)


def test_source_mirrors_the_wrapper():
    """The wrapper's limits are the source's."""
    import pathlib
    import re

    src = (pathlib.Path(__file__).resolve().parents[1] / kroi.SOURCE).read_text()
    assert int(re.search(r"kMaxOutput = (\d+);", src).group(1)) == kroi.MAX_OUTPUT
    assert "__fmul_rn" in src and "__fadd_rn" in src and "fmaf" not in src
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kGroups"] == kroi.GROUPS and consts["kRing"] == kroi.RING
    # both designs and their entry points, which `_impl` names
    assert "roi_align_rows<" in src and "roi_align_kernel<" in src
    entries = set(re.findall(r'extern "C" int (ov3_\w+)\(', src))
    assert entries == set(kroi._SIGNATURES) == {kroi._entry(None, True), kroi._entry("first", True)}


def _rows_design(feats: torch.Tensor, boxes: torch.Tensor, scale: float, out: int,
                 per_image: int) -> tuple:
    """`roi_align_rows` of csrc/roi_align.cu emulated in numpy: a region's
    output rows walked in order, each live y slot's cols[j, h] (every output
    column at once, as the CTA's threads form them) taken from a ring of the
    `kroi.RING` map rows formed last or formed (the live x slots in
    ascending order, each product and sum rounded in f32, the sum rounded
    to the feature dtype) and pushed, the oldest row out; the output rows
    summed in ascending slot order.  Returns (pooled (R, out, out, C) in the
    feature dtype, {region: map rows formed}, {region: distinct live map
    rows})."""
    dtype = feats.dtype
    f = feats.float().numpy()
    C = f.shape[-1]
    x1, bin_w, y1, bin_h = troi._box_axes(boxes, scale, out)
    px, wx, vx, nan_x = (t.numpy() for t in troi._axis_slots(x1, bin_w, f.shape[2], out))
    py, wy, vy, nan_y = (t.numpy() for t in troi._axis_slots(y1, bin_h, f.shape[1], out))
    wx = torch.from_numpy(wx).to(dtype).float().numpy()
    wy = torch.from_numpy(wy).to(dtype).float().numpy()
    R = boxes.shape[0]
    pooled = np.zeros((R, out, out, C), np.float32)
    formed, distinct = {}, {}
    for r in range(R):
        image = f[r // per_image]
        xlive = vx[r] & ~nan_x[r][:, None]  # a NaN column forms zeros
        ring = []  # (h, cols (out, C)), the oldest first
        formed[r] = 0
        distinct[r] = {int(py[r, i, k]) for i in range(out) for k in range(4) if vy[r, i, k]}
        for i in range(out):
            acc = np.zeros((out, C), np.float32)
            for ky in range(4):
                if not vy[r, i, ky]:
                    continue
                h = int(py[r, i, ky])
                held = [c for hh, c in ring if hh == h]
                if held:
                    cols = held[0]
                else:
                    cols = np.zeros((out, C), np.float32)
                    for kx in range(4):
                        take = xlive[:, kx, None]
                        prod = (wx[r, :, kx, None] * image[h, px[r, :, kx]]).astype(np.float32)
                        cols = np.where(take, (cols + prod).astype(np.float32), cols)
                    cols = torch.from_numpy(cols).to(dtype).float().numpy()
                    ring = (ring + [(h, cols)])[-kroi.RING:]
                    formed[r] += 1
                acc = (acc + (wy[r, i, ky] * cols).astype(np.float32)).astype(np.float32)
            nan = nan_y[r, i] | nan_x[r]
            pooled[r, i] = np.where(nan[:, None], np.float32("nan"), acc)
    return torch.from_numpy(pooled).to(dtype), formed, distinct


@pytest.mark.parametrize("out,C", [(7, 8), (18, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_design_forms_each_row_once(dtype, out, C):
    """The routed design's order: each live map row's columns formed once a
    region (the ring of `RING` never drops a row an output row still
    needs), the result `roi_align_plain`'s bit for bit: on the crafted
    boxes (taps sharing map pixels, clamped, inverted and edge boxes, NaN
    and infinite coordinates), on boxes under a map pixel tall (every
    output row reads the same one or two map rows) and on boxes taller than
    the map."""
    rng = np.random.default_rng(30 + out + C)
    B, Q = 2, 14
    feats = _features(rng, B, C, dtype)
    boxes = _crafted(B, Q).reshape(-1, 4)
    boxes[10] = [3.0, 7.0, 40.0, 9.5]  # 2.5 input pixels tall: bins of 0.03 map rows
    boxes[11] = [1.0, 20.0, 50.0, 20.3]
    boxes[12] = [-30.0, -40.0, 90.0, 120.0]  # far taller than the map
    boxes[13] = [10.0, 5.0, 30.0, 45.0]
    boxes = torch.from_numpy(boxes)
    got, formed, distinct = _rows_design(feats, boxes, SCALE, out, Q)
    want = troi.roi_align_plain(feats, boxes, None, SCALE, out, per_image=Q)
    assert _same_nan(got, want)
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert formed == {r: len(d) for r, d in distinct.items()}
    assert max(formed.values()) > kroi.RING  # the ring turns over
    assert torch.isnan(got).flatten(1).any(dim=1)[:10].tolist() == [False] * 5 + [True] * 3 + \
        [False, True]


def test_impl_argument():
    """`_impl` is None (the routed design) or "first", and chooses between
    CUDA kernels only: CPU tensors refuse "first"; nothing counts a launch."""
    f = torch.zeros(2, 3, 4, 8)
    b = torch.zeros(6, 4)
    with pytest.raises(ValueError, match="CUDA kernels"):
        kroi.roi_align(f, b, None, 1.0, 4, per_image=3, _impl="first")
    with pytest.raises(ValueError, match="_impl"):
        kroi.roi_align(f, b, None, 1.0, 4, per_image=3, _impl="rows")
    assert kroi.roi_align(f, b, None, 1.0, 4, per_image=3).shape == (6, 4, 4, 8)
    assert kroi.roi_align.launches == 0
