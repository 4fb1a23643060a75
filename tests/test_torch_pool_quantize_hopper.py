"""What the redesigned quantise pass (`pool_quantize_vec` in
`ov3det_torch/csrc/quant_conv.cu`) relies on, checked on the CPU against
the JAX package:

- the pool's `x 0.25` equals its `/ 4` (both round v / 4 correctly) for
  every bf16 bit pattern and over f32 sweeps of normal, subnormal,
  underflowing, infinite and NaN values;
- `FastDiv` (a division by a run-time constant as a multiply-high and a
  shift) equals the integer division for every divisor of the teacher's
  shapes and at every boundary below 2^31;
- the pass emulated in numpy in the kernel's order (pieces of 16 or 8
  values a thread from `pass_launch`, the pixel of a piece from `FastDiv`,
  the four taps summed in f32 from 0, x 0.25, rounded to the input type,
  the quantise by the reciprocal, the values near a half-integer redone by
  the division) equals JAX's pool summed in f32 and then `QuantConv`'s quantise, at
  pool 1 and 2, one and two scales, bf16 and f32, on odd shapes and on
  values whose quotients lie on half-integers;
- the launch (`pass_launch`) at the 9 passes of one teacher forward, and
  mirrored from the source; `_impl="first"` refused on CPU tensors.

The kernel itself runs only on the card, where chip_smoke.py holds both
designs against the plain version bit for bit.
"""
import re
from pathlib import Path

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det_torch.ops.kernels import quant_conv as qc

CSRC = Path(qc.__file__).resolve().parents[2] / "csrc"
F32 = np.float32

# the passes of one int8 RN50x4 teacher forward on 8 canvases of 530 x 730
# and 1024 regions (res5 in 4 chunks of 256), as chip_smoke's `record_trunk`
# finds them: (B, H, W, C, pool, scales, calls)
TEACHER_PASSES = [
    (8, 265, 365, 40, 1, 1, 1), (8, 265, 365, 80, 2, 2, 1), (8, 132, 182, 160, 2, 1, 1),
    (8, 132, 182, 320, 2, 1, 1), (8, 66, 91, 320, 2, 1, 1), (8, 66, 91, 640, 2, 1, 1),
    (256, 18, 18, 1280, 1, 1, 4), (256, 18, 18, 640, 2, 1, 4), (256, 18, 18, 1280, 2, 1, 4),
]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


# ------------------------------------------------------------------ x 0.25
def _same(a: np.ndarray, b: np.ndarray) -> None:
    """Equal bit for bit, NaN to NaN."""
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a[~nan].view(np.uint32), b[~nan].view(np.uint32))


def test_quarter_equals_division_for_every_bf16():
    v = (np.arange(2 ** 16, dtype=np.uint32) << 16).view(np.float32)
    with np.errstate(all="ignore"):
        _same(v * F32(0.25), v / F32(4))


def _sweep(kind: str, rng) -> np.ndarray:
    bits = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64).astype(np.uint32)
    if kind == "any bits":
        return bits.view(np.float32)
    if kind == "subnormal":
        return (bits & 0x807FFFFF).view(np.float32)
    if kind == "near underflow":  # exponents whose quarter is subnormal or the smallest normals
        return ((bits & 0x807FFFFF) | ((bits % 4 + 1).astype(np.uint32) << 23)).view(np.float32)
    if kind == "sums of four bf16":
        four = ((bits & 0xFFFF0000).view(np.float32).reshape(-1, 4)).astype(np.float32)
        with np.errstate(all="ignore"):
            return ((F32(0) + four[:, 0]) + four[:, 1] + four[:, 2] + four[:, 3]).astype(np.float32)
    return np.array([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 3.4028235e38, -1e-45, 1e-45],
                    np.float32)


@pytest.mark.parametrize("kind", ["any bits", "subnormal", "near underflow", "sums of four bf16",
                                  "specials"])
def test_quarter_equals_division_in_f32(kind):
    v = _sweep(kind, np.random.default_rng(len(kind)))
    with np.errstate(all="ignore"):
        _same(v * F32(0.25), v / F32(4))


# ------------------------------------------------------------------ FastDiv
def fast_div(d: int):
    """`make_fast_div` of csrc/quant_conv.cu: (d, m, s)."""
    if d == 1:
        return d, 0, 0
    ell = 0
    while (1 << ell) < d:
        ell += 1
    return d, ((1 << (31 + ell)) + d - 1) // d % 2 ** 32, ell - 1


def fast_div_apply(n: np.ndarray, fd) -> np.ndarray:
    """`FastDiv::div`: umulhi(n, m) >> s, or n for d = 1, in uint64."""
    d, m, s = fd
    n = n.astype(np.uint64)
    return n if d == 1 else ((n * np.uint64(m)) >> np.uint64(32)) >> np.uint64(s)


# C / VEC, W / 2 and H / 2 of the teacher's passes, and the edges
DIVISORS = sorted({c // v for c in (40, 80, 160, 320, 640, 1280) for v in (8, 16)}
                  | {182, 132, 91, 66, 45, 33, 9} | {1, 2, 3, 7, 127, 641, 65535, 2 ** 20 + 1,
                                                    2 ** 30, 2 ** 31 - 1})


@pytest.mark.parametrize("d", DIVISORS)
def test_fast_div_is_the_integer_division(d):
    rng = np.random.default_rng(d)
    top = 2 ** 31 - 1
    k = np.arange(0, top // d + 1, max(1, (top // d) // 5000), dtype=np.int64)
    n = np.concatenate([k * d, k * d - 1, k * d + 1, k * d + d - 1, [0, 1, top, top - 1],
                        rng.integers(0, top, 20_000)])
    n = n[(n >= 0) & (n <= top)]
    np.testing.assert_array_equal(fast_div_apply(n, fast_div(d)), n // d)


def test_fast_div_mirrors_the_source():
    src = (CSRC / "quant_conv.cu").read_text()
    body = src[src.index("FastDiv make_fast_div("):src.index("int pass_sms[")]
    assert "if (d == 1) return FastDiv{1, 0, 0};" in body
    assert "while ((1ull << l) < d) ++l;" in body
    assert "return FastDiv{d, static_cast<uint32_t>(((1ull << (31 + l)) + d - 1) / d), l - 1};" \
        in body
    assert "return d == 1 ? n : __umulhi(n, m) >> s;" in src


# ------------------------------------------------------------------ the launch
def test_the_table_is_one_teacher_forward():
    assert sum(row[-1] for row in TEACHER_PASSES) == 18  # chip_smoke.TEACHER_STEP
    assert len(TEACHER_PASSES) == 9


@pytest.mark.parametrize("B,H,W,C,pool,n_scales,calls", TEACHER_PASSES)
def test_launch_at_the_teacher_passes(B, H, W, C, pool, n_scales, calls):
    launch = qc.pass_launch(B, H, W, C, pool)
    assert launch["design"] == "vec"
    assert launch["vec"] == 16
    assert launch["items"] * launch["vec"] == B * (H // pool) * (W // pool) * C
    assert B * H * W * C < 2 ** 31  # 32-bit indices


def test_launch_rule():
    assert qc.pass_launch(2 ** 10, 2 ** 10, 2 ** 10, 8, 1) == {"design": "first"}
    assert qc.pass_launch(2 ** 10, 2 ** 10, 2 ** 7, 16, 2) == {"design": "first"}
    assert qc.pass_launch(1, 3, 3, 8, 1)["vec"] == 8  # 72 values
    assert qc.pass_launch(1, 2, 3, 8, 1)["vec"] == 16  # 48 values
    assert qc.pass_launch(2, 3, 3, 8, 1)["vec"] == 16  # 144 values
    assert qc.pass_launch(2, 9, 7, 40, 2)["vec"] == 8
    assert qc.pass_launch(2, 9, 7, 48, 2)["vec"] == 16


def test_launch_mirrors_the_source():
    src = (CSRC / "quant_conv.cu").read_text()
    assert "const uint32_t want = (a.items + kPoolThreads - 1) / kPoolThreads;" in src
    assert "const int vec = (pool == 1 ? elements % 16 : C % 16) == 0 ? 16 : 8;" in src
    assert "if (elements >= (int64_t{1} << 31))" in src
    assert "const uint32_t blocks = want < most ? want : most;" in src
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor(" in src
    assert "const uint32_t most = static_cast<uint32_t>(pass_sms[dev]) * per_sm[dev];" in src


# ------------------------------------------------------------------ the pass
def _bf16_round(v: np.ndarray) -> np.ndarray:
    """f32 -> the nearest bf16 (ties to even), as f32; NaN stays NaN."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16).astype(np.uint32).view(np.float32)
    return np.where(np.isnan(v), v, r).astype(np.float32)


def _codes(v: np.ndarray, s: np.float32) -> tuple:
    """`codes_q8_fast` on pieces of 8, the values whose quotient lies within
    2^-14 of a half-integer (every value when 1 / s is not normal) redone by
    `codes_q8_exact` (the division): (codes, values divided)."""
    exact = not (F32(2.0 ** -125) <= s <= F32(2.0 ** 125))
    with np.errstate(all="ignore"):
        u = v * (F32(1) / s)
        t = np.rint(u)
        near = (np.abs(u - t) > F32(0.5 - 2.0 ** -14)) | exact
        t = np.where(near, np.rint(v / s), t)
    t = np.where(np.isnan(t), F32(0), np.clip(t, F32(-127), F32(127)))  # `code_of`: NaN 0
    return t.astype(np.int8).reshape(-1), int(near.sum())


def emulate_pass(x: np.ndarray, pool: int, scales, bf16: bool) -> tuple:
    """The redesigned pass over x (B, H, W, C) f32 (bf16 values when
    `bf16`): (one int8 array a scale, values the division redid)."""
    B, H, W, C = x.shape
    launch = qc.pass_launch(B, H, W, C, pool)
    vec, items = launch["vec"], launch["items"]
    flat = x.reshape(-1)
    t = np.arange(items, dtype=np.int64)
    if pool == 1:
        offs = t[:, None] * vec + np.arange(vec)
        v = flat[offs]
    else:
        Ho, Wo = H // 2, W // 2
        pix = fast_div_apply(t, fast_div(C // vec)).astype(np.int64)
        g = t - pix * (C // vec)
        bho = fast_div_apply(pix, fast_div(Wo)).astype(np.int64)
        wo = pix - bho * Wo
        bb = fast_div_apply(bho, fast_div(Ho)).astype(np.int64)
        ho = bho - bb * Ho
        base = ((bb * H + 2 * ho) * W + 2 * wo) * C + g * vec
        lanes = np.arange(vec)
        v = np.zeros((items, vec), np.float32)
        for tap in (0, C, W * C, W * C + C):  # (0, 0), (0, 1), (1, 0), (1, 1), from 0
            v = (v + flat[(base + tap)[:, None] + lanes]).astype(np.float32)
        v = (v * F32(0.25)).astype(np.float32)
        if bf16:
            v = _bf16_round(v)
        offs = (pix * C + g * vec)[:, None] + lanes
    outs, redone = [], 0
    for s in scales:
        codes, n = _codes(v, F32(s))
        out = np.zeros(B * (H // pool) * (W // pool) * C, np.int8)
        out[offs.reshape(-1)] = codes
        outs.append(out.reshape(B, H // pool, W // pool, C))
        redone += n
    return outs, redone


def _jax_pool_quantize(x: np.ndarray, pool: int, scales, dtype) -> list:
    """JAX's pool summed in f32 (`nn.avg_pool` on f32, rounded to the input
    type) and then `QuantConv.__call__`'s quantise (clip(round(x / s)))."""
    xj = jnp.asarray(x, dtype)
    if pool > 1:
        xj = nn.avg_pool(xj.astype(jnp.float32), (pool, pool), strides=(pool, pool)).astype(dtype)
    xf = xj.astype(jnp.float32)
    return [np.asarray(jnp.clip(jnp.round(xf / F32(s)), -127, 127).astype(jnp.int8))
            for s in scales]


SHAPES = [(2, 7, 9, 48), (2, 9, 7, 40), (1, 6, 10, 32), (3, 5, 5, 24)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n_scales", [1, 2])
@pytest.mark.parametrize("pool", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_pass_equals_jax(shape, pool, n_scales, dtype):
    rng = np.random.default_rng(sum(shape) + pool + n_scales)
    x = (rng.normal(size=shape) * np.exp(rng.uniform(-3, 3, shape))).astype(np.float32)
    bf16 = dtype == "bfloat16"
    if bf16:
        x = _bf16_round(x)
    scales = [F32(0.05), F32(0.013)][:n_scales]
    want = _jax_pool_quantize(x, pool, scales, jnp.bfloat16 if bf16 else jnp.float32)
    got, _ = emulate_pass(x, pool, scales, bf16)
    plain = qc.pool_quantize_plain(torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32),
                                   pool, [torch.tensor(s) for s in scales])
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(p.numpy(), w)
    assert int(np.abs(got[-1]).max()) == 127 or n_scales == 1  # the smaller scale clips


@pytest.mark.parametrize("pool", [1, 2])
def test_emulated_pass_on_half_integers(pool):
    """Every quotient by 0.25 on a half-integer: every value takes the
    division, and rounds half to even as JAX does (by 1 / 16 every
    quotient is an integer: none does)."""
    rng = np.random.default_rng(pool)
    x = ((rng.integers(-64, 64, (2, 6, 10, 32)) + 0.5) * 0.25).astype(np.float32)  # in bf16
    if pool == 2:  # a 2 x 2 block of equal values pools to the value itself
        x = np.repeat(np.repeat(x[:, ::2, ::2], 2, 1), 2, 2)
    scales = [F32(0.25), F32(0.0625)]
    want = _jax_pool_quantize(x, pool, scales, jnp.bfloat16)
    assert (_bf16_round(x) == x).all()
    got, redone = emulate_pass(x, pool, scales, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert redone == x.size // (pool * pool)  # every value at 0.25, none at 1 / 16


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pool", [1, 2])
def test_emulated_pass_with_nan(pool, dtype):
    """NaN (and the infinities) among the values: a NaN, and a pool over one,
    codes 0 as JAX's and the plain version's int8 conversion give it; an
    infinity clamps."""
    rng = np.random.default_rng(40 + pool)
    x = (rng.normal(size=(2, 6, 10, 32)) * 2).astype(np.float32)
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, 40, replace=False)] = np.nan
    flat[rng.choice(flat.size, 6, replace=False)] = np.inf
    flat[rng.choice(flat.size, 6, replace=False)] = -np.inf
    bf16 = dtype == "bfloat16"
    if bf16:
        x = _bf16_round(x)
    scales = [F32(0.05), F32(0.013)]
    want = _jax_pool_quantize(x, pool, scales, jnp.bfloat16 if bf16 else jnp.float32)
    got, _ = emulate_pass(x, pool, scales, bf16)
    plain = qc.pool_quantize_plain(torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32),
                                   pool, [torch.tensor(s) for s in scales])
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(p.numpy(), w)
    pooled = x if pool == 1 else x.reshape(2, 3, 2, 5, 2, 32).sum((2, 4))
    assert np.isnan(pooled).any() and (got[0][np.isnan(pooled)] == 0).all()


def test_emulation_at_a_res5_chunk_slice():
    """The kernel's order at res5's pool-2 pass of the downsample (C 1280,
    18 x 18), on 2 of the chunk's 256 regions, against the plain version."""
    rng = np.random.default_rng(18)
    x = _bf16_round(np.maximum(rng.normal(size=(2, 18, 18, 1280)), 0).astype(np.float32) * 3)
    scales = [F32(0.021)]
    got, _ = emulate_pass(x, 2, scales, True)
    want = qc.pool_quantize_plain(torch.from_numpy(x).to(torch.bfloat16), 2,
                                  [torch.tensor(scales[0])])
    np.testing.assert_array_equal(got[0], want[0].numpy())


def test_impl_first_is_refused_on_cpu_tensors():
    x = torch.randn(1, 4, 4, 16).to(torch.bfloat16)
    s = [torch.tensor(0.05)]
    with pytest.raises(ValueError, match="lies on"):
        qc.pool_quantize(x, 2, s, _impl="first")
    with pytest.raises(ValueError, match="_impl is None"):
        qc.pool_quantize(x, 2, s, _impl="vec")
    assert torch.equal(qc.pool_quantize(x, 2, s)[0], qc.pool_quantize_plain(x, 2, s)[0])
