"""What the wgmma design of the trunk conv (`quant_conv_wgmma` in
`ov3det_torch/csrc/quant_conv.cu`) relies on, checked on the CPU: the route
by shape over every distinct conv of the RN50x4 teacher's forward, the
private `_impl` switch, the persistent tile order, and the index arithmetic
of a stage (the producer's implicit im2col gather into the 128-byte swizzle
and the consumers' k32 reads through the wgmma descriptors) emulated in
numpy.  The kernel itself runs only on the card, where chip_smoke.py holds
it and the first design against the plain version bit for bit.

Every comparison here is exact: integer products and index arithmetic.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ov3det_torch.ops.kernels import quant_conv as qc

CSRC = Path(qc.__file__).resolve().parents[2] / "csrc"
SMS = 132  # an H100 SXM's SMs: one CTA each

# The 27 distinct convs of one int8 RN50x4 teacher forward on an OV batch (8
# canvases of 530 x 730, 128 boxes each, res5 in chunks of 256 regions), as
# chip_smoke's `record_trunk` finds them: (B, H, W, C_in, C_out, k,
# residual, int8 output, calls).
TEACHER_CONVS = [
    (8, 265, 365, 40, 40, 3, False, True, 1),
    (8, 265, 365, 40, 80, 3, False, False, 1),
    (8, 132, 182, 80, 80, 1, False, True, 1),
    (8, 132, 182, 80, 80, 3, False, True, 4),
    (8, 132, 182, 80, 320, 1, False, False, 1),
    (8, 132, 182, 80, 320, 1, True, True, 4),
    (8, 132, 182, 320, 80, 1, False, True, 3),
    (8, 132, 182, 320, 160, 1, False, True, 1),
    (8, 132, 182, 160, 160, 3, False, False, 1),
    (8, 66, 91, 320, 640, 1, False, False, 1),
    (8, 66, 91, 160, 640, 1, True, True, 6),
    (8, 66, 91, 640, 160, 1, False, True, 5),
    (8, 66, 91, 160, 160, 3, False, True, 5),
    (8, 66, 91, 640, 320, 1, False, True, 1),
    (8, 66, 91, 320, 320, 3, False, False, 1),
    (8, 33, 45, 640, 1280, 1, False, False, 1),
    (8, 33, 45, 320, 1280, 1, True, True, 9),
    (8, 33, 45, 1280, 320, 1, False, True, 9),
    (8, 33, 45, 320, 320, 3, False, True, 9),
    (8, 33, 45, 320, 1280, 1, True, False, 1),
    (256, 18, 18, 1280, 640, 1, False, True, 4),
    (256, 18, 18, 640, 640, 3, False, False, 4),
    (256, 9, 9, 1280, 2560, 1, False, False, 4),
    (256, 9, 9, 640, 2560, 1, True, True, 20),
    (256, 9, 9, 2560, 640, 1, False, True, 20),
    (256, 9, 9, 640, 640, 3, False, True, 20),
    (256, 9, 9, 640, 2560, 1, True, False, 4),
]
RAGGED = [(15, 48, 432), (129, 88, 1024), (300, 640, 640), (1000, 1280, 2880), (777, 2568, 5760),
          (128, 80, 80), (20736, 2560, 1280)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_the_table_is_one_teacher_forward():
    assert sum(row[-1] for row in TEACHER_CONVS) == 141  # chip_smoke.TEACHER_STEP
    assert len({row[:8] for row in TEACHER_CONVS}) == 27


# ------------------------------------------------------------------ route
@pytest.mark.parametrize("B,H,W,cin,cout,k,res,q,calls", TEACHER_CONVS)
def test_route_of_each_teacher_conv(B, H, W, cin, cout, k, res, q, calls):
    """Every teacher conv runs the wgmma design except the two C_in-40 stem
    convs, which stay on the first design (their 40-byte pixels take 8-byte
    gathers); the N tile divides C_out, so no tile of the teacher is ragged
    in N."""
    route = qc._route(cin, cout, k)
    assert route == ("mma" if cin == 40 else "wgmma")
    if route == "wgmma":
        bn = qc._n_tile(cout, k * k * cin)
        assert bn == (160 if k * k * cin >= 1024 and cout > 80 else 80) and cout % bn == 0


def test_route_mirrors_the_source():
    src = (CSRC / "quant_conv.cu").read_text()
    assert re.search(r"constexpr bool takes\(int C\) \{ return C % 16 == 0; \}", src)
    assert re.search(r"constexpr int n_tile\(int N, int K\) \{ return N <= 80 \|\| K < 1024 \? 80 "
                     r": 160; \}", src)
    assert re.search(r"constexpr int kBM = (\d+);", src.split("namespace wg {")[1]).group(1) \
        == str(qc.WGMMA_ROWS)
    for cin in range(8, 2600, 8):
        assert qc._route(cin, 64, 3) == ("wgmma" if cin % 16 == 0 else "mma")
    for cout in range(8, 2600, 8):
        for depth in (16, 1008, 1024, 5760):
            assert qc._n_tile(cout, depth) == (80 if cout <= 80 or depth < 1024 else 160)


def _conv_args(cin=48, cout=48, k=3):
    rng = np.random.default_rng(cin + cout)
    x = torch.from_numpy(rng.integers(-127, 128, (1, 3, 5, cin), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (cout, k * k * cin), dtype=np.int8))
    return [x, w, k, k // 2, torch.tensor(0.02), torch.from_numpy(rng.random(cout, np.float32))]


def test_impl_mma_is_refused_on_cpu_tensors():
    args = _conv_args()
    with pytest.raises(ValueError, match="lie on the CPU"):
        qc.quant_conv(*args, _impl="mma")
    with pytest.raises(ValueError, match="_impl is None"):
        qc.quant_conv(*args, _impl="wgmma")
    out, _ = qc.quant_conv(*args)  # the route by shape: the plain version on the CPU
    want, _ = qc.quant_conv_plain(*args)
    assert torch.equal(out, want)


# ------------------------------------------------------------------ tile order
def _check_tiles(M, N, K, sms):
    per_cta = qc.persistent_tiles(M, N, K, sms)
    bn, bm = qc._n_tile(N, K), qc.WGMMA_ROWS
    nt, mt = -(-N // bn), -(-M // bm)
    assert len(per_cta) == min(sms, mt * nt)
    seen = [t for tiles in per_cta for t in tiles]
    want = {(m * bm, n * bn) for m in range(mt) for n in range(nt)}
    assert len(seen) == len(want) and set(seen) == want  # every tile exactly once
    # a CTA's tiles in the list's order; the tiles the CTAs hold at any one
    # time are consecutive in it, so the N tiles of an M tile run together
    order = sorted(seen)
    for b, tiles in enumerate(per_cta):
        assert tiles == [order[t] for t in range(b, mt * nt, len(per_cta))]
    for i in range(len(order) - 1):
        (m_a, n_a), (m_b, n_b) = order[i], order[i + 1]
        assert (m_b, n_b) == ((m_a, n_a + bn) if n_a + bn < N else (m_a + bm, 0))


@pytest.mark.parametrize("B,H,W,cin,cout,k,res,q,calls", TEACHER_CONVS)
def test_persistent_order_at_the_teacher_shapes(B, H, W, cin, cout, k, res, q, calls):
    _check_tiles(B * H * W, cout, k * k * cin, SMS)


@pytest.mark.parametrize("M,N,K", RAGGED)
@pytest.mark.parametrize("sms", [1, 7, SMS])
def test_persistent_order_ragged(M, N, K, sms):
    _check_tiles(M, N, K, sms)


# ------------------------------------------------------------------ one stage, emulated
BK = 128  # bytes of K a stage


def _swizzled(row: int, chunk: int) -> int:
    """`hopper::swizzled_offset`: chunk c of row r at r * 128 + ((c ^ r % 8) << 4)."""
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def _producer_stage(x, kq, ksize, m0, n0, kt, bn, bm):
    """The bytes of stage kt of the (bm, bn) tile at (m0, n0) as warpgroup 0
    writes them:
    thread t copies chunk q = t % 8 of rows t // 8 + 16 i; an A chunk is one
    tap's 16 channels of one pixel, zero outside the image, past M or past
    K; a B chunk 16 bytes of a kernel row, zero past N or K."""
    B, H, W, C = x.shape
    M, N, K = B * H * W, kq.shape[0], kq.shape[1]
    pad = ksize // 2
    xf, a = x.reshape(M, C), np.zeros(bm * BK, np.int8)
    b = np.zeros(bn * BK, np.int8)
    for tid in range(128):
        q, r0 = tid & 7, tid >> 3
        k = kt * BK + q * 16
        tap = k // C
        c = k - tap * C
        dy, dx = tap // ksize - pad, tap % ksize - pad
        for i in range(bm // 16):
            r = r0 + 16 * i
            m = m0 + r
            hw = m % (H * W)
            h, w = hw // W + dy, hw % W + dx
            if k < K and m < M and 0 <= h < H and 0 <= w < W:
                a[_swizzled(r, q):_swizzled(r, q) + 16] = xf[m + dy * W + dx, c:c + 16]
        for i in range(bn // 16):
            r = r0 + 16 * i
            if k < K and n0 + r < N:
                b[_swizzled(r, q):_swizzled(r, q) + 16] = kq[n0 + r, k:k + 16]
    return a, b


def _descriptor_rows(tile, rows, ks):
    """The (rows, 32) int8 operand a k32 step ks reads through a descriptor
    on a 128-byte-swizzled K-major tile: start address + 32 ks bytes, 8-row
    groups 1024 bytes apart, the hardware's XOR of address bits 4-6 with
    bits 7-9 undone on the way in."""
    out = np.empty((rows, 32), np.int8)
    for r in range(rows):
        for half in range(2):
            chunk = 2 * ks + half
            out[r, 16 * half:16 * half + 16] = tile[_swizzled(r, chunk):_swizzled(r, chunk) + 16]
    return out


def _emulated_conv(x, kq, ksize):
    B, H, W, _ = x.shape
    M, N, K = B * H * W, kq.shape[0], kq.shape[1]
    bn, bm = qc._n_tile(N, K), qc.WGMMA_ROWS
    acc = np.zeros((M, N), np.int64)
    for tiles in qc.persistent_tiles(M, N, K, 3):
        for m0, n0 in tiles:
            d = np.zeros((bm, bn), np.int64)
            for kt in range(-(-K // BK)):
                a, b = _producer_stage(x, kq, ksize, m0, n0, kt, bn, bm)
                for h in range(2):  # the consumer's two m64 products: rows 64 h .. 64 h + 63
                    a_wg = a[h * 64 * BK:(h + 1) * 64 * BK]
                    for ks in range(BK // 32):
                        d[h * 64:(h + 1) * 64] += (
                            _descriptor_rows(a_wg, 64, ks).astype(np.int64)
                            @ _descriptor_rows(b, bn, ks).astype(np.int64).T)
            rows, cols = min(bm, M - m0), min(bn, N - n0)
            acc[m0:m0 + rows, n0:n0 + cols] = d[:rows, :cols]
    return acc


@pytest.mark.parametrize("image,cin,cout,k", [
    ((1, 3, 5), 48, 48, 3),     # 15 rows, ragged in M and N, K 432: a part stage
    ((2, 7, 9), 32, 160, 1),    # K 32: one k32 step of data in the stage
    ((1, 11, 13), 16, 272, 3),  # N tiles of 80, the last ragged; 143 rows, K 144
    ((1, 4, 40), 64, 256, 1),   # N tiles of 80, the last ragged; 160 rows: two M tiles
    ((1, 5, 7), 128, 200, 3),   # K 1152: N tiles of 160, the second ragged
    ((1, 17, 19), 128, 160, 3),  # K 1152: 323 rows, three M tiles
])
def test_stage_arithmetic_reproduces_the_conv(image, cin, cout, k):
    rng = np.random.default_rng(cin * cout + k)
    x = rng.integers(-127, 128, (*image, cin), dtype=np.int8)
    kq = rng.integers(-127, 128, (cout, k * k * cin), dtype=np.int8)
    want = qc.int8_conv(torch.from_numpy(x), torch.from_numpy(kq), k, k // 2)
    got = _emulated_conv(x, kq, k)
    np.testing.assert_array_equal(got, want.reshape(-1, cout).numpy())


# ------------------------------------------------------------------ the quantise without division
def quantize_fast_emulated(v: np.ndarray, s: float) -> tuple:
    """`store_q8_fast` of `csrc/quant_conv.cu` and its redo by `store_q8`,
    in numpy f32, on groups of 8 consecutive values (a thread's piece): u =
    v * rs with rs = 1 / s rounded; rint(u) unless any u of the group lies
    within 2^-14 of a half-integer (|u - rint(u)| > 0.5 - 2^-14) or 1 / s is
    not normal, then rint(v / s);
    clamped to +-127 and a NaN coded 0, as `code_of` converts and clamps.
    Returns (int8 codes, how many groups took the division)."""
    v = v.astype(np.float32).reshape(-1, 8)
    s = np.float32(s)
    exact = not (np.float32(2.0 ** -125) <= s <= np.float32(2.0 ** 125))
    with np.errstate(all="ignore"):
        rs = np.float32(1.0) / s
        u = v * rs
        t = np.rint(u)
        near = np.abs(u - t) > np.float32(0.5 - 2.0 ** -14)  # u - t is exact and at most 0.5
        divide = near.any(axis=1) | exact
        t = np.where(divide[:, None], np.rint(v / s), t)
    t = np.where(np.isnan(t), np.float32(0), np.clip(t, np.float32(-127), np.float32(127)))
    return t.astype(np.int8).reshape(-1), int(divide.sum())


def _boundary_values(s: np.float32, rng) -> np.ndarray:
    """Values whose quotient by s is at, and a few ulps either side of,
    every half-integer k + 0.5 for |k| <= 130, and random ones; a multiple
    of 8 in all."""
    with np.errstate(over="ignore"):  # at 2^125 the large ones overflow to infinity
        half = ((np.arange(-131, 131) + 0.5) * np.float64(s)).astype(np.float32)
        exact_half = ((np.arange(-131, 131) + 0.5).astype(np.float32) * s).astype(np.float32)
        noise = (rng.standard_normal(4096) * 60 * np.float64(s)).astype(np.float32)
    vals = [half]
    for steps in (1, 2, 3, 5):
        up, down = half.copy(), half.copy()
        for _ in range(steps):
            up = np.nextafter(up, np.float32(np.inf))
            down = np.nextafter(down, np.float32(-np.inf))
        vals += [up, down]
    vals += [exact_half, noise]  # products that are half-integers times s, and random values
    out = np.concatenate(vals)
    rng.shuffle(out)
    return out[:len(out) // 8 * 8]


SCALES = ([1.0, 0.5, 1 / 127, 0.02, 3.0, 7.1e-3, 2.0 ** -20, 2.0 ** -125, 2.0 ** 125, 1e-6,
           4.7e3]
          + list(np.exp(np.random.default_rng(7).uniform(np.log(1e-7), np.log(1e4), 40))))


@pytest.mark.parametrize("s", SCALES)
def test_fast_quantise_equals_the_plain_quantise(s):
    rng = np.random.default_rng(int(s * 1e6) % 2 ** 32)
    s32 = np.float32(s)
    v = _boundary_values(s32, rng)
    got, divided = quantize_fast_emulated(v, s32)
    want = qc.quantize_plain(torch.from_numpy(v), torch.tensor(s32)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < divided < len(v) // 8  # both paths ran


@pytest.mark.parametrize("s", [2.0 ** -126, 1e-39, 2.0 ** 126, 3e38])
def test_fast_quantise_divides_where_one_over_s_is_not_normal(s):
    s32 = np.float32(s)
    with np.errstate(over="ignore"):  # at 3e38 some values overflow to infinity
        v = (np.random.default_rng(3).standard_normal(64) * 50 * np.float64(s32)).astype(np.float32)
    got, divided = quantize_fast_emulated(v, s32)
    assert divided == len(v) // 8
    want = qc.quantize_plain(torch.from_numpy(v), torch.tensor(s32)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fast_quantise_at_the_edges():
    """Infinities and values far past the clamp take the fast path and clamp
    as the division would; NaN gives 0 on both paths, as the plain version
    (and JAX) code it."""
    s = np.float32(0.02)
    v = np.array([np.inf, -np.inf, 1e30, -1e30, 3.0, -3.0, 127.5 * 0.02, 0.0], np.float32)
    got, _ = quantize_fast_emulated(v, s)
    want = qc.quantize_plain(torch.from_numpy(v), torch.tensor(s)).numpy()
    np.testing.assert_array_equal(got, want)
    nan = np.full(8, np.nan, np.float32)
    assert (quantize_fast_emulated(nan, s)[0] == 0).all()
    mixed = np.array([np.nan, 3.0, -np.nan, 127.5 * 0.02, np.inf, np.nan, -1e30, 0.0], np.float32)
    got, _ = quantize_fast_emulated(mixed, s)
    np.testing.assert_array_equal(got, qc.quantize_plain(torch.from_numpy(mixed),
                                                         torch.tensor(s)).numpy())
    assert got[0] == got[2] == got[5] == 0


def test_fast_quantise_mirrors_the_source():
    src = (CSRC / "quant_conv.cu").read_text()
    # the arithmetic, shared by the conv's epilogue (`store_q8_fast`) and the pass
    body = src[src.index("uint32_t codes_q8_fast("):src.index("bool store_q8_fast(")]
    assert "const float u = __fmul_rn(v[e], rs);" in body
    assert "const float t = rintf(u);" in body
    assert "near |= (fabsf(__fsub_rn(u, t)) > 0.5f - 0x1p-14f ? 1u : 0u) << e;" in body
    assert "b[e] = code_of(u);" in body
    # the code: the rounding conversion (a NaN 0, the infinities saturated), then the clamp
    assert "const int i = __float2int_rn(u);" in src
    assert "return static_cast<int8_t>(i < -127 ? -127 : (i > 127 ? 127 : i));" in src
    # a flagged piece is stored again by the division (`store_q8`)
    assert "store_q8_fast(p.out_q + off, v, rs, exact)) redo |= 1u << i2;" in src
    assert "store_q8(p.out_q + off, v, sn);" in src
    assert "quantize(float v, float s) {\n  return code_of(__fdiv_rn(v, s));" in src
    assert "!(sn >= 0x1p-125f && sn <= 0x1p125f)" in src and "__frcp_rn(sn)" in src
