"""What the cluster design of the NMS kernel (`nms_cluster_kernel` in
`ov3det_torch/csrc/nms.cu`) relies on, checked on the CPU against the JAX
package: the kernel's order emulated in numpy, f32 operation for operation.

- `pick_key`: one 64-bit key a box (the score's bits made monotone, NaN
  above everything, -0 as +0; the index breaking ties) orders the boxes as
  the argmax rounds of JAX and torch pick them.
- `exceeds`: the overlap compared with the threshold without a division
  outside a relative margin of 2^-20, by the division inside it, equals the
  rounded division's comparison on every pair near the threshold, for
  every threshold, the ones it must hand to the division too.
- `cluster_keep`: the whole kernel in its order (each CTA of the cluster
  ranks its share of the boxes by counting larger keys and writes the
  order; rows of the suppression bitmask in rank order, from the row's own
  word on, CTA r % C building row r; the word-by-word greedy pass on the
  live set) gives JAX's `_greedy_suppress` over `_aabb_overlap_matrix` and
  the port's `nms_plain` exactly, in every variant, at K 8, 128, 256, 1000
  and 1024, on scenes with exact score ties, NaN, -inf, -1e30 and -6e29
  scores, zero-volume and infinite boxes, pairs at the threshold and one
  ulp either side of it, a box of another class over a kept one and a
  scene with nothing valid; and every box of a scene of disjoint boxes
  survives.
- The cluster's split (`cluster_size_for`, `rank_threads_for`, mirrored
  from the source): every box ranked once, every row built once, a CTA's
  boxes within its threads.
- `_impl="first"` is refused on CPU tensors.

The kernel itself runs only on the card, where chip_smoke.py holds both
designs against the plain version bit for bit.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.geometry import nms as jnms
from ov3det_torch.ops.kernels import nms as kn

CSRC = Path(kn.__file__).resolve().parents[2] / "csrc"
THRESH = np.float32(0.25)
HAS_CUT = np.float32(-5e29)
F32 = np.float32
FEW_LIVE = 4  # csrc/nms.cu kFewLive: live ranks in a word taken one by one, above it bit by bit


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


# ------------------------------------------------------------------ emulation
def pick_key(s: np.ndarray) -> np.ndarray:
    """`pick_key` of csrc/nms.cu for scores s (K,) f32: uint64 keys."""
    s = np.where(s == 0, F32(0), s).astype(np.float32)  # -0 as +0
    b = s.view(np.uint32).astype(np.uint64)
    u = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    u = np.where(np.isnan(s), np.uint64(0xFFFFFFFF), u)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - np.arange(len(s), dtype=np.uint64))


def exceeds(inter: np.ndarray, den: np.ndarray, t: np.float32, fast: bool) -> tuple:
    """`exceeds` of csrc/nms.cu, elementwise in f32: (inter / den > t, how
    many pairs the division decided)."""
    with np.errstate(all="ignore"):
        p = F32(t) * den
        up, down = p * F32(1 + 2.0 ** -20), p * F32(1 - 2.0 ** -20)
        sure = fast & np.isfinite(inter) & np.isfinite(den) & ((inter > up) | (inter < down))
        divided = (inter / den) > t
    return np.where(sure, inter > up, divided), int((~sure).sum())


def nan_min(a, b):
    return np.where(np.isnan(a) | np.isnan(b), F32(np.nan), np.fmin(a, b))


def nan_max(a, b):
    return np.where(np.isnan(a) | np.isnan(b), F32(np.nan), np.fmax(a, b))


def clamp_lo(x, lo):
    return np.where(x < lo, F32(lo), x)  # NaN stays NaN


def cluster_keep(boxes, scores, classes, valid, t: np.float32, old_type: bool) -> tuple:
    """The cluster design on one scene: boxes (K, 2D), scores (K,),
    classes (K,) or None, valid (K,) -> (keep (K,) bool, pairs the division
    decided)."""
    K, D = scores.shape[0], boxes.shape[1] // 2
    cs, words = kn.cluster_size_for(K), -(-K // 32)
    fast = bool(F32(2.0 ** -60) <= t <= F32(2.0 ** 60))
    key = pick_key(scores)
    # the rank: CTA q counts the larger keys of its `per` boxes
    per = -(-K // cs)
    order = np.full(K, -1)
    for q in range(cs):
        for i in range(q * per, min(K, (q + 1) * per)):
            rank = int((key > key[i]).sum())
            assert order[rank] == -1
            order[rank] = i
    assert (np.sort(order) == np.arange(K)).all()
    # rank order: boxes, volumes, classes, live flags
    bx = boxes[order]
    vol = bx[:, D] - bx[:, 0]
    for d in range(1, D):
        vol = vol * (bx[:, D + d] - bx[:, d])
    cls = classes[order] if classes is not None else np.zeros(K, np.int64)
    live = valid[order] & (scores[order] > HAS_CUT)
    # the bitmask: row r by CTA r % cs, words from r // 32 on
    mask = np.zeros((K, words), np.uint32)
    built = np.zeros(K, int)
    divided = 0
    with np.errstate(all="ignore"):
        for q in range(cs):
            for r in range(q, K, cs):
                built[r] += 1
                c = np.arange((r // 32) * 32, K)
                inter = None
                for d in range(D):
                    e = clamp_lo(nan_min(bx[r, D + d], bx[c, D + d]) - nan_max(bx[r, d], bx[c, d]),
                                 F32(0))
                    inter = e if inter is None else inter * e
                den = clamp_lo(vol[c], F32(1e-12)) if old_type else \
                    clamp_lo((vol[r] + vol[c]) - inter, F32(1e-12))
                bit, n = exceeds(inter, den, t, fast)
                divided += n
                if classes is not None:
                    other = cls[c] != cls[r]
                    bit = np.where(other, (F32(0) > t) & np.isfinite(inter / den), bit)
                padded = np.zeros(words * 32 - (r // 32) * 32, bool)
                padded[:len(c)] = bit
                weights = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint64)
                mask[r, r // 32:] = (padded.reshape(-1, 32) * weights).sum(1).astype(np.uint32)
    assert (built == 1).all()
    # the greedy pass: word by word
    alive = [int(sum(1 << b for b in range(32) if w * 32 + b < K and live[w * 32 + b]))
             for w in range(words)]
    keep = np.zeros(K, bool)
    while any(alive):
        w = next(i for i, a in enumerate(alive) if a)
        a, kept = alive[w], 0
        if bin(a).count("1") <= FEW_LIVE:  # rank by rank
            while a:
                b = (a & -a).bit_length() - 1
                kept |= 1 << b
                a &= ~(int(mask[w * 32 + b, w]) | (1 << b))
        else:  # bit by bit
            for b in range(32):
                bit = a & (1 << b)
                kept |= bit
                a &= ~int(mask[w * 32 + b, w]) if bit else 0xFFFFFFFF
        for b in range(32):
            if kept >> b & 1:
                keep[order[w * 32 + b]] = True
        alive[w] = 0
        for v in range(w + 1, words):
            for b in range(32):
                if kept >> b & 1:
                    alive[v] &= ~int(mask[w * 32 + b, v])
    return keep, divided


# ------------------------------------------------------------------ scenes
def scenes(seed: int, B: int, K: int, D: int) -> tuple:
    """(boxes (B, K, 2D), scores, classes, valid) with every hard case."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 16, (B, K, D)) / 8.0
    boxes = np.concatenate([lo, lo + rng.integers(1, 10, (B, K, D)) / 8.0], -1).astype(np.float32)
    scores = (rng.integers(0, 12, (B, K)) / 16.0).astype(np.float32)  # many exact ties
    classes = rng.integers(0, 3, (B, K)).astype(np.int64)
    valid = rng.random((B, K)) > 0.2
    boxes[0, 0] = [0.0] * D + [1.0] * D
    boxes[0, 1] = [0.0] * D + [1.0] * (D - 1) + [0.25]  # IoU exactly the threshold
    scores[0, :2], classes[0, :2], valid[0, :2] = [0.9, 0.8], 0, True
    boxes[0, 2, D:] = boxes[0, 2, :D]  # zero volume
    scores[0, 3:7] = [np.nan, -np.inf, -1e30, -6e29]
    scores[1, 1::4] = np.nan
    scores[1, 2] = -0.0  # ties with +0
    valid[-1] = False  # nothing valid
    if K >= 32:
        heights = (np.nextafter(THRESH, F32(0)), THRESH, np.nextafter(THRESH, F32(1)))
        for k, (small_first, h) in enumerate([(s, h) for s in (False, True) for h in heights]):
            # a unit box and one of height h inside it, apart from the rest along x
            i, base = 8 + 2 * k, F32(20 + 4 * k)
            boxes[1, i] = [base] + [0.0] * (D - 1) + [base + 1] + [1.0] * (D - 1)
            boxes[1, i + 1] = [base] + [0.0] * (D - 1) + [base + 1] + [1.0] * (D - 2) + [h]
            scores[1, i:i + 2] = (0.97, 0.98) if small_first else (0.98, 0.97)
            classes[1, i:i + 2], valid[1, i:i + 2] = 1, True
        boxes[1, 20] = [-np.inf] * D + [np.inf] * D  # an infinite box
        scores[1, 20], valid[1, 20] = 0.5, True
        boxes[1, 21], scores[1, 21], classes[1, 21], valid[1, 21] = boxes[1, 8], 0.95, 2, True
        scores[1, 22] = scores[1, 21]  # a tie across classes
    return boxes, scores, classes, valid


def jax_keep(boxes, scores, classes, valid, old_type: bool) -> np.ndarray:
    """JAX's `_greedy_suppress` over `_aabb_overlap_matrix` (times the class
    product with classes), scene by scene."""
    D = boxes.shape[-1] // 2
    greedy = jax.jit(jnms._greedy_suppress)
    out = []
    for b in range(scores.shape[0]):
        ov = jnms._aabb_overlap_matrix(jnp.asarray(boxes[b, :, :D]), jnp.asarray(boxes[b, :, D:]),
                                       old_type)
        if classes is not None:
            ov = ov * (classes[b][:, None] == classes[b][None, :])
        out.append(np.asarray(greedy(ov, jnp.asarray(scores[b]), float(THRESH),
                                     jnp.asarray(valid[b]))))
    return np.stack(out)


CASES = [(kind, old, K) for kind in ("class_aware", "3d", "2d") for old in (False, True)
         for K in (8, 128, 256, 1000, 1024)]


@pytest.mark.parametrize("kind,old_type,K", CASES)
def test_cluster_order_equals_jax_and_plain(kind, old_type, K):
    D = 2 if kind == "2d" else 3
    boxes, scores, classes, valid = scenes(K + D + 7 * old_type, 3, K, D)
    cls = classes if kind == "class_aware" else None
    want = jax_keep(boxes, scores, cls, valid, old_type)
    plain = kn.nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores), float(THRESH),
                         torch.from_numpy(valid), None if cls is None else torch.from_numpy(cls),
                         old_type).numpy()
    np.testing.assert_array_equal(plain, want)
    got, divided = [], 0
    for b in range(3):
        keep, n = cluster_keep(boxes[b], scores[b], None if cls is None else cls[b], valid[b],
                               THRESH, old_type)
        got.append(keep)
        divided += n
    np.testing.assert_array_equal(np.stack(got), want)
    assert want[0, 0] and not want[0, 3:7].any() and not want[-1].any()
    assert 0 < want.sum() < valid.sum()
    if K >= 32:
        assert 0 < divided < 0.05 * 3 * K * K  # both paths decided pairs
        # the pairs at the threshold and one ulp either side: only the one above
        # suppresses (IoU: the unit box first, at 8, 10, 12; the old type's
        # intersection over the unit box: the small box first, at 15, 17, 19)
        kept, lost = ([9, 11], [13]) if not old_type else ([14, 16], [18])
        assert want[1, kept].all() and not want[1, lost].any()


def test_every_box_survives():
    K = 1024
    lo = np.zeros((K, 3), np.float32)
    lo[:, 0] = 2 * np.arange(K)
    boxes = np.concatenate([lo, lo + 1], -1)
    scores = np.linspace(1.0, 0.01, K, dtype=np.float32)
    keep, divided = cluster_keep(boxes, scores, np.zeros(K, np.int64), np.ones(K, bool), THRESH,
                                 False)
    assert keep.all() and divided == 0


def test_pick_key_orders_like_the_rounds():
    """The keys in descending order are the order in which the argmax
    rounds pick the boxes (the first design's `before`): a NaN first, then
    the larger score, ties (+0 and -0 among them) to the lower index; and
    the first pick of the rounds is torch's argmax."""
    rng = np.random.default_rng(5)
    s = rng.choice(np.array([np.nan, -np.inf, np.inf, -1e30, -6e29, -0.0, 0.0, 0.5, -0.5, 1e-40,
                             -1e-40, 3.0], np.float32), 400)
    key = pick_key(s)
    assert len(set(key.tolist())) == len(s)

    def before(a: int, c: int) -> int:
        na, nc = np.isnan(s[a]), np.isnan(s[c])
        if na != nc:
            return -1 if na else 1
        if not na and s[a] != s[c]:
            return -1 if s[a] > s[c] else 1
        return -1 if a < c else 1

    want = sorted(range(len(s)), key=functools.cmp_to_key(before))
    assert sorted(range(len(s)), key=lambda i: -int(key[i])) == want
    assert want[0] == int(torch.argmax(torch.from_numpy(s)))
    finite = np.where(np.isnan(s), F32(0), s)
    assert sorted(range(len(s)), key=lambda i: -int(pick_key(finite)[i]))[0] == \
        int(torch.argmax(torch.from_numpy(finite)))


THRESHOLDS = [0.25, 0.5, 0.1, 0.7, 1e-3, 0.999, 2.0 ** -60, 2.0 ** 60, 2.0 ** -61, 0.0, -0.25,
              np.inf, np.nan]


@pytest.mark.parametrize("t", THRESHOLDS)
def test_exceeds_equals_the_rounded_division(t):
    t = F32(t)
    rng = np.random.default_rng(11)
    den = np.concatenate([F32(1e-12) * np.ones(8, np.float32),
                          np.exp(rng.uniform(-20, 20, 4000)).astype(np.float32)])
    with np.errstate(all="ignore"):
        near = (den * t).astype(np.float32)
        inter = [near]
        for steps in (1, 2, 5, 40):
            up, down = near.copy(), near.copy()
            for _ in range(steps):
                up, down = np.nextafter(up, F32(np.inf)), np.nextafter(down, F32(-np.inf))
            inter += [up, down]
        inter = np.concatenate(inter + [np.abs(rng.standard_normal(len(near)).astype(np.float32))
                                        * near])
        dens = np.tile(den, len(inter) // len(den))
        inter = np.concatenate([inter, [np.inf, np.nan, 0.0, 1.0, 1e30]]).astype(np.float32)
        dens = np.concatenate([dens, [1.0, 1.0, np.nan, np.inf, 1e-12]]).astype(np.float32)
        want = (inter / dens) > t
    fast = bool(F32(2.0 ** -60) <= t <= F32(2.0 ** 60))
    got, divided = exceeds(inter, dens, t, fast)
    np.testing.assert_array_equal(got, want)
    if fast:
        assert 0 < divided < len(inter)  # both the margin and the division decide pairs
    else:
        assert divided == len(inter)


@pytest.mark.parametrize("K", [1, 8, 31, 33, 96, 128, 256, 257, 1000, 1024])
def test_cluster_split(K):
    """Every box ranked by one CTA, every row built by one, a CTA's boxes
    within its threads (`rank_threads_for` per box)."""
    cs = kn.cluster_size_for(K)
    assert 1 <= cs <= kn.MAX_CLUSTER and (cs == kn.MAX_CLUSTER or cs == -(-K // 32))
    per = -(-K // cs)
    ranked = [i for q in range(cs) for i in range(q * per, min(K, (q + 1) * per))]
    assert ranked == list(range(K))
    rows = sorted(r for q in range(cs) for r in range(q, K, cs))
    assert rows == list(range(K))
    tpb = kn.rank_threads_for(per)
    assert tpb & (tpb - 1) == 0 and tpb <= 32
    assert tpb * per <= kn.THREADS or tpb == 1
    assert tpb == 32 or 2 * tpb * per > kn.THREADS


def test_route_mirrors_the_source():
    src = (CSRC / "nms.cu").read_text()
    assert "constexpr int kMaxCluster = 8;" in src and "constexpr int kThreads = 256;" in src
    assert "constexpr int kMaxK = 1024;" in src and kn.MAX_K == 1024
    assert f"constexpr int kFewLive = {FEW_LIVE};" in src
    assert "if (__popc(a) <= kFewLive) {" in src and "a &= bit ? ~d : 0xffffffffu;" in src
    assert re.search(r"return K <= 32 \* kMaxCluster \? \(K \+ 31\) / 32 : kMaxCluster;", src)
    assert re.search(r"while \(t > 1 && t \* per_cta > kThreads\) t >>= 1;", src)
    for K in range(1, 1025):
        assert kn.cluster_size_for(K) == ((K + 31) // 32 if K <= 256 else 8)


def test_arithmetic_mirrors_the_source():
    src = (CSRC / "nms.cu").read_text()
    body = src[src.index("bool exceeds("):src.index("// Whether the box at (lo, hi)")]
    assert "const float p = __fmul_rn(t, den);" in body
    assert "if (inter > __fmul_rn(p, 1.0f + 0x1p-20f)) return true;" in body
    assert "if (inter < __fmul_rn(p, 1.0f - 0x1p-20f)) return false;" in body
    assert "return __fdiv_rn(inter, den) > t;" in body
    assert "const int fast = threshold >= 0x1p-60f && threshold <= 0x1p60f;" in src
    assert "if (by_class && ci != cj) return 0.0f > t && isfinite(__fdiv_rn(inter, den));" in src
    key = src[src.index("uint64_t pick_key("):src.index("// Whether inter / den > t")]
    assert "u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);" in key
    assert "__float_as_uint(s == 0.0f ? 0.0f : s)" in key
    assert "(0xffffffffu - static_cast<uint32_t>(i))" in key
    assert "live[c] = sv[i] != 0 && sc[i] > kHasCut;" in src


def test_impl_first_is_refused_on_cpu_tensors():
    boxes, scores, classes, valid = (torch.from_numpy(a) for a in scenes(0, 2, 8, 3))
    with pytest.raises(ValueError, match="lie on the CPU"):
        kn.nms_keep(boxes, scores, 0.25, valid, _impl="first")
    with pytest.raises(ValueError, match="_impl is None"):
        kn.nms_keep(boxes, scores, 0.25, valid, _impl="cluster")
    assert torch.equal(kn.nms_keep(boxes, scores, 0.25, valid, classes),
                       kn.nms_plain(boxes, scores, 0.25, valid, classes))
