"""What the fused picks-and-map kernel of the ball-group's feature gradient
(`feature_sources_map` of `csrc/feature_grad.cu`, wrapped by
`ball_group.sources_map`) relies on, checked on the CPU:

- the kernel's order emulated in numpy: each CTA of the cluster owns a
  contiguous range of buckets (fewer buckets than CTAs leave some with none),
  stages its points in chunks, keeps each slot's first hit by the expanded
  distance, publishes each center's first hit; the exchange fills an empty
  slot from the lowest rank with a hit; the map's segments are the CTAs'
  slot ranges cut among their warps.  Its sources equal `slot_sources_plain`
  and JAX's `_bwd` picks exactly, its list and work records equal the plain
  inverse map, and the sum over them `_scatter` bit for bit;
- through `BallGroup`, with the launches replaced by that emulation, the
  gradient equals `jax.vjp` of JAX's Pallas ball-group in interpret mode
  (1e-6; exactly at the interim shape, whose integer cotangents sum exactly
  in any order), in two launches: `sources_map`, then `feature_sum`;
- the route (which shapes the kernel takes, mirrored from the source), the
  first pair where it does not fit, and the wrappers' checks.  The kernel
  itself runs only on the card, where chip_smoke.py holds it against its
  plain version.

Cases: random, ragged N, a bucket wholly past N, empty balls, empty slots
filled from a lower rank, the r^2 boundary scene, K 1, K 4 (fewer buckets
than CTAs), K 33 (not a multiple of the cluster), and the interim SA's shape
at a narrow C.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.ops.pallas.ball_group_kernel import ball_group_pallas
from ov3det_torch.ops import pointcloud
from ov3det_torch.ops.kernels import ball_group as BG
from ov3det.ops.pointcloud import bucket_picks as jax_bucket_picks
from test_torch_ball_group_tile import NARROW, STAGE, _boundary_scene, _tile_sources
from test_torch_feature_grad_hopper import emulate, emulate_sum

SOURCE = (Path(BG.__file__).resolve().parents[2] / "csrc" / "feature_grad.cu").read_text()
CONSTS = dict(re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE))
CLUSTER, MAX_WARPS = int(CONSTS["kMapCluster"]), int(CONSTS["kMapMaxWarps"])
HEAVY, MAX_SLOTS = int(CONSTS["kHeavy"]), int(CONSTS["kMaxSlots"])
STAGE_POINTS, HIST_ROWS = int(CONSTS["kStagePoints"]), int(CONSTS["kHistRows"])
CARD_SMEM = 232448  # the shared memory a CTA of an H100 may opt into


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ the route
def first_bucket(c: int, K: int) -> int:
    return c * K // CLUSTER


def max_buckets(K: int) -> int:
    return -(-K // CLUSTER)


def stage_points(N: int, K: int) -> int:
    return min(max_buckets(K) * -(-N // K), STAGE_POINTS)


def hist_bytes(rows: int, N: int) -> int:
    return rows * (N + (N & 1)) * 2


def fused_bytes(warps: int, N: int, M: int, K: int) -> int:
    region = max(hist_bytes(min(warps, HIST_ROWS), N), stage_points(N, K) * 16)
    return -(-region // 16) * 16 + (3 * N + max_buckets(K) * M + M) * 4


def map_bytes(warps: int, N: int) -> int:
    return hist_bytes(warps, N) + N * 12


def route_warps(N: int, M: int, K: int, limit: int = CARD_SMEM) -> int:
    """Warps a CTA of `feature_sources_map` at this shape, 0 where the route
    (`ov3_sources_map_warps`) gives the shape to the first pair."""
    if min(N, M, K) <= 0 or K * M > MAX_SLOTS:
        return 0
    return next((w for w in (32, 16, 8, 4, 2, 1) if fused_bytes(w, N, M, K) <= limit), 0)


def map_warps(N: int, KM: int, limit: int = CARD_SMEM) -> int:
    """`ov3_feature_map_warps`: the warps of `feature_map`, 0 where refused."""
    if N <= 0 or KM <= 0 or KM > MAX_SLOTS:
        return 0
    return next((w for w in (32, 16, 8, 4, 2, 1) if map_bytes(w, N) <= limit), 0)


# ------------------------------------------------------------ emulation
def expanded_d2(centers: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(M, n) f32 (|c|^2 + |x|^2) - 2 c.x, each operation rounded on its own,
    not clamped (the kernel's comparison needs no clamp)."""
    c, x = centers[:, None, :], pts[None, :, :]
    c2 = (c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]) + c[..., 2] * c[..., 2]
    x2 = (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]
    cross = (c[..., 0] * x[..., 0] + c[..., 1] * x[..., 1]) + c[..., 2] * x[..., 2]
    return (c2 + x2) - np.float32(2) * cross


def emulate_picks(xyz: np.ndarray, centers: np.ndarray, r2: np.float32, K: int, stage: int):
    """Phases 1 and 2 for one scene: (src (K, M), the CTA each slot belongs
    to (K,), pub (CLUSTER, M) each CTA's first hit a center, and the rank each
    slot's effective source came from (K, M), -1 for its own or none)."""
    N, M = xyz.shape[0], centers.shape[0]
    Nb = -(-N // K)
    r2 = r2 if r2 > 0 else np.float32(-np.inf)
    picks, pub = [], np.full((CLUSTER, M), -1, np.int64)
    for c in range(CLUSTER):
        k0, nk = first_bucket(c, K), first_bucket(c + 1, K) - first_bucket(c, K)
        pick = np.full((nk, M), -1, np.int64)
        s, p1 = min(k0 * Nb, N), min((k0 + nk) * Nb, N)
        while s < p1:  # a chunk of the CTA's points in the stage
            n = min(stage, p1 - s)
            inb = expanded_d2(centers, xyz[s:s + n]) < r2
            for g in range(nk):
                lo, hi = max((k0 + g) * Nb, s), min((k0 + g + 1) * Nb, N, s + n)
                if lo >= hi:
                    continue
                hit = inb[:, lo - s:hi - s]
                take = (pick[g] < 0) & hit.any(1)  # a slot found in an earlier chunk stays
                pick[g, take] = lo + hit.argmax(1)[take]
            s += n
        if nk:
            found = pick >= 0
            pub[c] = np.where(found.any(0), pick[found.argmax(0), np.arange(M)], -1)
        picks.append(pick)
    eff, rank = np.full(M, -1, np.int64), np.full(M, -1, np.int64)
    for c in reversed(range(CLUSTER)):  # the lowest rank with a hit wins
        eff, rank = np.where(pub[c] >= 0, pub[c], eff), np.where(pub[c] >= 0, c, rank)
    owner = np.concatenate([np.full(len(p), c) for c, p in enumerate(picks)])
    src = np.concatenate(picks)
    filled = src < 0
    from_rank = np.where(filled & (eff >= 0)[None], rank[None], -1)
    return np.where(filled, eff[None], src), owner, pub, from_rank


def emulate_sort(keys: np.ndarray, N: int, segments: list, warps: int):
    """`sort_slots` for one scene: segments[q] = (lo, hi) of warp q % warps
    of CTA q // warps, in slot order -> (list (named,) of slot indices, work
    records (N, 4) in the kernel's order)."""
    hist = np.zeros((len(segments), N), np.int64)
    for q, (lo, hi) in enumerate(segments):
        k = keys[lo:hi]
        np.add.at(hist[q], k[(k >= 0) & (k < N)], 1)
    per_cta = hist.reshape(CLUSTER, warps, N)
    warp_prefix = np.cumsum(per_cta, axis=1) - per_cta  # the column prefix over the warps
    tot = per_cta.sum(1)
    ahead = np.cumsum(tot, axis=0) - tot  # the counts of the CTAs before each one (DSMEM)
    count = tot.sum(0)
    start = np.cumsum(count) - count  # the scan over the points
    place = (start[None, None] + ahead[:, None] + warp_prefix).reshape(len(segments), N)
    out = np.full(int(count.sum()), -1, np.int64)
    for q, (lo, hi) in enumerate(segments):
        for base in range(lo, hi, 32):  # a warp step: each slot's rank among its equal keys
            step = keys[base:min(base + 32, hi)]
            lanes = np.flatnonzero((step >= 0) & (step < N))
            k = step[lanes]
            rank = np.tril(k[:, None] == k[None, :], -1).sum(1)
            out[place[q, k] + rank] = base + lanes
            np.add.at(place[q], k, 1)
    heavy = count * N > HEAVY * int(count.sum())
    order = np.concatenate([np.flatnonzero(heavy), np.flatnonzero(~heavy)])
    work = np.stack([order, start[order], start[order] + count[order], 0 * order], 1)
    return out, work


def fused_segments(K: int, M: int, rows: int) -> list:
    """The warps' slot ranges: CTA c's slots first_bucket(c) * M ..
    first_bucket(c + 1) * M cut among its first `rows` warps (a histogram
    row each)."""
    segs = []
    for c in range(CLUSTER):
        j0, nloc = first_bucket(c, K) * M, (first_bucket(c + 1, K) - first_bucket(c, K)) * M
        seg = -(-nloc // rows)
        for w in range(rows):
            lo = min(w * seg, nloc)
            segs.append((j0 + lo, j0 + min(lo + seg, nloc)))
    return segs


def emulate_sources_map(xyz, centers, r2, K: int, warps: int = MAX_WARPS, stage: int = None):
    """`feature_sources_map` over the scenes -> (src (B, K, M), list (B, K M)
    with -1 past the named slots, work (B, N, 4)), and each scene's
    (owner, pub, from_rank) for the cases' own checks."""
    B, N, _ = xyz.shape
    M = centers.shape[1]
    stage = stage or stage_points(N, K)
    srcs, lists, works, facts = [], [], [], []
    for b in range(B):
        src, owner, pub, from_rank = emulate_picks(xyz[b], centers[b], np.float32(r2), K, stage)
        rows = min(warps, HIST_ROWS)
        lst, work = emulate_sort(src.reshape(-1), N, fused_segments(K, M, rows), rows)
        srcs.append(src)
        lists.append(np.concatenate([lst, np.full(K * M - len(lst), -1)]))
        works.append(work)
        facts.append((owner, pub, from_rank))
    return (np.stack(srcs).astype(np.int32), np.stack(lists).astype(np.int32),
            np.stack(works).astype(np.int32), facts)


# ------------------------------------------------------------ cases
_jax_picks = jax.jit(jax_bucket_picks, static_argnums=(2, 3))


def jax_eff_pick(xyz, centers, radius, K):
    """(B, K, M) global index JAX's `_bwd` scatters each slot's cotangent
    onto, -1 where the ball is empty (`test_torch_ball_group_tile`'s
    `_jax_eff_pick` with `bucket_picks` compiled once a shape)."""
    pick, has = (np.asarray(a) for a in _jax_picks(jnp.asarray(xyz), jnp.asarray(centers), radius,
                                                   K))
    Nb = -(-xyz.shape[1] // K)
    first = np.argmax(has, axis=-1)[..., None]
    eff_bucket = np.where(has, np.arange(K)[None, None], first)
    eff_pick = np.where(has, pick, np.take_along_axis(pick, first, axis=-1))
    return np.where(has.any(-1, keepdims=True), eff_bucket * Nb + eff_pick, -1).transpose(0, 2, 1)


CASES = ["random", "ragged_n", "past_n", "empty_balls", "lower_rank", "boundary", "k1", "k4",
         "k33", "interim"]


def case(name: str):
    """(xyz (B, N, 3), feats (B, N, C), centers (B, M, 3), radius, K)."""
    if name == "boundary":
        return _boundary_scene()
    rng = np.random.default_rng(CASES.index(name) + 40)
    B, N, M, K, C, radius = 2, 256, 32, 16, 4, 0.3
    if name == "interim":  # the masked step's interim SA at a narrow C
        B, N, M, K, C, radius = 1, 2048, 1024, 32, 4, 0.4
    if name == "ragged_n":
        N = 251  # a shorter last bucket
    if name == "past_n":
        N, M, K, radius = 14, 8, 12, 0.9  # buckets of 2: CTA 7's two wholly past N
    if name == "k1":
        K = 1
    if name == "k4":
        K = 4  # four CTAs hold no bucket
    if name == "k33":
        N, K = 264, 33
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    centers = xyz[:, rng.choice(N, M, replace=False)].copy()
    if name == "empty_balls":
        centers[:, ::3] += 10.0  # a third of the balls hold no point
    if name == "past_n":
        centers[:, -2:] += 10.0  # two empty balls
    if name == "lower_rank":
        radius = 0.2  # most slots empty: filled from the first CTA with a hit, often a lower rank
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    return xyz, feats, centers, radius, K


@pytest.mark.parametrize("stage", [None, 5])  # the source's stage; chunks of 5 points
@pytest.mark.parametrize("name", CASES)
def test_emulated_kernel_equals_the_plain_versions(name, stage):
    xyz, feats, centers, radius, K = case(name)
    if stage and name == "interim":
        stage = 100  # chunks that cut the CTA's 256 points across its buckets
    N, M, C = xyz.shape[1], centers.shape[1], feats.shape[-1]
    r2 = BG._f32(radius * radius)
    src, lst, work, facts = emulate_sources_map(xyz, centers, r2, K, stage=stage)
    want = BG.slot_sources_plain(_t(xyz), _t(centers), radius, K)
    np.testing.assert_array_equal(src, want.numpy())
    np.testing.assert_array_equal(src, jax_eff_pick(xyz, centers, radius, K))
    want_list, want_work = BG._inverse_map(want, N)
    np.testing.assert_array_equal(lst, want_list.numpy())
    np.testing.assert_array_equal(work, want_work.numpy())
    g = np.random.default_rng(9).normal(size=src.shape + (3 + C,)).astype(np.float32)
    g[..., 3:] *= np.float32(2.0) ** np.random.default_rng(10).integers(-20, 20, g[..., 3:].shape)
    got = np.stack([emulate_sum(g[b, ..., 3:].reshape(K * M, C), lst[b], work[b], N)
                    for b in range(src.shape[0])])
    np.testing.assert_array_equal(got.view(np.int32), BG._scatter(_t(src), _t(g), N, C).numpy()
                                  .view(np.int32))
    owners = facts[0][0]
    if name == "boundary":
        assert src.item() == 1  # the expanded pick
    if name in ("empty_balls", "past_n"):
        assert (src == -1).any() and (src >= 0).any()
    if name == "past_n":
        assert first_bucket(CLUSTER - 1, K) * -(-N // K) >= N and src.max() < N
    if name == "lower_rank":
        from_rank = np.stack([f[2] for f in facts])  # (B, K, M)
        owner = owners[None, :, None]
        assert ((from_rank >= 0) & (from_rank < owner)).sum() > 100
        assert ((from_rank >= 0) & (from_rank == owner)).any()  # and from its own first hit
    if name in ("k1", "k4"):
        assert len(set(owners)) == K  # the other CTAs hold no bucket
    if name == "k33":
        assert sorted(np.bincount(owners).tolist()) == [4] * 7 + [5]


# ------------------------------------------------------------ the route
def test_route_constants_mirror_the_source():
    assert BG.MAP_HEAVY == HEAVY and CLUSTER == 8
    code = re.sub(r"\s+", "", SOURCE)
    for piece in (
            "intfirst_bucket(intc,intK){returnc*K/kMapCluster;}",
            "intmax_buckets(intK){return(K+kMapCluster-1)/kMapCluster;}",
            "constintspan=max_buckets(K)*((N+K-1)/K);returnspan<kStagePoints?span:kStagePoints;",
            "constsize_thist=hist_bytes(hist_rows(warps),N);constsize_tstage="
            "static_cast<size_t>(stage_points(N,K))*sizeof(float4);return((hist>stage?hist:stage)"
            "+15)/16*16;",
            "returnstatic_cast<size_t>(rows)*hist_row(N)*2;",
            "inthist_rows(intwarps){returnwarps<kHistRows?warps:kHistRows;}",
            "returnfused_region(warps,N,K)+(3*static_cast<size_t>(N)+static_cast<size_t>("
            "max_buckets(K))*M+M)*sizeof(int);",
            "if(N<=0||M<=0||K<=0||static_cast<longlong>(K)*M>kMaxSlots)returncudaSuccess;return"
            "most_warps([=](intw){returnfused_bytes(w,N,M,K);},warps);",
            "for(intw=kMapMaxWarps;w>=1;w>>=1)if(bytes(w)<=static_cast<size_t>(limit)){*warps=w;",
            "returnhist_bytes(warps,N)+static_cast<size_t>(N)*12;",
            "constfloatr2k=r2>0.0f?r2:-INFINITY;",
    ):
        assert piece in code, piece


@pytest.mark.parametrize("N,M,K,limit,want", [
    (2048, 1024, 32, CARD_SMEM, 32),    # the masked step's interim SA: about 76 KiB a CTA
    (2048, 2048, 32, CARD_SMEM, 32),    # 65536 slots, the most
    (2048, 2049, 32, CARD_SMEM, 0),     # more: the first pair refuses them too
    (2048, 65536, 1, CARD_SMEM, 0),     # the picks of one bucket do not fit: the first pair
    (12000, 1024, 32, CARD_SMEM, 2),    # a long point axis: two warps' histograms
    (40000, 1024, 32, CARD_SMEM, 0),    # longer: the first pair refuses it too
    (256, 32, 8, 3600, 0),              # a card with less shared memory: the first pair
])
def test_route_depends_on_the_shape_alone(N, M, K, limit, want):
    assert route_warps(N, M, K, limit) == want
    if want:
        assert fused_bytes(want, N, M, K) <= limit
    if (N, M, K) == (2048, 1024, 32):
        assert fused_bytes(32, N, M, K) == 8 * 2048 * 2 + (3 * 2048 + 4 * 1024 + 1024) * 4
    if limit < CARD_SMEM:  # the first pair still takes it
        assert map_warps(N, K * M, limit) > 0
    if N == 40000:
        assert map_warps(N, K * M) == 0


# ------------------------------------------------------------ the card, emulated
class FakeCard:
    """Stands in for the card: the wrappers take their CUDA branch on CPU
    tensors; the routes answer as the sources do on a card with `limit`
    bytes of shared memory a CTA; each launch runs the numpy emulation of
    its kernel with the arguments the wrapper passes."""

    def __init__(self, monkeypatch, limit: int = CARD_SMEM):
        self.entries, self.limit = [], limit
        monkeypatch.setattr(BG, "_on_cuda", lambda *a, **k: True)
        monkeypatch.setattr(BG, "_runs_kernel", lambda *a, **k: True)
        monkeypatch.setattr(BG, "_map_warps", self.map_warps)
        monkeypatch.setattr(BG, "_fg_launch", self.fg_launch)
        monkeypatch.setattr(BG, "_launch", self.launch)

    def map_warps(self, entry, device, *dims):
        if entry == "ov3_sources_map_warps":
            return route_warps(*dims, limit=self.limit)
        return map_warps(*dims, limit=self.limit)

    def fg_launch(self, entry, device, *args):
        self.entries.append(entry)
        if entry == "ov3_sources_map":
            xyz, centers, B, N, M, K, r2, src, lst, work = args
            warps = route_warps(N, M, K, self.limit)
            if not warps:
                raise RuntimeError(f"{entry} kernel failed: the shape does not fit")
            got = emulate_sources_map(xyz.numpy(), centers.numpy(), r2, K, warps)
            for out, val in zip((src, lst, work), got):
                out.copy_(_t(val))
            return
        if entry == "ov3_feature_sum":
            grad, B, N, KM, C, lst, work, out = args
            rows = grad.numpy().reshape(B, KM, 3 + C)[..., 3:]
            out.copy_(_t(np.stack([emulate_sum(rows[b], lst[b].numpy(), work[b].numpy(), N)
                                   for b in range(B)])))
            return
        assert entry == "ov3_feature_scatter", entry
        src, grad, B, N, KM, C, slots, work, out = args
        got, _ = emulate(src.numpy(), grad.numpy(), N)
        out.copy_(_t(got))

    def launch(self, entry, device, *args):
        self.entries.append(entry)
        assert entry == "ov3_ball_group_sources", entry
        xyz, centers, B, N, M, K, r2, src = args
        src.copy_(_t(_tile_sources(xyz.numpy(), centers.numpy(), np.float32(r2), K, NARROW, STAGE,
                                   "sources")))


def _counts():
    return (BG.sources_map.launches, BG.feature_sum.launches, BG.slot_sources.launches,
            BG.feature_scatter.launches)


@pytest.mark.parametrize("name", CASES)
def test_ball_group_vjp_through_the_fused_route_matches_pallas(name, monkeypatch):
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")  # the TPU's ball-group, interpreted
    xyz, feats, centers, radius, K = case(name)
    C = feats.shape[-1]
    shape = (xyz.shape[0], K, centers.shape[1], 3 + C)
    rng = np.random.default_rng(12)
    exact = name == "interim"  # small integers: every partial sum exact in f32, in any order
    g = (rng.integers(-8, 9, shape) if exact else rng.normal(size=shape)).astype(np.float32)

    @jax.jit  # one program a shape: op by op, the interpreted kernel compiles for seconds
    def pallas_vjp(x, f, c, cot):
        _, vjp = jax.vjp(lambda f: ball_group_pallas(x, f, c, radius, K, True, True), f)
        return vjp(cot)[0]

    want = pallas_vjp(*(jnp.asarray(a) for a in (xyz, feats, centers, g)))
    card = FakeCard(monkeypatch)
    monkeypatch.setattr(BG, "ball_group", lambda *a, **k: BG.ball_group_plain(*a[:5]))
    before = _counts()
    tf = _t(feats).requires_grad_()
    pointcloud.ball_group(_t(xyz), tf, _t(centers), radius, K).backward(_t(g))
    assert card.entries == ["ov3_sources_map", "ov3_feature_sum"]
    assert [a - b for a, b in zip(_counts(), before)] == [1, 1, 0, 0]
    if exact:
        np.testing.assert_array_equal(tf.grad.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # and bit for bit what the CPU's path gives
    cpu = BG.feature_grad_plain(_t(xyz), _t(centers), radius, K, _t(g), C)
    np.testing.assert_array_equal(tf.grad.numpy(), cpu.numpy())


def test_wrappers_launch_once_and_count(monkeypatch):
    xyz, feats, centers, radius, K = case("empty_balls")
    N, C = xyz.shape[1], feats.shape[-1]
    card = FakeCard(monkeypatch)
    before = _counts()
    src, lst, work = BG.sources_map(_t(xyz), _t(centers), radius, K)
    want = BG.sources_map_plain(_t(xyz), _t(centers), radius, K)
    for got, w in zip((src, lst, work), want):
        assert got.dtype == torch.int32 and torch.equal(got, w)
    assert torch.equal(BG.slot_sources(_t(xyz), _t(centers), radius, K), want[0])  # the route
    assert torch.equal(BG.slot_sources(_t(xyz), _t(centers), radius, K, _impl="first"), want[0])
    g = _t(np.random.default_rng(2).normal(size=tuple(src.shape) + (3 + C,)).astype(np.float32))
    assert torch.equal(BG.feature_sum(g, lst, work, N, C), BG._scatter(src, g, N, C))
    assert card.entries == ["ov3_sources_map", "ov3_sources_map", "ov3_ball_group_sources",
                            "ov3_feature_sum"]
    assert [a - b for a, b in zip(_counts(), before)] == [2, 1, 1, 0]


def test_first_pair_where_the_kernel_does_not_fit(monkeypatch):
    xyz, feats, centers, radius, K = case("random")
    N, C = xyz.shape[1], feats.shape[-1]
    card = FakeCard(monkeypatch, limit=fused_bytes(1, N, centers.shape[1], K) - 16)
    g = _t(np.random.default_rng(3).normal(size=(2, K, centers.shape[1], 3 + C)).astype(np.float32))
    before = _counts()
    got = BG.feature_grad(_t(xyz), _t(centers), radius, K, g, C)
    assert card.entries == ["ov3_ball_group_sources", "ov3_feature_scatter"]
    assert [a - b for a, b in zip(_counts(), before)] == [0, 0, 1, 1]
    np.testing.assert_array_equal(got.numpy(), BG.feature_grad_plain(_t(xyz), _t(centers), radius,
                                                                      K, g, C).numpy())
    with pytest.raises(ValueError, match="do not fit"):
        BG.sources_map(_t(xyz), _t(centers), radius, K)


def test_cpu_path_and_checks():
    xyz, feats, centers, radius, K = case("k33")
    N, C = xyz.shape[1], feats.shape[-1]
    g = _t(np.random.default_rng(4).normal(size=(2, K, centers.shape[1], 3 + C)).astype(np.float32))
    before = _counts()
    got = BG.feature_grad(_t(xyz), _t(centers), radius, K, g, C)
    src = BG.slot_sources_plain(_t(xyz), _t(centers), radius, K)
    assert torch.equal(got, BG._scatter(src, g, N, C))  # the CPU's path, as before
    src2, lst, work = BG.sources_map(_t(xyz), _t(centers), radius, K)
    assert torch.equal(src2, src) and torch.equal(BG.feature_sum(g, lst, work, N, C), got)
    assert _counts() == before  # the CPU launches nothing
    with pytest.raises(ValueError, match="CPU"):
        BG.slot_sources(_t(xyz), _t(centers), radius, K, _impl="first")
    with pytest.raises(TypeError, match="work records"):
        BG.feature_sum(g, lst.long(), work, N, C)
    with pytest.raises(TypeError, match="work records"):
        BG.feature_sum(g, lst, work[:, :-1], N, C)
    with pytest.raises(TypeError, match="f32 cotangent"):
        BG.feature_sum(g.double(), lst, work, N, C)
    with pytest.raises(TypeError, match="f32 cotangent"):
        BG.feature_sum(g, lst, work, N, C + 1)
    with pytest.raises(ValueError, match="several devices"):
        BG.feature_sum(g, lst.to("meta"), work, N, C)
