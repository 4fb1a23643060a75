"""What the tile design of the ball-group (csrc/ball_group.cu,
`ball_group_tile<fill | sources, TM>`) relies on, checked on the CPU: the
pick pass of the feature gradient (`slot_sources_plain`) against the picks
JAX's `_bwd` scatters onto, the kernel's own tile, chunk and slab arithmetic
emulated in numpy against the plain versions, the route by shape, and the
wrappers' glue around each launch with the launch replaced by that
emulation.  The kernels themselves run only on the card, where
chip_smoke.py holds them against their plain versions and the first design.

Everything is exact except the feature gradient against `jax.vjp`, which
sums the same values in another order (1e-6, as `test_torch_masked.py`).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.ops.pallas.ball_group_kernel import ball_group_pallas
from ov3det.ops.pointcloud import bucket_picks as jax_bucket_picks
from ov3det_torch.ops import pointcloud
from ov3det_torch.ops.kernels import ball_group as BG

SOURCE = (Path(BG.__file__).resolve().parents[2] / "csrc" / "ball_group.cu").read_text()
CONSTS = dict(re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE))
STAGE, MAX_K = int(CONSTS["kStagePoints"]), int(CONSTS["kMaxK"])
NARROW, WIDE = int(CONSTS["kNarrowRows"]), int(CONSTS["kWideRows"])


def _route(K, C):
    """Centers a CTA of the tile design at this shape, as the source's
    entries route it (read back by `test_route_constants_mirror_the_source`),
    0 where the forward takes the first design."""
    if K > MAX_K:
        return 0
    return WIDE if C + 3 > 32 else NARROW


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ cases
def _boundary_scene():
    """Center (10, 0, 0) and a point just outside r along x by the direct
    distance and inside by the expanded one (`test_torch_masked.py`'s
    boundary pin): the forward picks point 2, the backward point 1."""
    radius, c0 = 0.2, np.float32(10.0)
    r2 = np.float32(radius * radius)
    direct = lambda p: (p - c0) * (p - c0)  # noqa: E731
    expanded = lambda p: np.maximum((c0 * c0 + p * p) - np.float32(2) * (c0 * p), 0)  # noqa: E731
    p = np.nextafter(np.float32(c0 + np.float32(radius)), np.float32(0))
    while not (direct(p) >= r2 and expanded(p) < r2):
        p = np.nextafter(p, np.float32(20))
    xyz = np.zeros((1, 4, 3), np.float32)
    xyz[0, :, 0] = [30.0, p, c0 - np.float32(0.1), 40.0]
    centers = np.array([[[c0, 0, 0]]], np.float32)
    return xyz, np.arange(8, dtype=np.float32).reshape(1, 4, 2), centers, radius, 1


def _case(name):
    """(xyz, feats, centers, radius, K), f32 numpy."""
    if name == "boundary":
        return _boundary_scene()
    rng = np.random.default_rng(21)
    radius, K, N, M = 0.3, 8, 512, 64
    xyz = rng.uniform(-1, 1, size=(2, N, 3)).astype(np.float32)
    if name == "ragged_n":
        xyz = xyz[:, :N - 5]  # a shorter last bucket
    if name == "past_n":
        # N 9, K 4: buckets of 3, the last wholly past N (the TPU pads it with
        # sentinels, the kernel tests no index >= N)
        xyz, K, radius = xyz[:, :9] * 0.2, 4, 0.25
    if name == "ragged_m":
        M = 61  # no tile of centers divides it
    centers = xyz[:, rng.choice(xyz.shape[1], min(M, xyz.shape[1]), replace=False)].copy()
    if name == "past_n":
        centers = np.concatenate([centers, centers[:, :3] + 5.0], axis=1)  # three empty balls
    if name == "empty_balls":
        centers[:, ::4] += 10.0  # a quarter of the balls hold no point
    if name == "empty_slots":
        radius = 0.12  # most balls miss most buckets: slots copy the first pick
    feats = rng.normal(size=(2, xyz.shape[1], 5)).astype(np.float32)
    return xyz, feats, centers, radius, K


PICK_CASES = ["random", "ragged_n", "empty_balls", "empty_slots", "boundary", "past_n"]


# ------------------------------------------- the pick pass against JAX's _bwd
def _jax_eff_pick(xyz, centers, radius, K):
    """(B, K, M) global index JAX's `_bwd` scatters each slot's cotangent
    onto (`ball_group_kernel.py:218-231`: `bucket_picks`, then eff_bucket *
    Nb + eff_pick), -1 where the ball is empty (its cotangent is zeroed)."""
    pick, has = (np.asarray(a) for a in jax_bucket_picks(jnp.asarray(xyz), jnp.asarray(centers),
                                                         radius, K))
    Nb = -(-xyz.shape[1] // K)
    first = np.argmax(has, axis=-1)[..., None]
    eff_bucket = np.where(has, np.arange(K)[None, None], first)
    eff_pick = np.where(has, pick, np.take_along_axis(pick, first, axis=-1))
    glob = np.where(has.any(-1, keepdims=True), eff_bucket * Nb + eff_pick, -1)
    return glob.transpose(0, 2, 1)


@pytest.mark.parametrize("name", PICK_CASES)
def test_slot_sources_plain_equals_jax_bwd_picks(name):
    xyz, _, centers, radius, K = _case(name)
    got = BG.slot_sources_plain(_t(xyz), _t(centers), radius, K)
    assert got.dtype == torch.int32 and got.shape == (xyz.shape[0], K, centers.shape[1])
    np.testing.assert_array_equal(got.numpy(), _jax_eff_pick(xyz, centers, radius, K))
    if name == "boundary":
        assert got.item() == 1  # the expanded pick, where the forward takes point 2
    if name in ("empty_balls", "past_n"):
        assert (got == -1).any() and (got >= 0).any()
    if name == "past_n":
        assert got.max() < xyz.shape[1]  # no pick in the bucket past N


def test_bucket_wholly_past_n_forward_equals_pallas():
    xyz, feats, centers, radius, K = _case("past_n")
    assert K * -(-xyz.shape[1] // K) - xyz.shape[1] >= -(-xyz.shape[1] // K)
    want = np.asarray(ball_group_pallas(jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(centers),
                                        radius, K, True, True))
    got = BG.ball_group_plain(_t(xyz), _t(feats), _t(centers), radius, K)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, :, -3:] == 0).all()  # the empty balls


# ---------------------------------------------- the kernel's arithmetic, emulated
def _d2(mode, c, pts):
    """f32 squared distances of `pts` (n, 3) to `c` (3,), each operation
    rounded on its own, in the kernel's order: direct for the forward
    (`fill`), expanded and clamped for the pick pass (`sources`)."""
    if mode == "fill":
        d = c[None] - pts
        return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    c2 = (c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]
    x2 = (pts[:, 0] * pts[:, 0] + pts[:, 1] * pts[:, 1]) + pts[:, 2] * pts[:, 2]
    cross = (c[0] * pts[:, 0] + c[1] * pts[:, 1]) + c[2] * pts[:, 2]
    return np.maximum((c2 + x2) - np.float32(2) * cross, np.float32(0))


def _tile_sources(xyz, centers, r2, K, TM, stage, mode):
    """(B, K, M) effective sources as `ball_group_tile<mode, TM>` leaves them
    in shared memory: CTA (tile of TM centers, scene b); a stage of the pick
    phase holds as many whole buckets as fit in `stage` points, or one chunk
    of a bucket longer than that; a row skips a later chunk once its slot
    holds a pick; then each slot takes its own pick, else the first
    non-empty bucket's, else -1."""
    B, N, _ = xyz.shape
    M = centers.shape[1]
    Nb = -(-N // K)
    chunks = -(-Nb // stage)
    per_stage = 1 if chunks > 1 else min(stage // Nb, K)
    tiles = K * chunks if chunks > 1 else -(-K // per_stage)
    cap = stage if chunks > 1 else per_stage * Nb
    out = np.full((B, K, M), -7, np.int64)
    for b in range(B):
        for m0 in range(0, M, TM):
            tm = min(TM, M - m0)
            pick = np.full((K, TM), -99, np.int64)  # shared memory is not initialised
            for t in range(tiles):
                if chunks > 1:
                    k0, c = divmod(t, chunks)
                    nk, start, opens = 1, k0 * Nb + c * stage, c == 0
                    end = k0 * Nb + min((c + 1) * stage, Nb)
                else:
                    k0 = t * per_stage
                    nk = min(per_stage, K - k0)
                    start, end, opens = k0 * Nb, (k0 + nk) * Nb, True
                n = max(min(end, N) - start, 0)
                assert n <= cap  # fits the stage
                for r in range(tm):
                    for g in range(nk):
                        k, lo = k0 + g, g * Nb
                        hi = min(lo + Nb, n)
                        if not opens and pick[k, r] >= 0:
                            continue
                        hit = _d2(mode, centers[b, m0 + r], xyz[b, start + lo:start + max(hi, lo)]) < r2
                        found = start + lo + int(np.argmax(hit)) if hit.any() else -1
                        if opens or found >= 0:
                            pick[k, r] = found
            for r in range(tm):
                own = pick[:, r]
                first = own[own >= 0][0] if (own >= 0).any() else -1
                pick[:, r] = np.where(own >= 0, own, first)
            out[b, :, m0:m0 + tm] = pick[:, :tm]
    return out


def _tile_fill(xyz, feats, centers, src, inv_r, TM):
    """The fill phase's writes into a flat output: the CTA (b, m0) writes
    element col of its row q = k TM + r at ((b K + k) M + m0) P + r P + col
    (narrow rows walked element by element over the K x TM rows, wide ones a
    warp a row); rows past a ragged M (r >= tm) are skipped."""
    B, K, M = src.shape
    C = 0 if feats is None else feats.shape[-1]
    P = 3 + C
    out = np.full(B * K * M * P, np.nan, np.float32)
    for b in range(B):
        for m0 in range(0, M, TM):
            tm = min(TM, M - m0)
            q, col = np.divmod(np.arange(K * TM * P), P)
            k, r = np.divmod(q, TM)
            keep = r < tm
            k, r, col = k[keep], r[keep], col[keep]
            s = src[b, k, m0 + r]
            rel = (xyz[b, s, np.minimum(col, 2)] - centers[b, m0 + r, np.minimum(col, 2)]) * inv_r
            val = np.where(col < 3, rel, feats[b, s, np.maximum(col - 3, 0)] if C else 0)
            out[((b * K + k) * M + m0) * P + r * P + col] = np.where(s < 0, 0, val)
    return out.reshape(B, K, M, P)


@pytest.mark.parametrize("mode", ["fill", "sources"])
@pytest.mark.parametrize("name", ["random", "ragged_n", "ragged_m", "empty_balls", "past_n",
                                  "boundary"])
@pytest.mark.parametrize("TM,stage", [
    (64, STAGE), (16, STAGE),  # the source's stages: every bucket of these cases in one
    (16, 7), (32, 20),         # buckets in chunks (at 512 points, K 8)
    (32, 150),                 # two whole buckets a stage
])
def test_tile_picks_equal_the_plain_versions(mode, name, TM, stage):
    xyz, _, centers, radius, K = _case(name)
    r2 = np.float32(BG._f32(radius * radius))
    got = _tile_sources(xyz, centers, r2, K, TM, stage, mode)
    if mode == "sources":
        want = BG.slot_sources_plain(_t(xyz), _t(centers), radius, K).numpy()
    else:
        src, any_hit = BG._slot_sources(*BG.bucket_picks(_t(xyz), _t(centers), radius, K))
        want = torch.where(any_hit, src, -1).transpose(1, 2).numpy()
    np.testing.assert_array_equal(got, want)
    if name == "boundary":
        assert got.item() == (1 if mode == "sources" else 2)


@pytest.mark.parametrize("C", [0, 3, 40])
@pytest.mark.parametrize("TM,name", [(64, "random"), (16, "ragged_m"), (32, "empty_balls")])
def test_tile_fill_writes_what_the_plain_version_gives(C, TM, name):
    xyz, feats, centers, radius, K = _case(name)
    feats = np.random.default_rng(C).normal(size=xyz.shape[:2] + (C,)).astype(np.float32) if C else None
    r2, inv_r = (np.float32(BG._f32(v)) for v in (radius * radius, 1.0 / radius))
    src = _tile_sources(xyz, centers, r2, K, TM, STAGE, "fill")
    got = _tile_fill(xyz, feats, centers, src, inv_r, TM)
    want = BG.ball_group_plain(_t(xyz), None if feats is None else _t(feats), _t(centers), radius, K)
    np.testing.assert_array_equal(got, want.numpy())


# -------------------------------------------------------------------- route
def test_route_constants_mirror_the_source():
    assert BG.MAX_SLOTS == MAX_K
    code = re.sub(r"\s+", "", SOURCE)
    assert "if(K>tile::kMaxK){if(pick==nullptr)returncudaErrorInvalidValue;returnfirst_design(" in code
    assert ("returnC+3>32?tile::launch<tile::kFill,tile::kWideRows>(a,B,stream):"
            "tile::launch<tile::kFill,tile::kNarrowRows>(a,B,stream);") in code
    assert "returntile::launch<tile::kSources,tile::kNarrowRows>(a,B,stream);" in code
    assert "||K>tile::kMaxK)returncudaErrorInvalidValue;" in code  # the pick pass refuses


@pytest.mark.parametrize("K,C,want", [
    (64, 0, 32),    # sunrgbd_quick's pre-encoder; the masked one at 40 000 points
    (32, 256, 16),  # the masked interim SA: rows wider than a warp
    (64, 3, 32),
    (64, 29, 32),
    (64, 30, 16),
    (1, 0, 32),
    (256, 0, 32),   # the most slots the design keeps
    (257, 0, 0),    # more: the first design
    (1024, 16, 0),
])
def test_route_depends_on_the_shape_alone(K, C, want, monkeypatch):
    assert _route(K, C) == want
    # the wrapper hands the source a pick scratch exactly where the route
    # takes the first design, whatever the scene holds
    rng = np.random.default_rng(K + C)
    xyz = rng.uniform(-1, 1, size=(1, 12, 3)).astype(np.float32)
    feats = rng.normal(size=(1, 12, C)).astype(np.float32) if C else None
    card = _FakeCard(monkeypatch)
    got = BG.ball_group(_t(xyz), None if feats is None else _t(feats), _t(xyz[:, :3]), 0.5, K)
    (entry, args), = card.entries
    assert entry == "ov3_ball_group" and (args[10] is None) == (want > 0)
    want_out = BG.ball_group_plain(_t(xyz), None if feats is None else _t(feats), _t(xyz[:, :3]),
                                   0.5, K)
    np.testing.assert_array_equal(got.numpy(), want_out.numpy())


# ------------------------------------------------------ the wrappers' glue
class _FakeCard:
    """Stands in for the card: the wrappers take their CUDA branch on CPU
    tensors, and each launch runs the numpy emulation of its kernel with the
    arguments the wrapper passes."""

    def __init__(self, monkeypatch):
        self.entries = []
        monkeypatch.setattr(BG, "_on_cuda", lambda *a, **k: True)
        monkeypatch.setattr(BG, "_launch", self.launch)

    def launch(self, entry, device, *args):
        self.entries.append((entry, args))
        if entry == "ov3_ball_group_sources":
            xyz, centers, B, N, M, K, r2, src = args
            if K > MAX_K:  # the source refuses it; `_build.check` raises
                raise RuntimeError(f"{entry} kernel failed: {K} slots, at most {MAX_K}")
            src.copy_(_t(_tile_sources(xyz.numpy(), centers.numpy(), np.float32(r2), K, NARROW,
                                       STAGE, "sources")))
            return
        xyz, feats, centers, B, N, M, K, C, r2, inv_r, pick, out = args
        TM = _route(K, C) if entry == "ov3_ball_group" else 0
        if not TM and pick is None:  # the first design needs its scratch
            raise RuntimeError(f"{entry} kernel failed: no pick scratch")
        TM = TM or 64  # the first design has no tile: the same function
        f = None if feats is None else feats.numpy()
        src = _tile_sources(xyz.numpy(), centers.numpy(), np.float32(r2), K, TM, STAGE, "fill")
        out.copy_(_t(_tile_fill(xyz.numpy(), f, centers.numpy(), src, np.float32(inv_r), TM)))


@pytest.mark.parametrize("K,impl,entry", [(8, None, "ov3_ball_group"),
                                          (8, "first", "ov3_ball_group_first"),
                                          (MAX_K + 1, None, "ov3_ball_group")])
def test_ball_group_launches_the_route_and_counts(K, impl, entry, monkeypatch):
    xyz, feats, centers, radius, _ = _case("ragged_m")
    card = _FakeCard(monkeypatch)
    before = BG.ball_group.launches
    got = BG.ball_group(_t(xyz), _t(feats), _t(centers), radius, K, _impl=impl)
    assert [e for e, _ in card.entries] == [entry] and BG.ball_group.launches == before + 1
    args = card.entries[0][1]
    assert args[8:10] == (BG._f32(radius * radius), BG._f32(1.0 / radius))
    if impl is None and K <= MAX_K:
        assert args[10] is None  # the tile design keeps its picks in shared memory
    else:  # the first design, asked for or routed to, gets its pick scratch
        assert args[10].shape == (2, K, centers.shape[1]) and args[10].dtype == torch.int32
    want = BG.ball_group_plain(_t(xyz), _t(feats), _t(centers), radius, K)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_slot_sources_launches_once_and_refuses_too_many_slots(monkeypatch):
    xyz, _, centers, radius, K = _case("empty_balls")
    card = _FakeCard(monkeypatch)
    before = BG.slot_sources.launches
    got = BG.slot_sources(_t(xyz), _t(centers), radius, K)
    assert [e for e, _ in card.entries] == ["ov3_ball_group_sources"]
    assert BG.slot_sources.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (2, K, centers.shape[1])
    np.testing.assert_array_equal(got.numpy(), _jax_eff_pick(xyz, centers, radius, K))
    with pytest.raises(RuntimeError, match="slots"):
        BG.slot_sources(_t(xyz), _t(centers), radius, MAX_K + 1)
    assert BG.slot_sources.launches == before + 1


@pytest.mark.parametrize("name", ["random", "empty_balls", "past_n"])
def test_feature_grad_through_the_launch_glue_matches_pallas_vjp(name, monkeypatch):
    xyz, feats, centers, radius, K = _case(name)
    g = np.random.default_rng(5).normal(size=(xyz.shape[0], K, centers.shape[1],
                                              3 + feats.shape[-1])).astype(np.float32)
    _, vjp = jax.vjp(lambda f: ball_group_pallas(jnp.asarray(xyz), f, jnp.asarray(centers),
                                                 radius, K, True, True), jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g))
    _FakeCard(monkeypatch)
    before = BG.slot_sources.launches
    tf = _t(feats).requires_grad_()
    out = pointcloud.ball_group(_t(xyz), tf, _t(centers), radius, K)
    out.backward(_t(g))
    assert BG.slot_sources.launches == before + 1
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_scatter_offsets_each_scene_and_drops_empty_balls():
    # B 2, K 2, M 2, N 3, C 1: scene 1's picks land N rows further down
    src = torch.tensor([[[0, 2], [-1, 2]], [[1, -1], [1, 0]]], dtype=torch.int32)
    g = torch.arange(2 * 2 * 2 * 4, dtype=torch.float32).view(2, 2, 2, 4)  # feature = channel 3
    got = BG._scatter(src, g, 3, 1)
    want = torch.zeros(2, 3, 1)
    for b, k, m in np.ndindex(2, 2, 2):
        if src[b, k, m] >= 0:
            want[b, src[b, k, m], 0] += g[b, k, m, 3]
    assert torch.equal(got, want)
    assert got[0, 1, 0] == 0 and got[1, 2, 0] == 0


def test_cuda_choices_are_refused_on_the_cpu():
    xyz, feats, centers, radius, K = _case("random")
    with pytest.raises(ValueError):
        BG.ball_group(_t(xyz), _t(feats), _t(centers), radius, K, _impl="first")
    with pytest.raises(ValueError):
        BG.ball_group(_t(xyz), None, _t(centers), radius, K, _impl="mma")
    before = BG.slot_sources.launches
    np.testing.assert_array_equal(BG.slot_sources(_t(xyz), _t(centers), radius, K).numpy(),
                                  BG.slot_sources_plain(_t(xyz), _t(centers), radius, K).numpy())
    assert BG.slot_sources.launches == before
