"""The port's kernel modules on the CPU: each plain version against the
JAX package's Pallas kernel in interpret mode, and each wrapper's CPU
dispatch.  The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.ops.pallas.attention_kernel import fused_attention
from ov3det.ops.pallas.ball_group_kernel import ball_group_pallas
from ov3det.ops.pallas.fps_kernel import furthest_point_sample_pallas
from ov3det_torch.ops import pointcloud
from ov3det_torch.ops.kernels import attention, ball_group, fps


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cloud(rng, B, N, lo=-2.0, hi=2.0):
    return rng.uniform(lo, hi, size=(B, N, 3)).astype(np.float32)


# ---------------------------------------------------------------- FPS
def _fps_cases():
    rng = np.random.default_rng(0)
    plain = _cloud(rng, 2, 2048)
    dup = _cloud(rng, 2, 1000)
    dup = np.concatenate([dup, dup, dup[:, :48]], axis=1)  # every point twice: ties
    grid = np.stack(np.meshgrid(*[np.arange(8.0)] * 3, indexing="ij"), -1)
    lattice = grid.reshape(1, 512, 3).astype(np.float32)  # equidistant ties everywhere
    return {"random": (plain, 256), "duplicates": (dup, 128), "lattice": (lattice, 64)}


@pytest.mark.parametrize("case", ["random", "duplicates", "lattice"])
def test_fps_plain_equals_pallas_exactly(case):
    xyz, k = _fps_cases()[case]
    want = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), k, interpret=True))
    got = fps.fps_plain(torch.from_numpy(xyz), k)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)  # exact, ties included


def test_fps_wrapper_takes_plain_version_on_cpu_without_counting():
    xyz = torch.from_numpy(_cloud(np.random.default_rng(1), 2, 300))
    before = fps.fps.launches
    np.testing.assert_array_equal(pointcloud.furthest_point_sample(xyz, 32).numpy(),
                                  fps.fps_plain(xyz, 32).numpy())
    assert fps.fps.launches == before
    with pytest.raises(TypeError):
        fps.fps(xyz.double(), 32)
    with pytest.raises(ValueError):
        fps.fps(xyz[..., :2], 32)


# ---------------------------------------------------------- ball-group
def _ball_group_case(name):
    rng = np.random.default_rng(7)
    radius, K = 0.3, 16
    xyz = _cloud(rng, 2, 2048, -1.0, 1.0)
    feats = None
    if name == "c3":
        feats = rng.normal(size=(2, 2048, 3)).astype(np.float32)
    if name == "ragged_n":
        xyz = xyz[:, :2000 + 3]  # N not a multiple of K
    centers = xyz[:, rng.choice(xyz.shape[1], 128, replace=False)].copy()
    if name == "far_centers":
        centers[:, ::3] += 10.0  # a third of the balls are empty
    if name == "boundary":
        radius = 0.5  # r^2 = 0.25 exactly in f32
        centers[:, 0] = 0.0
        ring = np.array([[0.5, 0, 0], [0, -0.5, 0], [0.3, 0.4, 0], [0, 0.3, -0.4],
                         [0.4999999, 0, 0], [0.2, 0.2, 0.2]], np.float32)
        xyz = xyz.copy()
        xyz[:, :: xyz.shape[1] // K][:, : len(ring)] = ring  # one per bucket
        xyz[np.abs(xyz).max(-1) < 0.6] += 3.0  # nothing else near the origin
        xyz[:, :: xyz.shape[1] // K][:, : len(ring)] = ring
    return xyz, feats, centers, radius, K


@pytest.mark.parametrize("name", ["c0", "c3", "ragged_n", "far_centers", "boundary"])
def test_ball_group_plain_equals_pallas_exactly(name, monkeypatch):
    xyz, feats, centers, radius, K = _ball_group_case(name)
    want = np.asarray(ball_group_pallas(
        jnp.asarray(xyz), None if feats is None else jnp.asarray(feats),
        jnp.asarray(centers), radius, K, True, True))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = ball_group.ball_group_plain(t(xyz), t(feats), t(centers), radius, K)
    assert got.shape == want.shape == (2, K, 128, 3 + (0 if feats is None else 3))
    np.testing.assert_array_equal(got.numpy(), want)  # atol 0
    if name == "far_centers":
        assert (got[:, :, ::3] == 0).all()  # empty balls: zeros
    if name == "boundary":
        # center 0 sits at the origin with one ring point per bucket and
        # nothing else near it: its hits are the ring points with
        # (dx*dx + dy*dy) + dz*dz < f32(r^2), the point at exactly r excluded
        ring = xyz[0, :: xyz.shape[1] // K][:6]
        d = -ring
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        assert d2[0] == np.float32(0.25)
        _, has = ball_group.bucket_picks(t(xyz), t(centers), radius, K)
        assert has[:, 0].sum(-1).tolist() == [int((d2 < np.float32(0.25)).sum())] * 2
    before = ball_group.ball_group.launches
    via_wrapper = pointcloud.ball_group(t(xyz), t(feats), t(centers), radius, K)
    np.testing.assert_array_equal(via_wrapper.numpy(), want)
    assert ball_group.ball_group.launches == before


def test_ball_group_wrapper_rejects_bad_input():
    x = torch.zeros(2, 64, 3)
    with pytest.raises(TypeError):
        ball_group.ball_group(x.double(), None, x[:, :8].double(), 0.2, 4)
    with pytest.raises(ValueError):
        ball_group.ball_group(x, None, x[:1, :8], 0.2, 4)


# ---------------------------------------------------------- attention
def _qkv(seed, B=2, H=2, N=256, D=32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, N, H, D)).astype(np.float32) for _ in range(3)]


def _heads(a):  # (B, N, H, D) -> (B*H, N, D)
    B, N, H, D = a.shape
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(B * H, N, D)))


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-4), ("bfloat16", 2e-2)])
def test_attention_plain_matches_pallas(dtype, atol):
    q, k, v = _qkv(3)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = fused_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    B, N, H, D = q.shape
    td = getattr(torch, dtype)
    out, lse = attention.attention_fwd_plain(*(_heads(a).to(td) for a in (q, k, v)))
    assert out.dtype == td and lse.dtype == torch.float32 and lse.shape == (B * H, N, 1)
    got = out.float().numpy().reshape(B, H, N, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_attention_plain_lse_is_logsumexp_of_f32_scores():
    q, k, v = _qkv(4)
    qh, kh, vh = (_heads(a) for a in (q, k, v))
    _, lse = attention.attention_fwd_plain(qh, kh, vh)
    s = np.einsum("bqd,bkd->bqk", qh.double().numpy(), kh.double().numpy()) / np.sqrt(32)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse[..., 0].numpy(), want, atol=1e-5, rtol=0)
    before = attention.attention_fwd.launches
    out2, lse2 = attention.attention_fwd(qh, kh, vh)  # CPU: the plain version
    np.testing.assert_array_equal(lse2.numpy(), lse.numpy())
    assert attention.attention_fwd.launches == before
    with pytest.raises(TypeError):
        attention.attention_fwd(qh.half(), kh.half(), vh.half())


def test_gather_points_matches_jax():
    from ov3det.ops import gather_points as jax_gather

    rng = np.random.default_rng(5)
    pts = rng.normal(size=(2, 100, 4)).astype(np.float32)
    inds = rng.integers(0, 100, size=(2, 17))
    want = np.asarray(jax_gather(jnp.asarray(pts), jnp.asarray(inds, jnp.int32)))
    got = pointcloud.gather_points(torch.from_numpy(pts), torch.from_numpy(inds))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------- attention dropout, backward
@pytest.mark.parametrize("seed", [0, 7, -5, 2 ** 31 - 1, -2 ** 31])
def test_drop_mask_equals_pallas_hash_exactly(seed):
    from ov3det.ops.pallas.attention_kernel import _drop_mask

    BH, tq, nq, nk, rate = 3, 64, 192, 320, 0.1
    keep_scale, threshold = attention.dropout_params(rate)
    want = np.stack([np.concatenate([np.asarray(_drop_mask(
        seed, bh, qi, tq, nk, keep_scale, jnp.uint32(threshold))) for qi in range(nq // tq)])
        for bh in range(BH)])
    got = attention.drop_mask(torch.tensor([seed], dtype=torch.int32), BH, nq, nk, rate)
    np.testing.assert_array_equal(got.numpy(), want)  # bit for bit
    assert abs(float((want == 0).mean()) - rate) < 0.01


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_forward_and_backward_match_pallas_vjp(rate):
    q, k, v = _qkv(8)
    g = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    B, N, H, D = q.shape
    seed = 1234

    def fn(q, k, v):
        return fused_attention(q, k, v, dropout_rate=rate, dropout_seed=seed, interpret=True)

    want, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (_heads(a).requires_grad_() for a in (q, k, v))
    out = attention.fused_attention(tq, tk, tv, rate,
                                    torch.tensor([seed], dtype=torch.int32) if rate else None)
    out.backward(_heads(g))

    def back(t):  # (B*H, N, D) -> (B, N, H, D)
        return t.detach().numpy().reshape(B, H, N, D).transpose(0, 2, 1, 3)

    np.testing.assert_allclose(back(out), np.asarray(want), rtol=0, atol=1e-5)
    for t, w in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(back(t.grad), np.asarray(w), rtol=0, atol=1e-5)


def test_backward_wrappers_take_plain_versions_on_cpu_without_counting():
    q, k, v = (_heads(a) for a in _qkv(10))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    seed = torch.tensor([3], dtype=torch.int32)
    out, lse = attention.attention_fwd(q, k, v, 0.1, seed)
    delta = (do * out).sum(-1, keepdim=True)
    before = (attention.attention_fwd.launches, attention.attention_dq.launches,
              attention.attention_dkv.launches)
    dq = attention.attention_dq(q, k, v, do, lse, delta, 0.1, seed)
    dk, dv = attention.attention_dkv(q, k, v, do, lse, delta, 0.1, seed)
    np.testing.assert_array_equal(dq.numpy(), attention.attention_dq_plain(
        q, k, v, do, lse, delta, 0.1, seed).numpy())
    for a, b in zip((dk, dv), attention.attention_dkv_plain(q, k, v, do, lse, delta, 0.1, seed)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (attention.attention_fwd.launches, attention.attention_dq.launches,
            attention.attention_dkv.launches) == before
    with pytest.raises(TypeError):
        attention.attention_dq(q, k, v, do.bfloat16(), lse, delta)
    with pytest.raises(ValueError):
        attention.attention_dkv(q, k, v, do[:, :64], lse, delta)
    with pytest.raises(ValueError):
        attention.fused_attention(q, k, v, 0.1, None)
