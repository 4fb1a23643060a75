"""What the cluster design of furthest-point sampling (csrc/fps.cu) relies
on, checked on the CPU: the integer argmax, the independence of the result
from how the points are dealt to CTAs, warps and threads, the kernel's own
slot, owner and parity arithmetic with one CTA running ahead, and the route
by N.  The kernel itself runs only on the card, where chip_smoke.py holds its
indices against the plain version's and the first design's.

Everything here is exact: indices are compared with `assert_array_equal`.
"""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.ops.pallas.fps_kernel import furthest_point_sample_pallas
from ov3det_torch.ops.kernels import fps

SOURCE = Path(fps.__file__).resolve().parents[2] / "csrc" / "fps.cu"
NONE = np.uint64(0xFFFFFFFF)  # the index of a candidate that holds no point
THREADS, WARP = fps.CLUSTER_THREADS, 32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ------------------------------------------------------- the integer argmax
def _packed_key(values: np.ndarray, index: np.ndarray) -> np.ndarray:
    """(bits(d2) << 32) | ~index: for d2 >= 0 the f32 bits order as an
    unsigned integer, so the largest key is the largest d2 and, among equal
    ones, the lowest index.  The kernel takes it in two steps (redux max on
    the bits, redux min on the index among the lanes that hold the maximum),
    which is the same order."""
    bits = np.ascontiguousarray(values, np.float32).view(np.uint32).astype(np.uint64)
    return (bits << np.uint64(32)) | (NONE - index.astype(np.uint64))


def _key_cases():
    rng = np.random.default_rng(3)
    spread = rng.uniform(0, 5, size=4096).astype(np.float32)
    ties = np.round(rng.uniform(0, 3, size=4096)).astype(np.float32)  # four values, many ties
    zeros = np.zeros(257, np.float32)
    start = np.full(1000, 1e10, np.float32)  # the first step: every point at the initial value
    start[17] = 0.0
    tiny = np.array([0.0, 1e-45, 1e-38, 1e-45, 0.0, 1e-38], np.float32)  # denormals order as well
    late = np.concatenate([spread, [np.float32(7.0), np.float32(7.0)]]).astype(np.float32)
    return {"spread": spread, "ties": ties, "zeros": zeros, "initial": start, "tiny": tiny,
            "late_tie": late}


@pytest.mark.parametrize("case", ["spread", "ties", "zeros", "initial", "tiny", "late_tie"])
def test_packed_key_maximum_is_the_first_argmax(case):
    v = _key_cases()[case]
    key = _packed_key(v, np.arange(len(v)))
    got = int(NONE - (key.max() & NONE))
    assert got == int(torch.argmax(torch.from_numpy(v)))  # torch: the first maximum
    assert got == int(np.argmax(v))
    # in any order of the candidates: the key carries the tie-break itself
    perm = np.random.default_rng(5).permutation(len(v))
    assert int(NONE - (_packed_key(v[perm], perm).max() & NONE)) == got


# ------------------------------------------- slices, local winners, combined
def _dealing(N: int, C: int, how: str) -> np.ndarray:
    """(slots, C, THREADS) point indices as the design deals them, padding
    marked N: "strided" is the kernel's (point (j C + r) 256 + t to CTA r,
    thread t, slot j), "contiguous" gives CTA r one run of the cloud."""
    slots = -(-N // (C * THREADS))
    j, r, t = np.meshgrid(np.arange(slots), np.arange(C), np.arange(THREADS), indexing="ij")
    index = (j * C + r) * THREADS + t if how == "strided" else (r * slots + j) * THREADS + t
    return np.where(index < N, index, N)


def _fps_in_slices(xyz: np.ndarray, K: int, C: int, how: str) -> np.ndarray:
    """Exact FPS of one (N, 3) f32 cloud with the argmax taken as the kernel
    takes it: a thread over its slots, a warp over its 32 threads, then every
    CTA over the C x 8 warp candidates of the cluster.  Padding holds -1."""
    N = len(xyz)
    deal = _dealing(N, C, how)
    padded = np.concatenate([xyz, np.zeros((1, 3), np.float32)])
    x, y, z = (padded[deal, a] for a in range(3))
    mind2 = np.where(deal < N, np.float32(1e10), np.float32(-1.0))
    index = np.where(deal < N, deal, int(NONE)).astype(np.uint64)
    out = np.zeros(K, np.int64)
    last = xyz[0]
    for k in range(1, K):
        dx, dy, dz = x - last[0], y - last[1], z - last[2]
        d2 = (dx * dx + dy * dy) + dz * dz  # f32, one rounding an operation, in this order
        mind2 = np.minimum(mind2, d2)
        key = _packed_key(np.maximum(mind2, np.float32(0.0)), index)
        thread = key.max(axis=0)                                          # (C, THREADS)
        warp = thread.reshape(C, THREADS // WARP, WARP).max(axis=2)       # (C, 8)
        best = int(NONE - (warp.max() & NONE))                            # every CTA alike
        assert best < N
        out[k] = best
        last = xyz[best]
    return out


def _fps_as_the_kernel(xyz: np.ndarray, K: int, C: int, buffers: int = 2) -> np.ndarray:
    """One scene as `fps_cluster_kernel` runs it on a cluster of C CTAs, with
    the kernel's own index arithmetic: CTA r keeps point (j C + r) 256 + t in
    slot j of thread t and a copy at pts[j 256 + t]; a warp's candidate
    (bits, index) goes with the point read from pts at
    ((index / 256) >> log2 C) 256 + index % 256 into slot r 8 + warp of every
    CTA, in the buffer of the step's parity; a CTA reduces the C x 8 keys
    and takes the winner's point from the slot
    ((index / 256) & (C - 1)) 8 + (index % 256) / 32.  CTA 0 runs ahead as
    far as the design lets it: it sends its candidates of step k + 1 before
    the others have read step k.  `buffers=1` drops the double buffer."""
    N, T, W = len(xyz), THREADS, THREADS // WARP
    log2c = C.bit_length() - 1
    P = -(-N // (C * T))
    none = np.uint32(0xFFFFFFFF)
    j, t = np.meshgrid(np.arange(P), np.arange(T), indexing="ij")
    own, pts, mind2 = [], [], []
    for r in range(C):
        index = (r * T + t) + j * (C * T)  # first + j * stride
        have = index < N
        own.append(index.astype(np.uint32))
        pts.append(np.where(have[..., None], xyz[np.where(have, index, 0)], np.float32(0.0))
                   .reshape(P * T, 3))  # pts[j T + t]
        mind2.append(np.where(have, np.float32(1e10), np.float32(-1.0)))
    keys = np.zeros((C, 2, C * W, 2), np.uint32)  # [receiving CTA][parity][slot] = (bits, index)
    coords = np.zeros((C, 2, C * W, 3), np.float32)
    last = [xyz[0].copy() for _ in range(C)]
    out = np.zeros(K, np.int64)

    def send(r: int, k: int) -> None:
        x, y, z = (pts[r][:, a].reshape(P, T) for a in range(3))  # the registers hold the same
        dx, dy, dz = x - last[r][0], y - last[r][1], z - last[r][2]
        mind2[r] = np.minimum(mind2[r], (dx * dx + dy * dy) + dz * dz)
        vj = mind2[r].argmax(axis=0)  # the first maximum: the lower slot keeps ties
        v = mind2[r][vj, np.arange(T)]
        bits = np.maximum(v, np.float32(0.0)).view(np.uint32).reshape(W, WARP)
        index = np.where(v >= 0, own[r][vj, np.arange(T)], none).reshape(W, WARP)
        wbits = bits.max(axis=1)
        windex = np.where(bits == wbits[:, None], index, none).min(axis=1)
        for w in range(W):
            wi = int(windex[w])
            c = pts[r][((wi // T) >> log2c) * T + wi % T] if windex[w] != none else np.zeros(3, np.float32)
            keys[:, k % buffers, r * W + w] = (wbits[w], windex[w])
            coords[:, k % buffers, r * W + w] = c

    def read(r: int, k: int) -> int:
        cand = keys[r, k % buffers]
        packed = (cand[:, 0].astype(np.uint64) << np.uint64(32)) | (NONE - cand[:, 1].astype(np.uint64))
        gindex = int(NONE - (packed.max() & NONE))
        last[r] = coords[r, k % buffers, ((gindex // T) & (C - 1)) * W + (gindex % T) // 32].copy()
        return gindex

    send(0, 1)
    for k in range(1, K):
        for r in range(1, C):
            send(r, k)
        out[k] = read(0, k)
        if k + 1 < K:
            send(0, k + 1)  # before the other CTAs have read step k
        for r in range(1, C):
            assert read(r, k) == out[k], f"step {k}: CTA {r} holds another winner than CTA 0"
        assert out[k] < N
        np.testing.assert_array_equal(np.stack(last), np.broadcast_to(xyz[out[k]], (C, 3)))
    return out


def _clouds():
    rng = np.random.default_rng(0)
    cloud = lambda n: rng.uniform(-2.0, 2.0, size=(n, 3)).astype(np.float32)  # noqa: E731
    dup = cloud(1000)
    dup = np.concatenate([dup, dup, dup[:48]])  # every point twice: ties
    grid = np.stack(np.meshgrid(*[np.arange(8.0)] * 3, indexing="ij"), -1)
    lattice = grid.reshape(512, 3).astype(np.float32)  # equidistant ties everywhere
    return {"random": (cloud(2048), 256), "duplicates": (dup, 128), "lattice": (lattice, 64),
            "n20000": (cloud(20000), 48), "n20001": (cloud(20001), 48)}


@functools.lru_cache(maxsize=None)
def _want(case: str) -> tuple:
    """(plain version's indices, the Pallas kernel's or None) of a case; the
    Pallas kernel, interpreted, on the three cases of test_torch_ops.py and
    on the ragged cloud."""
    xyz, k = _clouds()[case]
    plain = fps.fps_plain(torch.from_numpy(xyz)[None], k)[0].numpy()
    pallas = None
    if case in ("random", "duplicates", "lattice", "n20001"):
        pallas = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz)[None], k, interpret=True))[0]
    return plain, pallas


@pytest.mark.parametrize("how", ["strided", "contiguous"])
@pytest.mark.parametrize("C", [1, 2, 8, 16])
@pytest.mark.parametrize("case", ["random", "duplicates", "lattice", "n20000", "n20001"])
def test_slices_with_local_winners_give_the_plain_indices(case, C, how):
    xyz, k = _clouds()[case]
    plain, pallas = _want(case)
    deal = _dealing(len(xyz), C, how)
    assert sorted(deal[deal < len(xyz)]) == list(range(len(xyz)))  # every point dealt once
    got = _fps_in_slices(xyz, k, C, how)
    np.testing.assert_array_equal(got, plain)
    if pallas is not None:
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("case", ["random", "duplicates", "lattice", "n20000", "n20001"])
def test_the_kernels_index_arithmetic_gives_the_plain_indices(case, C):
    xyz, k = _clouds()[case]
    plain, pallas = _want(case)
    got = _fps_as_the_kernel(xyz, k, C)
    np.testing.assert_array_equal(got, plain)
    if pallas is not None:
        np.testing.assert_array_equal(got, pallas)


def test_one_buffer_is_not_enough_for_a_cta_that_runs_ahead():
    xyz, k = _clouds()["random"]
    with pytest.raises(AssertionError):
        _fps_as_the_kernel(xyz, k, 4, buffers=1)


# ------------------------------------------------------------------- route
def test_route_by_n_mirrors_the_source():
    text = SOURCE.read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert consts["kClusterThreads"] == fps.CLUSTER_THREADS
    steps = ((consts["kOneCtaPoints"], 1), (consts["kFourCtaPoints"], 4))
    assert steps == fps._CLUSTER_STEPS
    assert ("return N <= kOneCtaPoints ? 1 : N <= kFourCtaPoints ? 4 : "
            f"{fps._CLUSTER_LARGEST};") in text
    # the route takes every N the first design takes
    largest = fps._CLUSTER_LARGEST * consts["kMaxSlotsPerThread"] * consts["kClusterThreads"]
    assert largest >= 64 * 1024 and "return 64 * kThreads;" in text
    assert "fps_cluster(xyz, B, N, K, cluster_size_for(N), out, stream, nullptr)" in text
    for entry in ("ov3_fps", "ov3_fps_first"):
        assert f'extern "C" int {entry}(const float* xyz' in text


@pytest.mark.parametrize("n,want", [(1, 1), (256, 1), (1024, 1), (1025, 4), (2048, 4), (4096, 4),
                                    (8192, 4), (8193, 8), (20000, 8), (40000, 8), (65536, 8)])
def test_cluster_size_depends_on_n_alone(n, want):
    assert fps.cluster_size(n) == want


@pytest.mark.parametrize("impl", ["first", "cluster"])
def test_impl_is_refused_on_cpu_tensors_and_counts_no_launch(impl):
    xyz = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, size=(2, 300, 3)).astype(np.float32))
    before = fps.fps.launches
    with pytest.raises(ValueError, match="_impl"):
        fps.fps(xyz, 16, _impl=impl)
    assert fps.fps.launches == before
    np.testing.assert_array_equal(fps.fps(xyz, 16).numpy(), fps.fps_plain(xyz, 16).numpy())
    assert fps.fps.launches == before
