"""The first-K ball query's wrapper (`ov3det_torch.ops.kernels.ball_query`)
on the CPU: CPU tensors take the plain version (nothing built, no launch
counted) and it returns JAX's `ball_query(method="first_k")` indices at
both nsample the configs use and on small balls, with N not a multiple of
32, empty and full balls; the nsample limit of the kernel is checked on both routes; and the
empty-box test's and the first-K query's modules import, and their plain
versions run, on a machine without nvcc or triton.  The r^2 boundary case,
the chunks of centers and the grouping are in `test_torch_reference_ckpt.py`."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.ops.pointcloud import ball_query as jax_ball_query
from ov3det_torch.ops.kernels import _build
from ov3det_torch.ops.kernels import ball_query as bq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


def _cloud(seed: int, N: int, M: int):
    """(xyz (2, N, 3), centers (2, M, 3)): half the centers on points, the
    rest anywhere, some far from every point."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (2, N, 3)).astype(np.float32)
    centers = np.concatenate([xyz[:, :M // 2], rng.uniform(-2, 2, (2, M - M // 2, 3))], 1)
    return xyz, centers.astype(np.float32)


@pytest.mark.parametrize("nsample,radius", [(64, 0.2), (32, 0.4), (64, 0.9), (16, 0.05)])
def test_first_k_equals_jax(nsample, radius):
    xyz, centers = _cloud(nsample + int(radius * 10), 1000 + 7, 50)
    want = np.asarray(jax_ball_query(jnp.asarray(xyz), jnp.asarray(centers), radius, nsample,
                                     method="first_k"))
    got = bq.first_k(torch.from_numpy(xyz), torch.from_numpy(centers), radius, nsample)
    assert got.dtype == torch.int64 and got.shape == (2, 50, nsample)
    np.testing.assert_array_equal(got.numpy(), want)
    hits = (want[..., 1:] != want[..., :1]).sum(-1) + 1
    empty = (want == 0).all(-1)
    assert empty.any()  # a ball far from every point
    if radius == 0.9:
        assert (hits == nsample).any()  # a full ball


def test_the_wrapper_sends_cpu_tensors_to_the_plain_version(monkeypatch):
    xyz, centers = (torch.from_numpy(a) for a in _cloud(6, 200, 10))
    calls = []
    plain = bq.first_k_plain

    def spy(*args, **kw):
        calls.append(args)
        return plain(*args, **kw)

    monkeypatch.setattr(bq, "first_k_plain", spy)
    before = bq.first_k.launches
    from ov3det_torch.ops.pointcloud import ball_query

    got = ball_query(xyz, centers, 0.3, 8)
    assert len(calls) == 1 and bq.first_k.launches == before
    assert "first_k" not in _build._loaded
    np.testing.assert_array_equal(got.numpy(), plain(xyz, centers, 0.3, 8).numpy())


@pytest.mark.parametrize("nsample", [0, bq.MAX_NSAMPLE + 1, 300])
def test_nsample_past_the_limit_raises_on_the_cpu_too(nsample):
    """The check is shared: the CPU route refuses what the kernel refuses,
    with the limit in the message, and nothing falls back."""
    xyz, centers = (torch.from_numpy(a) for a in _cloud(7, 260, 4))
    with pytest.raises(ValueError, match=str(bq.MAX_NSAMPLE)):
        bq.first_k(xyz, centers, 0.3, nsample)


def test_the_limit_itself_and_n_bound_the_sample():
    xyz, centers = (torch.from_numpy(a) for a in _cloud(8, 260, 4))
    assert bq.MAX_NSAMPLE == 128
    assert bq.first_k(xyz, centers, 0.5, bq.MAX_NSAMPLE).shape == (2, 4, bq.MAX_NSAMPLE)
    with pytest.raises(ValueError, match="N = 100"):
        bq.first_k(xyz[:, :100], centers, 0.5, 101)


_NO_TOOLCHAIN = """
import json, shutil, sys, torch
from ov3det_torch.ops.kernels import _build, ball_query, points_in_box
assert shutil.which("nvcc") is None
g = torch.Generator().manual_seed(0)
xyz = torch.rand(2, 300, 3, generator=g)
idx = ball_query.first_k(xyz, xyz[:, :20].contiguous(), 0.2, 32)
corners = torch.rand(2, 5, 8, 3, generator=g)
counts = points_in_box.points_in_box(xyz, corners)
print(json.dumps({"triton": "triton" in sys.modules, "loaded": sorted(_build._loaded),
                  "shapes": [list(idx.shape), list(counts.shape)],
                  "dtypes": [str(idx.dtype), str(counts.dtype)]}))
"""


def test_the_modules_import_and_run_plain_without_nvcc_or_triton():
    import json

    path = os.pathsep.join(p for p in os.environ.get("PATH", "").split(os.pathsep)
                           if not os.path.exists(os.path.join(p, "nvcc")))
    env = dict(os.environ, PYTHONPATH=REPO, PATH=path, CUDA_HOME=os.path.join(REPO, "no-cuda"))
    res = subprocess.run([sys.executable, "-c", _NO_TOOLCHAIN], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["loaded"] == [] and report["triton"] is False
    assert report["shapes"] == [[2, 20, 32], [2, 5]]
    assert report["dtypes"] == ["torch.int64", "torch.int32"]
