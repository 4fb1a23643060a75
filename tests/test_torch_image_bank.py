"""The port's device image bank and its yuv420 codec on the CPU against the
JAX package (`ov3det/datasets/image_bank.py`, the codec of
`ov3det/datasets/loader.py`).

- The encoder is JAX's bit for bit (single canvases, saturated colours,
  several frames a sample), and so is the row size.
- The decoder gives JAX's uint8 canvases exactly: 0 pixels differ on the
  shapes below (XLA's CPU fusion and torch agree on every rounding here).
- `build_image_bank` holds JAX's rows and geometry; `BankRefDataset` gives
  JAX's samples, `image_ref` int32 in place of the canvas.
- A banked OV step (`image_ref` + the bank) equals, bit for bit, the step
  given the host-decoded canvases of the same rows, as
  `tests/test_image_bank.py:141` holds JAX's.
- `--use_image --image_bank` trains on the CPU through the CLI (the tiny
  teacher of `tests/test_torch_ov.py`), and its checkpoint holds the
  detector and optimiser alone, never the bank.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ov3det.datasets import BankRefDataset as JBankRefDataset
from ov3det.datasets import build_image_bank as jax_build_image_bank
from ov3det.datasets.loader import _yuv420_encode, _yuv_sample_bytes
from ov3det.datasets.loader import yuv420_decode_rows as jax_decode
from ov3det.datasets.synthetic import SyntheticOVDataset as JOV
from ov3det_torch import config as tc
from ov3det_torch import main as cli
from ov3det_torch.datasets import image_bank as ib
from ov3det_torch.datasets.loader import collate
from ov3det_torch.datasets.synthetic import SyntheticOVDataset
from ov3det_torch.engine import train as T
from ov3det_torch.models import regionclip as trc
from tests import torch_parity as tp
from tests.test_torch_data import assert_same_sample
from tests.test_torch_ov import TEACHER, TINY_OV, tiny_teacher  # noqa: F401 (a fixture)


class SmallOV(SyntheticOVDataset):
    """64 x 96 canvases, as `tests/test_image_bank.py`'s."""

    IMG_H, IMG_W = 64, 96


class JSmallOV(JOV):
    IMG_H, IMG_W = 64, 96


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")


def _canvases(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    img[..., :8, :, :] = 255  # saturated rows: the clamps of both directions
    img[..., 8:16, :, 1:] = 0
    return img


@pytest.mark.parametrize("shape", [(530, 730, 3), (64, 96, 3), (3, 64, 96, 3)])
def test_encode_is_jax_bit_for_bit(shape):
    img = _canvases(1, shape)
    got, want = ib.yuv420_encode(img), _yuv420_encode(img)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert ib.yuv_sample_bytes(shape) == _yuv_sample_bytes(shape) == got.size


@pytest.mark.parametrize("shape", [(2, 530, 730, 3), (2, 3, 64, 96, 3)])
def test_decode_equals_jax(shape):
    imgs = _canvases(2, shape)
    rows = np.stack([ib.yuv420_encode(im) for im in imgs])
    got = ib.yuv420_decode_rows(torch.from_numpy(rows), shape).numpy()
    want = np.asarray(jax_decode(jnp.asarray(rows), shape))
    assert got.dtype == want.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, want)  # 0 pixels off
    # the 4:2:0 round trip is close to the canvas, not equal to it
    err = np.abs(got.astype(int) - imgs.astype(int))
    assert err.max() > 0 and np.median(err) < 64


def test_bank_and_its_refs_match_jax():
    kw = dict(size=5, seed=3, num_points=256, num_semcls=4, num_angle_bin=1)
    ds, jds = SmallOV(**kw), JSmallOV(**kw)
    bank, hw = ib.build_image_bank(ds, "cpu")
    jbank, jhw = jax_build_image_bank(jds)
    assert bank.dtype == torch.uint8 and bank.device.type == "cpu"
    np.testing.assert_array_equal(bank.numpy(), np.asarray(jbank))
    assert hw == tuple(jhw) == (64, 96)
    refs, jrefs = ib.BankRefDataset(ds), JBankRefDataset(jds)
    assert len(refs) == len(jrefs) == 5 and refs.scan_names == jrefs.scan_names
    for i in (0, 4):
        item = refs[i]
        assert "image" not in item and item["image_ref"].dtype == np.int32
        assert int(item["image_ref"]) == i
        assert_same_sample(item, jrefs[i])
    with pytest.raises(ValueError, match="chroma grid"):
        ib.build_image_bank([{"image": np.zeros((5, 8, 3), np.uint8)}], "cpu")


def test_banked_step_equals_the_host_decoded_step():
    """Two OV steps from the same weights: batches of `image_ref` with the
    bank, against batches of the canvases decoded on the host from the
    same rows; every loss and parameter equal bit for bit."""
    ds = SmallOV(size=4, seed=11, num_points=tp.N_POINTS, num_semcls=10, num_angle_bin=12)
    bank, hw = ib.build_image_bank(ds, "cpu")
    refs = ib.BankRefDataset(ds)
    banked = [collate([refs[i] for i in idx]) for idx in ((0, 1), (2, 3))]
    shipped = []
    for b in banked:
        b = dict(b)
        rows = bank[torch.from_numpy(b["image_ref"]).long()]
        b["image"] = ib.yuv420_decode_rows(rows, (2, *hw, 3)).numpy()
        del b["image_ref"]
        shipped.append(b)

    _, tm = tp.configs("float32")
    cfg = tc.TrainConfig(model=tm, loss=tc.LossConfig(alignment_2d_weight=1.0))
    teacher = trc.RegionCLIPTeacher(device="cpu", **TEACHER)
    teacher.load(trc.quantize_teacher_params(trc.init_teacher_state(teacher, seed=0), "float32",
                                             teacher=teacher))
    runs = []
    for batches, kw in ((banked, dict(image_bank=(bank, hw))), (shipped, {})):
        training = T.build_training(cfg, 10, device="cpu", seed=0, teacher=teacher, **kw)
        gen = torch.Generator().manual_seed(0)
        metrics = [training.train_step(T.batch_to_device(b, "cpu"), gen) for b in batches]
        runs.append((metrics, training.model.state_dict()))
    (m_bank, sd_bank), (m_ship, sd_ship) = runs
    for a, b in zip(m_bank, m_ship):
        assert set(a) == set(b) and a["loss_2dalignment"] > 0
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for k in sd_ship:
        assert torch.equal(sd_bank[k], sd_ship[k]), k
    with pytest.raises(ValueError, match="teacher"):
        T.build_training(cfg, 10, device="cpu", image_bank=(bank, hw))


def test_image_bank_cli_trains_and_saves_no_bank(tmp_path, tiny_teacher, capsys):
    run = str(tmp_path / "run")
    training = cli.main(TINY_OV + ["--image_bank", "--checkpoint_dir", run])
    out = capsys.readouterr().out
    bank, hw = training.image_bank
    assert hw == (530, 730) and bank.dtype == torch.uint8
    assert f"image bank: {bank.shape[0]} canvases of 530 x 730 as yuv420, {bank.numel()} bytes" in out
    assert "saved new best checkpoint" in out
    payload = torch.load(os.path.join(run, "checkpoint"), weights_only=True)
    assert set(payload["model"]) == set(training.model.state_dict())
    tensors = list(payload["model"].values()) + payload["optimizer"]["mu"]
    assert not any(t.dtype == torch.uint8 or t.shape == bank.shape for t in tensors)
    with pytest.raises(ValueError, match="--image_bank needs --use_image"):
        cli.main([a for a in TINY_OV if a != "--use_image"]
                 + ["--image_bank", "--checkpoint_dir", str(tmp_path / "other")])
    assert not os.path.exists(tmp_path / "other")
