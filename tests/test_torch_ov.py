"""The port's open-vocabulary training step on the CPU against the JAX
package: `SyntheticOVDataset`, the canvases' copy to the device, the CLIP
contrastive loss, two OV training steps of `make_train_step` with the
frozen teacher, one step with the int8 teacher, and the `--use_image` CLI.

The detector is `tests/torch_parity.py`'s small f32 config (embed 64) with
every dropout at 0; the teacher is the tiny tower of
`tests/test_torch_teacher.py` (width 16, one block a stage, pooler 6, embed
64) on 64 x 96 canvases whose camera looks along the scenes' +y axis, both
packages from JAX's init through `from_flax_teacher_variables`.

Tolerances: the f32 teacher's two steps are held as
`tests/test_torch_train.py`'s two steps are (losses 1e-4 relative on the
first step, 2e-3 on the second; the parameters after the first), and
`loss_2dalignment` within 1e-4 relative on the first step; but the BatchNorm
statistics after the second step within 2e-4, not 1e-4: the alignment
loss's gradient (weight 1, 64 regions a layer) reaches every decoder and
head parameter, so more gradient elements near zero, whose sign the f32
noise flips, move by up to 2 lr in the first step, and the second forward
runs on those parameters.  With the int8 teacher (from JAX's quantised
tree), one step's `loss_2dalignment` within 1e-3 relative (the int8
features agree to cosine >= 0.999), `grad_norm` within 1e-2 (the gradient
of 1 - cos follows the teacher's direction, which int8 turns by up to
0.045 rad) and the other losses within 1e-4.  Datasets, the teacher's rebuild and the resume: bit
for bit.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ov3det import config as jc
from ov3det.models import regionclip as jrc
from ov3det_torch import config as tc
from ov3det_torch import main as cli
from ov3det_torch.datasets.loader import collate
from ov3det_torch.engine import train as T
from ov3det_torch.engine.checkpoint import CheckpointManager
from ov3det_torch.models import regionclip as trc
from ov3det_torch.models.convert import from_flax_teacher_variables
from tests import torch_parity as tp

LR = 5e-4
IMG_H, IMG_W = 64, 96
TEACHER = dict(width=16, layers=(1, 1, 1, 1), embed_dim=64, pooler_resolution=6,
               pooler_scale=1.0 / 16.0, image_resolution=96)
# the camera of tests/test_training_race_ov.py: focal 52 px, principal point
# at the canvas centre
_K = np.array([[52.0, 0, IMG_W / 2], [0, 52.0, IMG_H / 2], [0, 0, 1]], np.float32)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")


def _t(a):
    return torch.from_numpy(np.array(a))


def ov_batch(seed: int) -> dict:
    """`tp.make_batch` plus the image fields, the scenes moved 3 m along +y
    (in front of the camera) so that the predicted boxes project into it."""
    batch = tp.make_batch(seed=seed)
    B = batch["point_clouds"].shape[0]
    shift = np.array([0.0, 3.0, 0.0], np.float32)
    for k in ("point_clouds", "gt_box_centers", "gt_box_corners", "point_cloud_dims_min",
              "point_cloud_dims_max"):
        batch[k] = batch[k].copy()
        batch[k][..., :3] += shift
    rng = np.random.default_rng(seed + 50)
    batch["image"] = rng.integers(0, 256, (B, IMG_H, IMG_W, 3), dtype=np.uint8)
    batch["image_height"] = np.full((B,), IMG_H, np.int32)
    batch["image_width"] = np.array([IMG_W, IMG_W - 16], np.int32)[:B]
    batch["calib_Rtilt"] = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    batch["calib_K"] = np.tile(_K, (B, 1, 1))
    return batch


@pytest.fixture(scope="module")
def teacher_vars():
    """The JAX tiny teacher's f32 init, numpy leaves."""
    teacher = jrc.RegionCLIPTeacher(**TEACHER)
    v = jax.jit(lambda: teacher.init(jax.random.PRNGKey(7), jnp.zeros((1, IMG_H, IMG_W, 3)),
                                     jnp.zeros((1, 1, 4))))()
    return tp.to_numpy(v)


def _configs(**loss):
    jm, tm = tp.configs("float32")
    jq = dataclasses.replace(jc.sunrgbd_quick(), loss=dataclasses.replace(
        jc.sunrgbd_quick().loss, alignment_2d_weight=1.0, **loss))
    tq = dataclasses.replace(tc.sunrgbd_quick(), loss=dataclasses.replace(
        tc.sunrgbd_quick().loss, alignment_2d_weight=1.0, **loss))
    return jq, tq, jm, tm


# ------------------------------------------------------------ data
def test_synthetic_ov_dataset_matches_jax():
    from ov3det.config import DataConfig as JDataConfig
    from ov3det.datasets import registry as jregistry
    from ov3det.datasets.synthetic import SyntheticOVDataset as JOV
    from ov3det_torch.datasets.registry import build_dataset
    from ov3det_torch.datasets.synthetic import SyntheticOVDataset
    from tests.test_torch_data import assert_same_sample

    kw = dict(size=4, seed=5, num_points=600, num_semcls=20, num_angle_bin=12)
    ours, theirs = SyntheticOVDataset(**kw), JOV(**kw)
    for i in (0, 3):
        item = ours[i]
        assert item["image"].dtype == np.uint8 and item["image"].shape == (530, 730, 3)
        assert_same_sample(item, theirs[i])
    splits = ("train", "test")
    got, _ = build_dataset(tc.DataConfig(dataset_name="synthetic", num_points=512, use_image=True),
                           splits)
    want, _ = jregistry.build_dataset(JDataConfig(dataset_name="synthetic", num_points=512,
                                                  use_image=True), splits)
    for split in splits:
        assert type(got[split]).__name__ == type(want[split]).__name__ == "SyntheticOVDataset"
        assert_same_sample(got[split][2], want[split][2])


def test_batch_to_device_keeps_canvases_uint8():
    batch = ov_batch(0)
    out = T.batch_to_device(batch, "cpu")
    assert out["image"].dtype == torch.uint8 and torch.equal(out["image"], _t(batch["image"]))
    assert out["image_height"].dtype == torch.int64 and out["calib_K"].dtype == torch.float32
    assert out["gt_box_present"].dtype == torch.float32


def test_clip_contrastive_loss_matches_jax():
    from ov3det.losses.clip_loss import clip_contrastive_loss as jax_clip
    from ov3det_torch.losses.clip_loss import clip_contrastive_loss

    rng = np.random.default_rng(3)
    pc, text = rng.normal(size=(2, 6, 16)).astype(np.float32)
    text[2] = pc[2] * 3  # one pair aligned
    want, wd = jax_clip(jnp.asarray(pc), jnp.asarray(text))
    got, gd = clip_contrastive_loss(_t(pc), _t(text))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(gd["clip_acc"].item(), float(wd["clip_acc"]), rtol=1e-6)


# ------------------------------------------------------------ the step
def test_two_ov_training_steps_match_jax(teacher_vars):
    jq, tq, jm, tm = _configs()
    teacher = trc.RegionCLIPTeacher(device="cpu", **TEACHER).load(from_flax_teacher_variables(teacher_vars))
    jfn = jrc.make_teacher_fn(jrc.RegionCLIPTeacher(**TEACHER))
    steps = tp.assert_two_steps_match(ov_batch(0), jq, tq, jm, tm, LR,
                                      teacher=(jfn, teacher_vars, teacher))
    got, want = steps[0]
    assert got["loss_2dalignment"] > 0 and "loss_2dalignment_0" in got
    for k in ("loss_2dalignment", "loss_2dalignment_0"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_ov_step_with_int8_teacher_matches_jax(teacher_vars):
    jq, tq, jm, tm = _configs()
    jm, tm = tp.zero_dropout(jm), tp.zero_dropout(tm)
    jq = dataclasses.replace(jq, model=jm, optim=dataclasses.replace(jq.optim, warm_lr_epochs=0))
    tq = dataclasses.replace(tq, model=tm, optim=dataclasses.replace(tq.optim, warm_lr_epochs=0))
    jt = jrc.RegionCLIPTeacher(compute_dtype="int8", **TEACHER)
    qvars = tp.jax_quantize_teacher(teacher_vars, jt)
    batch = ov_batch(1)

    from ov3det.engine.schedule import make_lr_schedule as jax_schedule
    from ov3det.engine.train import TrainState
    from ov3det.engine.train import build_optimizer as jax_build_optimizer
    from ov3det.engine.train import make_train_step as jax_make_train_step
    from ov3det_torch.models.convert import from_flax_variables
    from ov3det_torch.models.detr3d import Model3DETR

    model, variables = tp.jax_model_and_variables(jm, batch)
    tx = jax_build_optimizer(jq.optim, jax_schedule(jq.optim, jq.max_epoch, 100))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                       frozen=jax.tree_util.tree_map(jnp.asarray, dict(variables["frozen"],
                                                                        teacher2d=qvars)),
                       opt_state=tx.init(params))
    jstep = jax_make_train_step(model, tx, jq.loss, jm.num_angle_bin, jm.num_semcls,
                                teacher_fn=jrc.make_teacher_fn(jt))
    _, want = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    net = Model3DETR(tm, device="cpu")
    net.load_state_dict(from_flax_variables(variables))
    teacher = trc.RegionCLIPTeacher(device="cpu", compute_dtype="int8", **TEACHER)
    teacher.load(from_flax_teacher_variables(qvars))
    opt = T.build_optimizer(net, tq.optim, T.make_lr_schedule(tq.optim, tq.max_epoch, 100))
    step = T.make_train_step(net, opt, tq.loss, tm.num_angle_bin, tm.num_semcls,
                             teacher_fn=trc.make_teacher_fn(teacher))
    got = step(T.batch_to_device(batch, "cpu"), torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    for k, w in want.items():
        rtol = {"grad_norm": 1e-2}.get(k, 1e-3 if k.startswith("loss_2dalignment") or k == "loss"
                                        else 1e-4)
        np.testing.assert_allclose(got[k].item(), float(w), rtol=rtol, atol=1e-6, err_msg=k)
    assert got["loss_2dalignment"].item() > 0


# ------------------------------------------------------------ the CLI
TINY_OV = ["--dataset_name", "synthetic", "--device", "cpu", "--dataset_num_workers", "0",
           "--max_epoch", "1", "--eval_every_epoch", "1", "--batchsize_per_gpu", "8",
           "--num_points", "512", "--preenc_npoints", "128", "--enc_nlayers", "2",
           "--enc_dim", "64", "--enc_ffn_dim", "64", "--dec_nlayers", "2", "--dec_dim", "64",
           "--dec_ffn_dim", "64", "--nqueries", "32", "--mlp_dropout", "0.0",
           "--log_every", "4", "--log_metrics_every", "100", "--use_image",
           "--loss_2dalignment_weight", "1"]


@pytest.fixture
def tiny_teacher(monkeypatch):
    """The CLI's teacher at the tiny width (its default is RN50x4)."""
    tiny = {k: v for k, v in TEACHER.items() if k != "embed_dim"}
    monkeypatch.setattr(cli, "RegionCLIPTeacher",
                        functools.partial(trc.RegionCLIPTeacher, **tiny))


def test_use_image_cli_trains_and_saves_no_teacher(tmp_path, tiny_teacher, capsys):
    run = str(tmp_path / "run")
    training = cli.main(TINY_OV + ["--checkpoint_dir", run])
    out = capsys.readouterr().out
    assert "WARNING: no --region_clip_ckpt_path" in out and "saved new best checkpoint" in out
    assert training.teacher is not None and training.teacher.compute_dtype == "int8"
    import json

    with open(os.path.join(run, "scalars.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    align = [r["Train_details/loss_2dalignment"] for r in rows
             if "Train_details/loss_2dalignment" in r]
    assert len(align) == 2 and all(np.isfinite(a) and a > 0 for a in align)
    payload = torch.load(os.path.join(run, "checkpoint"), weights_only=True)
    assert set(payload["model"]) == set(training.model.state_dict())
    assert not any("teacher" in k or "backbone" in k or "roi_head" in k for k in payload["model"])
    assert len(payload["optimizer"]["mu"]) == len(list(training.model.parameters()))
    # a point-only run of the same detector writes the same keys and shapes
    cfg = cli.config_from_args(cli.make_args_parser().parse_args(
        TINY_OV + ["--checkpoint_dir", run]))
    assert cfg.teacher.enabled and cfg.data.use_image and cfg.loss.alignment_2d_weight == 1
    ref = T.build_training(cfg, 8, device="cpu").model.state_dict()
    assert {k: tuple(v.shape) for k, v in payload["model"].items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}


def test_ov_resume_rebuilds_the_teacher_bit_for_bit(tmp_path, tiny_teacher):
    """Three OV steps uninterrupted against two, a save, then a fresh
    detector, optimiser and teacher (rebuilt by `build_teacher` from its
    seed and a recalibration on the same canvas) restored from the file,
    and the third step: losses and parameters equal bit for bit."""
    from ov3det_torch.datasets.synthetic import SyntheticOVDataset

    args = TINY_OV + ["--checkpoint_dir", str(tmp_path), "--mlp_dropout", "0.3"]
    cfg = cli.config_from_args(cli.make_args_parser().parse_args(args))
    ds = SyntheticOVDataset(size=6, seed=1, num_points=512, num_semcls=18, num_angle_bin=1)
    batches = [T.batch_to_device(collate([ds[2 * i], ds[2 * i + 1]]), "cpu") for i in range(3)]

    def build(seed):
        teacher = cli.build_teacher(cfg, ds[0], "cpu")
        return T.build_training(cfg, 10, device="cpu", seed=seed, teacher=teacher)

    def steps(training, which):
        gen = torch.Generator()
        for i in which:
            gen.manual_seed(cli.step_seed(cfg.seed, i))
            metrics = training.train_step(batches[i], gen)
        return metrics

    a = build(0)
    want = steps(a, range(3))
    b = build(0)
    steps(b, range(2))
    CheckpointManager(str(tmp_path)).save_latest(b.model, b.optimizer, 0)
    c = build(7)
    for k, v in b.teacher.state_dict().items():
        assert torch.equal(c.teacher.state_dict()[k], v), k
    CheckpointManager(str(tmp_path)).restore(c.model, c.optimizer)
    got = steps(c, [2])
    assert set(got) == set(want) and got["loss_2dalignment"].item() > 0
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k, v in a.model.state_dict().items():
        assert torch.equal(c.model.state_dict()[k], v), k


def test_teacher_runs_on_the_card_unless_asked(tiny_teacher):
    """`RegionCLIPTeacher` and `build_teacher` default to CUDA, as the
    detector and `build_training` do, and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = cli.config_from_args(cli.make_args_parser().parse_args(
        TINY_OV + ["--checkpoint_dir", "unused"]))
    example = {k: v[0] for k, v in ov_batch(2).items()}
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            trc.RegionCLIPTeacher(device=device, **TEACHER)
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.build_teacher(cfg, example, device)
    teacher = trc.RegionCLIPTeacher(device="cpu", **TEACHER)
    assert {b.device.type for b in teacher.buffers()} == {"cpu"}
    # the CLIP normalisation is held on the teacher's device, not a weight
    assert "pixel_mean" not in teacher.state_dict() and "inv_std" not in teacher.state_dict()


def test_build_teacher_converts_the_region_clip_checkpoint(tmp_path, tiny_teacher):
    """`--region_clip_ckpt_path`: the teacher is the converted checkpoint,
    quantised and calibrated on the example canvas."""
    from tests.ref_oracle import CLIPModifiedResNet

    torch.manual_seed(5)
    # the CLI's teacher embeds into the detector's clip_embed_dim, 640
    net = CLIPModifiedResNet(layers=(1, 1, 1, 1), output_dim=640, width=16, image_resolution=96)
    path = str(tmp_path / "regionclip.pth")
    torch.save({"model": {f"backbone.visual.{k}": v for k, v in net.state_dict().items()}}, path)
    example = ov_batch(2)
    example = {k: v[0] for k, v in example.items()}
    for dtype in ("int8", "float32"):
        cfg = cli.config_from_args(cli.make_args_parser().parse_args(
            TINY_OV + ["--checkpoint_dir", str(tmp_path), "--region_clip_ckpt_path", path,
                       "--teacher_compute_dtype", dtype]))
        teacher = cli.build_teacher(cfg, example, "cpu")
        state = trc.convert_torch_checkpoint(path, layers=(1, 1, 1, 1))
        if dtype == "int8":
            calib = (example["image"][None].astype(np.float32),
                     trc.calibration_boxes(np.random.default_rng(0), IMG_H, IMG_W))
            state = trc.quantize_teacher_params(state, "int8", teacher=teacher, calib=calib)
        got = teacher.state_dict()
        assert set(got) == set(state)
        for k, v in state.items():
            assert torch.equal(got[k], v), k
