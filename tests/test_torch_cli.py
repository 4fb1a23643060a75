"""The port's training CLI (`python -m ov3det_torch.main`) on the CPU: the
slice as a whole.

- `evaluate` of both packages over the synthetic test split at batch 6 (16
  scenes: a padded tail of 4) gives every AP and recall within 1e-4
  absolute and the same number of detections per scan, once from the same
  weights and once from one stub step whose outputs lie near the GT boxes
  (nonzero APs); no objectness lies within 1e-5 of the confidence threshold
  0.05, so the f32 noise between the two forwards (about 1e-6) decides no
  detection;
- the tiny CLI run of `tests/test_main_loop.py` through the port with
  `--device cpu`: checkpoints, `final_eval.txt`, the `Test_details/` keys,
  the idempotent re-run, and `--test_only` on `checkpoint_best` printing the
  AP table of the epoch that saved it, digit for digit;
- `CheckpointManager` round trips and `best_ap25` across `write_extra`;
- resume parity: 2 steps, save, restore into a fresh model and optimiser,
  and the third step's losses and parameters equal the uninterrupted run's
  bit for bit;
- the flags of every run script exist in the port's parser, each flag the
  port refuses raises `NotImplementedError` naming its ROADMAP item, and
  the open-vocabulary flags set the config as JAX's parser does.
"""
import dataclasses
import glob
import json
import os
import re

import numpy as np
import pytest
import torch

from ov3det_torch import main as cli
from ov3det_torch.datasets.loader import DataLoader
from ov3det_torch.datasets.synthetic import SyntheticDataset, make_batch
from ov3det_torch.engine.checkpoint import CheckpointManager, restore_eval_checkpoint
from ov3det_torch.engine.train import batch_to_device, build_training
from tests import torch_parity as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the run of tests/test_main_loop.py:12-67, with the port's pre-encoder MLP
# left at its default (the CLI has no flag for it)
TINY = ["--dataset_name", "synthetic", "--device", "cpu", "--dataset_num_workers", "0",
        "--max_epoch", "2", "--eval_every_epoch", "1", "--batchsize_per_gpu", "4",
        "--num_points", "512", "--preenc_npoints", "128", "--enc_nlayers", "2", "--enc_dim", "64",
        "--enc_ffn_dim", "64", "--dec_nlayers", "2", "--dec_dim", "64", "--dec_ffn_dim", "64",
        "--nqueries", "32", "--mlp_dropout", "0.0", "--loss_giou_weight", "1",
        "--log_every", "5", "--log_metrics_every", "10", "--eval_loss"]


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")


def tiny_cfg(*extra):
    return cli.config_from_args(cli.make_args_parser().parse_args(TINY + list(extra)))


# ------------------------------------------------------------ evaluate against JAX
def _stub_steps():
    """Eval steps for both packages that ignore the model: the i-th call
    returns outputs near its batch's GT boxes from generator i, so that the
    APs are not all 0."""
    import jax.numpy as jnp

    from tests.test_torch_eval import detections_near_gt

    def outputs(batch, calls):
        host = {k: np.asarray(v) for k, v in batch.items()}
        calls.append(None)
        return detections_near_gt(host, np.random.default_rng(100 + len(calls)), 18, 1, Q=64)

    jcalls, tcalls = [], []
    jax_step = lambda state, b: {k: jnp.asarray(v) for k, v in outputs(b, jcalls).items()}  # noqa: E731
    step = lambda b: {k: torch.from_numpy(v) for k, v in outputs(b, tcalls).items()}  # noqa: E731
    return jax_step, step


@pytest.mark.parametrize("outputs", ["model", "detections"])
def test_evaluate_matches_jax(outputs):
    """`outputs="model"`: both forwards from the same weights; with random
    weights no detection hits a GT box, so the APs are 0 and the detections
    per scan carry the signal.  `outputs="detections"`: one stub step for
    both, outputs near the GT boxes, so nonzero APs go through the pad
    stripping and the batching."""
    import jax
    import jax.numpy as jnp

    from ov3det.datasets.dataset_configs import ScannetDatasetConfig as JScannet
    from ov3det.datasets.loader import DataLoader as JDataLoader
    from ov3det.datasets.synthetic import SyntheticDataset as JSynthetic
    from ov3det.engine.train import TrainState
    from ov3det.engine.train import make_eval_step as jax_make_eval_step
    from ov3det.main import evaluate as jax_evaluate
    from ov3det_torch.datasets.dataset_configs import ScannetDatasetConfig
    from ov3det_torch.engine.infer import make_eval_step
    from ov3det_torch.models.convert import from_flax_variables
    from ov3det_torch.models.detr3d import Model3DETR

    kw = dict(size=16, seed=2, num_points=1024, num_semcls=18, num_angle_bin=1)
    loader_kw = dict(batch_size=6, shuffle=False, drop_last=False)
    loader = DataLoader(SyntheticDataset(**kw), num_workers=0, **loader_kw)
    assert len(loader) == 3
    if outputs == "model":
        jm, tm = tp.configs("float32")
        jm = dataclasses.replace(jm, num_semcls=18, num_angle_bin=1)
        tm = dataclasses.replace(tm, num_semcls=18, num_angle_bin=1)
        example = make_batch(np.random.default_rng(0), batch_size=2, num_points=1024,
                             num_semcls=18, num_angle_bin=1)
        model, variables = tp.jax_model_and_variables(jm, example)
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                           batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                           frozen=jax.tree_util.tree_map(jnp.asarray, variables["frozen"]),
                           opt_state=None)
        jax_step = jax_make_eval_step(model)
        net = Model3DETR(tm, device="cpu")
        net.load_state_dict(from_flax_variables(variables))
        step = make_eval_step(net)
    else:
        state = None
        jax_step, step = _stub_steps()
    objectness = np.concatenate([step(batch_to_device(b, "cpu"))["objectness_prob"].numpy()
                                 for b in loader])
    assert np.abs(objectness - 0.05).min() > 1e-5
    if outputs == "detections":
        jax_step, step = _stub_steps()  # the calls above count
    theirs = jax_evaluate(None, jax_step, state,
                          JDataLoader(JSynthetic(**kw), num_workers=1, transfer="tree",
                                      sharding=None, **loader_kw), JScannet())
    ours = cli.evaluate(step, loader, ScannetDatasetConfig(), torch.device("cpu"))

    assert ours.scan_cnt == theirs.scan_cnt == 16  # the pad scored nowhere
    assert ([len(ours.pred_map_cls[s][0]) for s in range(16)]
            == [len(theirs.pred_map_cls[s][0]) for s in range(16)])
    got, want = ours.compute_metrics(), theirs.compute_metrics()
    for t in (0.25, 0.5):
        assert list(got[t]) == list(want[t])
        for k, w in want[t].items():
            assert abs(float(got[t][k]) - float(w)) <= 1e-4, (t, k)
    assert min(len(theirs.pred_map_cls[s][0]) for s in range(16)) > 0
    if outputs == "detections":
        assert want[0.25]["mAP"] > 0.1


# ------------------------------------------------------------ the CLI run
def _table_after(lines: list, header: str) -> list:
    """The AP table printed after the line starting with `header`."""
    i = next(i for i, line in enumerate(lines) if line.startswith(header))
    out = []
    for line in lines[i + 1:]:
        if not re.match(r"(mAP|AR)0\.|-----|IOU Thresh|.* (Average Precision|Recall): ", line):
            break
        out.append(line)
    return out


def test_tiny_cli_run_on_the_cpu(tmp_path, capsys):
    run = str(tmp_path / "run")
    cli.main(TINY + ["--checkpoint_dir", run])
    for name in ("checkpoint", "checkpoint_best", "final_eval.txt", "scalars.jsonl"):
        assert os.path.isfile(os.path.join(run, name)), name
    assert "mAP0.25" in open(os.path.join(run, "final_eval.txt")).read()
    scalars = [json.loads(line) for line in open(os.path.join(run, "scalars.jsonl"))]
    keys = {k for s in scalars for k in s}
    assert {"Test_details/loss_giou", "Test_details/loss_sem_cls", "Test/loss", "Train/lr",
            "Train/loss", "Train/batch_time", "Train/mAP_0.25", "Test/mAP_0.25"} <= keys, keys
    lines = capsys.readouterr().out.splitlines()
    assert any(line.startswith("Epoch [1/2]; Iter [30/32]; Loss ") for line in lines)
    epochs = [int(re.match(r"Evaluate Epoch \[(\d+)/2\]", line).group(1)) for line in lines
              if line.startswith("Evaluate Epoch")]
    assert epochs == [0, 1]
    # the epoch that saved checkpoint_best is the last whose eval preceded a save
    saves = [i for i, line in enumerate(lines) if line.startswith("saved new best checkpoint")]
    best_epoch = max(int(re.match(r"Evaluate Epoch \[(\d+)", lines[j]).group(1))
                     for j in range(saves[-1]) if lines[j].startswith("Evaluate Epoch"))
    want = _table_after(lines, f"Evaluate Epoch [{best_epoch}/2]")
    assert want[0].startswith("mAP0.25, mAP0.50: ") and len(want) == 2 + 2 * (2 + 2 * 18)

    # the idempotent re-run guard (reference main.py:226-231)
    cli.main(TINY + ["--checkpoint_dir", run])
    assert "Skipping training." in capsys.readouterr().out

    # --test_only reads checkpoint_best back: the same AP table
    metrics = cli.main(TINY + ["--test_only", "--test_ckpt", os.path.join(run, "checkpoint_best")])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"Test model (epoch {best_epoch}); Metrics:"
    assert _table_after(out, "Test model") == want
    assert 0.25 in metrics and "mAP" in metrics[0.25]


def test_profile_and_debug_nans_flags(tmp_path):
    prof = tmp_path / "prof"
    cli.main(["--dataset_name", "synthetic", "--device", "cpu", "--dataset_num_workers", "0",
              "--checkpoint_dir", str(tmp_path / "run"), "--max_epoch", "1",
              "--eval_every_epoch", "5", "--batchsize_per_gpu", "8", "--num_points", "256",
              "--preenc_npoints", "64", "--enc_nlayers", "1", "--enc_dim", "32",
              "--enc_ffn_dim", "32", "--dec_nlayers", "1", "--dec_dim", "32",
              "--dec_ffn_dim", "32", "--nqueries", "16", "--mlp_dropout", "0.0",
              "--profile_dir", str(prof), "--profile_steps", "2", "--debug_nans"])
    assert glob.glob(str(prof / "trace-*.json"))
    assert not torch.is_anomaly_enabled()  # set for the run only


# ------------------------------------------------------------ checkpoints
def test_checkpoint_roundtrip(tmp_path):
    cfg = tiny_cfg()
    a = build_training(cfg, 10, device="cpu", seed=0)
    batch = batch_to_device(make_batch(np.random.default_rng(0), batch_size=2, num_points=512), "cpu")
    a.train_step(batch, torch.Generator().manual_seed(0))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save_latest(a.model, a.optimizer, epoch=3)
    assert not [f for f in os.listdir(tmp_path / "ckpt") if f.startswith(".")]  # no temporary left
    b = build_training(cfg, 10, device="cpu", seed=1)
    payload, epoch, extra = mgr.restore(b.model, b.optimizer)
    assert epoch == 3 and extra is None and set(payload) == {"model", "optimizer", "epoch"}
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    assert b.optimizer.count == a.optimizer.count == 1
    assert all(torch.equal(x, y) for x, y in zip(b.optimizer.nu, a.optimizer.nu))
    # a fresh directory restores the sentinel
    assert CheckpointManager(str(tmp_path / "empty")).restore(b.model) == (None, -1, None)
    # eval restore: a file path, or the directory's latest
    c = build_training(cfg, 10, device="cpu", seed=2)
    assert restore_eval_checkpoint(c.model, os.path.join(tmp_path, "ckpt", "checkpoint")) == 3
    assert restore_eval_checkpoint(c.model, checkpoint_dir=str(tmp_path / "ckpt")) == 3
    with pytest.raises(FileNotFoundError):
        restore_eval_checkpoint(c.model, str(tmp_path / "ckpt" / "checkpoint_best"))


def test_best_ap_extra_persists_across_resume(tmp_path):
    a = build_training(tiny_cfg(), 10, device="cpu", seed=0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save_latest(a.model, a.optimizer, epoch=5, extra={"best_ap25": 0.37})
    _, epoch, extra = mgr.restore(a.model, a.optimizer)
    assert epoch == 5 and extra == {"best_ap25": 0.37}
    # write_extra refreshes the bookkeeping without rewriting the checkpoint
    before = os.path.getmtime(tmp_path / "ckpt" / "checkpoint")
    mgr.write_extra({"best_ap25": 0.41})
    _, _, extra = mgr.restore(a.model, a.optimizer)
    assert extra == {"best_ap25": 0.41}
    assert os.path.getmtime(tmp_path / "ckpt" / "checkpoint") == before


def test_resume_continues_bit_for_bit(tmp_path):
    """Three steps uninterrupted against two, a save, a restore into a
    fresh model and optimiser (other seed) and the third; dropout on, its
    generator seeded per step as the CLI seeds it."""
    cfg = tiny_cfg("--mlp_dropout", "0.3")
    batches = [batch_to_device(make_batch(np.random.default_rng(10 + i), batch_size=2,
                                          num_points=512), "cpu") for i in range(3)]

    def steps(training, which):
        gen = torch.Generator()
        for i in which:
            gen.manual_seed(cli.step_seed(cfg.seed, i))
            metrics = training.train_step(batches[i], gen)
        return metrics

    a = build_training(cfg, 10, device="cpu", seed=0)
    want = steps(a, range(3))
    b = build_training(cfg, 10, device="cpu", seed=0)
    steps(b, range(2))
    CheckpointManager(str(tmp_path)).save_latest(b.model, b.optimizer, 0)
    c = build_training(cfg, 10, device="cpu", seed=7)
    CheckpointManager(str(tmp_path)).restore(c.model, c.optimizer)
    got = steps(c, [2])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k, v in a.model.state_dict().items():
        assert torch.equal(c.model.state_dict()[k], v), k
    assert c.optimizer.count == a.optimizer.count == 3
    assert all(torch.equal(x, y) for x, y in zip(c.optimizer.mu, a.optimizer.mu))


# ------------------------------------------------------------ the parser
def test_run_scripts_parse_with_the_ports_parser():
    known = {s for a in cli.make_args_parser()._actions for s in a.option_strings}
    scripts = sorted(glob.glob(os.path.join(REPO, "scripts", "*.sh")))
    calls = [fn for fn in scripts if "ov3det.main" in open(fn).read()]
    assert len(calls) == 7
    for fn in calls:
        for flag in re.findall(r"--[a-z0-9_]+", open(fn).read()):
            assert flag in known, (fn, flag)
    assert "--device" in known


@pytest.mark.parametrize("flag,item", [
    (["--ngpus", "2"], "item 6"),
    (["--coordinator_address", "localhost:1234"], "item 6"),
    (["--num_processes", "2"], "item 6"),
    (["--use_image", "--image_bank"], "item 8"),
    (["--super_batch", "2"], "Queue 3 item 1"),
    (["--quantize_points"], "Queue 3 item 1"),
    (["--yuv_images"], "Queue 3 item 1"),
])
def test_refused_flags_raise(tmp_path, flag, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP .*{item}"):
        cli.main(TINY + ["--checkpoint_dir", str(tmp_path)] + flag)
    assert not os.listdir(tmp_path)  # refused before anything ran


@pytest.mark.parametrize("flag,check", [
    (["--use_image"], lambda c: c.teacher.enabled and c.data.use_image
     and c.teacher.compute_dtype == "int8"),
    (["--use_image", "--region_clip_ckpt_path", "teacher.pth", "--teacher_compute_dtype",
      "bfloat16"], lambda c: c.teacher.checkpoint_path == "teacher.pth"
     and c.teacher.compute_dtype == "bfloat16"),
    (["--use_image", "--loss_2dalignment_weight", "0.5"],
     lambda c: c.loss.alignment_2d_weight == 0.5 and not c.loss.teacher_per_layer),
])
def test_open_vocabulary_flags_are_accepted(flag, check):
    """The open-vocabulary flags, refused until the OV step was ported, set
    the config as the JAX package's `config_from_args` does (the tiny
    `--use_image` run itself is in tests/test_torch_ov.py)."""
    from ov3det.main import config_from_args as jax_config_from_args
    from ov3det.main import make_args_parser as jax_args_parser

    cfg = tiny_cfg(*flag)
    assert check(cfg)
    argv = [a for a in TINY if a not in ("--device", "cpu")] + flag
    jcfg = jax_config_from_args(jax_args_parser().parse_args(argv))
    for k in ("enabled", "checkpoint_path", "compute_dtype"):
        assert getattr(cfg.teacher, k) == getattr(jcfg.teacher, k), k
    assert cfg.data.use_image == jcfg.data.use_image
    assert cfg.loss.alignment_2d_weight == jcfg.loss.alignment_2d_weight


def test_cli_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    argv = [a for a in TINY if a not in ("--device", "cpu")] + ["--checkpoint_dir", "unused"]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv + extra)
    assert not os.path.exists("unused")
