"""The port's pseudo-label round on the CPU against the JAX package's:
`python -m ov3det_torch.generate_pseudo_label`, its `LabelFormatter` and the
`--use_pbox` retraining that reads what it writes.

- `LabelFormatter`: the same eval outputs (numpy for JAX, tensors for the
  port) give byte-equal `{scan}_bbox.npy` files, with and without the
  label-agreement filter, serially and through the process pool;
- end to end on the ScanNet fixture tree of `tests/test_datasets.py` with a
  tiny detector (encoder 2 x 64, decoder 2 x 64, 32 queries, 2048 points):
  JAX's `generate_pseudo_label.main` from a JAX checkpoint (exact FPS, the
  Pallas ball-group interpreted, `OV3DET_ATTENTION=fused`), the port's from
  the same weights through `from_flax_variables`.  The accumulated rows
  agree within 1e-4 (labels exactly), and the written files have the same
  count a scan and rows within 1e-4, with and without `--label_dir`.  The
  thresholds sit where no score or objectness lies within 1e-3 of them,
  which the test asserts before it compares;
- the padded tail of the last batch is written once;
- the port's parser takes every flag of JAX's, with its defaults;
- a `--use_pbox` epoch of `ov3det_torch.main` trains on the written files
  (after `adjust_format_to_nyu40`, as ScanNet's loader reads nyu40 ids).
"""
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from ov3det_torch import generate_pseudo_label as gpl
from ov3det_torch.tools.label_formatter import LabelFormatter
from tests.test_datasets import scannet_tree  # noqa: F401  (the fixture)

TINY = ["--dataset_name", "scannet", "--dataset_num_workers", "0", "--batchsize_per_gpu", "3",
        "--num_points", "2048", "--preenc_npoints", "128", "--enc_nlayers", "2", "--enc_dim",
        "64", "--enc_ffn_dim", "64", "--dec_nlayers", "2", "--dec_dim", "64", "--dec_ffn_dim",
        "64", "--nqueries", "32", "--mlp_dropout", "0.0"]
MARGIN = 1e-3  # no score or objectness lies this close to a threshold


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")
    monkeypatch.setenv("OV3DET_ATTENTION", "fused")


def tree_argv(root) -> list:
    return TINY + ["--dataset_root_dir", str(root / "scannet_train_detection_data"),
                   "--meta_data_dir", str(root / "meta_data")]


def write_label_dir(root, scans, label: int) -> str:
    """Per-scan xyz + semantic label files (`--label_dir`): every point of
    the scan's cloud labelled `label`, so that a box survives the filter
    iff it holds a point and predicts `label`."""
    out = root / "labels"
    out.mkdir(exist_ok=True)
    for scan in scans:
        xyz = np.load(root / "scannet_train_detection_data" / f"{scan}_vert.npy")[:, :3]
        np.save(out / f"{scan}.npy", np.concatenate([xyz, np.full((len(xyz), 1), label)], 1))
    return str(out)


def read_files(d, scans) -> dict:
    return {s: np.load(os.path.join(d, f"{s}_bbox.npy")) for s in scans}


# ------------------------------------------------------------ LabelFormatter
def _outputs(rng, B, Q, C):
    logits = rng.normal(size=(B, Q, C + 1)) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {"sem_cls_prob": probs[..., :C].astype(np.float32),
            "objectness_prob": (1 - probs[..., -1]).astype(np.float32),
            "center_unnormalized": rng.uniform(-2, 2, (B, Q, 3)).astype(np.float32),
            "size_unnormalized": rng.uniform(0.3, 1.5, (B, Q, 3)).astype(np.float32)}


@pytest.mark.parametrize("filtered", [False, True])
def test_label_formatter_writes_the_files_of_jax(tmp_path, filtered):
    from ov3det.tools.label_formatter import LabelFormatter as JFormatter

    rng = np.random.default_rng(0)
    scans = [f"scene{i:04d}_00" for i in range(5)]
    label_dir = None
    if filtered:
        label_dir = tmp_path / "labels"
        label_dir.mkdir()
        for scan in scans:
            pts = rng.uniform(-2.5, 2.5, (3000, 3))
            sem = rng.integers(0, 6, (3000, 1)).astype(np.float64)  # >= 18 never: few classes
            np.save(label_dir / f"{scan}.npy", np.concatenate([pts, sem], 1))
        label_dir = str(label_dir)
    jf = JFormatter(str(tmp_path / "jax"), label_dir, scans, num_classes=6)
    tf = LabelFormatter(str(tmp_path / "port"), label_dir, scans, num_classes=6)
    for b in range(3):  # batches of 2, scan 4 alone in the last
        out = _outputs(rng, 2 if b < 2 else 1, 20, 6)
        idx = np.arange(2 * b, min(2 * b + 2, 5))
        jf.step(out, {"scan_idx": idx})
        tf.step({k: torch.from_numpy(v) for k, v in out.items()},
                {"scan_idx": torch.from_numpy(idx)})
    n = jf.process(100, 0.3, 0.5, processes=0)
    assert tf.process(100, 0.3, 0.5) == n > 0
    for scan in scans:
        want = (tmp_path / "jax" / f"{scan}_bbox.npy").read_bytes()
        assert (tmp_path / "port" / f"{scan}_bbox.npy").read_bytes() == want


# ------------------------------------------------------------ end to end against JAX
def _spread_text_embed(variables, example, rng) -> np.ndarray:
    """A text-embedding head under which the random detector's scores and
    objectness spread over the queries of a scene: at init the queries of a
    scene share their visual embedding closely (the scenes differ more), so
    the rows are random directions orthogonal to the scenes' mean
    embeddings, scaled to logits of standard deviation 2 within a scene;
    the no-object row then gains a part in the span of those means that
    puts its logit, in each scene on average, at the log-sum-exp of the
    others (objectness about 0.5)."""
    from ov3det_torch.models.convert import from_flax_variables
    from ov3det_torch.models.detr3d import Model3DETR, last_layer_outputs
    from tests import torch_parity as tp

    cfg = gpl.config_from_args(gpl.make_pseudo_label_parser().parse_args(
        TINY + ["--device", "cpu"]))
    net = Model3DETR(cfg.model, device="cpu")
    net.load_state_dict(from_flax_variables(variables))
    with torch.inference_mode():
        out = last_layer_outputs(net({k: torch.from_numpy(example[k]) for k in tp.INPUT_KEYS}))
    v = out["visual_embeds"].double().numpy()  # (S, Q, D)
    means = v.mean(1)
    _, sv, vt = np.linalg.svd(means, full_matrices=False)
    basis = vt[sv > 1e-6 * sv[0]]
    rows = rng.normal(size=variables["frozen"]["text_embed"].shape)
    rows -= (rows @ basis.T) @ basis
    rows *= 2.0 / ((v - means[:, None]) @ rows.T).std()
    logits = v @ rows.T
    gap = (np.log(np.exp(logits[..., :-1]).sum(-1)) - logits[..., -1]).mean(1)  # (S,)
    rows[-1] += basis.T @ np.linalg.lstsq(means @ basis.T, gap, rcond=None)[0]
    return rows.astype(np.float32)


def _jax_checkpoint(argv, ckpt_dir, example):
    """A JAX checkpoint of the tiny detector (seeded init, random BatchNorm
    statistics, the text-embedding head of `_spread_text_embed`) and its
    variables as numpy."""
    import jax
    import jax.numpy as jnp

    from ov3det import generate_pseudo_label as jgpl
    from ov3det.engine import CheckpointManager, build_training
    from ov3det.models import Model3DETR
    from tests import torch_parity as tp

    cfg = jgpl.config_from_args(jgpl.make_pseudo_label_parser().parse_args(argv))
    inputs = {k: jnp.asarray(example[k]) for k in tp.INPUT_KEYS}
    state, _, _, _ = build_training(cfg, Model3DETR(cfg.model), inputs, iters_per_epoch=1,
                                    rng=jax.random.PRNGKey(5))
    variables = {"params": tp.to_numpy(state.params), "frozen": tp.to_numpy(state.frozen),
                 "batch_stats": tp.randomize_batch_stats(tp.to_numpy(state.batch_stats),
                                                         np.random.default_rng(6))}
    # sharper decoder attention: at init it is near uniform, and every query
    # of a scene would read the same features
    for layer in variables["params"]["decoder"].values():
        for name, attn in layer.items():
            if name.startswith("MultiHeadDotProductAttention"):
                for proj in ("query", "key"):
                    attn[proj]["kernel"] = attn[proj]["kernel"] * np.float32(4.0)
    variables["frozen"]["text_embed"] = _spread_text_embed(variables, example,
                                                           np.random.default_rng(7))
    state = state.replace(**{k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in variables.items()})
    CheckpointManager(str(ckpt_dir)).save(state, 0)
    return variables


def _exact_fps(config_from_args):
    def wrapped(args):
        cfg = config_from_args(args)
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, fps_shards=1,
                                                                   query_fps_shards=1))
    return wrapped


def _port_checkpoint(variables, argv, ckpt_dir):
    from ov3det_torch.engine.checkpoint import CheckpointManager
    from ov3det_torch.models.convert import from_flax_variables
    from ov3det_torch.models.detr3d import Model3DETR

    cfg = gpl.config_from_args(gpl.make_pseudo_label_parser().parse_args(argv))
    net = Model3DETR(cfg.model, device="cpu")
    net.load_state_dict(from_flax_variables(variables))
    opt = torch.optim.AdamW(net.parameters())
    return CheckpointManager(str(ckpt_dir)).save(net, opt, 0)


def _thresholds(rows) -> tuple:
    """(conf, obj) near the 40th percentiles with no score or objectness
    within MARGIN of them."""
    picked = []
    for col in (7, 8):
        vals = np.sort(rows[:, col])
        cands = np.linspace(vals.min(), vals.max(), 2001)
        ok = [c for c in cands if np.abs(vals - c).min() > 2 * MARGIN]
        target = np.quantile(vals, 0.4)
        picked.append(float(min(ok, key=lambda c: abs(c - target))))
    return tuple(picked)


def test_generate_pseudo_label_matches_jax(tmp_path, scannet_tree, monkeypatch):  # noqa: F811
    from ov3det import generate_pseudo_label as jgpl

    argv = tree_argv(scannet_tree) + ["--device", "cpu"]
    jargv = tree_argv(scannet_tree)
    from ov3det_torch.datasets.loader import collate
    from ov3det_torch.datasets.registry import build_dataset

    cfg = gpl.config_from_args(gpl.make_pseudo_label_parser().parse_args(argv))
    ds = build_dataset(cfg.data, splits=("inference",))[0]["inference"]
    variables = _jax_checkpoint(jargv, tmp_path / "jax_ckpt", collate([ds[0], ds[1], ds[1]]))
    ckpt = _port_checkpoint(variables, argv, tmp_path / "port_ckpt")
    scans = ["scene0000_00", "scene0001_00"]  # the train split, 2 scans in one padded batch

    # JAX's pass from its checkpoint; its main then writes the files from it
    monkeypatch.setattr(jgpl, "config_from_args", _exact_fps(jgpl.config_from_args))
    jargs = jgpl.make_pseudo_label_parser().parse_args(
        jargv + ["--checkpoint_dir", str(tmp_path / "jax_ckpt"), "--out_dir",
                 str(tmp_path / "unused")])
    formatter = jgpl.run_inference(jgpl.config_from_args(jargs), jargs)
    want_rows = np.concatenate(formatter.boxes)
    assert want_rows.shape == (2 * 32, 10)  # the pad sample's rows are not there
    conf, obj = _thresholds(want_rows)
    for col, th in ((7, conf), (8, obj)):
        assert np.abs(want_rows[:, col] - th).min() > MARGIN

    def replay(cfg, args):  # the pass above, with the paths this call's run_inference takes
        out = copy.deepcopy(formatter)
        out.output_path = args.out_dir
        out.raw_label_path = os.path.join(args.label_dir, "{}.npy") if args.label_dir else None
        return out

    monkeypatch.setattr(jgpl, "run_inference", replay)

    label = int(np.bincount(want_rows[(want_rows[:, 7] >= conf) & (want_rows[:, 8] >= obj), 6]
                            .astype(int)).argmax())
    label_dir = write_label_dir(scannet_tree, scans, label)
    flags = ["--conf_thresh", str(conf), "--obj_thresh", str(obj)]
    for out, extra in (("jax_out", []), ("jax_lab", ["--label_dir", label_dir])):
        jgpl.main(jargv + ["--checkpoint_dir", str(tmp_path / "jax_ckpt"), "--out_dir",
                           str(tmp_path / out)] + flags + extra)

    # the port's, from the same weights
    got_rows = []
    run = gpl.run_inference

    def keep_rows(cfg, args, device=None):
        out = run(cfg, args, device)
        got_rows.append(np.concatenate(out.boxes))
        return out

    monkeypatch.setattr(gpl, "run_inference", keep_rows)
    n_all = gpl.main(argv + ["--test_ckpt", ckpt, "--out_dir", str(tmp_path / "port_out")] + flags)
    n_lab = gpl.main(argv + ["--test_ckpt", ckpt, "--out_dir", str(tmp_path / "port_lab"),
                             "--label_dir", label_dir] + flags)
    np.testing.assert_array_equal(got_rows[0], got_rows[1])
    got = got_rows[0]
    np.testing.assert_array_equal(got[:, 6], want_rows[:, 6])  # labels
    np.testing.assert_array_equal(got[:, 9], want_rows[:, 9])  # scan indices
    np.testing.assert_allclose(got, want_rows, rtol=0, atol=1e-4)

    for port_dir, jax_dir, n in (("port_out", "jax_out", n_all), ("port_lab", "jax_lab", n_lab)):
        port, want = read_files(tmp_path / port_dir, scans), read_files(tmp_path / jax_dir, scans)
        assert [len(port[s]) for s in scans] == [len(want[s]) for s in scans]
        assert sum(len(v) for v in port.values()) == n
        for s in scans:
            np.testing.assert_allclose(port[s], want[s], rtol=0, atol=1e-4)
    assert 0 < n_lab < n_all < len(want_rows)  # each threshold and the filter took some


def test_padded_tail_is_written_once(tmp_path, scannet_tree):  # noqa: F811
    from ov3det_torch.engine.checkpoint import CheckpointManager
    from ov3det_torch.models.detr3d import Model3DETR

    argv = tree_argv(scannet_tree) + ["--device", "cpu", "--batchsize_per_gpu", "4"]
    cfg = gpl.config_from_args(gpl.make_pseudo_label_parser().parse_args(argv))
    net = Model3DETR(cfg.model, device="cpu", seed=3)
    ckpt = CheckpointManager(str(tmp_path / "ckpt")).save(net, torch.optim.AdamW(net.parameters()), 0)
    args = gpl.make_pseudo_label_parser().parse_args(
        argv + ["--test_ckpt", ckpt, "--out_dir", str(tmp_path / "out")])
    formatter = gpl.run_inference(cfg, args, "cpu")
    rows = np.concatenate(formatter.boxes)
    # 2 scans in one batch of 4: two pad samples repeat scan 1
    assert rows.shape == (2 * 32, 10)
    assert np.bincount(rows[:, 9].astype(int)).tolist() == [32, 32]
    n = formatter.process(100, 0.0, 0.0)
    assert n == 64
    assert [len(v) for v in read_files(tmp_path / "out", ["scene0000_00", "scene0001_00"])
            .values()] == [32, 32]


def test_parser_takes_every_flag_of_jax():
    from ov3det.generate_pseudo_label import make_pseudo_label_parser as jax_parser

    jp, tp_ = jax_parser(), gpl.make_pseudo_label_parser()
    theirs = {a.dest: a for a in jp._actions if a.option_strings and a.dest != "help"}
    ours = {a.dest: a for a in tp_._actions if a.option_strings and a.dest != "help"}
    assert set(theirs) <= set(ours)
    for dest in ("out_dir", "label_dir", "topk", "conf_thresh", "obj_thresh"):
        assert (ours[dest].default, ours[dest].type) == (theirs[dest].default, theirs[dest].type)
    assert ours["device"].default == "cuda"
    # a line JAX's parser takes parses alike
    line = ["--dataset_name", "scannet", "--out_dir", "o", "--label_dir", "l", "--topk", "7",
            "--conf_thresh", "0.5", "--obj_thresh", "0.8", "--use_color", "--nqueries", "64"]
    a, b = jp.parse_args(line), tp_.parse_args(line)
    assert all(getattr(a, d) == getattr(b, d) for d in theirs)


def test_use_pbox_epoch_trains_on_the_written_files(tmp_path, scannet_tree):  # noqa: F811
    from ov3det_torch import main as cli
    from ov3det_torch.config import DataConfig
    from ov3det_torch.datasets.registry import build_dataset
    from ov3det_torch.engine.checkpoint import CheckpointManager
    from ov3det_torch.models.detr3d import Model3DETR
    from ov3det_torch.tools.format_tools import adjust_format_to_nyu40

    scans = ["scene0000_00", "scene0001_00"]
    argv = tree_argv(scannet_tree) + ["--device", "cpu"]
    cfg = gpl.config_from_args(gpl.make_pseudo_label_parser().parse_args(argv))
    net = Model3DETR(cfg.model, device="cpu", seed=3)
    ckpt = CheckpointManager(str(tmp_path / "ckpt")).save(net, torch.optim.AdamW(net.parameters()), 0)
    n = gpl.main(argv + ["--test_ckpt", ckpt, "--out_dir", str(tmp_path / "pseudo"),
                         "--conf_thresh", "0", "--obj_thresh", "0.5"])
    assert n > 0
    adjust_format_to_nyu40(str(tmp_path / "pseudo"), str(tmp_path / "pbox"), scans)
    written = read_files(tmp_path / "pbox", scans)
    # the test split reads --pseudo_label_dir too (`datasets/scannet.py`):
    # the val scan's boxes are its GT, as a lifting pass over every scan
    # would have written them
    data_dir = scannet_tree / "scannet_train_detection_data"
    (tmp_path / "pbox" / "scene0002_00_bbox.npy").write_bytes(
        (data_dir / "scene0002_00_bbox.npy").read_bytes())

    data = DataConfig(dataset_name="scannet", root_dir=str(data_dir),
                      meta_data_dir=str(scannet_tree / "meta_data"),
                      pseudo_label_dir=str(tmp_path / "pbox"), use_pbox=True, num_points=2048)
    ds = build_dataset(data, splits=("inference",))[0]["inference"]
    for i, scan in enumerate(ds.scan_names):
        item = ds[i]
        k = len(written[scan])
        assert int(item["gt_box_present"].sum()) == k
        np.testing.assert_array_equal(item["gt_box_centers"][:k], written[scan][:, :3].astype(np.float32))

    run = tmp_path / "retrain"
    training = cli.main(argv + ["--use_pbox", "--pseudo_label_dir", str(tmp_path / "pbox"),
                                "--max_epoch", "1", "--batchsize_per_gpu", "2", "--checkpoint_dir",
                                str(run), "--log_every", "1"])
    assert training.model is not None
    assert os.path.isfile(run / "checkpoint") and os.path.isfile(run / "final_eval.txt")
