"""The port's data parallelism on the CPU against the JAX package's mesh.

- Two gloo ranks of the port (`tests/torch_ddp_worker.py`, spawned here)
  train two steps of a global batch of 2, a scene a rank, from the
  weights of JAX's init, against JAX's `make_train_step` on a 2-device
  `make_mesh(2)` (`replicate` / `shard_batch`, conftest's virtual CPU
  devices) and against the port's one rank on the whole batch.  Held as
  `tests/torch_parity.py`'s `assert_two_steps_match` holds a step (see
  `tests/test_torch_train.py`'s docstring: f32 parity of a step is bounded
  by training-mode BatchNorm): losses and grad_norm within 1e-4 relative on
  the first step and 2e-3 on the second, the matched masks equal, BatchNorm
  running statistics within 1e-4, `gauss_B` within 1e-6, and after the
  first step 99.5 % of the parameters within 1e-6 and all within 2 lr.
  The ranks hold the same state bit for bit.  Against the port's one rank:
  the first step's losses and grad_norm within 1e-5 relative, BatchNorm
  statistics within 1e-5.  Why a batch of 2: on `make_batch(seed=0)` of 4
  scenes JAX's own mesh step and its one-device step disagree by 6.6 % in
  the second step's grad_norm (1e-3 in the first), the f32 noise of its
  fast BatchNorm variance, so that batch decides nothing; on the batch of
  2 they agree within 6e-5.
- The seed fold: JAX's fused attention under a 2-device mesh
  (OV3DET_ATTENTION=fused, interpreted) at dropout 0.1 equals the port's
  attention on each half with seed + rank, masks and all; the decoder's
  broadcast mask is the same on both ranks, an element-wise mask differs,
  and the ranks' masks are the rows of one rank's mask of the global batch.
- The loader: two shuffled epochs with a padded tail; the two ranks'
  batches concatenated are the one-rank global batch, and each equals
  JAX's `DataLoader(process_index=r, process_count=2)` local batch, with
  its `valid_mask`.
- `clip_contrastive_loss(gather=True)` on two ranks: the loss and the rows'
  gradient equal the one-rank loss of the global batch and JAX's under
  `shard_map` with `axis_name`.
- The CLI: `python -m ov3det_torch.main --device cpu --ngpus 2`: one set
  of files, written by rank 0, one AP table an eval, a resume that trains
  on from the checkpoint, and with every dropout at 0 the logged losses
  (steps 0, 5, 10, 15) within 1e-4 relative of `--ngpus 1` at the same
  global batch, each epoch from one state: the one-rank run's second epoch
  resumes from the two ranks' first checkpoint.  The run takes 8 queries, not the 32 of the CLI tests:
  at random init the decoder's 32 queries of a scene nearly share their
  boxes, so the auction's costs hold near-ties, and the f32 noise between
  one rank and two (outputs within 1e-5) flips the assignment of 2
  proposals in the first batch, 2.1e-3 of the first step's loss and up to
  9.3e-3 later; local BatchNorm statistics move them by no more (4.4e-3,
  1.2e-2), so those limits could not tell the two apart.  With 8 queries
  the first steps agree within 2.1e-7, and local BatchNorm statistics are
  2.8e-4 off in the first step and 1.3e-2 later.  Near-ties remain: at
  step 7 grad_norm jumps to 2.3e-3 apart with equal losses (an assignment
  flipped), and from there the losses of one run from initialisation
  drift apart by up to 1.2e-4 by step 15, moved by the last bit of an
  AdamW update; from one state at the epoch boundary they stay within
  1.5e-5.
- `main.evaluate` on two ranks, of detections near the GT boxes that
  score, with a padded tail whose rows on rank 1 are all padding: the
  gathered calculator holds the one-rank calculator's scans in its order,
  and gives its metrics.  `any_rank` (the preemption guard's flag) is
  raised on every rank when one raises it.
"""
import dataclasses
import json
import os
import re
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ov3det import config as jc
from ov3det_torch import config as tc
from tests import torch_parity as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ddp_worker.py")
LR = 5e-4
TIMEOUT = 300  # seconds of a spawned rank


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")  # the TPU's ball-group, interpreted


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(path: str, names: tuple, world: int = 2, **job) -> list:
    """Run `tests/torch_ddp_worker.py`'s jobs `names` on `world` gloo ranks
    (the job file at `path`); returns what each rank wrote."""
    torch.save(dict(job, names=names, world=world, port=_free_port()), path)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, path, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in range(world)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"a rank failed:\n{out}\n{err}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [torch.load(f"{path}.{r}", weights_only=False) for r in range(world)]


def _step_configs():
    """(JAX TrainConfig, port TrainConfig, JAX ModelConfig): the small f32
    detector of `tests/torch_parity.py`, dropout 0, sunrgbd_quick's loss, no
    warm-up."""
    jm, tm = (tp.zero_dropout(m) for m in tp.configs("float32"))
    jq, tq = jc.sunrgbd_quick(), tc.sunrgbd_quick()
    jcfg = dataclasses.replace(jq, model=jm, optim=dataclasses.replace(jq.optim, warm_lr_epochs=0))
    tcfg = dataclasses.replace(tq, model=tm, optim=dataclasses.replace(tq.optim, warm_lr_epochs=0))
    return jcfg, tcfg, jm


# 10 scenes in global batches of 8: the second batch's 2 scenes are rank 0's,
# and rank 1's 4 rows are all padding
EVAL_JOB = dict(eval_scenes=dict(size=10, seed=2, num_points=2048, num_semcls=18,
                                 num_angle_bin=1), eval_batch=8)
CLIP_EMBEDS = {name: np.random.default_rng(8 + i).normal(size=(8, 16)).astype(np.float32)
               for i, name in enumerate(("pc", "text"))}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two ranks for the step and the clip loss: (the JAX
    model, its variables as numpy, the global batch, each rank's results)."""
    from ov3det_torch.models.convert import from_flax_variables

    _, tcfg, jm = _step_configs()
    batch = tp.make_batch(seed=0, batch_size=2)
    model, variables = tp.jax_model_and_variables(jm, batch)
    path = str(tmp_path_factory.mktemp("ddp") / "ranks.job")
    ranks = spawn_ranks(path, ("train_steps", "clip_loss", "evaluate", "any_rank"), cfg=tcfg,
                        state=from_flax_variables(variables), batches=[batch, batch],
                        embeds=CLIP_EMBEDS, **EVAL_JOB)
    return model, variables, batch, ranks


# ------------------------------------------------------------ two steps
def _jax_mesh_steps(jcfg, jm, variables, model, batch: dict) -> list:
    """Two steps of JAX's `build_training` step on `make_mesh(2)` from
    `variables`: [(metrics, port state_dict)] after each."""
    import jax
    import jax.numpy as jnp

    from ov3det.engine import build_training
    from ov3det.parallel.mesh import make_mesh, replicate, set_data_mesh, shard_batch
    from ov3det_torch.models.convert import from_flax_variables

    inputs = {k: jnp.asarray(batch[k]) for k in tp.INPUT_KEYS}
    state, step, _, _ = build_training(jcfg, model, inputs, iters_per_epoch=100,
                                       rng=jax.random.PRNGKey(0))
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    state = state.replace(params=as_jax(variables["params"]),
                          batch_stats=as_jax(variables["batch_stats"]),
                          frozen=as_jax(variables["frozen"]))
    mesh = make_mesh(2)
    try:
        state = replicate(state, mesh)
        sharded = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
        seen = []
        for i in range(2):
            state, metrics = step(state, sharded, jax.random.PRNGKey(i))
            seen.append(({k: float(v) for k, v in metrics.items()}, from_flax_variables({
                "params": jax.tree_util.tree_map(np.asarray, state.params),
                "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats),
                "frozen": variables["frozen"]})))
    finally:
        set_data_mesh(None)
    return seen


def test_two_ranks_match_the_jax_mesh_and_one_rank(two_ranks):
    from ov3det_torch.engine.train import batch_to_device, build_training
    from ov3det_torch.models.convert import from_flax_variables

    jcfg, tcfg, jm = _step_configs()
    model, variables, batch, results = two_ranks
    ranks = [r["train_steps"] for r in results]
    want = _jax_mesh_steps(jcfg, jm, variables, model, batch)

    # the ranks agree bit for bit: replicated state, global metrics
    for (m0, sd0), (m1, sd1) in zip(ranks[0]["steps"], ranks[1]["steps"]):
        assert m0 == m1
        assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)

    for i, ((got, sd), (metrics, sd_want)) in enumerate(zip(ranks[0]["steps"], want)):
        assert set(got) == set(metrics)
        for k, w in metrics.items():
            np.testing.assert_allclose(got[k], w, rtol=(1e-4, 2e-3)[i], atol=1e-6,
                                       err_msg=f"{k}, step {i}")
        for k, w in sd_want.items():
            if "running" in k:
                np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0, atol=1e-4,
                                           err_msg=f"{k}, step {i}")
        np.testing.assert_allclose(sd["pos_embedding.gauss_B"].numpy(),
                                   sd_want["pos_embedding.gauss_B"].numpy(), rtol=0, atol=1e-6)
        if i == 0:
            diffs = torch.cat([(sd[k] - w).abs().flatten() for k, w in sd_want.items()
                               if "running" not in k and k != "text_embed"])
            assert float((diffs <= 1e-6).float().mean()) >= 0.995
            assert float(diffs.max()) <= 2 * LR

    # the port's one rank on the global batch
    one = build_training(tcfg, 100, device="cpu", seed=0)
    one.model.load_state_dict(from_flax_variables(variables))
    got = one.train_step(batch_to_device(batch, "cpu"), torch.Generator().manual_seed(0))
    two, sd_two = ranks[0]["steps"][0]
    for k, v in got.items():
        np.testing.assert_allclose(two[k], float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    sd_one = one.model.state_dict()
    for k in sd_one:
        if "running" in k:
            np.testing.assert_allclose(sd_two[k].numpy(), sd_one[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


# ------------------------------------------------------------ dropout
class _Rank:
    """`data_group()` of rank `rank` in a world of 2, for the modules that
    read it: no collective is called by what these tests run."""

    def __init__(self, monkeypatch, rank: int):
        from ov3det_torch.models import mlp, transformer
        from ov3det_torch.parallel import DataGroup

        group = DataGroup(rank, 2, "gloo")
        for module in (mlp, transformer):
            monkeypatch.setattr(module, "data_group", lambda: group)


def test_attention_seed_is_the_shared_draw_plus_the_rank(monkeypatch):
    """JAX's fused attention under a 2-device mesh (seed + axis_index, the
    hash's b counted within the shard) equals the port's attention on each
    half with seed + rank; and the port's layer adds its rank to the seed
    it draws from the generator every rank seeds alike."""
    import jax
    import jax.numpy as jnp

    from ov3det.models.transformer import _fused_attention_fn, _seed_from_rng
    from ov3det.parallel.mesh import make_mesh, set_data_mesh
    from ov3det_torch.models import transformer
    from ov3det_torch.ops.kernels import attention

    monkeypatch.setenv("OV3DET_ATTENTION", "fused")  # the Pallas kernel, interpreted
    B, N, H, D, rate = 2, 128, 2, 32, 0.1
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(B, N, H, D)).astype(np.float32) for _ in range(3))
    key = jax.random.PRNGKey(11)
    make_mesh(2)
    try:
        want = np.asarray(_fused_attention_fn(*(jnp.asarray(a) for a in (q, k, v)),
                                              dropout_rng=key, dropout_rate=rate,
                                              deterministic=False))
    finally:
        set_data_mesh(None)
    seed = int(_seed_from_rng(key))

    def heads(a):  # (1, N, H, D) -> (H, N, D)
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(-1, N, D)))

    outs = []
    for r in range(2):
        got = attention.fused_attention(heads(q[r:r + 1]), heads(k[r:r + 1]), heads(v[r:r + 1]),
                                        rate, torch.tensor([seed + r], dtype=torch.int32))
        outs.append(got.numpy().reshape(1, H, N, D).transpose(0, 2, 1, 3))
        np.testing.assert_allclose(outs[-1][0], want[r], rtol=0, atol=1e-5, err_msg=f"rank {r}")
    # the fold matters: rank 1 without it is another mask
    unfolded = attention.fused_attention(heads(q[1:2]), heads(k[1:2]), heads(v[1:2]), rate,
                                         torch.tensor([seed], dtype=torch.int32))
    assert np.abs(unfolded.numpy().reshape(1, H, N, D).transpose(0, 2, 1, 3)[0] - want[1]).max() > 1e-2

    seen = []
    monkeypatch.setattr(transformer, "fused_attention",
                        lambda q, k, v, rate, seed, radius: seen.append(int(seed)) or q)
    layer = transformer.MultiheadAttention(H * D, H, dropout=rate).train()
    x = torch.randn(1, 1024, H * D, generator=torch.Generator().manual_seed(0))  # the fused path
    for r in range(2):
        _Rank(monkeypatch, r)
        layer(x, x, x, torch.Generator().manual_seed(5))
    assert seen[1] == seen[0] + 1


def test_dropout_masks_under_a_group(monkeypatch):
    """The decoder's broadcast (NQ, NK) mask is the same on both ranks; an
    element-wise mask differs, and the two ranks' masks are the rows of the
    mask one rank draws for the global batch (JAX's partitionable threefry
    slices one global draw the same way)."""
    from ov3det_torch.models import mlp, transformer

    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 32, 2, 16)).astype(np.float32))
               for _ in range(3))
    x = torch.ones(4, 8, 16)  # a rank's rows: 4 scenes
    heads = torch.ones(2, 4, 8, 16)  # a head's input: (L, B, Q, C)
    whole = mlp.dropout(torch.ones(8, 8, 16), 0.5, torch.Generator().manual_seed(1))
    whole_heads = mlp.dropout(torch.ones(2, 8, 8, 16), 0.5, torch.Generator().manual_seed(1), 1)
    broadcast, element, element_heads = [], [], []
    for r in range(2):
        _Rank(monkeypatch, r)
        broadcast.append(transformer.dot_product_attention(q, k, v, 0.5,
                                                           torch.Generator().manual_seed(1)))
        element.append(mlp.dropout(x, 0.5, torch.Generator().manual_seed(1)))
        element_heads.append(mlp.dropout(heads, 0.5, torch.Generator().manual_seed(1), 1))
    assert torch.equal(broadcast[0], broadcast[1])
    assert not torch.equal(element[0], element[1])
    assert torch.equal(torch.cat(element), whole)
    assert torch.equal(torch.cat(element_heads, 1), whole_heads)


# ------------------------------------------------------------ the loader
def test_each_rank_loads_its_rows_of_the_global_batch():
    from ov3det.datasets import SyntheticDataset as JSynthetic
    from ov3det.datasets.loader import DataLoader as JDataLoader
    from ov3det_torch.datasets.loader import DataLoader
    from ov3det_torch.datasets.synthetic import SyntheticDataset

    kw = dict(size=14, seed=2, num_points=128, num_semcls=18, num_angle_bin=1)
    common = dict(batch_size=8, shuffle=True, drop_last=False, seed=3)
    one = DataLoader(SyntheticDataset(**kw), num_workers=0, **common)
    ranks = [DataLoader(SyntheticDataset(**kw), num_workers=0, process_index=r, process_count=2,
                        **common) for r in range(2)]
    theirs = [JDataLoader(JSynthetic(**kw), num_workers=1, transfer="tree", sharding=None,
                          process_index=r, process_count=2, **common) for r in range(2)]
    for epoch in (0, 1):
        for loader in (one, *ranks, *theirs):
            loader.set_epoch(epoch)
        whole = list(one)
        parts = [list(loader) for loader in ranks]
        jparts = [list(loader) for loader in theirs]
        assert len(whole) == len(parts[0]) == len(parts[1]) == 2
        for b, (g0, g1) in enumerate(zip(*parts)):
            for key, w in whole[b].items():
                assert torch.equal(torch.cat([g0[key], g1[key]]), w), (epoch, b, key)
            for r, g in enumerate((g0, g1)):
                want = jparts[r][b]
                assert sorted(g) == sorted(want)
                for key, w in want.items():
                    np.testing.assert_array_equal(g[key].numpy(), np.asarray(w),
                                                  err_msg=f"{epoch} {b} {r} {key}")
        # the padded tail: 14 = 8 + 6, the pad all on rank 1
        np.testing.assert_array_equal(parts[1][-1]["valid_mask"].numpy(), [1, 1, 0, 0])


# ------------------------------------------------------------ the clip loss
def test_clip_loss_gathers_the_global_batch(two_ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ov3det.losses.clip_loss import clip_contrastive_loss as jax_clip
    from ov3det.parallel.mesh import make_mesh, set_data_mesh
    from ov3det_torch.losses.clip_loss import clip_contrastive_loss

    embeds = CLIP_EMBEDS
    ranks = [r["clip_loss"] for r in two_ranks[3]]

    pc, tx = (torch.from_numpy(embeds[k]).requires_grad_() for k in ("pc", "text"))
    loss, metrics = clip_contrastive_loss(pc, tx)
    loss.backward()
    mesh = make_mesh(2)
    try:
        sharded = jax.shard_map(lambda a, b: jax_clip(a, b, axis_name="data")[0], mesh=mesh,
                                in_specs=(P("data"), P("data")), out_specs=P(), check_vma=False)
        jloss, jgrads = jax.value_and_grad(sharded, argnums=(0, 1))(
            jnp.asarray(embeds["pc"]), jnp.asarray(embeds["text"]))
    finally:
        set_data_mesh(None)
    for r, got in enumerate(ranks):
        rows = slice(4 * r, 4 * (r + 1))
        np.testing.assert_allclose(got["loss"], float(loss.detach()), rtol=1e-6)
        np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-6)
        assert got["acc"] == float(metrics["clip_acc"])
        for name, t, jg in (("pc_grad", pc, jgrads[0]), ("text_grad", tx, jgrads[1])):
            np.testing.assert_allclose(got[name].numpy(), t.grad[rows].numpy(), rtol=0, atol=1e-6)
            np.testing.assert_allclose(got[name].numpy(), np.asarray(jg)[rows], rtol=0, atol=1e-6)


# ------------------------------------------------------------ the eval
def test_evaluate_gathers_every_rank_in_the_global_order(two_ranks):
    """`main.evaluate` on two ranks, of detections that score, with a padded
    tail in which rank 1's rows are all padding: on both ranks the gathered
    calculator holds the one-rank calculator's scans, scan for scan in the
    same order, and gives its metrics."""
    from ov3det_torch.datasets.dataset_configs import ScannetDatasetConfig
    from ov3det_torch.main import evaluate
    from tests.torch_ddp_worker import eval_loader, near_gt_eval_step

    tail = list(eval_loader(EVAL_JOB, 1, 2))[-1]
    np.testing.assert_array_equal(tail["valid_mask"].numpy(), [0, 0, 0, 0])
    one = evaluate(near_gt_eval_step, eval_loader(EVAL_JOB), ScannetDatasetConfig(), "cpu")
    want = one.compute_metrics()
    assert one.scan_cnt == EVAL_JOB["eval_scenes"]["size"]
    assert want[0.25]["mAP"] > 0.1 and want[0.5]["mAP"] > 0
    for r, res in enumerate(res["evaluate"] for res in two_ranks[3]):
        assert sorted(res["pred"]) == sorted(one.pred_map_cls) == list(range(one.scan_cnt))
        for i in range(one.scan_cnt):
            for got, w in ((res["pred"][i], one.pred_map_cls[i]), (res["gt"][i], one.gt_map_cls[i])):
                assert len(got) == len(w), (r, i)
                for a, b in zip(got, w):
                    np.testing.assert_array_equal(a, b, err_msg=f"rank {r}, scan {i}")
        for t, metrics in want.items():
            for k, v in metrics.items():
                np.testing.assert_allclose(res["metrics"][t][k], v, rtol=0, atol=1e-12,
                                           err_msg=f"rank {r}: {t} {k}")


def test_any_rank_agrees_on_every_rank(two_ranks):
    """The preemption guard's flag: raised on one rank, every rank sees it."""
    assert [res["any_rank"] for res in two_ranks[3]] == [[True, False, True]] * 2


# ------------------------------------------------------------ the CLI
def _cli(argv: list) -> str:
    res = subprocess.run([sys.executable, "-m", "ov3det_torch.main", *argv], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return res.stdout


def _losses(run: str) -> dict:
    rows = [json.loads(line) for line in open(os.path.join(run, "scalars.jsonl"))]
    return {r["step"]: r["Train_details/loss"] for r in rows if "Train_details/loss" in r}


def test_cli_trains_on_two_cpu_ranks(tmp_path):
    """`--ngpus 2 --device cpu`: rank 0 alone prints, logs and writes; one
    AP table an eval; a resume trains on from the checkpoint; the losses
    follow the one-rank run of the same global batch (8 = 2 x 4)."""
    from tests.test_torch_cli import TINY

    from ov3det_torch import main as cli

    # mlp_dropout is 0 already; 8 queries, for the matcher's sake (the docstring)
    argv = TINY + ["--enc_dropout", "0", "--dec_dropout", "0", "--nqueries", "8"]
    run2, run1 = str(tmp_path / "two"), str(tmp_path / "one")
    out = _cli(argv + ["--ngpus", "2", "--max_epoch", "1", "--checkpoint_dir", run2])
    lines = out.splitlines()
    assert sorted(os.listdir(run2)) == sorted([
        "checkpoint", "checkpoint.extra.json", "checkpoint_best", "checkpoint_best.extra.json",
        "final_eval.pkl", "final_eval.txt", "scalars.jsonl",
        *[f for f in os.listdir(run2) if f.startswith("events.out.tfevents")]])
    assert len([f for f in os.listdir(run2) if f.startswith("events.out")]) <= 1
    assert lines.count("Evaluate Epoch [0/1]") == 1
    assert sum(line.startswith("mAP0.25, mAP0.50: ") for line in lines) == 1
    assert sum(line.startswith("Epoch [0/1] train mAP0.25") for line in lines) == 1
    assert sum(line.startswith("Epoch [0/1]; Iter [0/8]; ") for line in lines) == 1
    assert sorted(_losses(run2)) == [0, 5]  # one row a logged step: rank 0's

    # the one-rank run's first epoch; its second resumes from the two ranks'
    # first checkpoint, so that both epochs start from one state
    cli.main(argv + ["--batchsize_per_gpu", "8", "--max_epoch", "1", "--checkpoint_dir", run1])
    for name in ("checkpoint", "checkpoint.extra.json"):
        shutil.copy(os.path.join(run2, name), os.path.join(run1, name))

    # resume: the second epoch from the first's checkpoint
    os.remove(os.path.join(run2, "final_eval.txt"))
    out = _cli(argv + ["--ngpus", "2", "--checkpoint_dir", run2])
    assert out.splitlines().count("resumed from epoch 0 (best AP25 0.0000)") == 1
    assert "Evaluate Epoch [1/2]" in out and os.path.isfile(os.path.join(run2, "final_eval.txt"))
    assert sorted(_losses(run2)) == [0, 5, 10, 15]

    os.remove(os.path.join(run1, "final_eval.txt"))
    cli.main(argv + ["--batchsize_per_gpu", "8", "--checkpoint_dir", run1])
    one, two = _losses(run1), _losses(run2)
    assert sorted(one) == sorted(two)
    for step, want in one.items():
        np.testing.assert_allclose(two[step], want, rtol=1e-4, err_msg=f"step {step}")
