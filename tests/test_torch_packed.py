"""The packed training transfer on the CPU against the JAX package.

- `pack_batch` gives JAX's buffer byte for byte and its metas, for a point
  batch (SUN RGB-D's 12 angle bins), a masked ScanNet batch (one bin, the
  3DETR-m schema) and a SUN RGB-D-layout OV batch (canvases, calibration,
  a pad mask), with and without the q16 and yuv420 codecs; `batch_metas`
  gives the same layout without building the batch;
- `unpack_batch` gives JAX's `unpack_batch` after the widening: verbatim
  keys exactly (and exactly what `batch_to_device` gives for the tree
  batch), q16 exactly (the port rounds the multiply-add once, as XLA's
  fused program does), yuv420 uint8-equal;
- the loader's packed groups: each row of a `super_batch` group equals
  JAX's `pack_batch` of the batch JAX's loader visits there, over two
  epochs with the short tail group, with worker processes and memoised
  canvases and without;
- the packed step on the CPU (`PackedStep`, eager) equals the tree step
  bit for bit without codecs, and a parameter rebound after the first
  packed step raises;
- the q16 step's first losses equal JAX's `make_packed_step` on the same
  buffer within the f32 step tolerance of `tests/test_torch_train.py`
  (1e-4 relative), exact FPS and the Pallas ball-group interpreted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det import config as jc
from ov3det.datasets import loader as J
from ov3det.datasets.synthetic import SyntheticDataset as JSyntheticDataset
from ov3det.engine.schedule import make_lr_schedule as jax_schedule
from ov3det.engine.train import TrainState
from ov3det.engine.train import build_optimizer as jax_build_optimizer
from ov3det.engine.train import make_packed_step as jax_make_packed_step
from ov3det.engine.train import make_train_step as jax_make_train_step
from ov3det_torch import config as tc
from ov3det_torch.datasets import loader as L
from ov3det_torch.datasets.synthetic import SyntheticDataset, SyntheticOVDataset, make_batch
from ov3det_torch.engine import train as T
from ov3det_torch.models.convert import from_flax_variables
from ov3det_torch.models.detr3d import Model3DETR
from tests import torch_parity as tp

CODECS = ("point_clouds", "image")


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")  # the TPU's ball-group, interpreted


def ov_batch() -> dict:
    """A SUN RGB-D-layout OV batch of 3 scenes: 512 points, 530 x 730
    canvases and calibration, and a pad mask."""
    ds = SyntheticOVDataset(size=3, seed=4, num_points=512, num_semcls=10, num_angle_bin=12)
    batch = L.collate([ds[i] for i in range(3)])
    batch["valid_mask"] = np.array([1, 1, 0], np.float32)
    return batch


BATCHES = {
    "point": lambda: make_batch(np.random.default_rng(0), batch_size=2, num_points=700,
                                num_semcls=10, num_angle_bin=12),
    "masked": lambda: make_batch(np.random.default_rng(1), batch_size=2, num_points=900,
                                 num_semcls=18, num_angle_bin=1),
    "ov": ov_batch,
}


@pytest.mark.parametrize("quantize", [(), CODECS], ids=["verbatim", "codecs"])
@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_pack_batch_is_jax_byte_for_byte(kind, quantize):
    batch = BATCHES[kind]()
    want_buf, want_metas = J.pack_batch(batch, quantize)
    buf, metas = L.pack_batch(batch, quantize)
    assert metas == want_metas
    assert buf.dtype == np.uint8 and np.array_equal(buf, want_buf)
    tags = {k: tag for k, tag, _, _ in metas}
    if quantize:
        assert tags["point_clouds"] == "q16"
        assert tags.get("image", "yuv420") == "yuv420"
    # the layout without the batch
    sample = {k: v[0] for k, v in batch.items() if k != "valid_mask"}
    with_mask = "valid_mask" in batch
    got = L.batch_metas(sample, len(batch["point_clouds"]), with_mask, quantize)
    assert got == J.batch_metas(sample, len(batch["point_clouds"]), with_mask, quantize)
    assert got == (metas, buf.size)


@pytest.mark.parametrize("quantize", [(), CODECS], ids=["verbatim", "codecs"])
@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_unpack_batch_matches_jax(kind, quantize):
    batch = BATCHES[kind]()
    buf, metas = J.pack_batch(batch, quantize)
    want = {k: np.asarray(v) for k, v in J.unpack_batch(jnp.asarray(buf), metas).items()}
    got = L.unpack_batch(torch.from_numpy(buf), metas)
    tree = T.batch_to_device(batch, "cpu")
    assert set(got) == set(want) == set(batch)
    for k, tag, _, _ in metas:
        w = want[k]
        assert got[k].dtype == (torch.uint8 if w.dtype == np.uint8 else
                                torch.float32 if w.dtype.kind == "f" else torch.int64), k
        # the widening only: int32 -> int64, every value kept
        np.testing.assert_array_equal(got[k].numpy(), w.astype(got[k].numpy().dtype), err_msg=k)
        if tag not in ("q16", "yuv420"):
            assert got[k].dtype == tree[k].dtype and torch.equal(got[k], tree[k]), k
    if quantize:
        assert not torch.equal(got["point_clouds"], tree["point_clouds"])  # the codec ran
        err = (got["point_clouds"] - tree["point_clouds"]).abs().amax((0, 1))
        span = tree["point_clouds"].amax(1) - tree["point_clouds"].amin(1)
        assert bool((err <= span.amax(0) / 65535).all())  # half a step, and rounding


def jax_order(n: int, batch_size: int, drop_last: bool, seed: int, epoch: int) -> list:
    """JAX's loader's (indices, real count) of each batch of an epoch."""
    jl = J.DataLoader(JSyntheticDataset(size=n, num_points=16), batch_size, shuffle=True,
                      drop_last=drop_last, num_workers=1, seed=seed, process_index=0,
                      process_count=1)
    jl.set_epoch(epoch)
    return list(jl._index_batches())


@pytest.mark.parametrize("workers,ov", [(0, False), (2, True)], ids=["in-process", "workers-ov"])
def test_super_batch_rows_are_jax_batches(workers, ov):
    n, b, G, seed = 22, 4, 3, 5
    if ov:  # canvases through yuv420, memoised in each worker; the tail padded
        ds = SyntheticOVDataset(size=n, seed=2, num_points=256, num_semcls=10, num_angle_bin=12)
        kw = dict(quantize=CODECS, encode_cache=("image",), drop_last=False)
    else:
        ds = SyntheticDataset(size=n, seed=2, num_points=256)
        kw = dict(drop_last=True)
    loader = L.DataLoader(ds, b, shuffle=True, seed=seed, num_workers=workers,
                          transfer="packed", super_batch=G, **kw)
    for epoch in range(2):
        loader.set_epoch(epoch)
        items = list(loader)
        order = jax_order(n, b, kw["drop_last"], seed, epoch)
        assert len(loader) == len(order)
        assert [rows.shape[0] for rows, _ in items] == [G] * (len(order) // G) + (
            [len(order) % G] if len(order) % G else [])
        got = [row for rows, _ in items for row in rows.numpy()]
        for (idxs, n_valid), row in zip(order, got, strict=True):
            batch = L.collate([ds[int(i)] for i in idxs])
            if not kw["drop_last"]:
                batch["valid_mask"] = (np.arange(b) < n_valid).astype(np.float32)
            want, metas = J.pack_batch(batch, kw.get("quantize", ()))
            assert items[0][1] == metas and np.array_equal(row, want)


def _training(cfg, seed: int = 0):
    return T.build_training(cfg, 10, device="cpu", seed=seed)


def test_packed_step_equals_tree_step_bit_for_bit():
    _, tm = tp.configs("float32")
    cfg = dataclasses.replace(tc.sunrgbd_quick(), model=dataclasses.replace(tm, mlp_dropout=0.3))
    batches = [tp.make_batch(seed=20 + i) for i in range(3)]
    tree, packed = _training(cfg), _training(cfg)
    step = T.PackedStep(packed, seed=7, device="cpu")
    assert step.graph is False  # the CPU runs it eagerly
    gen = torch.Generator()
    rows = [L.pack_batch(b) for b in batches]
    got, want = [], []
    for i, b in enumerate(batches):
        gen.manual_seed(T.step_seed(7, i))
        want.append(tree.train_step(T.batch_to_device(b, "cpu"), gen))
    # one item of 1 batch, then a group of 2
    got.append(step(torch.from_numpy(rows[0][0]), rows[0][1], 0)[0])
    metrics, last = step(torch.from_numpy(np.stack([rows[1][0], rows[2][0]])), rows[1][1], 1)
    got.append(metrics)
    assert torch.equal(last["point_clouds"], T.batch_to_device(batches[2], "cpu")["point_clouds"])
    for g, w in zip(got, want[::2]):
        assert set(g) == set(w) and all(torch.equal(g[k], w[k]) for k in w)
    for k, v in tree.model.state_dict().items():
        assert torch.equal(packed.model.state_dict()[k], v), k
    assert packed.optimizer.count == tree.optimizer.count == 3
    assert torch.equal(packed.optimizer.scalars, tree.optimizer.scalars)
    # restoring state with in-place copies keeps the step; rebinding breaks it
    packed.model.load_state_dict(tree.model.state_dict())
    step(torch.from_numpy(rows[0][0]), rows[0][1], 3)
    p = next(packed.model.parameters())
    p.data = p.data.clone()
    with pytest.raises(RuntimeError, match="rebound"):
        step(torch.from_numpy(rows[0][0]), rows[0][1], 4)


def test_q16_step_matches_jax_make_packed_step():
    """The first step on one q16 buffer: JAX's `make_packed_step` and the
    port's `PackedStep`, from the same weights, dropout at 0."""
    jm, tm = (tp.zero_dropout(m) for m in tp.configs("float32"))
    jq = dataclasses.replace(jc.sunrgbd_quick(), model=jm)
    jq = dataclasses.replace(jq, optim=dataclasses.replace(jq.optim, warm_lr_epochs=0))
    tq = dataclasses.replace(tc.sunrgbd_quick(), model=tm)
    tq = dataclasses.replace(tq, optim=dataclasses.replace(tq.optim, warm_lr_epochs=0))
    batch = tp.make_batch(seed=3)
    buf, metas = J.pack_batch(batch, ("point_clouds",))
    model, variables = tp.jax_model_and_variables(jm, batch)
    tx = jax_build_optimizer(jq.optim, jax_schedule(jq.optim, jq.max_epoch, 100))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                       frozen=jax.tree_util.tree_map(jnp.asarray, variables["frozen"]),
                       opt_state=tx.init(params))
    jstep = jax_make_packed_step(jax_make_train_step(model, tx, jq.loss, jm.num_angle_bin,
                                                     jm.num_semcls))
    _, want = jstep(state, jnp.asarray(buf), metas, jax.random.PRNGKey(0))

    net = Model3DETR(tm, device="cpu")
    net.load_state_dict(from_flax_variables(variables))
    schedule = T.make_lr_schedule(tq.optim, tq.max_epoch, 100)
    opt = T.build_optimizer(net, tq.optim, schedule)
    step = T.make_train_step(net, opt, tq.loss, tm.num_angle_bin, tm.num_semcls)
    packed = T.PackedStep(T.Training(net, opt, schedule, step, None), seed=0, device="cpu")
    got, _ = packed(torch.from_numpy(buf), metas, 0)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4, atol=1e-6, err_msg=k)


def test_multi_step_matches_jax_make_packed_multi_step():
    """Two steps on a group of 2 packed batches: JAX's
    `make_packed_multi_step` (one `lax.scan`) and the port's
    `make_packed_multi_step` (eager on the CPU), from the same weights,
    dropout at 0: the losses within 1e-4 relative on step 1 and 2e-3 on
    step 2 (`tests/test_torch_train.py`'s f32 bounds), grad_norm within
    1e-4 on step 1 (on step 2 it reads 2.7e-3 apart: JAX's scan body rounds
    otherwise than its one-step program, and a random-init step is
    ill-conditioned in f32, ROADMAP's reference-side notes); the port's
    stacked metrics equal two `PackedStep` steps bit for bit."""
    from ov3det.engine.train import make_packed_multi_step as jax_make_packed_multi_step

    jm, tm = (tp.zero_dropout(m) for m in tp.configs("float32"))
    jq = dataclasses.replace(jc.sunrgbd_quick(), model=jm)
    jq = dataclasses.replace(jq, optim=dataclasses.replace(jq.optim, warm_lr_epochs=0))
    tq = dataclasses.replace(tc.sunrgbd_quick(), model=tm)
    tq = dataclasses.replace(tq, optim=dataclasses.replace(tq.optim, warm_lr_epochs=0))
    batches = [tp.make_batch(seed=30 + i) for i in range(2)]
    packed = [J.pack_batch(b) for b in batches]
    assert packed[0][1] == packed[1][1]
    metas = packed[0][1]
    bufs = np.stack([buf for buf, _ in packed])
    model, variables = tp.jax_model_and_variables(jm, batches[0])
    tx = jax_build_optimizer(jq.optim, jax_schedule(jq.optim, jq.max_epoch, 100))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                       frozen=jax.tree_util.tree_map(jnp.asarray, variables["frozen"]),
                       opt_state=tx.init(params))
    jstep = jax_make_packed_multi_step(jax_make_train_step(model, tx, jq.loss, jm.num_angle_bin,
                                                           jm.num_semcls))
    _, want = jstep(state, jnp.asarray(bufs), metas, jax.random.PRNGKey(0))

    def port(multi: bool):
        net = Model3DETR(tm, device="cpu")
        net.load_state_dict(from_flax_variables(variables))
        schedule = T.make_lr_schedule(tq.optim, tq.max_epoch, 100)
        opt = T.build_optimizer(net, tq.optim, schedule)
        step = T.make_train_step(net, opt, tq.loss, tm.num_angle_bin, tm.num_semcls)
        training = T.Training(net, opt, schedule, step, None)
        if multi:
            return T.make_packed_multi_step(training, seed=0, device="cpu")(
                torch.from_numpy(bufs), metas, 0)[0], opt
        one = T.PackedStep(training, seed=0, device="cpu")
        ms = [one(torch.from_numpy(bufs[g]), metas, g)[0] for g in range(2)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}, opt

    (got, opt), (singles, _) = port(True), port(False)
    assert opt.count == 2 and set(got) == set(want) == set(singles)
    for k, w in want.items():
        assert got[k].shape == (2,) and torch.equal(got[k], singles[k]), k
        for g, rtol in ((0, 1e-4), (1, 2e-3))[:1 if k == "grad_norm" else 2]:
            np.testing.assert_allclose(float(got[k][g]), float(w[g]), rtol=rtol, atol=1e-6,
                                       err_msg=f"{k} step {g + 1}")
