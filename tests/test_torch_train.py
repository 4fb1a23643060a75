"""The port's training step on the CPU against the JAX package: GIoU, the
auction assignment, the criterion, the schedule, the optimiser, and two whole
`make_train_step` steps from the same weights.

Tolerances.  Where both sides get identical inputs (GIoU, auction,
criterion, optimiser, schedule) only f32 rounding differs: 1e-5 relative
(the optimiser's parameters 1e-6).  The whole step is the detector in
training mode at f32, and there the two frameworks cannot agree closer than
about 1e-4: training-mode BatchNorm normalises post-ReLU features whose mean
is about three standard deviations, so each of the SA MLP's BatchNorms
multiplies the ~1e-7 summation-order noise by 4-16 (measured: 3.6e-7 in the
eval forward, 7.9e-5 on the same pre-encoder output in training, relative
1.1e-5).  Adam then turns the noise of gradient elements near zero into
opposite-sign updates of up to the learning rate.  So the step is held
to: equal matched masks; losses and grad_norm within 1e-4 relative on the
first step and 2e-3 on the second; after the first step 99.5 % of the
parameters within 1e-6 and all within 2 lr; BN running statistics within
1e-4; `gauss_B` (decay only) within 1e-6 after both steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ov3det import config as jc
from ov3det.engine.schedule import make_lr_schedule as jax_schedule
from ov3det.engine.train import build_optimizer as jax_build_optimizer
from ov3det.geometry import boxes as jboxes
from ov3det.geometry.iou import generalized_box3d_iou as jax_giou
from ov3det.losses.criterion import compute_assignments as jax_assignments
from ov3det.losses.criterion import set_criterion as jax_criterion
from ov3det.ops import auction_lap as jax_auction
from ov3det_torch import config as tc
from ov3det_torch.engine import train as T
from ov3det_torch.geometry import boxes as tboxes
from ov3det_torch.geometry.iou import generalized_box3d_iou
from ov3det_torch.losses.criterion import set_criterion
from ov3det_torch.ops.hungarian import auction_lap
from tests import torch_parity as tp

LR = 5e-4


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")  # the TPU's ball-group, interpreted


def _t(a):
    return torch.from_numpy(np.array(a))


def _corners(center, size, angle):
    c = jboxes.corners_from_upright_depth_param(jnp.asarray(center), jnp.asarray(size),
                                                jnp.asarray(angle))
    return np.asarray(c, np.float32)


# ------------------------------------------------------------ box helpers
def test_training_box_helpers_match_jax():
    rng = np.random.default_rng(0)
    angle = rng.uniform(-7, 7, (4, 9)).astype(np.float32)
    jcls, jres = jboxes.angle_to_bin(jnp.asarray(angle), 12)
    cls, res = tboxes.angle_to_bin(_t(angle), 12)
    np.testing.assert_array_equal(cls.numpy(), np.asarray(jcls))
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=0, atol=1e-6)
    center = rng.normal(size=(4, 9, 3)).astype(np.float32)
    half = rng.uniform(0.1, 1, (4, 9, 3)).astype(np.float32)
    want = jboxes.gt_corners_upright_depth(jnp.asarray(center), jnp.asarray(half), jnp.asarray(angle))
    got = tboxes.gt_corners_upright_depth(_t(center), _t(half), _t(angle))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    corners = _corners(center, 2 * half, angle)
    np.testing.assert_allclose(tboxes.box_volume_from_corners(_t(corners)).numpy(),
                               np.asarray(jboxes.box_volume_from_corners(jnp.asarray(corners))),
                               rtol=1e-6)


# ------------------------------------------------------------------ GIoU
def _giou_case(name):
    rng = np.random.default_rng(1)
    B, K1, K2 = 2, 12, 9
    c1 = rng.uniform(-2, 2, (B, K1, 3)).astype(np.float32)
    s1 = rng.uniform(0.3, 1.5, (B, K1, 3)).astype(np.float32)
    a1 = rng.uniform(-np.pi, np.pi, (B, K1)).astype(np.float32)
    if name == "identical":
        a1[0] = 0.0  # unrotated in scene 0, where the GIoU of a box with itself is 1
    c2, s2, a2 = c1[:, :K2].copy(), s1[:, :K2].copy(), a1[:, :K2].copy()
    if name == "random":
        c2 += rng.normal(0, 0.3, c2.shape).astype(np.float32)
        a2 = rng.uniform(-np.pi, np.pi, (B, K2)).astype(np.float32)
    elif name == "touching":  # unrotated boxes sharing a face, and one offset along it
        a1[:] = 0.0
        a2[:] = 0.0
        c2[..., 0] += s1[:, :K2, 0]
        s2[:] = s1[:, :K2]
    elif name == "contained":  # a smaller box inside, rotated and not
        s2 *= 0.5
        a2[:, ::2] += 0.3
    elif name == "rotated":  # the same boxes turned by 45 and 90 degrees
        a2 += np.where(np.arange(K2) % 2 == 0, np.pi / 4, np.pi / 2).astype(np.float32)
    n = np.array([K2, K2 - 3])
    return _corners(c1, s1, a1), _corners(c2, s2, a2), n


@pytest.mark.parametrize("name", ["random", "identical", "touching", "contained", "rotated"])
@pytest.mark.parametrize("rotated", [True, False])
def test_generalized_box3d_iou_matches_jax(name, rotated):
    k1, k2, n = _giou_case(name)
    want = np.asarray(jax_giou(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(n),
                               rotated_boxes=rotated))
    got = generalized_box3d_iou(_t(k1), _t(k2), _t(n), rotated_boxes=rotated)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if name == "identical":
        K2 = k2.shape[1]
        diag = got.numpy()[0, np.arange(K2), np.arange(K2)]
        np.testing.assert_allclose(diag, 1.0, atol=1e-5)
    assert (got.numpy()[1, :, n[1]:] == 0).all()  # padded targets


def test_generalized_box3d_iou_bf16_and_gradient_match_jax():
    k1, k2, n = _giou_case("random")
    want = np.asarray(jax_giou(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(n),
                               compute_dtype=jnp.bfloat16))
    got = generalized_box3d_iou(_t(k1), _t(k2), _t(n), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2)

    w = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    jg = jax.grad(lambda c: jnp.sum(jax_giou(c, jnp.asarray(k2), jnp.asarray(n)) * w))(
        jnp.asarray(k1))
    c = _t(k1).requires_grad_()
    (generalized_box3d_iou(c, _t(k2), _t(n)) * _t(w)).sum().backward()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ auction LAP
def _cost_case(name):
    rng = np.random.default_rng(3)
    B, P, O = 6, 10, 32
    cost = rng.uniform(0, 5, (B, P, O)).astype(np.float32)
    n = np.array([10, 7, 0, 1, 10, 4])
    if name == "near_duplicate":  # GT rows a hair apart: long price wars
        cost[:, 1::2] = cost[:, 0:-1:2] + rng.normal(0, 1e-5, (B, P // 2, O)).astype(np.float32)
    return cost, n


@pytest.mark.parametrize("name", ["random", "near_duplicate"])
def test_auction_lap_gives_jax_assignments(name):
    cost, n = _cost_case(name)
    want = [np.asarray(a) for a in jax_auction(jnp.asarray(cost), jnp.asarray(n, jnp.int32))]
    got = auction_lap(_t(cost), _t(n))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[1].sum(1).tolist() == n.tolist()  # one proposal per live GT


def test_auction_lap_fallback_phases_match_jax():
    # caps so low that the tight phase fails and the loose phase or the
    # rank-matching fallback has to finish the job
    cost, n = _cost_case("near_duplicate")
    for tight, loose in ((3, 800), (2, 2)):
        want = [np.asarray(a) for a in jax_auction(jnp.asarray(cost), jnp.asarray(n, jnp.int32),
                                                    tight_iters=tight, loose_iters=loose)]
        got = auction_lap(_t(cost), _t(n), tight_iters=tight, loose_iters=loose)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


# ------------------------------------------------------------ criterion
def _outputs(batch, L=3, Q=24, C=10, nbins=12, seed=4):
    """Random stacked model outputs (L, B, Q, ...) with consistent boxes
    (unrotated with one angle bin, as the detector decodes them)."""
    rng = np.random.default_rng(seed)
    B = batch["point_clouds"].shape[0]
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    centers = rng.uniform(-2, 2, (L, B, Q, 3)).astype(np.float32)
    sizes = rng.uniform(0.2, 1.5, (L, B, Q, 3)).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, (L, B, Q)).astype(np.float32) * (nbins > 1)
    logits = f(L, B, Q, C + 1)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    lo, hi = batch["point_cloud_dims_min"], batch["point_cloud_dims_max"]
    return {
        "box_corners": _corners(centers, sizes, angles),
        "center_normalized": ((centers - lo[None, :, None]) / (hi - lo)[None, :, None]).astype(np.float32),
        "size_normalized": rng.uniform(0, 1, (L, B, Q, 3)).astype(np.float32),
        "sem_cls_logits": logits,
        "sem_cls_prob": probs[..., :-1].astype(np.float32),
        "objectness_prob": (1 - probs[..., -1]).astype(np.float32),
        "angle_logits": f(L, B, Q, nbins),
        "angle_residual_normalized": f(L, B, Q, nbins),
    }


def _criterion_case(case):
    """(batch, outputs, JAX loss config, port loss config, angle bins)."""
    if case == "scannet_masked":  # 3DETR-m: axis-aligned boxes, its run script's weights
        from ov3det.datasets import make_batch as jax_make_batch

        batch = jax_make_batch(np.random.default_rng(5), batch_size=2, num_points=2048,
                               num_semcls=10, num_angle_bin=1)
        kw = dict(giou_weight=1.0, no_object_weight=0.25)
        return (batch, _outputs(batch, nbins=1),
                dataclasses.replace(jc.scannet_quick().loss, matcher=jc.MatcherConfig(1, 0, 0, 2),
                                    **kw),
                dataclasses.replace(tc.scannet_quick().loss, matcher=tc.MatcherConfig(1, 0, 0, 2),
                                    **kw), 1)
    batch = tp.make_batch(seed=5)
    return (batch, _outputs(batch),
            dataclasses.replace(jc.sunrgbd_quick().loss, matcher_giou=case, giou_weight=1.0),
            dataclasses.replace(tc.sunrgbd_quick().loss, matcher_giou=case, giou_weight=1.0), 12)


@pytest.mark.parametrize("case", ["rotated", "axis_aligned", "scannet_masked"])
def test_set_criterion_matches_jax(case):
    batch, out, jloss, tloss, nbins = _criterion_case(case)
    grad_keys = ("center_normalized", "size_normalized", "sem_cls_logits", "angle_logits",
                 "angle_residual_normalized", "box_corners")

    def jtotal(diff):
        o = dict({k: jnp.asarray(v) for k, v in out.items()}, **diff)
        return jax_criterion(o, {k: jnp.asarray(v) for k, v in batch.items()}, jloss,
                             num_angle_bin=nbins, num_semcls=10)

    (_, want), jgrads = jax.value_and_grad(jtotal, has_aux=True)(
        {k: jnp.asarray(out[k]) for k in grad_keys})
    want = {k: float(v) for k, v in want.items()}
    jassign = jax_assignments({k: jnp.asarray(v) for k, v in out.items()},
                              dict({k: jnp.asarray(v) for k, v in batch.items()},
                                   nactual_gt=jnp.asarray(batch["gt_box_present"].sum(1), jnp.int32)),
                              jloss, rotated_boxes=nbins > 1)

    tout = {k: _t(v).requires_grad_(k in grad_keys) for k, v in out.items()}
    total, got = set_criterion(tout, T.batch_to_device(batch, "cpu"), tloss, nbins, 10)
    assert set(got) == set(want) and "loss_cardinality" in got and "loss_center_1" in got
    for k, w in want.items():
        np.testing.assert_allclose(got[k].item(), w, rtol=1e-5, atol=1e-7, err_msg=k)
    total.backward()
    for k in grad_keys:
        np.testing.assert_allclose(tout[k].grad.numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    if case == "scannet_masked":  # the GIoU loss carries gradient into the corners
        assert got["loss_giou"].item() > 0 and tout["box_corners"].grad.abs().sum() > 0

    from ov3det_torch.losses.criterion import compute_assignments
    targets = dict(T.batch_to_device(batch, "cpu"),
                   nactual_gt=_t(batch["gt_box_present"].sum(1)).long())
    assign = compute_assignments({k: v.detach() for k, v in tout.items()}, targets, tloss,
                                 nbins > 1)
    for k in ("per_prop_gt_inds", "proposal_matched_mask"):
        np.testing.assert_array_equal(assign[k].numpy(), np.asarray(jassign[k]), err_msg=k)


def test_set_criterion_rejects_the_teacher():
    """Once a refusal pin, now the 2D-alignment branch the open-vocabulary
    step ported (the name kept): the teacher's features, shared (B, Q, C)
    or per layer (L, B, Q, C), against `visual_embeds` in f32 and in bf16
    (the bf16 detector's).  The port computes in f32 and, as JAX does, takes
    the norm of bf16 embeds in bf16 (the squares' f32 sum rounded to bf16,
    its root rounded to bf16).  The losses and the weighted total equal
    JAX's within 1e-5 relative with either dtype; the gradient into
    `visual_embeds` within 1e-5 relative in f32 and, in bf16, within 5e-3
    of the largest value (about one bf16 ulp there: the two frameworks round
    the backward's bf16 terms at other places)."""
    batch = tp.make_batch(seed=5)
    out = _outputs(batch)
    rng = np.random.default_rng(11)
    embeds = rng.normal(size=(3, 2, 24, 16)).astype(np.float32)
    jloss = dataclasses.replace(jc.sunrgbd_quick().loss, alignment_2d_weight=0.5)
    tloss = dataclasses.replace(tc.sunrgbd_quick().loss, alignment_2d_weight=0.5)
    for dtype, rtol in (("float32", 1e-5), ("bfloat16", 1e-5)):
        v0 = jnp.asarray(embeds, dtype)
        for shape in ((2, 24, 16), (3, 2, 24, 16)):
            feats = rng.normal(size=shape).astype(np.float32)

            def jtotal(v):
                o = dict({k: jnp.asarray(x) for k, x in out.items()}, visual_embeds=v)
                return jax_criterion(o, {k: jnp.asarray(x) for k, x in batch.items()}, jloss,
                                     num_angle_bin=12, num_semcls=10,
                                     teacher_feats=jnp.asarray(feats))

            (_, want), jgrad = jax.value_and_grad(jtotal, has_aux=True)(v0)
            tout = {k: _t(v) for k, v in out.items()}
            tout["visual_embeds"] = _t(np.asarray(v0, np.float32)).to(
                getattr(torch, dtype)).requires_grad_()
            total, got = set_criterion(tout, T.batch_to_device(batch, "cpu"), tloss, 12, 10,
                                       teacher_feats=_t(feats))
            assert set(got) == set(want) and "loss_2dalignment_1" in got
            for k in ("loss_2dalignment", "loss_2dalignment_0", "loss_2dalignment_1", "loss"):
                np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=rtol,
                                           err_msg=f"{k}, {dtype}, {shape}")
            assert got["loss_2dalignment"].item() > 0
            total.backward()
            jg = np.asarray(jgrad, np.float32)
            np.testing.assert_allclose(
                tout["visual_embeds"].grad.float().numpy(), jg,
                **(dict(rtol=1e-5, atol=1e-7) if dtype == "float32"
                   else dict(rtol=0, atol=5e-3 * np.abs(jg).max())))
    tc.LossConfig(alignment_2d_weight=1.0)  # accepted


# ------------------------------------------------------ schedule, optimiser
@pytest.mark.parametrize("warm", [0, 9])
def test_lr_schedule_matches_jax(warm):
    cfg_j = dataclasses.replace(jc.OptimConfig(), warm_lr_epochs=warm)
    cfg_t = dataclasses.replace(tc.OptimConfig(), warm_lr_epochs=warm)
    sj, st = jax_schedule(cfg_j, 90, 50), T.make_lr_schedule(cfg_t, 90, 50)
    steps = [0, 1, 100, 449, 450, 451, 2000, 4499, 4500, 9000]
    # JAX evaluates the schedule in f32 (its cosine near the end of the run
    # loses ~1e-6 relative); the port's is in Python floats
    np.testing.assert_allclose([st(s) for s in steps], [float(sj(s)) for s in steps],
                               rtol=1e-5, atol=0)
    if warm == 0:
        assert st(0) == cfg_t.base_lr


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("filter_biases_wd", [False, True])
def test_adamw_matches_optax(filter_biases_wd, staged):
    """`staged`: the steps staged as `PackedStep` stages a group, the
    scalars of 3 updates in one copy, one row a step."""
    rng = np.random.default_rng(6)
    shapes = {"w": (5, 4), "b": (4,), "frozen_at_use": (3, 6)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cfg_j = dataclasses.replace(jc.OptimConfig(), warm_lr_epochs=0, filter_biases_wd=filter_biases_wd)
    cfg_t = dataclasses.replace(tc.OptimConfig(), warm_lr_epochs=0, filter_biases_wd=filter_biases_wd)
    tx = jax_build_optimizer(cfg_j, jax_schedule(cfg_j, 2, 2))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tparams = [torch.nn.Parameter(_t(params[k])) for k in shapes]
    opt = T.AdamW(tparams, cfg_t, T.make_lr_schedule(cfg_t, 2, 2))
    table = opt.scalar_rows(3)
    for step, scale in enumerate((0.01, 5.0, 0.02)):  # below and above the clip
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
        grads["frozen_at_use"][:] = 0.0  # stopped at use: zero in JAX, None here
        upd, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(tparams, shapes):
            p.grad = None if k == "frozen_at_use" else _t(grads[k])
        if staged:
            opt.stage(table[step])
            g_norm = opt.apply()
        else:
            g_norm = opt.step()
        np.testing.assert_allclose(float(g_norm), float(optax.global_norm(grads)), rtol=1e-6)
        for p, k in zip(tparams, shapes):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=f"{k} after step {step}")
    # no gradient ever reached it: the decay alone moved it
    assert (tparams[2].detach().numpy() != params["frozen_at_use"]).all()
    assert opt.count == 3


# ------------------------------------------------------------ whole step
def test_two_training_steps_match_jax_make_train_step():
    jm, tm = tp.configs("float32")
    jq, tq = jc.sunrgbd_quick(), tc.sunrgbd_quick()
    tp.assert_two_steps_match(tp.make_batch(seed=0), jq, tq, jm, tm, LR)


def test_build_training_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.build_training(tc.sunrgbd_quick(), iters_per_epoch=10)
    _, tm = tp.configs("float32")
    cfg = dataclasses.replace(tc.sunrgbd_quick(), model=tm)
    training = T.build_training(cfg, iters_per_epoch=10, device="cpu", seed=1)
    assert next(training.model.parameters()).device.type == "cpu"
    assert training.schedule(0) == pytest.approx(cfg.optim.warm_lr)
    metrics = training.train_step(T.batch_to_device(tp.make_batch(seed=2), "cpu"),
                                  torch.Generator().manual_seed(3))
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert training.optimizer.count == 1
