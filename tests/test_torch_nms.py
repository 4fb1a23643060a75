"""The port's NMS on the CPU against `ov3det.geometry.nms`, and the greedy
order of the NMS kernel (`ov3det_torch/csrc/nms.cu`) emulated in numpy.

- `nms_3d`, `nms_3d_class_aware` and `nms_2d`, each with and without
  `old_type`, at K = 8, 128 and 256 on seeded scenes with exact score ties,
  invalid boxes, NaN, -inf and -1e30 scores, zero-volume boxes and pairs at
  exactly the threshold: the keep masks of the port's plain version equal
  JAX's `vmap` of the same function.  The boxes lie on a grid of 1/8, so
  every overlap is computed exactly by both (the products of a few grid
  values are exact in f32; the one division is rounded alike), and the
  comparison with the threshold agrees pair for pair; the test checks that
  before it compares the masks.
- The kernel's greedy pass (rank the boxes by NaN first, then descending
  score, ties to the lower index; build the suppression bitmask; scan it
  once) emulated in numpy gives the plain version's K argmax rounds' keep
  mask on the same cases: the two orders agree on ties, on NaN and on the
  scores the rounds never keep.
- The wrapper's checks: a non-f32 box or score, a class array of another
  dtype, and mismatched shapes raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.geometry import nms as jnms
from ov3det_torch.geometry import nms as tnms

THRESH = 0.25


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def scenes(seed: int, B: int, K: int, D: int):
    """(boxes (B, K, 2D), scores (B, K), classes (B, K), valid (B, K)) with
    every hard case of the greedy rule."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 16, (B, K, D)) / 8.0
    ext = rng.integers(1, 10, (B, K, D)) / 8.0
    boxes = np.concatenate([lo, lo + ext], -1).astype(np.float32)
    scores = (rng.integers(0, 12, (B, K)) / 16.0).astype(np.float32)  # many exact ties
    classes = rng.integers(0, 3, (B, K)).astype(np.int64)
    valid = rng.random((B, K)) > 0.2
    if K >= 8:
        # a pair at exactly the threshold: inter 1/4 of a unit box, union 1
        boxes[0, 0] = [0.0] * D + [1.0] * D
        boxes[0, 1] = [0.0] * D + [1.0] * (D - 1) + [0.25]
        scores[0, :2] = [0.9, 0.8]
        classes[0, :2] = 0
        valid[0, :2] = True
        boxes[0, 2, D:] = boxes[0, 2, :D]  # zero volume
        scores[0, 3] = np.nan
        scores[0, 4] = -np.inf
        scores[0, 5] = -1e30
        scores[0, 6] = -6e29
        boxes[0, 7] = boxes[0, 6]  # a duplicate of a box that is never kept
        valid[-1] = False  # a scene with nothing valid
    return boxes, scores, classes, valid


def jax_keep(kind: str, boxes, scores, classes, valid, old_type: bool) -> np.ndarray:
    if kind == "class_aware":
        fn = jax.vmap(lambda b, s, c, v: jnms.nms_3d_class_aware(b, s, c, THRESH, v, old_type))
        return np.asarray(fn(boxes, scores, classes, valid))
    f = jnms.nms_3d if kind == "3d" else jnms.nms_2d
    return np.asarray(jax.vmap(lambda b, s, v: f(b, s, THRESH, v, old_type))(boxes, scores, valid))


def port_keep(kind: str, boxes, scores, classes, valid, old_type: bool) -> np.ndarray:
    t = {k: torch.from_numpy(v) for k, v in
         dict(boxes=boxes, scores=scores, classes=classes, valid=valid).items()}
    if kind == "class_aware":
        keep = tnms.nms_3d_class_aware(t["boxes"], t["scores"], t["classes"], THRESH, t["valid"],
                                       old_type=old_type)
    else:
        f = tnms.nms_3d if kind == "3d" else tnms.nms_2d
        keep = f(t["boxes"], t["scores"], THRESH, t["valid"], old_type=old_type)
    assert keep.dtype == torch.bool and keep.shape == scores.shape
    return keep.numpy()


def suppression(kind: str, boxes, classes, old_type: bool):
    """Each package's (B, K, K) `overlap > THRESH` (with the class mask)."""
    D = boxes.shape[-1] // 2
    theirs = jax.vmap(lambda b: jnms._aabb_overlap_matrix(b[:, :D], b[:, D:], old_type))(boxes)
    t = torch.from_numpy(boxes)
    ours = tnms._aabb_overlap_matrix(t[..., :D], t[..., D:], old_type)
    if kind == "class_aware":
        same = classes[:, :, None] == classes[:, None, :]
        theirs = theirs * same
        ours = ours * torch.from_numpy(same)
    return np.asarray(theirs) > THRESH, (ours > THRESH).numpy()


CASES = [(kind, old, K) for kind in ("class_aware", "3d", "2d") for old in (False, True)
         for K in (8, 128, 256)]


@pytest.mark.parametrize("kind,old_type,K", CASES)
def test_keep_masks_equal_jax(kind, old_type, K):
    D = 2 if kind == "2d" else 3
    boxes, scores, classes, valid = scenes(K + D + int(old_type), 3, K, D)
    theirs, ours = suppression(kind, boxes, classes, old_type)
    np.testing.assert_array_equal(ours, theirs)  # every pair compares alike
    want = jax_keep(kind, boxes, scores, classes, valid, old_type)
    got = port_keep(kind, boxes, scores, classes, valid, old_type)
    np.testing.assert_array_equal(got, want)
    assert not got[-1].any()  # nothing valid, nothing kept
    if K >= 8:
        assert got[0, 0] and not got[0, 3:7].any()
        if kind != "2d" and not old_type:
            assert got[0, 1]  # IoU exactly at the threshold does not suppress
    assert 0 < got.sum() < valid.sum()


def kernel_order_keep(boxes, scores, classes, valid, old_type: bool) -> np.ndarray:
    """The kernel's greedy pass in numpy: ranks by counting, a bitmask of
    `overlap > THRESH`, one scan in rank order."""
    B, K = scores.shape
    D = boxes.shape[-1] // 2
    t = torch.from_numpy(boxes)
    ov = tnms._aabb_overlap_matrix(t[..., :D], t[..., D:], old_type)
    if classes is not None:
        ov = ov * torch.from_numpy(classes[:, :, None] == classes[:, None, :])
    mask = (ov > THRESH).numpy()
    keep = np.zeros((B, K), bool)
    for b in range(B):
        s = scores[b]

        def before(a: int, c: int) -> bool:
            na, nc = np.isnan(s[a]), np.isnan(s[c])
            if na != nc:
                return bool(na)
            if not na and s[a] != s[c]:
                return bool(s[a] > s[c])
            return a < c

        order = [None] * K
        for i in range(K):
            order[sum(before(j, i) for j in range(K))] = i
        alive = valid[b].copy()
        for j in order:
            nan = np.isnan(s[j])
            if not nan and not s[j] > np.float32(-5e29):
                break
            if not alive[j]:
                continue
            if not nan:
                keep[b, j] = True
                alive &= ~mask[b, j]
            alive[j] = False
    return keep


@pytest.mark.parametrize("kind,old_type", [("class_aware", False), ("3d", True), ("2d", False)])
def test_kernel_order_equals_argmax_rounds(kind, old_type):
    D = 2 if kind == "2d" else 3
    for seed, K in ((0, 8), (1, 40), (2, 96)):
        boxes, scores, classes, valid = scenes(seed, 4, K, D)
        scores[1, ::3] = scores[1, 0]  # one score on a third of the scene
        scores[2, 1::4] = np.nan
        cls = classes if kind == "class_aware" else None
        want = tnms.nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores), THRESH,
                              torch.from_numpy(valid),
                              None if cls is None else torch.from_numpy(cls), old_type).numpy()
        got = kernel_order_keep(boxes, scores, cls, valid, old_type)
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
        assert want.any()


def test_wrapper_checks():
    boxes, scores, classes, valid = (torch.from_numpy(a) for a in scenes(0, 2, 8, 3))
    with pytest.raises(ValueError, match="f32 boxes"):
        tnms.nms_3d(boxes.double(), scores, THRESH, valid)
    with pytest.raises(ValueError, match="f32 scores"):
        tnms.nms_3d(boxes, scores.half(), THRESH, valid)
    with pytest.raises(ValueError, match="int64 classes"):
        tnms.nms_3d_class_aware(boxes, scores, classes.int(), THRESH, valid)
    with pytest.raises(ValueError, match="valid mask"):
        tnms.nms_2d(boxes[..., :4], scores, THRESH, valid[:, :4])
    # valid defaults to every box
    full = tnms.nms_3d(boxes, scores, THRESH)
    assert torch.equal(full, tnms.nms_3d(boxes, scores, THRESH, torch.ones_like(valid)))
