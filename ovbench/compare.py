"""The numbers that decide `correct`, each held against its cell's limit.

Training cells (the program's readings are taken in set-up, from the
first three steps the window's own call runs; the reference follows the
same three from the same weights, batches and dropout seeds):

  loss_gap    the largest relative gap of a step's total loss
              (`loss_gap_first`: the first step's);
  align_gap   the same of the 2D-alignment loss (cells with the teacher);
  feature_gap the teacher's region features in each checked step against
              the reference teacher's on the same canvases and the
              program's own boxes: the relative gap of all the step's
              features together, the largest over the steps;
  grad_gap    the first gradient as the optimiser got it (its first moment
              after step 1 over 1 - b1), by the worst leaf: the gap of the
              two norms over the larger of the reference leaf's norm and the
              median leaf's;
  change_gap  the parameters' change over the three steps, the same way,
              over the leaves whose reference gradient is above a
              thousandth of the median leaf's (a key's bias under softmax
              moves by round-off alone);
  grad_median_gap, change_median_gap
              the same by the median leaf: steady where the worst leaf's
              reading is the matcher's near-tied assignment swinging;
  forward_prob_gap, forward_box_gap
              the first step's forward (training mode, the same weights and
              dropout masks), its last decoder layer, as `prob_gap` and
              `box_gap` below: no matcher before it.

Detection cells (a sample of the window's requests, drawn from the seed):

  prob_gap    the largest gap of a class or objectness probability;
  box_gap     the largest gap, in metres, of a box's centre or of one of
              its three edge lengths (the heading's bin is an argmax of
              near-equal logits with random weights, so corners are
              compared through what the heading does not move);
  parse_miss  boxes kept or dropped unlike the reference's parse of the
              program's own forward outputs, plus detections unlike the
              reference's assembly of them: an exact comparison.
"""
from __future__ import annotations

import math

import numpy as np
import torch

B1, B2 = 0.9, 0.999
QUIET = 1e-3  # a leaf moves by round-off alone below this share of the median leaf's gradient


def rel_gap(got: float, want: float) -> float:
    if not math.isfinite(got):
        return math.inf
    return abs(got - want) / max(abs(want), 1e-12)


def leaf_gaps(got: list, want: list, keep=None) -> torch.Tensor:
    """Each leaf's | |got| - |want| | / max(|want|, the median |want|)."""
    g = torch.stack([t.double().norm() for t in got])
    w = torch.stack([t.double().norm() for t in want])
    if keep is not None:
        g, w = g[keep], w[keep]
    if not torch.isfinite(g).all():
        return torch.full_like(g, math.inf)
    floor = torch.clamp(w, min=float(w.median()))
    return (g - w).abs() / torch.clamp(floor, min=1e-30)


def feature_gap(got: list, want: list) -> float:
    """The largest over the steps of | F_got - F_want | / | F_want | over all
    of a step's regions; `want` None (boxes not one set a canvas) or a
    number that is not finite reads inf."""
    gap = 0.0
    for (_, f), w in zip(got, want):
        if w is None or w.shape != f.shape or not torch.isfinite(f).all():
            return math.inf
        gap = max(gap, float((f.double() - w.double()).norm() / w.double().norm()))
    return gap


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [{name: value}] a step, "mu1": [leaf], "p0",
    "p3": [leaf]} (host tensors in parameter order); with a teacher, prog's
    "teacher" [(boxes, features)] a step and ref's "teacher_on_judged" (the
    reference teacher's features on those boxes).  Every number a cell can
    compare; its limits pick those it does: the `_median` ones are the
    median leaf's gap where the worst leaf's is the noise of the matcher."""
    gaps = [rel_gap(p["loss"], r["loss"]) for p, r in zip(prog["losses"], ref["losses"])]
    out = {"loss_gap": max(gaps), "loss_gap_first": gaps[0]}
    if "teacher" in prog:
        out["align_gap"] = max(rel_gap(p["loss_2dalignment"], r["loss_2dalignment"])
                               for p, r in zip(prog["losses"], ref["losses"]))
        out["feature_gap"] = feature_gap(prog["teacher"], ref["teacher_on_judged"])
    g_p = [m / (1 - B1) for m in prog["mu1"]]
    g_r = [m / (1 - B1) for m in ref["mu1"]]
    grad = leaf_gaps(g_p, g_r)
    norms = torch.stack([t.double().norm() for t in g_r])
    moved = norms >= QUIET * float(norms.median())
    change = leaf_gaps([b - a for a, b in zip(prog["p0"], prog["p3"])],
                       [b - a for a, b in zip(ref["p0"], ref["p3"])], moved)
    out.update(grad_gap=float(grad.max()), grad_median_gap=float(grad.median()),
               change_gap=float(change.max()), change_median_gap=float(change.median()))
    fwd = detect_numbers([tuple(t.numpy() for t in prog["forward"])],
                         [tuple(t.numpy() for t in ref["forward"])], 0)
    out.update(forward_prob_gap=fwd["prob_gap"], forward_box_gap=fwd["box_gap"])
    return out


def worst_leaves(prog: dict, ref: dict, names: list, top: int = 3) -> dict:
    """The leaves that read worst in `grad_gap` and `change_gap`, with their
    gaps: what a reading that is too high is looked into by."""
    def gaps(got, want):
        g = torch.stack([t.double().norm() for t in got])
        w = torch.stack([t.double().norm() for t in want])
        return ((g - w).abs() / torch.clamp(w, min=float(w.median()))).tolist()

    g = gaps([m / (1 - B1) for m in prog["mu1"]], [m / (1 - B1) for m in ref["mu1"]])
    c = gaps([b - a for a, b in zip(prog["p0"], prog["p3"])],
             [b - a for a, b in zip(ref["p0"], ref["p3"])])
    pick = lambda v: sorted(zip(v, names), reverse=True)[:top]  # noqa: E731
    return {"grad": pick(g), "change": pick(c)}


def _centres_edges(corners: np.ndarray) -> tuple:
    c = corners.astype(np.float64)
    edge = lambda i, j: np.linalg.norm(c[..., i, :] - c[..., j, :], axis=-1)  # noqa: E731
    return c.mean(axis=-2), np.stack([edge(0, 1), edge(1, 2), edge(0, 4)], -1)


def detect_numbers(prog: list, ref: list, misses: int) -> dict:
    """prog, ref: per sampled request (corners (B, K, 8, 3), sem_cls_prob
    (B, K, C), objectness_prob (B, K)) as numpy; misses: parse_miss."""
    prob, box = 0.0, 0.0
    for (pc, ps, po), (rc, rs, ro) in zip(prog, ref):
        if pc.shape != rc.shape or not (np.isfinite(pc).all() and np.isfinite(ps).all()
                                        and np.isfinite(po).all()):
            return {"prob_gap": math.inf, "box_gap": math.inf, "parse_miss": misses}
        prob = max(prob, float(np.abs(ps - rs).max()), float(np.abs(po - ro).max()))
        (cp, ep), (cr, er) = _centres_edges(pc), _centres_edges(rc)
        box = max(box, float(np.abs(cp - cr).max()), float(np.abs(ep - er).max()))
    return {"prob_gap": prob, "box_gap": box, "parse_miss": misses}


def same_detections(got: list, want: list) -> int:
    """Scenes whose detection triples differ in any bit."""
    bad = 0
    for (gc, gb, gs), (wc, wb, ws) in zip(got, want):
        if not (np.array_equal(gc, wc) and np.array_equal(gb, wb) and np.array_equal(gs, ws)):
            bad += 1
    return bad + abs(len(got) - len(want))


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number the cell has a limit
    for at or under it."""
    rows = [(k, numbers[k], lim) for k, lim in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
