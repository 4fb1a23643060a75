"""The training step: forward in train mode, set criterion, backward, clip
and AdamW.

Counterpart of `ov3det/engine/train.py:39-177, 317-352` (`build_optimizer`,
`make_train_step`, `build_training`).  The optimiser is written out here
rather than taken from `torch.optim`, because the JAX step is
`optax.chain(clip_by_global_norm, adamw)` and two of its rules differ from
`clip_grad_norm_` + `torch.optim.AdamW`:
  * the clip scales by max_norm / g_norm when g_norm >= max_norm, with no
    `+ 1e-6` in the denominator (the port multiplies by that factor, which
    may differ from optax's (t / g_norm) * max_norm in the last bit);
  * every parameter is decayed (`filter_biases_wd=False`), including
    `pos_embedding.gauss_B`, whose gradient is stopped at use: its Adam
    moments stay zero and only the decay moves it.  `torch.optim.AdamW`
    skips a parameter whose `.grad` is None; here a missing gradient is a
    zero gradient.
Adam as optax has it: b1 0.9, b2 0.999, eps 1e-8 outside the square root,
bias correction with the count after the increment, the decay added to the
Adam direction before the learning rate scales it, the learning rate
`schedule(count)` with count 0 at the first update.

Data parallelism (`ov3det_torch.parallel`), in place of the JAX step's
GSPMD over the `data` mesh: each rank runs the step on its rows of the
global batch, the criterion gives it its share of the global loss, and the
gradients are summed over the ranks in one all-reduce between the backward
and the clip, so that the clip, `grad_norm` and the update see the global
gradient on every rank, as `optax.global_norm(grads)` sees it.  The state
is replicated from rank 0 when it is built.

The image bank (`--image_bank`, `ov3det_torch.datasets.image_bank`): the
step gathers the rows of its batch's `image_ref` from the bank on the
device and decodes them into the canvases before the teacher
(`decode_banked_images`, `ov3det/engine/train.py:93-110`).

The packed steps (`make_packed_step`, `make_packed_group_step`,
`ov3det/engine/train.py:180-197, 235-278`): `PackedStep` unpacks a packed
row on the device (`datasets.loader.unpack_batch`) and runs the step on it.
On CUDA it is one CUDA-graph replay a batch, JAX's one dispatch: the first
batch of a layout runs eagerly on a side stream (the warm-up, a real step),
then `train_step(unpack_batch(static row), generator)` is captured once; a
batch is a device-to-device copy into the static row, the AdamW scalars
(`AdamW.scalars`, staged from the host, a group's in one copy) and the
dropout generator reseeded from `(seed, iteration)`, then one replay.  A
group of G rows (`super_batch`) is G replays after its one copy to the
card, each seeded as the ungrouped loop seeds that iteration, so grouping
changes no bit.  JAX folds the row into its group's key instead
(`fold_in(key, g)`); the two packages' dropout streams differ anyway.  Every
step of the capture is a device op: the matcher's auction loops on the
device (`ops.kernels.auction`), the optimiser reads its learning rate and
bias corrections from `AdamW.scalars`.  A capture that fails raises; there
is no eager fallback on the card but the one asked for (`graph=False`,
`--debug_nans`).  On the CPU the same function runs eagerly.
`make_packed_multi_step` (`PackedMultiStep`, `ov3det/engine/train.py:200-232`)
captures a group's G steps as one graph instead, each with its own
generator and row of scalars; no CLI path takes it, as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ov3det_torch.config import LossConfig, OptimConfig, TrainConfig
from ov3det_torch.datasets.loader import unpack_batch, yuv420_decode_rows
from ov3det_torch.device import resolve_device
from ov3det_torch.engine.infer import INPUT_KEYS, make_eval_step
from ov3det_torch.engine.schedule import make_lr_schedule
from ov3det_torch.losses.criterion import set_criterion
from ov3det_torch.models.detr3d import Model3DETR
from ov3det_torch.models.regionclip import RegionCLIPTeacher, make_teacher_fn
from ov3det_torch.parallel.mesh import all_reduce_grads, data_group, replicate


class AdamW:
    """`optax.chain(clip_by_global_norm(clip), adamw(schedule, wd, mask))` over
    a fixed list of parameters; `step()` reads their `.grad` (None counts as
    zero), updates them in place and returns the global norm of the raw
    gradients as a device tensor.  Multi-tensor (`torch._foreach_*`) ops keep
    the launches per step to a few dozen.

    The update's host numbers live in `scalars`, a (3,) f32 tensor on the
    parameters' device: -lr, bc1 and bc2 of the next update, filled from the
    host by `stage()` (or a group's `scalar_rows` copied in), so that
    `apply()` is device ops only and can be captured in a CUDA graph.  `count`,
    the updates done, stays on the host.  The update reads -lr from
    `scalars` and adds `-lr * update` in two roundings, eager or captured
    alike, on every device."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params, cfg: OptimConfig, schedule: Callable[[int], float]):
        self.params = [p for p in params if p.requires_grad]
        self.cfg = cfg
        self.schedule = schedule
        self.count = 0  # updates done, on the host
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        # filter_biases_wd decays only the parameters of rank > 1 (train.py:46-47)
        self.decayed = [i for i, p in enumerate(self.params)
                        if not cfg.filter_biases_wd or p.dim() > 1]
        device = self.params[0].device if self.params else torch.device("cpu")
        self.scalars = torch.zeros(3, dtype=torch.float32, device=device)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def host_scalars(self, counts) -> np.ndarray:
        """(len(counts), 3) f32: -lr, bc1, bc2 of the updates numbered
        `counts` (1 the first), as optax computes them: the bias corrections
        in f32 with the count after the increment, lr `schedule(count - 1)`."""
        rows = [(-self.schedule(c - 1), 1 - np.float32(self.b1) ** np.float32(c),
                 1 - np.float32(self.b2) ** np.float32(c)) for c in counts]
        return np.asarray(rows, np.float32).reshape(len(rows), 3)

    def scalar_rows(self, n: int) -> torch.Tensor:
        """The scalars of the next `n` updates as an (n, 3) tensor on the
        device, in one copy (non-blocking, from pinned memory, on CUDA)."""
        host = torch.from_numpy(self.host_scalars(range(self.count + 1, self.count + n + 1)))
        if self.scalars.device.type == "cuda":
            return host.pin_memory().to(self.scalars.device, non_blocking=True)
        return host.to(self.scalars.device)

    def stage(self, rows: Optional[torch.Tensor] = None) -> None:
        """Count one update and put its scalars in `scalars`: `rows`, one row
        of `scalar_rows` already on the device, or the host's numbers."""
        self.scalars.copy_(self.scalar_rows(1)[0] if rows is None else rows)
        self.count += 1

    @torch.no_grad()
    def apply(self) -> torch.Tensor:
        """The update with the staged `scalars`: device ops only."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip = self.cfg.clip_gradient
        if clip > 0:
            factor = torch.where(g_norm < clip, torch.ones_like(g_norm), clip / g_norm)
            grads = torch._foreach_mul(grads, factor)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        neg_lr, bc1, bc2 = self.scalars[0], self.scalars[1], self.scalars[2]
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        if self.cfg.weight_decay > 0 and self.decayed:
            torch._foreach_add_([upd[i] for i in self.decayed],
                                [self.params[i] for i in self.decayed],
                                alpha=self.cfg.weight_decay)
        # optax scales the update by -lr, then adds it
        torch._foreach_mul_(upd, neg_lr)
        torch._foreach_add_(self.params, upd)
        return g_norm

    def step(self) -> torch.Tensor:
        """`stage()` then `apply()`: one eager update."""
        self.stage()
        return self.apply()

    def state_dict(self) -> dict:
        """The update count and the Adam moments, in the order of `params`."""
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        for name in ("mu", "nu"):
            saved = state[name]
            if len(saved) != len(self.params):
                raise ValueError(f"{name}: {len(saved)} tensors for {len(self.params)} parameters")
            for cur, new in zip(getattr(self, name), saved):
                if cur.shape != new.shape:
                    raise ValueError(f"{name}: shape {tuple(new.shape)}, expected {tuple(cur.shape)}")
                cur.copy_(new)
        self.count = int(state["count"])


def build_optimizer(model: torch.nn.Module, cfg: OptimConfig,
                    schedule: Callable[[int], float]) -> AdamW:
    """AdamW with global-norm clipping over every parameter of `model`
    (reference optimizer.py:5-27, engine.py:112-113)."""
    return AdamW(model.parameters(), cfg, schedule)


def batch_to_device(batch: dict, device, non_blocking: bool = False) -> dict:
    """A batch of the training schema (numpy arrays or CPU tensors) ->
    tensors on `device` (floats f32, integers int64; uint8 canvases and
    flags as they are: the teacher normalises the canvases on the device,
    so they cross at 1 byte a value).  `non_blocking` lets the copy of a
    pinned batch overlap the work already queued on the card."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if t.is_floating_point():
            t = t.to(device, torch.float32, non_blocking=non_blocking)
        elif t.dtype not in (torch.bool, torch.uint8):
            t = t.to(device, torch.int64, non_blocking=non_blocking)
        else:
            t = t.to(device, non_blocking=non_blocking)
        out[k] = t
    return out


def decode_banked_images(batch: dict, image_bank: tuple) -> dict:
    """`batch` with `image` decoded from the bank's rows at its `image_ref`
    (as it is when it carries no `image_ref` or already an `image`).
    image_bank: (bank (N, row_bytes) uint8 on the batch's device, (H, W))."""
    if "image_ref" not in batch or "image" in batch:
        return batch
    bank, (h, w) = image_bank
    ref = batch["image_ref"]
    rows = bank.index_select(0, ref.to(bank.device))
    return dict(batch, image=yuv420_decode_rows(rows, (ref.shape[0], h, w, 3)))


def make_train_step(model: Model3DETR, optimizer: AdamW, loss_cfg: LossConfig,
                    num_angle_bin: int, num_semcls: int,
                    teacher_fn: Optional[Callable[[dict, dict], torch.Tensor]] = None,
                    image_bank: Optional[tuple] = None):
    """`train_step(batch, generator) -> metrics`: one step of
    `make_train_step` (`ov3det/engine/train.py:112-177`).

    batch: the training schema as tensors on the model's device;
    generator: a `torch.Generator` on that device for the dropout masks.
    teacher_fn: `(batch, outputs) -> (B, Q, C) or (L, B, Q, C)` frozen
    2D-teacher region features for the 2D-alignment loss
    (`models.regionclip.make_teacher_fn`); it runs between the forward and
    the criterion, inside a profiler range named "teacher".  The step's
    other stages are profiler ranges too: "forward", "criterion",
    "backward" (autograd's kernels launch from its own threads) and
    "optimizer".
    image_bank: (bank, (H, W)) when the batches carry `image_ref` in place
    of the canvases (`decode_banked_images`, inside the teacher's range).
    metrics: the criterion's loss dict plus `grad_norm`, the global norm
    of the raw gradients, all device tensors (nothing is synchronised);
    under a data group the global values, the same on every rank.
    `mark`, if given, is called with "forward", "teacher" (with a teacher),
    "criterion", "backward", "all_reduce" (under a data group) and
    "optimizer" as each phase has been issued (timing hooks).  `staged`:
    the optimiser's scalars of this update are in place already
    (`AdamW.stage`; the captured step), so the step is device ops only.
    """

    def train_step(batch: dict, generator: torch.Generator,
                   mark: Optional[Callable[[str], None]] = None, staged: bool = False) -> dict:
        mark = mark or (lambda _: None)
        model.train()
        with record_function("forward"):
            outputs = model({k: batch[k] for k in INPUT_KEYS}, generator)
        mark("forward")
        teacher_feats = None
        if teacher_fn is not None:
            with record_function("teacher"):
                if image_bank is not None:
                    batch = decode_banked_images(batch, image_bank)
                teacher_feats = teacher_fn(batch, outputs)
            mark("teacher")
        with record_function("criterion"):
            total, loss_dict = set_criterion(outputs, batch, loss_cfg, num_angle_bin=num_angle_bin,
                                             num_semcls=num_semcls, teacher_feats=teacher_feats)
        mark("criterion")
        with record_function("backward"):
            optimizer.zero_grad()
            total.backward()
        mark("backward")
        if data_group() is not None:  # the global gradient, on every rank
            all_reduce_grads(optimizer.params)
            mark("all_reduce")
        with record_function("optimizer"):
            grad_norm = optimizer.apply() if staged else optimizer.step()
        mark("optimizer")
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


@dataclass
class Training:
    """What `build_training` wires together."""

    model: Model3DETR
    optimizer: AdamW
    schedule: Callable[[int], float]
    train_step: Callable[..., dict]
    eval_step: Callable[[dict], dict | tuple]
    teacher: Optional[RegionCLIPTeacher] = None
    image_bank: Optional[tuple] = None


def build_training(cfg: TrainConfig, iters_per_epoch: int, device=None, seed: int = 0,
                   eval_loss: bool = False,
                   teacher: Optional[RegionCLIPTeacher] = None,
                   image_bank: Optional[tuple] = None,
                   eval_graph: Optional[bool] = None) -> Training:
    """Schedule, optimiser, detector (seeded random weights) and the steps
    from a `TrainConfig` (`ov3det/engine/train.py:317-352`).  `device`
    defaults to CUDA and raises when no card is present.  With `eval_loss`
    the eval step also returns the criterion's loss dict.  `teacher`, a
    loaded `RegionCLIPTeacher` on `device`, feeds the training step's
    2D-alignment loss (`cfg.loss.teacher_per_layer` picks the hook's mode);
    it stays frozen, in eval mode, outside the optimiser and outside the
    model's state_dict (the eval step never runs it, as in JAX).
    `image_bank`, (bank, (H, W)) from `datasets.image_bank.build_image_bank`
    on `device`, feeds the teacher when the batches carry `image_ref`; like
    the teacher it is no part of the state.  Under a data group the model's
    parameters and buffers are replicated from rank 0.  `eval_graph` is
    `make_eval_step`'s `graph` (None: a CUDA graph on a card outside a data
    group)."""
    device = resolve_device(device)
    schedule = make_lr_schedule(cfg.optim, cfg.max_epoch, iters_per_epoch)
    model = Model3DETR(cfg.model, device=device, seed=seed)
    replicate(list(model.parameters()) + list(model.buffers()))
    optimizer = build_optimizer(model, cfg.optim, schedule)
    teacher_fn = None
    if teacher is not None:
        teacher.eval()
        teacher_fn = make_teacher_fn(teacher, per_layer=cfg.loss.teacher_per_layer)
    if image_bank is not None and teacher is None:
        raise ValueError("the image bank feeds the 2D teacher: pass teacher= too")
    train_step = make_train_step(model, optimizer, cfg.loss, cfg.model.num_angle_bin,
                                 cfg.model.num_semcls, teacher_fn=teacher_fn,
                                 image_bank=image_bank)
    eval_step = make_eval_step(model, cfg.loss if eval_loss else None,
                               cfg.model.num_angle_bin, cfg.model.num_semcls, graph=eval_graph)
    return Training(model, optimizer, schedule, train_step, eval_step, teacher, image_bank)


def step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed of training step `step`: the JAX
    package's key `[seed, step]` as one 64-bit integer."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


class PackedStep:
    """`make_packed_step` / `make_packed_group_step` on the card: G training
    steps on a (G, nbytes) group of packed rows (`datasets.loader`), step g
    at iteration `first_iter + g`, its dropout generator seeded
    `step_seed(seed, first_iter + g)`.

    graph (default: on CUDA): the step is one CUDA-graph replay a row.  The
    first row of a layout (`metas`) is the warm-up: the eager step on a side
    stream; then the step on the static row is captured once (the model's
    and optimiser's tensors must be in place by then: restore a checkpoint
    with in-place copies before the first call; a parameter, buffer or
    moment rebound after it raises, in either mode).  graph=False runs every
    row eagerly: the CPU's path, and `--debug_nans`'s.  Returns (metrics,
    batch) of the group's last row, both device tensors valid until the next
    call (the graph's static outputs)."""

    def __init__(self, training: Training, seed: int, device=None, graph: Optional[bool] = None):
        self.train_step = training.train_step
        self.optimizer = training.optimizer
        self.model = training.model
        self.seed = seed
        self.device = resolve_device(device) if device is not None else \
            self.optimizer.scalars.device
        self.graph = self.device.type == "cuda" if graph is None else graph
        if self.graph and self.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device")
        self.generator = torch.Generator(device=self.device)
        # metas -> (graph, static row, static batch, static metrics)
        self._graphs: dict = {}
        self._bound = None  # the storage of the state, at the first step

    def _state(self) -> list:
        return (list(self.model.parameters()) + list(self.model.buffers())
                + self.optimizer.mu + self.optimizer.nu + [self.optimizer.scalars])

    def _check_bound(self) -> None:
        if self._bound is None:
            return
        now = [t.data_ptr() for t in self._state()]
        if now != self._bound:
            raise RuntimeError("a parameter, buffer or optimiser moment was rebound after the "
                               "step was captured: restore state with in-place copies "
                               "(load_state_dict) before the first step")

    def _eager(self, batch: dict, it: int) -> dict:
        self.generator.manual_seed(step_seed(self.seed, it))
        return self.train_step(batch, self.generator)

    def _run_eagerly(self, rows: torch.Tensor, metas, first_iter: int) -> tuple:
        """Every row eagerly: (the last row's metrics, its batch)."""
        for g in range(rows.shape[0]):
            batch = unpack_batch(rows[g], metas)
            metrics = self._eager(batch, first_iter + g)
        return metrics, batch

    def _capture(self, rows: torch.Tensor, metas, first_iter: int) -> tuple:
        """The warm-up step on rows[0] on a side stream, then the capture."""
        static_row = torch.empty(rows.shape[1], dtype=torch.uint8, device=self.device)
        static_row.copy_(rows[0])
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            batch = unpack_batch(static_row, metas)
            metrics = self._eager(batch, first_iter)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # a replay draws from the generator's seed and offset as they stand
        graph.register_generator_state(self.generator)
        static_batch, static_metrics = self._record(graph, side, static_row, metas)
        self._graphs[metas] = (graph, static_row, static_batch, static_metrics)
        return metrics, batch

    def _record(self, graph, stream, static_row: torch.Tensor, metas) -> tuple:
        """Capture the step on the static row into `graph`: (static batch,
        static metrics)."""
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            static_batch = unpack_batch(static_row, metas)
            static_metrics = self.train_step(static_batch, self.generator, staged=True)
        return static_batch, static_metrics

    def __call__(self, rows: torch.Tensor, metas, first_iter: int) -> tuple:
        if rows.dim() == 1:
            rows = rows[None]
        self._check_bound()
        if not self.graph:
            metrics, batch = self._run_eagerly(rows, metas, first_iter)
        else:
            metrics, batch = self._replay(rows, metas, first_iter)
        if self._bound is None:  # held on the CPU too, so that its tests guard the card
            self._bound = [t.data_ptr() for t in self._state()]
        return metrics, batch

    def _replay(self, rows: torch.Tensor, metas, first_iter: int) -> tuple:
        G, g0 = rows.shape[0], 0
        if metas not in self._graphs:
            metrics, batch = self._capture(rows, metas, first_iter)
            g0 = 1
            if G == 1:
                return metrics, batch
        graph, static_row, static_batch, static_metrics = self._graphs[metas]
        table = self.optimizer.scalar_rows(G - g0)  # the group's scalars in one copy
        for g in range(g0, G):
            static_row.copy_(rows[g])
            self.optimizer.stage(table[g - g0])
            self.generator.manual_seed(step_seed(self.seed, first_iter + g))
            graph.replay()
        return static_metrics, static_batch



class PackedMultiStep(PackedStep):
    """`make_packed_multi_step` (`ov3det/engine/train.py:200-232`) on the
    card: the G training steps of a (G, nbytes) group in **one** CUDA-graph
    replay, where `PackedStep` replays one step's graph G times.  Sub-step g
    runs at iteration `first_iter + g` with its own registered dropout
    generator, seeded `step_seed(seed, first_iter + g)`, and its own row of
    the AdamW scalars, so that one replay equals G replays of `PackedStep`
    bit for bit.  Returns (metrics stacked (G,), the last row's batch).

    The first group of a layout (`metas`) and size G is the warm-up: G eager
    steps on a side stream, then the capture of G steps on a static
    (G, nbytes) group.  JAX scans its step over the rows with
    `fold_in(rng, g)` keys; the two packages' dropout streams differ anyway.
    On the CPU (graph=False) the steps run eagerly, one after the other.
    """

    def _run_eagerly(self, rows: torch.Tensor, metas, first_iter: int) -> tuple:
        ms = []
        for g in range(rows.shape[0]):
            batch = unpack_batch(rows[g], metas)
            ms.append(self._eager(batch, first_iter + g))
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}, batch

    def _replay(self, rows: torch.Tensor, metas, first_iter: int) -> tuple:
        G = rows.shape[0]
        if (metas, G) not in self._graphs:
            return self._capture(rows, metas, first_iter)
        graph, (static_rows, table, gens), static_batch, static_metrics = self._graphs[(metas, G)]
        static_rows.copy_(rows)
        table.copy_(self.optimizer.scalar_rows(G))
        self.optimizer.count += G
        for g, gen in enumerate(gens):
            gen.manual_seed(step_seed(self.seed, first_iter + g))
        graph.replay()
        return static_metrics, static_batch

    def _capture(self, rows: torch.Tensor, metas, first_iter: int) -> tuple:
        """G eager steps on a side stream, then the capture of G steps."""
        G = rows.shape[0]
        static = (rows.clone(), torch.zeros((G, 3), dtype=torch.float32, device=self.device),
                  [torch.Generator(device=self.device) for _ in range(G)])
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            metrics, batch = self._run_eagerly(static[0], metas, first_iter)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for gen in static[2]:
            graph.register_generator_state(gen)
        static_batch, static_metrics = self._record(graph, side, static, metas)
        self._graphs[(metas, G)] = (graph, static, static_batch, static_metrics)
        return metrics, batch

    def _record(self, graph, stream, static: tuple, metas) -> tuple:
        """Capture the G steps on the static (rows, scalars, generators) into
        `graph`: (the last static batch, static metrics stacked (G,))."""
        static_rows, table, gens = static
        ms = []
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            for g, gen in enumerate(gens):
                self.optimizer.scalars.copy_(table[g])
                static_batch = unpack_batch(static_rows[g], metas)
                ms.append(self.train_step(static_batch, gen, staged=True))
            static_metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        return static_batch, static_metrics


def make_packed_multi_step(training: Training, seed: int, device=None,
                           graph: Optional[bool] = None) -> PackedMultiStep:
    """G training steps of a packed group as one CUDA-graph replay
    (`PackedMultiStep`); no CLI path takes it, as in JAX."""
    return PackedMultiStep(training, seed, device, graph)
