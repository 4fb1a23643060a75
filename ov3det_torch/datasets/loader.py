"""Batching data loader: the JAX package's batch schema on
`torch.utils.data.DataLoader`, with its packed transfer.

Counterpart of `ov3det/datasets/loader.py`'s batch schema: `collate`
(`:30`), `valid_count` / `slice_valid` (`:409-420`) and the index order of
`DataLoader._index_batches` (`:546-564`).  Epoch `e` of a shuffled loader
visits `default_rng(seed * 1000003 + e).shuffle(arange(n))`; with
`drop_last=False` the tail batch is padded to the full batch size by
repeating its last index, and `valid_mask` (float32, 1 for the real
samples) marks the pad.  Under data parallelism each rank loads its rows
`[r b, (r + 1) b)` of every global batch (`process_index` r,
`process_count` W, b = batch_size / W; `ov3det/datasets/loader.py:570-614`),
with `valid_mask` over the global positions.

Two transfers, as the JAX loader has them (`:423-520`):
  * "tree": each batch a dict of CPU tensors with the samples' dtypes,
    pinned when `pin_memory` is set, for `engine.train.batch_to_device`;
  * "packed" (one process only): each batch one uint8 row in JAX's byte
    layout (`pack_batch`: keys sorted, int64 -> int32, float64 -> float32,
    bool -> uint8, and the opt-in q16 and yuv420 codecs of `quantize`),
    each worker writing a batch's samples straight into one row (shared
    memory, no collate) and `super_batch` G consecutive rows gathered into
    one pinned (G, nbytes) row set (the tail group holds fewer rows).  With
    a CUDA `device` each group crosses in one non-blocking copy on a side
    stream, ordered before the consumer's stream by an event, so that it
    overlaps the step in flight; `unpack_batch` slices, bitcasts, decodes
    and widens a row on the device into what `batch_to_device` gives for
    the same batch.  Keys in `encode_cache` (the canvases: augmentation
    never touches them) have their encoded rows memoised per dataset index
    in each persistent worker.

Worker processes run the numpy datasets only: torch's default start method
forks them, possibly after CUDA is initialised in the parent, and a worker
must never touch `torch.cuda`.  They start at the first `iter()` and serve
every later epoch and eval pass, as the JAX loader keeps its pool: forking
them anew each time is measured in `PERF.md`.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.utils.data


def collate(samples: list[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def valid_count(batch: dict) -> int:
    """Number of real (non-pad) samples in a batch of a loader with
    drop_last=False; the full batch size when no padding happened."""
    mask = batch.get("valid_mask")
    if mask is None:
        return int(batch["point_clouds"].shape[0])
    return int(np.asarray(mask).sum())


def slice_valid(tree: dict, n: int) -> dict:
    """Strip pad samples (always at the tail) from every batched array."""
    return {k: v[:n] for k, v in tree.items()}


# --- the packed transfer: JAX's byte layout and codecs ------------------------
# Copies of `ov3det/datasets/loader.py:80-406`, numpy on the host and torch
# on the device.  q16: a float32 (N, C) sample as [min f32[C] | max f32[C] |
# uint16 payload (N*C)], scaled per sample and channel (error at most
# range / 65535 / 2).  yuv420: a uint8 (..., H, W, 3) sample as full-range
# BT.601 [Y | U / 2x2 | V / 2x2], 1.5 bytes a pixel.

Q16_TAG = "q16"
YUV_TAG = "yuv420"


def _q16_eligible(key: str, dtype, sample_ndim: int, quantize) -> bool:
    """float32 per-sample matrices (N, C) only; an ineligible key in
    `quantize` packs verbatim."""
    return key in quantize and np.dtype(dtype) == np.float32 and sample_ndim >= 2


def _yuv_eligible(key: str, dtype, sample_shape, quantize) -> bool:
    """uint8 (..., H, W, 3) images with even H, W (the 2x2 chroma grid)."""
    return (key in quantize and np.dtype(dtype) == np.uint8 and len(sample_shape) >= 3
            and sample_shape[-1] == 3 and sample_shape[-3] % 2 == 0
            and sample_shape[-2] % 2 == 0)


def yuv_sample_bytes(sample_shape) -> int:
    """Bytes of one sample's yuv420 row: (..., H, W, 3) with even H and W."""
    h, w = sample_shape[-3], sample_shape[-2]
    frames = int(np.prod(sample_shape[:-3], dtype=np.int64)) if len(sample_shape) > 3 else 1
    return frames * (h * w + 2 * (h // 2) * (w // 2))


# full-range BT.601 (JPEG) scaled by 256, as f32 rows of one product: every
# intermediate is an integer below 2^24, so the f32 arithmetic is exact
_YUV_M = np.array([[77, 150, 29], [-43, -85, 128], [128, -107, -21]], np.float32).T


def yuv420_encode(img: np.ndarray) -> np.ndarray:
    """(..., H, W, 3) uint8 RGB -> one uint8 row [Y | U / 2x2 | V / 2x2]."""
    a = np.asarray(img)
    h, w = a.shape[-3], a.shape[-2]
    yuv = np.floor(
        (a.reshape(-1, 3).astype(np.float32) @ _YUV_M + 128.0) * (1.0 / 256.0)
    ).reshape(-1, h, w, 3)
    y, u, v = yuv[..., 0], yuv[..., 1] + 128.0, yuv[..., 2] + 128.0

    def sub(c):  # 2 x 2 box average, rounded half up; sums below 2^24
        c4 = c.reshape(-1, h // 2, 2, w // 2, 2)
        return np.floor((c4.sum(axis=(2, 4)) + 2.0) * 0.25)

    parts = [np.clip(y, 0, 255).astype(np.uint8).reshape(-1),
             np.clip(sub(u), 0, 255).astype(np.uint8).reshape(-1),
             np.clip(sub(v), 0, 255).astype(np.uint8).reshape(-1)]
    return np.concatenate(parts)


def _q16_sample_bytes(sample_shape) -> int:
    C = sample_shape[-1]
    return 8 * C + 2 * int(np.prod(sample_shape, dtype=np.int64))


def _q16_encode(a: np.ndarray) -> np.ndarray:
    """One sample (N, C) f32 -> one uint8 row [min | max | uint16 payload]."""
    C = a.shape[-1]
    flat = np.ascontiguousarray(a, np.float32).reshape(-1, C)
    mn = flat.min(axis=0)
    mx = flat.max(axis=0)
    scale = np.float32(65535.0) / np.maximum(mx - mn, np.float32(1e-12))
    q = np.clip(np.rint((flat - mn) * scale), 0.0, 65535.0).astype(np.uint16)
    return np.concatenate([mn.view(np.uint8), mx.view(np.uint8), q.view(np.uint8).ravel()])


def _cached_encode(encode_fn, sample, key, idx, enc_cache):
    """The encoded row of `sample`, memoised per (key, dataset index) in
    `enc_cache` when one is given (keys whose row is the same every epoch)."""
    if enc_cache is None or idx is None:
        return encode_fn(np.asarray(sample))
    ck = (key, int(idx))
    row = enc_cache.get(ck)
    if row is None:
        row = enc_cache[ck] = encode_fn(np.asarray(sample))
    return row


def _pack_cast(dt) -> np.dtype:
    """The wire dtype: int64 -> int32, float64 -> float32, bool -> uint8."""
    dt = np.dtype(dt)
    return {np.dtype(np.int64): np.dtype(np.int32), np.dtype(np.float64): np.dtype(np.float32),
            np.dtype(np.bool_): np.dtype(np.uint8)}.get(dt, dt)


def pack_batch(batch: dict, quantize=(), idxs=None, enc_cache=None, cache_keys=()) -> tuple:
    """Dict of numpy arrays -> (uint8 buffer, metas), byte for byte
    `ov3det.datasets.loader.pack_batch`.  metas: one (key, wire dtype str or
    codec tag, shape, bytes) a key, keys sorted.  `cache_keys` memoise
    their encoded rows per dataset index (`idxs`, one a row) in `enc_cache`."""
    metas, parts = [], []
    for k in sorted(batch):
        a = np.ascontiguousarray(batch[k])
        cache = enc_cache if k in cache_keys else None
        idx_of = (lambda b: idxs[b]) if idxs is not None else (lambda b: None)
        for tag, eligible, encode in ((Q16_TAG, _q16_eligible(k, a.dtype, a.ndim - 1, quantize),
                                       _q16_encode),
                                      (YUV_TAG, _yuv_eligible(k, a.dtype, a.shape[1:], quantize),
                                       yuv420_encode)):
            if eligible:
                rows = [_cached_encode(encode, a[b], k, idx_of(b), cache) for b in range(a.shape[0])]
                metas.append((k, tag, a.shape, a.shape[0] * rows[0].size))
                parts.extend(rows)
                break
        else:
            a = a.astype(_pack_cast(a.dtype), copy=False)
            flat = a.view(np.uint8).reshape(-1)
            metas.append((k, a.dtype.str, a.shape, flat.size))
            parts.append(flat)
    return np.concatenate(parts), tuple(metas)


def batch_metas(sample: dict, batch_size: int, with_valid_mask: bool, quantize=()) -> tuple:
    """(metas, bytes) of `pack_batch` for a batch of `batch_size` samples of
    `sample`'s schema, without building the batch."""
    items = {k: np.asarray(v) for k, v in sample.items()}
    if with_valid_mask:
        items["valid_mask"] = np.zeros(batch_size, np.float32)
    metas = []
    for k in sorted(items):
        a = items[k]
        if k != "valid_mask" and _q16_eligible(k, a.dtype, a.ndim, quantize):
            metas.append((k, Q16_TAG, (batch_size,) + a.shape,
                          batch_size * _q16_sample_bytes(a.shape)))
            continue
        if k != "valid_mask" and _yuv_eligible(k, a.dtype, a.shape, quantize):
            metas.append((k, YUV_TAG, (batch_size,) + a.shape,
                          batch_size * yuv_sample_bytes(a.shape)))
            continue
        dt = _pack_cast(a.dtype)
        shape = a.shape if k == "valid_mask" else (batch_size,) + a.shape
        metas.append((k, dt.str, shape, int(np.prod(shape, dtype=np.int64)) * dt.itemsize))
    return tuple(metas), sum(m[3] for m in metas)


def _pack_samples_into(samples, valid_mask, out_row: np.ndarray, metas, idxs=None,
                       enc_cache=None, cache_keys=()) -> None:
    """Write `samples` straight into one packed row of `metas`' layout (no
    collate stack, no concatenation)."""
    off, B = 0, len(samples)
    idx_of = (lambda s: idxs[s]) if idxs is not None else (lambda s: None)
    for k, dts, shape, size in metas:
        if k == "valid_mask":
            out_row[off:off + size] = valid_mask.astype(np.float32).view(np.uint8).ravel()
            off += size
            continue
        nb = size // B
        cache = enc_cache if k in cache_keys else None
        encode = {Q16_TAG: _q16_encode, YUV_TAG: yuv420_encode}.get(dts)
        for s, smp in enumerate(samples):
            if encode is not None:
                row = _cached_encode(encode, smp[k], k, idx_of(s), cache)
            else:
                a = np.atleast_1d(np.ascontiguousarray(smp[k]))
                row = a.astype(np.dtype(dts), copy=False).view(np.uint8).ravel()
            out_row[off + s * nb:off + (s + 1) * nb] = row
        off += size


def yuv420_decode_rows(rows: torch.Tensor, shape) -> torch.Tensor:
    """yuv420 rows (B, row_bytes) uint8, laid out per sample as [Y | U | V]
    over its frames, -> uint8 RGB of `shape` (B, ..., H, W, 3), on the rows'
    device: nearest 2 x 2 chroma upsampling and the inverse JPEG matrix in
    f32, rounded half to even and clamped (JAX's `yuv420_decode_rows`)."""
    B = shape[0]
    h, w = shape[-3], shape[-2]
    F = int(np.prod(shape[:-3], dtype=np.int64)) // B  # frames a sample
    ny, nc = h * w, (h // 2) * (w // 2)
    y = rows[:, :F * ny].reshape(-1, h, w).float()

    def chroma(part):
        c = part.reshape(-1, h // 2, w // 2).repeat_interleave(2, 1).repeat_interleave(2, 2)
        return c.float() - 128.0

    u = chroma(rows[:, F * ny:F * (ny + nc)])
    v = chroma(rows[:, F * (ny + nc):])
    rgb = torch.stack([y + 1.402 * v, y - 0.344136 * u - 0.714136 * v, y + 1.772 * u], -1)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8).reshape(shape)


_WIRE = {"|u1": torch.uint8, "|i1": torch.int8, "<i2": torch.int16, "<i4": torch.int32,
         "<f4": torch.float32, "<f2": torch.float16}


def _bitcast(seg: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A uint8 slice viewed as `dtype` (copied first when its offset is not
    a multiple of the item size: JAX's layout packs keys unaligned)."""
    if seg.storage_offset() % dtype.itemsize:
        seg = seg.clone()
    return seg.view(dtype)


def unpack_batch(buf: torch.Tensor, metas, device=None) -> dict:
    """The inverse of `pack_batch` in torch, on `buf`'s device (or on
    `device`): slices and bitcasts (`view(dtype)`), dequantises q16 as
    `mn + q * ((mx - mn) * (1 / 65535))` (the scale in f32, the multiply-add
    rounded once to f32, as JAX's fused program rounds it) and decodes yuv420, then
    widens each array as `engine.train.batch_to_device` does (floats f32,
    other integers int64, uint8 kept), so that the step sees the tensors of
    the tree transfer.  No host copy, no wait: capturable in a CUDA graph."""
    if device is not None:
        buf = buf.to(device)
    out, off = {}, 0
    for k, dts, shape, size in metas:
        seg = buf[off:off + size]
        off += size
        if dts == Q16_TAG:
            B, C = shape[0], shape[-1]
            rows = seg.view(B, size // B)
            hdr = rows[:, :8 * C].contiguous().view(torch.float32).view(B, 2, C)
            # uint16 read as int16 and masked back: int32 holds it exactly
            q = (rows[:, 8 * C:].contiguous().view(torch.int16).view(B, -1, C).int() & 0xFFFF)
            mn = hdr[:, :1]  # (B, 1, C) over the N axis
            scale = (hdr[:, 1:] - mn) * (1.0 / 65535.0)
            # mn + q * scale rounded once, as XLA's fused multiply-add rounds
            # it: the product (16 x 24 bits) is exact in f64
            out[k] = (mn.double() + q.double() * scale.double()).float().reshape(shape)
            continue
        if dts == YUV_TAG:
            out[k] = yuv420_decode_rows(seg.view(shape[0], size // shape[0]), shape)
            continue
        arr = _bitcast(seg, _WIRE[dts]).view(shape)
        if arr.is_floating_point():
            arr = arr.float()
        elif arr.dtype != torch.uint8:
            arr = arr.long()
        out[k] = arr
    return out


class _EpochBatches(torch.utils.data.Sampler):
    """Yields each batch as a list of `(dataset index, is_real)` pairs in the
    JAX loader's order; reads `epoch` when an iteration starts, so that
    `DataLoader.set_epoch` takes effect at the next `iter()`."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, drop_last: bool, seed: int,
                 process_index: int = 0, process_count: int = 1):
        self.n, self.batch_size, self.shuffle, self.seed = n, batch_size, shuffle, seed
        self.batches = n // batch_size if drop_last else -(-n // batch_size)
        self.epoch = 0
        self.local = batch_size // process_count
        self.rows = slice(process_index * self.local, (process_index + 1) * self.local)

    def __len__(self):
        return self.batches

    def __iter__(self):
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed * 1000003 + self.epoch).shuffle(order)
        for b in range(self.batches):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size].tolist()
            n_valid = len(idxs)
            idxs += [idxs[-1]] * (self.batch_size - n_valid)
            yield [(i, j < n_valid) for j, i in enumerate(idxs)][self.rows]


class _Indexed(torch.utils.data.Dataset):
    """`dataset[(i, is_real)]` -> `(dataset[i], is_real, i)`: the sample, its
    flag and its index (the packed transfer's memo key)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, item):
        i, real = item
        return self.dataset[i], real, i


class _Collate:
    """Stacks the samples, adds `valid_mask` when the tail is padded, and
    wraps each array as a CPU tensor.  A class, not a closure, so that the
    workers can unpickle it under any start method."""

    def __init__(self, with_valid_mask: bool):
        self.with_valid_mask = with_valid_mask

    def __call__(self, items: list) -> dict:
        batch = collate([s for s, _, _ in items])
        if self.with_valid_mask:
            batch["valid_mask"] = np.array([r for _, r, _ in items], np.float32)
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


class _PackInto:
    """Writes a batch's samples straight into one packed row
    (`_pack_samples_into`), in shared memory when it runs in a worker so
    that the row crosses to the parent without a copy.  `enc_cache` lives
    in each worker's copy, kept across epochs by persistent workers."""

    def __init__(self, metas, nbytes: int, with_valid_mask: bool, cache_keys=()):
        self.metas, self.nbytes = metas, nbytes
        self.with_valid_mask, self.cache_keys = with_valid_mask, tuple(cache_keys)
        self.enc_cache: dict = {}

    def __call__(self, items: list) -> torch.Tensor:
        if torch.utils.data.get_worker_info() is not None:  # as default_collate does
            storage = torch.empty(0, dtype=torch.uint8)._typed_storage()._new_shared(self.nbytes)
            row = torch.empty(0, dtype=torch.uint8).new(storage)
        else:
            row = torch.empty(self.nbytes, dtype=torch.uint8)
        mask = np.array([r for _, r, _ in items], np.float32) if self.with_valid_mask else None
        _pack_samples_into([smp for smp, _, _ in items], mask, row.numpy(), self.metas,
                           idxs=[i for _, _, i in items], enc_cache=self.enc_cache,
                           cache_keys=self.cache_keys)
        return row


class DataLoader:
    """`ov3det.datasets.loader.DataLoader`'s batches with no sharding.

    transfer "tree": dicts of CPU tensors.  transfer "packed" (one process
    only): `(rows, metas)` items, rows a (G, nbytes) uint8 tensor of G <=
    super_batch consecutive batches in JAX's packed layout (`pack_batch`),
    on `device` when it is given (one non-blocking copy a group on a side
    stream; the consumer's current stream waits for it), else on the host.
    quantize: keys shipped through the q16 (float32 (N, C)) or yuv420
    (uint8 (H, W, 3)) codec; encode_cache: the keys of `quantize` whose
    encoded row is the same every epoch, memoised per dataset index in each
    worker (one row a scene a worker: the canvases of all SUN RGB-D are
    about 3 GB of host memory a worker).  num_workers: worker processes of
    `torch.utils.data.DataLoader`, started at the first `iter()` and kept
    for the loader's life; 0 builds the batches in the calling thread.
    pin_memory: page-locked batches, for copies that overlap the step.
    batch_size: the global batch; process_index, process_count: this rank's
    rows of it, and the ranks.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, drop_last: bool = True,
                 num_workers: int = 4, seed: int = 0, pin_memory: bool = False,
                 process_index: int = 0, process_count: int = 1, transfer: str = "tree",
                 super_batch: int = 1, quantize: tuple = (), encode_cache: tuple = (),
                 device=None):
        if batch_size % process_count:
            raise ValueError(f"batch {batch_size} does not split over {process_count} processes")
        if transfer not in ("tree", "packed"):
            raise ValueError(f"transfer is 'tree' or 'packed', got {transfer!r}")
        if transfer == "packed" and process_count != 1:
            raise ValueError("the packed transfer is single-process (its key-major layout "
                             "does not split batch-wise)")
        if super_batch < 1 or (super_batch > 1 and transfer != "packed"):
            raise ValueError(f"super_batch {super_batch} needs transfer='packed'")
        if (quantize or encode_cache) and transfer != "packed":
            raise ValueError("the q16 and yuv420 codecs ride the packed transfer")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.transfer, self.super_batch = transfer, super_batch
        self.quantize, self.encode_cache = tuple(quantize), tuple(encode_cache)
        self.device = None if device is None else torch.device(device)
        self._batches = _EpochBatches(len(dataset), batch_size, shuffle, drop_last, seed,
                                      process_index, process_count)
        self.metas = self.nbytes = None
        if transfer == "tree":
            collate = _Collate(with_valid_mask=not drop_last)
        else:
            self.metas, self.nbytes = batch_metas(dataset[0], batch_size, not drop_last,
                                                  self.quantize)
            collate = _PackInto(self.metas, self.nbytes, not drop_last, self.encode_cache)
        # a group of several rows is gathered into pinned memory here, once
        self._pin_group = pin_memory and super_batch > 1
        self._torch = torch.utils.data.DataLoader(
            _Indexed(dataset), batch_sampler=self._batches, num_workers=num_workers,
            collate_fn=collate,
            pin_memory=pin_memory and not self._pin_group, persistent_workers=num_workers > 0)
        self._copies = None  # the side stream of the packed copies

    def set_epoch(self, epoch: int) -> None:
        self._batches.epoch = epoch

    def __len__(self):
        """Batches an epoch (a packed item may carry several)."""
        return len(self._batches)

    def __iter__(self) -> Iterator:
        if self.transfer == "tree":
            return iter(self._torch)
        return self._packed()

    def _packed(self):
        group = []
        for row in self._torch:
            group.append(row)
            if len(group) == self.super_batch:
                yield self._ship(group), self.metas
                group = []
        if group:  # the tail group keeps its true length
            yield self._ship(group), self.metas

    def _ship(self, group: list) -> torch.Tensor:
        """A group's rows as one (G, nbytes) tensor on `device`."""
        if len(group) == 1:
            rows = group[0][None]
        else:
            rows = torch.empty((len(group), self.nbytes), dtype=torch.uint8,
                               pin_memory=self._pin_group)
            for g, row in enumerate(group):
                rows[g].copy_(row)
        if self.device is not None and self.device.type == "cuda":
            return self._to_device(rows)
        return rows if self.device is None else rows.to(self.device)

    def _to_device(self, rows: torch.Tensor) -> torch.Tensor:
        """One non-blocking copy of a group on the side stream; the current
        stream waits for it, so that it overlaps the work already queued."""
        if self._copies is None:
            self._copies = torch.cuda.Stream(self.device)
        consumer = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copies):
            out = rows.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copies)
        consumer.wait_event(done)
        out.record_stream(consumer)  # allocated on the side stream, read on this one
        return out
