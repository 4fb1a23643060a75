#!/usr/bin/env python3
"""On-card check of the PyTorch port (`ov3det_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `ov3det_torch/csrc/` (one nvcc per source, all
at once), then:
  1. prints the card's name and power limit, the build time, each kernel's
     registers and shared memory (ptxas) and, from `cuobjdump -sass`, that the
     wgmma kernels (forward, dq, dk/dv, each with and without the radius)
     hold HGMMA and LDGSTS (cp.async) and no HMMA, and that the tile
     ball-group kernels the route launches (the forward at both tiles of
     centers, the pick pass) hold no FFMA;
  2. holds each kernel against its plain PyTorch version on the card at the
     shapes the main paths give it, and times kernel, plain version and,
     where one exists, a PyTorch call as a yardstick:
       FPS 8 x 20000 -> 2048 and 8 x 2048 -> 128, and a ragged 8 x 20001 ->
       64: the indices of the cluster design equal the plain version's and
       those of the first design (`_impl="first"`); both designs timed in
       turns (the cluster design must not be the slower); the cluster size
       and CTAs of each launch; the chain alone (the step's reductions,
       exchange and wait on no points), a measurement of the design printed
       beside the operations and bytes bound and never in its place;
       ball-group 8 x 20000, M = 2048, K = 64, C = 0 and C = 3, and at a
       ragged N (20 001) and a ragged M (2047): the tile design's output
       equals the plain version's and the first design's bit for bit on two
       launches, both designs timed in turns (replays of a CUDA graph of
       the calls, so that the host's launch rate does not enter the kernel
       time), with the distance tests the data needs and the bound beside
       them;
       attention BH = 32, N = 2048, D = 64 (the encoder of the training
       step): the dropout mask read back through the forward, dq and dk/dv
       kernels, in both designs, equals the plain hash exactly; forward, dq
       and dk/dv in bf16, with dropout 0.1 and without, within 2e-2 of the
       largest value of the plain version in f32 (LSE within 1e-3); the f32
       variants within 1e-4 of it.  The three kernels run their wgmma
       design at these shapes; their first (mma.sync) design, reached
       through the wrappers' `_impl="mma"`, must agree with it within the
       same tolerance and is timed in turns beside it (the wgmma design
       must be the faster), and is held against the plain version at
       N = 192, a shape it still serves.  Each time stands beside the plain
       version's, SDPA's without dropout and with the kernel's rate, and a
       bound: the largest of bytes, tensor operations, one exponential a
       score and, with dropout, the hash's integer operations;
  3. serves 3 requests of 8 synthetic scenes x 20 000 points through
     `Detector` at the full width of `sunrgbd_quick()` (seeded random
     weights): each request must launch FPS twice, the ball-group once, the
     attention forward 3 times and no backward kernel;
  4. runs one scene at f32 on the card and on the CPU (plain versions) with
     the same weights: query indices equal, box corners within 1e-3;
  5. trains: `build_training(sunrgbd_quick(), ...)` on the card takes one
     warm-up step and 5 timed steps on seeded synthetic batches (8 scenes x
     20 000 points, dropout as configured); each step must launch FPS twice,
     the ball-group once and each attention kernel 3 times, and give a
     finite loss and gradient norm.  Then a synchronised split of a step
     into forward, criterion, backward and optimiser, one step under
     torch.profiler, and the peak device memory of a step;
  6. takes one training step at f32 with every dropout at 0 on one scene at
     full width, on the card and on the CPU from the same weights: matched
     masks equal, every loss within 1e-4 relative, grad_norm within 1e-3;
  7. the masked-encoder ScanNet config (3DETR-m: `scannet_quick()` with
     `EncoderConfig(kind="masked", dropout=0.3)` and the matcher and loss
     weights of reference scripts/scannet_masked_ep1080.sh), at full width
     and depth on 8 scenes x 40 000 points:
       kernels: FPS 40000 -> 2048 -> 1024 -> 256 and a ragged 40001 -> 64,
       checked, timed and bounded as in 2; the
       ball-group at 40 000 points (C = 0) and at the interim SA's shapes
       (2048 tokens, 1024 centers, K = 32, C = 256), as in 2; the pick pass
       of its feature gradient (`slot_sources`) equal to its plain version at
       every position on two launches, and on a scene where the direct and
       the expanded distances split at r^2 (it must give the expanded pick,
       the forward the direct one); the feature gradient on the card against
       the CPU's, timed with the plain pick pass and with the kernel; the
       attention kernels with
       the radius bias at the three (N, r^2) of the encoder's layers, with
       token coordinates from the FPS picks above: the radius mask read
       back through the forward, dq and dk/dv kernels, in both designs,
       equals the plain version's bit for bit, bf16 within 2e-2 and f32
       within 1e-4 of the plain version (dropout 0 and 0.3), the two designs
       of the three kernels agreeing, each timed beside the first design
       (which must not be the faster at any layer), its plain
       version and `scaled_dot_product_attention` with the boolean mask
       (without dropout and with 0.3); the share of 64 x 64 and 128 x 128
       (q, k) tiles with no in-radius pair is printed;
       serving: 3 requests, each launching FPS 3 times, the ball-group
       twice, the radius forward 3 times and no backward kernel;
       training: one warm-up and 3 timed steps, each launching FPS 3 times,
       the ball-group twice, its pick pass once and each radius kernel 3
       times, with the stage
       split, peak memory and one profiled step; then one f32 step with
       every dropout at 0 on one scene, card against CPU, as in 6;
  8. the training CLI: `ov3det_torch.main.main(argv)` in this process on a
     fresh directory, `--dataset_name synthetic` at the full width of
     `scannet_quick()` (3 x 256 vanilla encoder, 8 x 256 decoder, 256
     queries, 18 classes, 1 angle bin, 8 scenes x 40 000 points, bf16) with
     the matcher and loss flags of scripts/scannet_quick.sh: 2 epochs of 8
     steps, an eval of the 16 test scenes (2 batches) after each and at the
     end, with the loss; it must save `checkpoint`, `checkpoint_best` and a
     `final_eval.txt` holding mAP0.25; a second call on the directory must
     return at the final-eval guard; `--test_only` on `checkpoint_best` must
     print the AP table of the epoch that saved it, digit for digit.  Every
     training step must launch FPS twice, the ball-group once and each
     attention kernel 3 times, every eval batch FPS twice, the ball-group
     once and the attention forward 3 times (read around each call alone).
     Printed: wall time per epoch, the host-clock iteration time (median and
     spread), the loop's wait on the loader, each eval pass split into
     forward, parse (NMS) and the host AP, checkpoint save and restore times
     and sizes, and the peak device memory; then the host AP with the C++
     rotated IoU and with the numpy one, in turns, on the `--test_only` pass
     and on 16 scenes of detections near the GT boxes;
  9. (after 11) prints the kernels line (launches summed over the serving
     and training runs of both configs, the CLI's run, phase 10's OV
     training and OV CLI runs and phase 11's runs), the card line, and last
     {"ok": true, "device": {...}}.
 10. the open-vocabulary step ("OV sunrgbd_quick": `sunrgbd_quick()` with
     the 2D-alignment loss at weight 1, as bench.py:518-530 builds it, and
     the frozen RegionCLIP RN50x4 teacher in int8 at its defaults, seeded
     weights, 8 `SyntheticOVDataset` scenes x 20 000 points with 530 x 730
     uint8 canvases, 1024 regions a step):
       `QuantConv`'s int8 product at three trunk shapes (res4 block 3x3,
       8 x 33 x 45 rows, 320 -> 320; res5 block 0 3x3 over a chunk, 82 944
       rows, 640 -> 640; res5 1x1, 20 736 rows, 2560 -> 640): the int32
       accumulators on the card equal the CPU's bit for bit; `_int_mm`
       alone, the whole int8 conv (im2col + product) and cuDNN's bf16 conv
       timed in turns beside their operations bounds;
       the whole teacher on one canvas and 8 boxes, card against CPU from
       the same weights: f32 within 1e-3 of the largest value; int8
       (quantised and calibrated on the card) cosine >= 0.999 per region
       and within INT8_CARD_VS_CPU of the largest value, beside the bf16
       teacher's distance from the int8 one;
       the teacher's forward alone on a batch, int8 against bf16, in turns;
       training: `build_training(..., teacher=)` with the teacher of
       `ov3det_torch.main.build_teacher`, one warm-up and 3 timed steps,
       each launching FPS twice, the ball-group once and each attention
       kernel 3 times, with a finite loss and loss_2dalignment > 0; the
       stage split (forward, teacher, criterion, backward, optimiser), peak
       memory, one profiled step (with the teacher range's device time and
       kernels, and the host's waits for the card), the lines that make the
       host wait in one step (CUDA's sync debug mode) and the bytes of one
       batch crossing to the card;
       the CLI: `main(argv)` with --use_image, --loss_2dalignment_weight 1
       and the flags of scripts/sunrgbd_quick.sh at full width (8 x 20 000
       points, bf16), one epoch of 8 steps and its evals: every step and
       eval batch launching as above, and a checkpoint holding the detector
       and its optimiser only, the keys, shapes and size of a point-only
       run's.
 11. the pseudo-label round at `scannet_quick()`'s width (the CLI's flags of
     scripts/scannet_quick.sh, bf16, batch 8) on a ScanNet-layout tree that
     `ov3det_torch.datasets.synthetic.write_scannet_tree` writes (16 train
     and 8 val scans of 40 000 points, per-scan point labels): one epoch of
     `ov3det_torch.main` to a checkpoint; `generate_pseudo_label.main` in
     this process with `--conf_thresh 0 --obj_thresh 0` (exactly 16 x 256
     finite rows, one file a scan; each of its 2 batches launching FPS
     twice, the ball-group once and the attention forward 3 times), then
     with `--label_dir` at the default thresholds (the boxes kept printed);
     the first batch's formatter rows from the card and from the CPU, the
     checkpoint at f32 (centres and sizes within 1e-3, score and objectness
     within 1e-4, labels where the top-2 margin exceeds 1e-4); one epoch of
     `--use_pbox` on the kept boxes (in nyu40 ids, `adjust_format_to_nyu40`),
     every step and eval batch launching as in 8; `lift_scene_scannet` on one
     scene of 4 frames whose 16-bit depth PNGs `write_png16` writes, with
     PIL never imported; the CLIP text tower at RN50x4's width from seeded
     weights on the 18 ScanNet classes x 15 templates (a stub vocabulary),
     card against CPU within 1e-5 of the largest value on 30 prompts, timed;
     a reference-layout 3DETR checkpoint at `scannet_quick()`'s width read by
     `load_reference_checkpoint` into a `Detector` with
     `ball_query_method="first_k"`: one request (FPS twice, no ball-group,
     the attention forward 3 times), its time and peak memory, the first-K
     indices card against CPU on one scene, and the first-K query and its
     grouping timed beside the tile ball-group at 8 x 40 000, M 2048, K 64.
Launch counts are set to 0 just before each serving, training and CLI run,
and read just after it.  The radius variants of the attention kernels count
apart (`.radius_launches`) and have their own entries in the kernels line.
Exits non-zero, printing no result, without CUDA or without the package
beside this file.  Any failed check raises.
"""
import collections
import contextlib
import dataclasses
import gc
import io
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, NUM_POINTS, REQUESTS = 8, 20000, 3  # sunrgbd_quick's data part
SCANNET_POINTS = 40000  # scannet_quick's data part, batch 8 as well
TRAIN_STEPS, MASKED_TRAIN_STEPS = 5, 3
ITERS_PER_EPOCH = 1000  # sets only the learning-rate schedule of the train phase
F32_PEAK, BF16_PEAK, HBM_BYTES_PER_S = 67e12, 989e12, 3.35e12  # H100 SXM data sheet
EX2_PER_SM_CLOCK, INT_LANES_PER_SM_CLOCK = 16, 64  # special-function and int32 results an SM a clock
# integer operations a score of the dropout hash with its row term formed once a
# thread and its column term advanced once a tile: 1.5 adds, the finaliser's
# 3 shifts, 3 xors and 2 multiplies, the compare and the select
HASH_OPS_PER_SCORE = 11


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel from nvcc's `-Xptxas -v` report:
    registers, spill stores and shared memory."""
    import re

    lines, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        tile = re.search(r"ball_group_tileILi([01])ELi(\d+)E", m.group(1)) if m else None
        if tile:
            kernel = f"ball_group_tile<{('fill', 'sources')[int(tile.group(1))]}, {tile.group(2)}>"
        elif m:
            t = re.search(r"(attn_(?:fwd|dq|dkv)_(?:bf16|f32|wgmma)|fps_kernel|fps_cluster_kernel|"
                          r"pick_kernel|fill_kernel)(?:ILi(\d+)E)?(?:ILb([01])E|Lb([01])E)?", m.group(1))
            flag = "cluster" if t and t.group(1) == "fps_cluster_kernel" else "radius"
            args = [a for a in (t.group(2), {"1": flag}.get(t.group(3) or t.group(4)))
                    if a] if t else []
            kernel = (t.group(1) + (f"<{', '.join(args)}>" if args else "")) if t else m.group(1)
        elif "spill stores" in line and kernel:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif "Used" in line and "registers" in line and kernel:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{kernel}: {regs} registers, {spill} B spilled, "
                         f"{smem.group(1) if smem else 0} B shared")
            kernel = None
    return lines


def sass_summary() -> list:
    """What the wgmma attention kernels (the forward, dq and dk/dv, each with
    and without the radius) compile to, from `cuobjdump -sass` of the two
    attention libraries: per kernel the count of warpgroup products
    (HGMMA), of mma.sync products (HMMA) and of asynchronous 16-byte copies
    (LDGSTS).  A wgmma kernel must hold the first and the last and no HMMA.
    And the tile ball-group's kernels the route launches (two tiles of
    centers of the forward, one of the pick pass) must hold no FFMA: each
    distance is rounded operation by operation."""
    import re

    from ov3det_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return [f"SASS not inspected: no cuobjdump beside {_build.nvcc_path()}"]
    lines = []
    for name, expected in (("attention_fwd", 2), ("attention_bwd", 4)):
        res = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                             capture_output=True, text=True, timeout=300, check=True)
        counts, kernel = {}, None
        for line in res.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                t = re.search(r"attn_(?:fwd|dq|dkv)_wgmmaILb([01])E", m.group(1))
                kernel = (t.group(0).split("IL")[0] + ("<radius>" if t.group(1) == "1" else "")) if t else None
            elif kernel:
                for op in ("HGMMA", "HMMA", "LDGSTS"):
                    if re.search(rf"\b{op}\b", line):
                        counts.setdefault(kernel, dict(HGMMA=0, HMMA=0, LDGSTS=0))[op] += 1
        for kernel, c in counts.items():
            require(c["HGMMA"] > 0 and c["LDGSTS"] > 0 and c["HMMA"] == 0,
                    f"{kernel} must run on wgmma and cp.async alone: {c}")
            lines.append(f"{kernel}: {c['HGMMA']} HGMMA, {c['HMMA']} HMMA, {c['LDGSTS']} LDGSTS in its SASS")
        require(len(counts) == expected,
                f"{name}: expected {expected} wgmma kernels in the SASS, found {sorted(counts)}")
    # the tile ball-group: no fused multiply-add may round a distance
    res = subprocess.run([tool, "-sass", str(_build.library_path("ball_group"))],
                         capture_output=True, text=True, timeout=300, check=True)
    ffma, kernel = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            t = re.search(r"ball_group_tileILi([01])ELi(\d+)E", m.group(1))
            kernel = (f"ball_group_tile<{('fill', 'sources')[int(t.group(1))]}, {t.group(2)}>"
                      if t else None)
            if kernel:
                ffma[kernel] = 0
        elif kernel and re.search(r"\bFFMA\b", line):
            ffma[kernel] += 1
    modes = sorted(k.split("<")[1].split(",")[0] for k in ffma)
    require(modes == ["fill", "fill", "sources"],
            f"ball_group: expected the forward at two tiles and the pick pass in the SASS, found "
            f"{sorted(ffma)}")
    require(not any(ffma.values()), f"ball_group tile kernels hold FFMA: {ffma}")
    lines.append(f"{', '.join(sorted(ffma))}: 0 FFMA in their SASS")
    return lines


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of one call, from CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of one call: `reps` calls captured in a CUDA graph
    (after one call outside it), the graph replayed once, then timed by CUDA
    events around one replay, so that the host's cost of each call (the
    wrapper's checks, allocation and launch) does not enter the time of a
    kernel shorter than it.  The launches a capture records count once, at
    capture, in the wrappers' counts."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def designs_in_turns(kernel, rate: float, seed, reps: int) -> tuple:
    """(ms, ms without dropout, the same two of the first design) of
    `kernel(p, seed, impl)`, timed this design, the first, the first, this,
    the smaller of each pair kept."""
    ms, nd_ms = cuda_ms(lambda: kernel(rate, seed), reps), cuda_ms(lambda: kernel(0.0, None), reps)
    old_ms = cuda_ms(lambda: kernel(rate, seed, "mma"), reps)
    old_nd = cuda_ms(lambda: kernel(0.0, None, "mma"), reps)
    old_ms = min(old_ms, cuda_ms(lambda: kernel(rate, seed, "mma"), reps))
    old_nd = min(old_nd, cuda_ms(lambda: kernel(0.0, None, "mma"), reps))
    ms = min(ms, cuda_ms(lambda: kernel(rate, seed), reps))
    nd_ms = min(nd_ms, cuda_ms(lambda: kernel(0.0, None), reps))
    return ms, nd_ms, old_ms, old_nd


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sm_rates() -> tuple[float, float]:
    """(exponentials a second, int32 operations a second) of the card: 16 and
    64 results an SM a clock, at the SM count and clock the card reports."""
    props = torch.cuda.get_device_properties(0)
    khz = getattr(props, "clock_rate", None)
    if not khz:  # older PyTorch: nvidia-smi gives the maximum SM clock in MHz
        res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True)
        khz = float(res.stdout.strip().splitlines()[0]) * 1e3
    per_s = props.multi_processor_count * khz * 1e3
    return EX2_PER_SM_CLOCK * per_s, INT_LANES_PER_SM_CLOCK * per_s


def attention_bound(nbytes: float, tensor_flops: float, scores: float, dropout: bool,
                    f32_ops: float = 0.0) -> dict:
    """The least time of one attention kernel call: the largest of its bytes
    at the memory rate, its tensor operations at the bf16 peak, one
    exponential a score, its f32 operations (the radius test) and, with
    dropout, the hash's integer operations.  Returns bound_ms, bound_by
    ("bytes" or "operations") and bound_term, the term that won."""
    ex2_rate, int_rate = sm_rates()
    terms = {"bytes": nbytes / HBM_BYTES_PER_S, "tensor operations": tensor_flops / BF16_PEAK,
             "exponentials": scores / ex2_rate, "distance test": f32_ops / F32_PEAK}
    if dropout:
        terms["hash"] = HASH_OPS_PER_SCORE * scores / int_rate
    term = max(terms, key=terms.get)
    return dict(bound_ms=terms[term] * 1e3, bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def kernel_counters() -> dict:
    """name -> (wrapper, attribute): each wrapper counts its kernel's launches
    in `.launches`, the attention wrappers those of the radius variant in
    `.radius_launches`."""
    from ov3det_torch.ops.kernels import attention, ball_group, fps

    counters = {"fps": (fps.fps, "launches"), "ball_group": (ball_group.ball_group, "launches"),
                "slot_sources": (ball_group.slot_sources, "launches")}
    for name in ("attention_fwd", "attention_dq", "attention_dkv"):
        counters[name] = (getattr(attention, name), "launches")
        counters[f"{name}_radius"] = (getattr(attention, name), "radius_launches")
    return counters


def read_counts() -> dict:
    return {n: getattr(w, a) for n, (w, a) in kernel_counters().items()}


def reset_counts() -> None:
    for w, a in kernel_counters().values():
        setattr(w, a, 0)


def kernel_sources() -> dict:
    """name -> (source in the repo, the TPU kernel it replaces)."""
    from ov3det_torch.ops.kernels import attention, ball_group, fps

    return {"fps": (fps.SOURCE, fps.REPLACES),
            "ball_group": (ball_group.SOURCE, ball_group.REPLACES),
            "slot_sources": (ball_group.SOURCE, ball_group.SOURCES_REPLACES),
            "attention_fwd": (attention.SOURCE, attention.REPLACES),
            "attention_dq": (attention.BWD_SOURCE, attention.DQ_REPLACES),
            "attention_dkv": (attention.BWD_SOURCE, attention.DKV_REPLACES),
            "attention_fwd_radius": (attention.SOURCE, attention.FWD_RADIUS_REPLACES),
            "attention_dq_radius": (attention.BWD_SOURCE, attention.DQ_RADIUS_REPLACES),
            "attention_dkv_radius": (attention.BWD_SOURCE, attention.DKV_RADIUS_REPLACES)}


def expect(**counts) -> dict:
    """Launches of every counter: the named ones as given, the rest 0."""
    return {n: counts.get(n, 0) for n in kernel_counters()}


def check_fps(fps, calls: list, ragged, label: str) -> dict:
    """FPS at the (cloud, samples) `calls` of one request: the indices of the
    cluster design must equal the plain version's and the first design's (at
    the ragged cloud too); both designs are timed in turns, the plain version
    once, and the chain alone (the step's reductions, exchange and wait on no
    points, at the call's cluster size and sample count).  Returns the sums
    over the calls as the kernels line's keys: `bound_ms` and `bound_by` are
    the bytes and f32 operations of these inputs at the card's peak rates;
    `chain_floor_ms` is a measurement of this design's own step, kept beside
    the bound and never in its place."""
    tot = dict(ms=0.0, ms_previous_design=0.0, plain_ms=0.0, chain_floor_ms=0.0)
    nbytes, ops, plans, shapes = 0, 0, [], []
    for xyz, k in list(calls) + [ragged]:
        N = xyz.shape[1]
        want = fps.fps_plain(xyz, k)
        require(torch.equal(fps.fps(xyz, k), want), f"fps {N}->{k} differs from plain")
        require(torch.equal(fps.fps(xyz, k, _impl="first"), want),
                f"fps {N}->{k}: the first design differs from plain")
    for xyz, k in calls:
        B, N, _ = xyz.shape
        reps = 3 if N > 4096 else 10
        plan = fps.plan(B, N)
        ms, old = cuda_ms(lambda: fps.fps(xyz, k), reps), cuda_ms(lambda: fps.fps(xyz, k, _impl="first"), reps)
        old = min(old, cuda_ms(lambda: fps.fps(xyz, k, _impl="first"), reps))
        ms = min(ms, cuda_ms(lambda: fps.fps(xyz, k), reps))
        chain = cuda_ms(lambda: fps.chain(B, k, plan["cluster"], xyz.device), reps)
        plain = cuda_ms(lambda: fps.fps_plain(xyz, k), 1 if N > 20000 else 2)
        require(ms <= old, f"fps {N}->{k}: the cluster design ({ms:.3f} ms) is slower than the "
                           f"first ({old:.3f} ms)")
        print(f"fps {B}x{N}->{k}: cluster of {plan['cluster']} ({plan['ctas']} CTAs of "
              f"{plan['threads']} threads, {plan['clusters_at_once']} clusters fit at once): "
              f"{ms:.3f} ms ({ms / (k - 1) * 1e3:.3f} us a step); first design {old:.3f} ms; the "
              f"chain alone {chain:.3f} ms ({chain / (k - 1) * 1e3:.3f} us a step); plain {plain:.3f} ms")
        for key, val in (("ms", ms), ("ms_previous_design", old), ("plain_ms", plain),
                         ("chain_floor_ms", chain)):
            tot[key] += val
        nbytes += B * (N * 12 + k * 8)
        ops += 10 * B * (k - 1) * N  # 3 sub, 3 mul, 2 add, min, compare per point-step
        plans.append(dict(points=N, samples=k, **plan))
        shapes.append(f"{N}->{k}")
    b_ms, b_by = bound_ms(nbytes, ops, F32_PEAK)
    work = f"one {label} request: {BATCH}x" + " + ".join(shapes)
    print(f"fps ({label}): indices equal the plain version's and the first design's at "
          f"{', '.join(shapes)} and at the ragged {ragged[0].shape[1]}->{ragged[1]}; cluster design "
          f"{tot['ms']:.3f} ms, first design {tot['ms_previous_design']:.3f} ms, plain "
          f"{tot['plain_ms']:.3f} ms; bound {b_ms:.4f} ms ({b_by}), chain floor "
          f"{tot['chain_floor_ms']:.3f} ms")
    return dict(max_abs_err=0.0, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, bound_term=b_by,
                chain_floor_ms=tot["chain_floor_ms"], library_ms=None,
                design="thread-block cluster per scene, st.async exchange",
                ms_previous_design=tot["ms_previous_design"], launch_plans=plans, work=work)


def grow_by_one(xyz: torch.Tensor) -> torch.Tensor:
    """The cloud with one more point: a point count that no tile divides."""
    return torch.cat([xyz, xyz[:, :1] + 0.5], dim=1).contiguous()


def check_kernels(batch: dict, dev: torch.device) -> dict:
    """Phase 2: the point kernels against their plain versions, timed;
    returns their entries for one request's work on the serving path."""
    from ov3det_torch.ops.kernels import fps

    xyz = torch.from_numpy(batch["point_clouds"]).to(dev)
    B, N, _ = xyz.shape
    entries = {}

    # FPS: 20000 -> 2048 (pre-encoder), then 2048 -> 128 (query seeds)
    inds = fps.fps(xyz, 2048)
    pre_xyz = torch.gather(xyz, 1, inds[..., None].expand(-1, -1, 3)).contiguous()
    entries["fps"] = check_fps(fps, [(xyz, 2048), (pre_xyz, 128)], (grow_by_one(xyz), 64), "sunrgbd")

    # ball-group: 8 x 20000 points, 2048 centers, K = 64, r = 0.2; C = 0 and C = 3,
    # then a ragged N (20 001 points) and a ragged M (2047 centers)
    K, radius = 64, 0.2
    feats = torch.randn(B, N, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    main = check_ball_group(xyz, None, pre_xyz, radius, K, "sunrgbd C=0", 10)
    c3 = check_ball_group(xyz, feats, pre_xyz, radius, K, "sunrgbd C=3", 10)
    grown = grow_by_one(xyz)
    ragged_n = check_ball_group(grown, torch.cat([feats, feats[:, :1]], 1).contiguous(), pre_xyz,
                                radius, K, "ragged N=20001 C=3", 3)
    ragged_m = check_ball_group(xyz, None, pre_xyz[:, :2047].contiguous(), radius, K,
                                "ragged M=2047 C=0", 3)
    entries["ball_group"] = dict(main, max_abs_err=0.0, library_ms=None,
                                 design="tile: a CTA a (scene, tile of centers), buckets staged by "
                                        "cp.async, picks in shared memory, one launch",
                                 shapes={"c3": c3, "ragged_n": ragged_n, "ragged_m": ragged_m},
                                 work="one request: 8x20000, M=2048, K=64, C=0")
    return entries


def distance_tests(pick, has, N: int, K: int) -> int:
    """Distance tests the early exit leaves: each bucket is scanned up to its
    first hit, or whole (its length within N) when it holds none."""
    Nb = -(-N // K)
    starts = torch.arange(K, device=pick.device) * Nb
    bucket_len = torch.clamp(N - starts, 0, Nb)
    return int(torch.where(has, pick - starts + 1, bucket_len).sum().item())


def check_ball_group(xyz, feats, centers, radius: float, K: int, label: str, reps: int) -> dict:
    """The forward at one shape: the tile design's output equals the plain
    version's and the first design's bit for bit, on two launches; the two
    designs timed in turns (tile, first, first, tile; the smaller of each
    pair; each a CUDA graph of `reps` calls: `graph_ms`), the plain version
    once.  The bound: the bytes (points, centers
    and features read once, the output written once) or the distance tests
    this data needs with the early exit (9 f32 operations each), the larger."""
    from ov3det_torch.ops.kernels import ball_group as BG

    B, N, _ = xyz.shape
    M = centers.shape[1]
    C = 0 if feats is None else feats.shape[-1]
    want = BG.ball_group_plain(xyz, feats, centers, radius, K)
    for launch in range(2):
        got = BG.ball_group(xyz, feats, centers, radius, K)
        require(torch.equal(got, want), f"ball_group {label}, launch {launch}: the tile design "
                                        f"differs from plain by {(got - want).abs().max().item()}")
    first = BG.ball_group(xyz, feats, centers, radius, K, _impl="first")
    require(torch.equal(first, want), f"ball_group {label}: the first design differs from plain")
    ms = graph_ms(lambda: BG.ball_group(xyz, feats, centers, radius, K), reps)
    old = graph_ms(lambda: BG.ball_group(xyz, feats, centers, radius, K, _impl="first"), reps)
    old = min(old, graph_ms(lambda: BG.ball_group(xyz, feats, centers, radius, K, _impl="first"), reps))
    ms = min(ms, graph_ms(lambda: BG.ball_group(xyz, feats, centers, radius, K), reps))
    plain = cuda_ms(lambda: BG.ball_group_plain(xyz, feats, centers, radius, K), 1)
    tests = distance_tests(*BG.bucket_picks(xyz, centers, radius, K), N, K)
    nbytes = (xyz.numel() + centers.numel() + (0 if feats is None else feats.numel())
              + want.numel()) * 4
    b_ms, b_by = bound_ms(nbytes, 9 * tests, F32_PEAK)
    print(f"ball_group {label} ({B}x{N}, M={M}, K={K}, C={C}): tile design equals plain and the "
          f"first design on two launches; "
          f"{tests} distance tests with early exit; tile {ms:.4f} ms, first design {old:.4f} ms, "
          f"plain {plain:.3f} ms, bound {b_ms:.4f} ms ({b_by}; output {want.numel() * 4 / 1e6:.1f} MB)")
    return dict(ms=ms, ms_previous_design=old, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                distance_tests=tests)


def reveal_masks(A, seed, rate: float, BH: int, N: int, D: int, dev, radius=None,
                 impl=None) -> dict:
    """The mask as each bf16 kernel applies it, read back exactly: the
    dropout mask, or with `radius` and no dropout the radius mask; `impl` is
    the wrappers' `_impl` (None: the design the shape routes to, "mma": the
    first design).

    With q = 0 every probability is 1/N (1/count of the in-radius keys with
    the radius), so a kernel's output is 0 exactly where it dropped or
    masked a position.  One-hot operands pick D columns per launch:
      forward: V = one-hot(key t*D + d)      -> out[q, d]  = m(q, t*D + d) / N
      dq:      K = one-hot, V = dO = 1        -> dq[q, d]   ~ m(q, t*D + d)
      dk/dv:   dO = one-hot(query t*D + d)    -> dv[key, d] = m(t*D + d, key) / N
    """
    bf = dict(dtype=torch.bfloat16, device=dev)
    zero, ones = torch.zeros(BH, N, D, **bf), torch.ones(BH, N, D, **bf)
    lse = torch.full((BH, N, 1), math.log(N), dtype=torch.float32, device=dev)
    no_delta = torch.zeros(BH, N, 1, dtype=torch.float32, device=dev)
    eye = torch.eye(D, **bf)
    seen = {name: torch.empty(BH, N, N, dtype=torch.bool, device=dev)
            for name in ("attention_fwd", "attention_dq", "attention_dkv")}
    for t in range(N // D):
        cols = slice(t * D, (t + 1) * D)
        sel = torch.zeros(BH, N, D, **bf)
        sel[:, cols] = eye
        out, _ = A.attention_fwd(zero, zero, sel, rate, seed, radius, _impl=impl)
        seen["attention_fwd"][:, :, cols] = out != 0
        dq = A.attention_dq(zero, sel, ones, ones, lse, no_delta, rate, seed, radius, _impl=impl)
        seen["attention_dq"][:, :, cols] = dq != 0
        _, dv = A.attention_dkv(zero, zero, zero, sel, lse, no_delta, rate, seed, radius,
                                _impl=impl)
        seen["attention_dkv"][:, cols, :] = (dv != 0).transpose(1, 2)
    return seen


def check_attention(dev: torch.device) -> dict:
    """Phase 2, attention: the three kernels of the training step's encoder
    (BH = 8 x 4 heads, N = 2048, D = 64) against their plain versions, per
    call.  The operands (8 MB each) stay in the 50 MB L2 between timed
    launches."""
    from ov3det_torch.ops.kernels import attention as A

    BH, N, D, rate = 32, 2048, 64, 0.1
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(BH, N, D, generator=g).to(dev) for _ in range(4))
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    seed = torch.tensor([20260101], dtype=torch.int32, device=dev)

    kept = A.drop_mask(seed, BH, N, N, rate) != 0
    for impl in (None, "mma"):
        for name, mask in reveal_masks(A, seed, rate, BH, N, D, dev, impl=impl).items():
            flips = int((mask != kept).sum())
            require(flips == 0, f"{name} (_impl={impl}): the dropout mask differs from the hash at "
                                f"{flips} positions")
    print(f"attention dropout p={rate}: the masks of the forward, dq and dk/dv kernels, in the wgmma "
          f"and in the first design, equal the hash at all {kept.numel()} positions (kept share "
          f"{kept.float().mean().item():.4f})")
    del kept, mask

    def rel(got, want):  # max error over the largest magnitude of the plain version
        err = (got.float() - want).abs().max()
        abs_err[0] = max(abs_err[0], err.item())
        return (err / want.abs().max()).item()

    errs = {"attention_fwd": 0.0, "attention_dq": 0.0, "attention_dkv": 0.0}
    abs_err = [0.0]
    for p in (0.0, rate):
        out, lse = A.attention_fwd(qb, kb, vb, p, seed)
        ref, ref_lse = A.attention_fwd_plain(qb.float(), kb.float(), vb.float(), p, seed)
        abs_err[0] = 0.0
        e_out, e_lse = rel(out, ref), (lse - ref_lse).abs().max().item()
        errs["attention_fwd"] = max(errs["attention_fwd"], abs_err[0])
        require(e_out <= 2e-2 and e_lse <= 1e-3, f"attention_fwd bf16 p={p}: {e_out}, lse {e_lse}")
        delta = (dob.float() * out.float()).sum(-1, keepdim=True)
        dq = A.attention_dq(qb, kb, vb, dob, lse, delta, p, seed)
        dk, dv = A.attention_dkv(qb, kb, vb, dob, lse, delta, p, seed)
        f32 = [t.float() for t in (qb, kb, vb, dob)]
        rdq = A.attention_dq_plain(*f32, lse, delta, p, seed)
        rdk, rdv = A.attention_dkv_plain(*f32, lse, delta, p, seed)
        abs_err[0] = 0.0
        e_dq = rel(dq, rdq)
        errs["attention_dq"] = max(errs["attention_dq"], abs_err[0])
        abs_err[0] = 0.0
        e_dkv = max(rel(dk, rdk), rel(dv, rdv))
        errs["attention_dkv"] = max(errs["attention_dkv"], abs_err[0])
        require(e_dq <= 2e-2 and e_dkv <= 2e-2, f"attention backward bf16 p={p}: dq {e_dq}, dk/dv {e_dkv}")
        # the first (mma.sync) design of the three kernels on the same inputs
        old_out, old_lse = A.attention_fwd(qb, kb, vb, p, seed, _impl="mma")
        old_dq = A.attention_dq(qb, kb, vb, dob, lse, delta, p, seed, _impl="mma")
        old_dk, old_dv = A.attention_dkv(qb, kb, vb, dob, lse, delta, p, seed, _impl="mma")
        e_old = max((a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                    for a, b in ((out, old_out), (dq, old_dq), (dk, old_dk), (dv, old_dv)))
        e_old_lse = (lse - old_lse).abs().max().item()
        require(e_old <= 2e-2 and e_old_lse <= 1e-3,
                f"attention p={p}: the wgmma and mma.sync designs differ by {e_old}, lse {e_old_lse}")

        out32, lse32 = A.attention_fwd(q, k, v, p, seed)
        ref32, rlse32 = A.attention_fwd_plain(q, k, v, p, seed)
        d32 = (do * out32).sum(-1, keepdim=True)
        e32 = [rel(out32, ref32), (lse32 - rlse32).abs().max().item(),
               rel(A.attention_dq(q, k, v, do, lse32, d32, p, seed),
                   A.attention_dq_plain(q, k, v, do, lse32, d32, p, seed))]
        e32 += [rel(a, b) for a, b in zip(A.attention_dkv(q, k, v, do, lse32, d32, p, seed),
                                          A.attention_dkv_plain(q, k, v, do, lse32, d32, p, seed))]
        require(max(e32) <= 1e-4, f"attention f32 p={p}: out, lse, dq, dk, dv errors {e32}")
        print(f"attention p={p}: bf16 error over the largest plain value: out {e_out:.2e}, "
              f"lse {e_lse:.2e} (abs), dq {e_dq:.2e}, dk/dv {e_dkv:.2e}; wgmma against mma.sync "
              f"design {e_old:.2e}, lse {e_old_lse:.2e}; f32 variants {max(e32):.2e}")

    first_design_check(A, dev)

    out, lse = A.attention_fwd(qb, kb, vb, rate, seed)
    delta = (dob.float() * out.float()).sum(-1, keepdim=True)
    bwd = (qb, kb, vb, dob, lse, delta)
    # name -> (kernel(p, seed, impl), plain version with dropout)
    calls = {
        "attention_fwd": (lambda p, sd, impl=None: A.attention_fwd(qb, kb, vb, p, sd, _impl=impl),
                          lambda: A.attention_fwd_plain(qb, kb, vb, rate, seed)),
        "attention_dq": (lambda p, sd, impl=None: A.attention_dq(*bwd, p, sd, _impl=impl),
                         lambda: A.attention_dq_plain(*bwd, rate, seed)),
        "attention_dkv": (lambda p, sd, impl=None: A.attention_dkv(*bwd, p, sd, _impl=impl),
                          lambda: A.attention_dkv_plain(*bwd, rate, seed)),
    }
    # yardsticks: PyTorch's fused attention without dropout and with the
    # kernels' rate; its backward computes dq, dk and dv in one call
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t.view(8, 4, N, D).detach().requires_grad_() for t in (qb, kb, vb))
    g4 = dob.view(8, 4, N, D)
    library, library_drop = {}, {}
    for p, into in ((0.0, library), (rate, library_drop)):
        into["attention_fwd"] = cuda_ms(lambda: sdpa(q4, k4, v4, dropout_p=p), 20)
        o4 = sdpa(q4, k4, v4, dropout_p=p)
        into["attention_dq"] = into["attention_dkv"] = cuda_ms(
            lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True), 20)
    flops = {"attention_fwd": 4, "attention_dq": 6, "attention_dkv": 8}  # x BH N^2 D
    tensor = BH * N * D * 2  # bytes of one bf16 operand
    nbytes = {"attention_fwd": 4 * tensor + BH * N * 4,  # q, k, v in; out, lse out
              "attention_dq": 5 * tensor + 2 * BH * N * 4,  # q, k, v, dO, lse, delta in; dq out
              "attention_dkv": 6 * tensor + 2 * BH * N * 4}
    scores = BH * N * N  # one exponential each, recomputed in dq and in dk/dv
    ex2_rate, int_rate = sm_rates()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"bounds: {sms} SMs at {ex2_rate / EX2_PER_SM_CLOCK / sms / 1e9:.3f} GHz: "
          f"{ex2_rate:.3e} exponentials/s, {int_rate:.3e} int32 operations/s, "
          f"{HASH_OPS_PER_SCORE} of them a score for the dropout hash")
    entries = {}
    for name, (kernel, plain) in calls.items():
        ms, nd_ms, old_ms, old_nd = designs_in_turns(kernel, rate, seed, 20)
        require(ms < old_ms and nd_ms < old_nd,
                f"{name}: the wgmma design ({ms:.3f} / {nd_ms:.3f} ms with / without dropout) is "
                f"not faster than the mma.sync design ({old_ms:.3f} / {old_nd:.3f} ms)")
        extra = dict(design="wgmma, cp.async ring", ms_previous_design=old_ms,
                     ms_previous_design_no_dropout=old_nd)
        plain_ms = cuda_ms(plain, 3)
        args = (nbytes[name], flops[name] * BH * N * N * D, scores)
        bound, bound_nd = attention_bound(*args, dropout=True), attention_bound(*args, dropout=False)
        was = f"; mma.sync design {old_ms:.3f} ms ({old_nd:.3f})"
        print(f"{name}: per call with dropout {rate}: kernel {ms:.3f} ms (without dropout "
              f"{nd_ms:.3f} ms){was}, plain {plain_ms:.3f} ms, library "
              f"{library_drop[name]:.3f} ms with dropout {rate} ({library[name]:.3f} ms without)"
              f"{' (SDPA backward: dq, dk and dv)' if name != 'attention_fwd' else ' (SDPA)'}, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_term']}; without dropout "
              f"{bound_nd['bound_ms']:.4f} ms, {bound_nd['bound_term']})")
        entries[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, **bound,
                             library_ms=library[name], library_ms_dropout=library_drop[name],
                             ms_no_dropout=nd_ms, bound_ms_no_dropout=bound_nd["bound_ms"],
                             bound_term_no_dropout=bound_nd["bound_term"], **extra,
                             work=f"one call, BH=32, N=2048, D=64 bf16, dropout {rate}; "
                                  "max_abs_err of bf16 against the plain version in f32")
    return entries


def first_design_check(A, dev: torch.device) -> None:
    """The first (mma.sync) forward, dq and dk/dv stay the route of every bf16
    shape the wgmma design does not take, and no main path reaches them: held
    against their plain versions at N = 192 (a multiple of 64, not of 128),
    with dropout and the radius."""
    BH, N, D, rate = 8, 192, 64, 0.1
    g = torch.Generator().manual_seed(7)
    q, k, v, do = (torch.randn(BH, N, D, generator=g).to(dev).bfloat16() for _ in range(4))
    xyz = torch.rand(2, N, 3, generator=g).to(dev)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    require(A._route(q.dtype, D, N, N) == "mma", "N = 192 must take the first design")
    worst = 0.0
    for radius in (None, (xyz, xyz, 0.25)):
        out, lse = A.attention_fwd(q, k, v, rate, seed, radius)
        f32 = [t.float() for t in (q, k, v, do)]
        ref, ref_lse = A.attention_fwd_plain(*f32[:3], rate, seed, radius)
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        pairs = [(out, ref), (A.attention_dq(q, k, v, do, lse, delta, rate, seed, radius),
                              A.attention_dq_plain(*f32, lse, delta, rate, seed, radius))]
        pairs += list(zip(A.attention_dkv(q, k, v, do, lse, delta, rate, seed, radius),
                          A.attention_dkv_plain(*f32, lse, delta, rate, seed, radius)))
        err = max(((a.float() - b).abs().max() / b.abs().max()).item() for a, b in pairs)
        e_lse = (lse - ref_lse).abs().max().item()
        require(err <= 2e-2 and e_lse <= 1e-3,
                f"first design at N=192, radius {radius is not None}: {err}, lse {e_lse}")
        worst = max(worst, err)
    print(f"attention, first design (mma.sync) at BH=8, N=192: forward, dq and dk/dv within "
          f"{worst:.2e} of the largest plain value, with dropout {rate}, with and without the radius")


def check_masked_points(batch: dict, dev: torch.device) -> tuple:
    """Phase 7, point kernels of the masked ScanNet config: FPS and the
    ball-group at its shapes against their plain versions and first designs,
    timed, and the pick pass of the ball-group's feature gradient with the
    gradient itself on the card against the CPU.  Returns (extras for the
    fps and ball_group entries and the slot_sources entry, the token
    coordinates at 2048 and 1024 tokens)."""
    from ov3det_torch.ops.kernels import fps

    xyz = torch.from_numpy(batch["point_clouds"]).to(dev)
    B, N, _ = xyz.shape
    gather = lambda p, i: torch.gather(p, 1, i[..., None].expand(-1, -1, 3)).contiguous()  # noqa: E731
    samples, clouds = (2048, 1024, 256), [xyz]
    for k in samples:
        clouds.append(gather(clouds[-1], fps.fps(clouds[-1], k)))
    fps_extra = check_fps(fps, list(zip(clouds, samples)), (grow_by_one(xyz), 64), "scannet_masked")
    del fps_extra["max_abs_err"]

    # pre-encoder 8 x 40000, M = 2048, K = 64, r = 0.2, C = 0; interim SA:
    # 2048 tokens, 1024 centers, K = 32, r = 0.4, C = 256
    pre_xyz, mid_xyz = clouds[1], clouds[2]
    feats = torch.randn(B, 2048, 256, generator=torch.Generator().manual_seed(2)).to(dev)
    pre = check_ball_group(xyz, None, pre_xyz, 0.2, 64, "masked pre-encoder C=0", 5)
    mid = check_ball_group(pre_xyz, feats, mid_xyz, 0.4, 32, "masked interim C=256", 5)
    bg_extra = dict(mid, library_ms=None, pre_encoder=pre,
                    work="one interim SA call: 8x2048, M=1024, K=32, C=256")
    return {"fps": fps_extra, "ball_group": bg_extra,
            "slot_sources": check_slot_sources(pre_xyz, mid_xyz, dev)}, pre_xyz, mid_xyz


def check_slot_sources(pre_xyz, mid_xyz, dev: torch.device) -> dict:
    """The feature gradient's pick pass (`ball_group_tile<sources>`) at the
    interim SA's shape: equal to the plain version at every position on two
    launches, and on a scene where the direct and the expanded distances
    split at r^2 (the expanded pick must win); the kernel timed as
    replays of a CUDA graph (`graph_ms`); then the feature gradient on the
    card against the CPU's, timed with the plain pick pass ("before") and
    with the kernel ("after").  Returns the kernels line's entry."""
    from ov3det_torch.ops.kernels import ball_group as BG

    B, N, _ = pre_xyz.shape
    M, K, radius, C = mid_xyz.shape[1], 32, 0.4, 256
    want = BG.slot_sources_plain(pre_xyz, mid_xyz, radius, K)
    for launch in range(2):
        got = BG.slot_sources(pre_xyz, mid_xyz, radius, K)
        require(torch.equal(got, want), f"slot_sources, launch {launch}: differs from the plain "
                                        f"version at {int((got != want).sum())} positions")
    # the boundary scene: center (10, 0, 0), a point just outside r by the
    # direct distance and inside by the expanded one, first in bucket 0
    c0, r = np.float32(10.0), 0.2
    r2 = np.float32(r * r)
    p = np.nextafter(np.float32(c0 + np.float32(r)), np.float32(0))
    expanded = lambda p: np.maximum((c0 * c0 + p * p) - np.float32(2) * (c0 * p), 0)  # noqa: E731
    while not ((p - c0) * (p - c0) >= r2 and expanded(p) < r2):
        p = np.nextafter(p, np.float32(20))
    edge = np.zeros((1, 4, 3), np.float32)
    edge[0, :, 0] = [30.0, p, c0 - np.float32(0.1), 40.0]
    e_xyz = torch.from_numpy(edge).to(dev)
    e_c = torch.tensor([[[10.0, 0.0, 0.0]]], device=dev)
    e_feats = torch.arange(8, dtype=torch.float32, device=dev).view(1, 4, 2)
    e_src = BG.slot_sources(e_xyz, e_c, r, 1)
    e_out = BG.ball_group(e_xyz, e_feats, e_c, r, 1)
    require(e_src.item() == 1 and torch.equal(e_src, BG.slot_sources_plain(e_xyz, e_c, r, 1)),
            f"slot_sources at the r^2 boundary: {e_src.item()}, the expanded pick is 1")
    require(e_out[0, 0, 0, 3:].tolist() == [4.0, 5.0], "ball_group at the r^2 boundary must take "
                                                        "the direct pick, point 2")

    ms = graph_ms(lambda: BG.slot_sources(pre_xyz, mid_xyz, radius, K), 10)
    plain = cuda_ms(lambda: BG.slot_sources_plain(pre_xyz, mid_xyz, radius, K), 2)
    ms = min(ms, graph_ms(lambda: BG.slot_sources(pre_xyz, mid_xyz, radius, K), 10))
    tests = distance_tests(*BG.bucket_picks_expanded(pre_xyz, mid_xyz, radius, K), N, K)
    # 10 f32 operations a test: c.x five, then add, multiply by 2, subtract,
    # clamp, compare; |x|^2 five once a point and |c|^2 five once a center
    b_ms, b_by = bound_ms((pre_xyz.numel() + mid_xyz.numel()) * 4 + want.numel() * 4,
                          10 * tests + 5 * B * (N + M), F32_PEAK)

    g = torch.randn(B, K, M, 3 + C, generator=torch.Generator().manual_seed(3)).to(dev)
    grad = BG.feature_grad(pre_xyz, mid_xyz, radius, K, g, C)
    cpu = BG.feature_grad(pre_xyz.cpu(), mid_xyz.cpu(), radius, K, g.cpu(), C)
    g_err = (grad.cpu() - cpu).abs().max().item() / cpu.abs().max().item()
    # the card's index_add_ sums with atomics, in another order than the CPU
    require(g_err <= 1e-5, f"ball_group feature gradient: card vs CPU {g_err} relative")
    before = cuda_ms(lambda: BG.feature_grad_plain(pre_xyz, mid_xyz, radius, K, g, C), 3)
    after = cuda_ms(lambda: BG.feature_grad(pre_xyz, mid_xyz, radius, K, g, C), 10)
    before = min(before, cuda_ms(lambda: BG.feature_grad_plain(pre_xyz, mid_xyz, radius, K, g, C), 3))
    after = min(after, cuda_ms(lambda: BG.feature_grad(pre_xyz, mid_xyz, radius, K, g, C), 10))
    # its bound: the grouped gradient's features read once, the feature gradient written once
    g_bound = (B * K * M * C + B * N * C) * 4 / HBM_BYTES_PER_S * 1e3
    print(f"slot_sources ({B}x{N}, M={M}, K={K}): equals the plain version at all {want.numel()} "
          f"positions on two launches, and gives the expanded pick at the r^2 boundary (the forward "
          f"the direct one); {tests} distance tests with early exit; kernel {ms:.4f} ms, plain "
          f"{plain:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    print(f"ball_group feature gradient (C=256): card vs CPU within {g_err:.2e} of the largest "
          f"value; with the pick kernel {after:.3f} ms, with the plain pick pass {before:.3f} ms, "
          f"bound {g_bound:.4f} ms (bytes)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, distance_tests=tests, feature_grad_ms=after,
                feature_grad_plain_ms=before, feature_grad_bound_ms=g_bound,
                feature_grad_rel_err=g_err,
                design="ball_group_tile<sources>: the forward's tile design with the expanded "
                       "distance, (B, K, M) int32 out",
                work="one masked training step's backward: 8x2048, M=1024, K=32")


def check_radius_attention(pre_xyz, mid_xyz, dev: torch.device) -> dict:
    """Phase 7, attention: the three kernels with the radius bias at the
    masked encoder's layers (BH = 8 x 4 heads, D = 64): N = 2048 at r^2 =
    0.16^2 and N = 1024 at 0.64^2 and 1.44^2, the points the FPS picks of a
    ScanNet-shaped batch.  Returns their entries, summed over the three
    layers (one training step's calls)."""
    from ov3det_torch.ops.kernels import attention as A

    H, D, rate = 4, 64, 0.3
    seed = torch.tensor([20261016], dtype=torch.int32, device=dev)
    names = ("attention_fwd", "attention_dq", "attention_dkv")
    flops = {"attention_fwd": 4, "attention_dq": 6, "attention_dkv": 8}  # x in-radius pairs x D
    tot = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_ms_no_dropout=0.0, library_ms=0.0,
                   library_ms_dropout=0.0, ms_no_dropout=0.0, max_abs_err=0.0, bound_time={})
           for n in names}
    for n in names:
        tot[n].update(ms_previous_design=0.0, ms_previous_design_no_dropout=0.0)
    empty_tiles = []
    for xyz, r in ((pre_xyz, 0.4 ** 2), (mid_xyz, 0.8 ** 2), (mid_xyz, 1.2 ** 2)):
        B, N, _ = xyz.shape
        BH, r2 = B * H, r * r
        radius = (xyz, xyz, r2)
        inside = A.radius_mask(xyz, xyz, r2)
        share = inside.float().mean().item()
        # (q, k) tiles with no pair inside the radius: what skipping them could save
        empty = {T: 1.0 - inside.view(B, N // T, T, N // T, T).any(dim=4).any(dim=2).float().mean().item()
                 for T in (64, 128)}
        empty_tiles.append(dict(N=N, r2=r2, in_radius_share=share, empty_64x64=empty[64],
                                empty_128x128=empty[128]))
        want = inside.repeat_interleave(H, dim=0)
        for impl in (None, "mma"):
            for name, mask in reveal_masks(A, None, 0.0, BH, N, D, dev, radius, impl).items():
                flips = int((mask != want).sum())
                require(flips == 0, f"{name} (_impl={impl}) radius N={N} r2={r2:.4f}: the mask "
                                    f"differs at {flips} positions")
        del want, mask

        g = torch.Generator().manual_seed(N)
        q, k, v, do = (torch.randn(BH, N, D, generator=g).to(dev) for _ in range(4))
        qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
        worst = {n: 0.0 for n in names}
        for p in (0.0, rate):
            out, lse = A.attention_fwd(qb, kb, vb, p, seed, radius)
            f32 = [t.float() for t in (qb, kb, vb, dob)]
            ref, ref_lse = A.attention_fwd_plain(*f32[:3], p, seed, radius)
            delta = (dob.float() * out.float()).sum(-1, keepdim=True)
            got = {"attention_fwd": [out], "attention_dq": [
                A.attention_dq(qb, kb, vb, dob, lse, delta, p, seed, radius)],
                "attention_dkv": list(A.attention_dkv(qb, kb, vb, dob, lse, delta, p, seed, radius))}
            refs = {"attention_fwd": [ref],
                    "attention_dq": [A.attention_dq_plain(*f32, lse, delta, p, seed, radius)],
                    "attention_dkv": list(A.attention_dkv_plain(*f32, lse, delta, p, seed, radius))}
            for n in names:
                for a, b in zip(got[n], refs[n]):
                    err = (a.float() - b).abs().max().item()
                    tot[n]["max_abs_err"] = max(tot[n]["max_abs_err"], err)
                    worst[n] = max(worst[n], err / b.abs().max().item())
            e_lse = (lse - ref_lse).abs().max().item()
            # the first (mma.sync) design of the three kernels on the same inputs
            old_out, old_lse = A.attention_fwd(qb, kb, vb, p, seed, radius, _impl="mma")
            olds = [old_out, A.attention_dq(qb, kb, vb, dob, lse, delta, p, seed, radius, _impl="mma"),
                    *A.attention_dkv(qb, kb, vb, dob, lse, delta, p, seed, radius, _impl="mma")]
            e_old = max((a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                        for a, b in zip(got["attention_fwd"] + got["attention_dq"]
                                        + got["attention_dkv"], olds))
            require(e_old <= 2e-2 and (lse - old_lse).abs().max().item() <= 1e-3,
                    f"radius N={N} r2={r2:.4f} p={p}: the wgmma and mma.sync designs differ by {e_old}")
            out32, lse32 = A.attention_fwd(q, k, v, p, seed, radius)
            ref32, rlse32 = A.attention_fwd_plain(q, k, v, p, seed, radius)
            d32 = (do * out32).sum(-1, keepdim=True)
            pairs = [(out32, ref32), (lse32, rlse32),
                     (A.attention_dq(q, k, v, do, lse32, d32, p, seed, radius),
                      A.attention_dq_plain(q, k, v, do, lse32, d32, p, seed, radius))]
            pairs += list(zip(A.attention_dkv(q, k, v, do, lse32, d32, p, seed, radius),
                              A.attention_dkv_plain(q, k, v, do, lse32, d32, p, seed, radius)))
            e32 = max(((a - b).abs().max() / b.abs().max()).item() for a, b in pairs)
            require(max(worst.values()) <= 2e-2 and e_lse <= 1e-3 and e32 <= 1e-4,
                    f"radius N={N} r2={r2:.4f} p={p}: bf16 {worst}, lse {e_lse}, f32 {e32}")
        print(f"attention radius N={N} r2={r2:.4f}: in-radius share {share:.4f}; (q, k) tiles with "
              f"no in-radius pair: {empty[64]:.4f} of the 64x64, {empty[128]:.4f} of the 128x128; "
              f"the masks of the "
              f"forward, dq and dk/dv kernels equal the plain version's at all {BH * N * N} "
              f"positions; bf16 error over the largest plain value {max(worst.values()):.2e}, "
              f"lse {e_lse:.2e}; f32 {e32:.2e}")

        out, lse = A.attention_fwd(qb, kb, vb, rate, seed, radius)
        delta = (dob.float() * out.float()).sum(-1, keepdim=True)
        bwd = (qb, kb, vb, dob, lse, delta)
        # name -> (kernel(p, seed, impl), plain version with dropout)
        calls = {
            "attention_fwd": (lambda p, sd, impl=None: A.attention_fwd(qb, kb, vb, p, sd, radius,
                                                                       _impl=impl),
                              lambda: A.attention_fwd_plain(qb, kb, vb, rate, seed, radius)),
            "attention_dq": (lambda p, sd, impl=None: A.attention_dq(*bwd, p, sd, radius,
                                                                      _impl=impl),
                             lambda: A.attention_dq_plain(*bwd, rate, seed, radius)),
            "attention_dkv": (lambda p, sd, impl=None: A.attention_dkv(*bwd, p, sd, radius,
                                                                       _impl=impl),
                              lambda: A.attention_dkv_plain(*bwd, rate, seed, radius)),
        }
        # yardstick: PyTorch's fused attention with the (B, 1, N, N) boolean
        # mask, without dropout and with the kernels' rate; its backward
        # computes dq, dk and dv in one call
        q4, k4, v4 = (t.view(B, H, N, D).detach().requires_grad_() for t in (qb, kb, vb))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        mask4 = inside[:, None]
        g4 = dob.view(B, H, N, D)
        lib = {}
        for p in (0.0, rate):
            fwd_ms = cuda_ms(lambda: sdpa(q4, k4, v4, attn_mask=mask4, dropout_p=p), 10)
            o4 = sdpa(q4, k4, v4, attn_mask=mask4, dropout_p=p)
            bwd_ms = cuda_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True), 10)
            lib[p] = {"attention_fwd": fwd_ms, "attention_dq": bwd_ms, "attention_dkv": bwd_ms}
            del o4
        pairs_in = inside.sum().item() * H  # (bh, q, k) pairs inside the radius
        tensor = BH * N * D * 2
        nbytes = {"attention_fwd": 4 * tensor + BH * N * 4,
                  "attention_dq": 5 * tensor + 2 * BH * N * 4,
                  "attention_dkv": 6 * tensor + 2 * BH * N * 4}
        for n, (kernel, plain) in calls.items():
            ms, nd_ms, old_ms, old_nd = designs_in_turns(kernel, rate, seed, 10)
            require(ms <= old_ms and nd_ms <= old_nd,
                    f"{n}_radius N={N} r2={r2:.4f}: the wgmma design ({ms:.3f} / {nd_ms:.3f} ms) is "
                    f"slower than the mma.sync design ({old_ms:.3f} / {old_nd:.3f} ms)")
            tot[n]["ms_previous_design"] += old_ms
            tot[n]["ms_previous_design_no_dropout"] += old_nd
            was = f"; mma.sync design {old_ms:.3f} ms ({old_nd:.3f})"
            plain_ms = cuda_ms(plain, 2)
            # what this data needs: the products, exponentials and hashes of
            # the in-radius pairs, and the distance test of every (b, q, k)
            # pair (9 f32 operations)
            args = (nbytes[n] + 2 * B * N * 12, flops[n] * pairs_in * D, pairs_in)
            bound = attention_bound(*args, dropout=True, f32_ops=9 * B * N * N)
            bound_nd = attention_bound(*args, dropout=False, f32_ops=9 * B * N * N)
            print(f"{n}_radius N={N} r2={r2:.4f}: kernel {ms:.3f} ms with dropout {rate} "
                  f"({nd_ms:.3f} ms without){was}, plain {plain_ms:.3f} ms, library "
                  f"{lib[rate][n]:.3f} ms with dropout {rate} ({lib[0.0][n]:.3f} ms without) "
                  f"(SDPA with the boolean mask{', backward: dq, dk and dv' if n != 'attention_fwd' else ''})"
                  f", bound {bound['bound_ms']:.4f} ms ({bound['bound_term']})")
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("ms_no_dropout", nd_ms),
                             ("library_ms", lib[0.0][n]), ("library_ms_dropout", lib[rate][n]),
                             ("bound_ms", bound["bound_ms"]),
                             ("bound_ms_no_dropout", bound_nd["bound_ms"])):
                tot[n][key] += val
            bt = tot[n]["bound_time"]
            bt[bound["bound_term"]] = bt.get(bound["bound_term"], 0.0) + bound["bound_ms"]
        del q4, k4, v4, mask4, inside
    entries = {}
    for n in names:
        e = tot[n]
        bt = e.pop("bound_time")
        term = max(bt, key=bt.get)
        e["design"] = "wgmma, cp.async ring"
        entries[f"{n}_radius"] = dict(
            e, bound_by="bytes" if term == "bytes" else "operations", bound_term=term,
            empty_tiles=empty_tiles,
            work="one masked training step: N=2048 r2=0.0256 + N=1024 r2=0.4096 + N=1024 "
                 "r2=2.0736, BH=32, D=64 bf16, dropout 0.3; library: SDPA with the boolean "
                 "mask; max_abs_err of bf16 against the plain version in f32")
    return entries


def stage_times(det, batch: dict, reps: int = 3) -> None:
    """Host-clock time of each stage of `Detector.detect`, each ended by a
    synchronize: the model's forward (pre-encoder, encoder, decoder, heads
    timed apart), the device parse (empty-box test + NMS) and the host
    assembly.  Medians of `reps` runs."""
    from ov3det_torch.engine.infer import INPUT_KEYS
    from ov3det_torch.eval.parse import assemble_predictions, parse_predictions

    model = det.model
    marks = {}

    def mark(name):
        def hook(*_):
            torch.cuda.synchronize()
            marks[name] = time.perf_counter()
        return hook

    handles = [model.pre_encoder.register_forward_hook(mark("pre_encoder")),
               model.encoder.register_forward_hook(mark("encoder")),
               model.decoder.register_forward_hook(mark("decoder"))]
    interim = getattr(model, "interim_downsample", None)
    if interim is not None:
        handles.append(interim.register_forward_hook(mark("interim")))
    rows = []
    for _ in range(reps):
        inputs = {k: torch.as_tensor(batch[k]).to(det.device) for k in INPUT_KEYS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = det.eval_step(inputs)
            torch.cuda.synchronize()
            t_fwd = time.perf_counter()
            keep, _ = parse_predictions(out["box_corners"], out["sem_cls_prob"],
                                        out["objectness_prob"], inputs["point_clouds"])
            host = [t.cpu().numpy() for t in (out["box_corners"], out["sem_cls_prob"],
                                              out["objectness_prob"], keep)]
        t_parse = time.perf_counter()
        assemble_predictions(*host)
        t_end = time.perf_counter()
        row = {"pre_encoder (FPS + ball-group + SA MLP)": marks["pre_encoder"] - t0}
        if interim is not None:
            row["encoder layer 0 + interim SA"] = marks["interim"] - marks["pre_encoder"]
            row["encoder layers 1-2"] = marks["encoder"] - marks["interim"]
        else:
            row["encoder"] = marks["encoder"] - marks["pre_encoder"]
        rows.append({**row,
                     "projection + query FPS + decoder": marks["decoder"] - marks["encoder"],
                     "heads + box decode": t_fwd - marks["decoder"],
                     "parse (empty-box test + NMS)": t_parse - t_fwd,
                     "assemble (host)": t_end - t_parse})
    for h in handles:
        h.remove()
    parts = ", ".join(f"{k} {np.median([r[k] for r in rows]) * 1e3:.2f} ms" for k in rows[0])
    print(f"stages of one request (synchronised, median of {reps}): {parts}")


def range_kernels(prof, name: str):
    """(device ms, kernel count) of the kernels launched inside the profiler
    range `name` (a `record_function`), from the kernels the profiler ties
    to each op of the range; None when the range holds none."""
    found = [e for e in prof.events() if e.name == name]
    if not found:
        return None

    def walk(e):
        kernels = list(getattr(e, "kernels", []))
        us, n = sum(k.duration for k in kernels), len(kernels)
        for child in getattr(e, "cpu_children", []):
            c_us, c_n = walk(child)
            us, n = us + c_us, n + c_n
        return us, n

    us, n = map(sum, zip(*(walk(e) for e in found)))
    return (us / 1e3, n) if n else None


def profile(title: str, fn, ranges: tuple = (), waits: bool = False) -> None:
    """Run `fn` once under torch.profiler; print the wall time, the device
    busy time (kernels only), the kernel count, the idle share and the top
    kernels and ops by device time; for each profiler range named in
    `ranges`, its kernels' device time, their share of the busy time and
    their count; with `waits`, the host's calls that wait for the card
    (stream and device synchronisations), each with its count and host
    time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def device_us(e):  # the attribute's name changed across PyTorch versions
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # kernels are the device events; a CPU op's self device time is that of
    # the kernels it launched, so the two groups are listed apart and only
    # the kernels are summed
    # a profiler range (record_function) also leaves a device-side event
    # spanning its kernels: not a kernel, and it would count them twice
    ranges_seen = set(ranges) | {e.name for e in prof.events()
                                 if getattr(e, "is_user_annotation", False)}
    rows = [e for e in prof.key_averages() if device_us(e) > 0 and e.key not in ranges_seen]
    kernels = sorted((e for e in rows if e.device_type != torch.autograd.DeviceType.CPU),
                     key=device_us, reverse=True)
    ops = sorted((e for e in rows if e.device_type == torch.autograd.DeviceType.CPU),
                 key=device_us, reverse=True)
    busy_us = sum(device_us(e) for e in kernels)
    if not kernels:
        print(f"{title}: wall {wall_us / 1e3:.2f} ms, device time not measured "
              "(the profiler recorded no device events)")
    else:
        print(f"{title}: wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
              f"in {sum(e.count for e in kernels)} kernels (idle share "
              f"{1 - busy_us / wall_us:.3f})")
        for name in ranges:
            got = range_kernels(prof, name)
            print(f" range {name!r}: " + ("device time not measured (no kernel tied to it)"
                                          if got is None else
                                          f"{got[0]:.2f} ms of device time in {got[1]} kernels, "
                                          f"{got[0] * 1e3 / busy_us:.3f} of the busy time"))
    own = [e for e in kernels if any(k in e.key for k in
                                     ("fps_kernel", "fps_cluster_kernel", "pick_kernel", "fill_kernel",
                                      "ball_group_tile", "attn_"))]
    for name, group in (("kernels", kernels[:12]), ("the port's own kernels", own),
                        ("ops, by the device time of their kernels", ops[:12])):
        print(f" {name}:")
        for e in group:
            print(f"  {device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    host = sorted((e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print(" ops, by host time (self, profiler on):")
    for e in host[:8]:
        print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    if waits:
        got = {e.key: e for e in host if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize")}
        print(" host waits for the card (profiler on): " + (", ".join(
            f"{k} x{e.count}, {e.self_cpu_time_total / 1e3:.3f} ms" for k, e in sorted(got.items()))
            or "none"))


def sync_points(title: str, fn) -> None:
    """Run `fn` once with CUDA's sync debug mode at "warn" and print each
    line of Python that made the host wait for the card (a copy to the
    host, a blocking copy from pageable host memory, `.item()`), with its
    count."""
    where = collections.Counter()
    package = os.path.join(HERE, "ov3det_torch")

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        # the innermost line of the package on the stack, else the warning's own
        ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(package)]
        f = ours[-1] if ours else None
        where[f"{os.path.relpath(f.filename, HERE)}:{f.lineno}" if f else
              f"{os.path.basename(filename)}:{lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"{title}: {sum(where.values())} synchronising calls on the host"
          + "".join(f"\n  x{n:<3d} {line}" for line, n in sorted(where.items())))


def serve(cfg, batches: list, per_request: dict, label: str, dev: torch.device) -> dict:
    """Phases 3 and 7: the serving path at full width; returns the launch
    counts of the requests."""
    from ov3det_torch.engine.infer import Detector

    det = Detector(cfg, device=dev, seed=0)
    det.detect(batches[0])  # warm-up: cuBLAS handles, allocator
    reset_counts()
    for r, batch in enumerate(batches):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = det.detect(batch)
        ms = (time.perf_counter() - t0) * 1e3
        after = read_counts()
        delta = {n: after[n] - before[n] for n in after}
        require(delta == per_request, f"{label} request {r}: launches {delta}, expected {per_request}")
        require(len(dets) == BATCH, "one detection list per scene")
        for classes, corners, scores in dets:
            require(corners.shape[1:] == (8, 3) and len(classes) == len(scores) == len(corners),
                    "detection arrays disagree in shape")
            require(np.isfinite(corners).all() and np.isfinite(scores).all(), "non-finite detections")
        print(f"{label} request {r}: {ms:.2f} ms, detections per scene "
              f"{[len(c) for c, _, _ in dets]}, launches { {n: c for n, c in delta.items() if c} }")
    counts = read_counts()
    stage_times(det, batches[-1])

    # one more request under the profiler: device time by kernel and idle share
    profile(f"profiled {label} request", lambda: det.detect(batches[-1]))
    return counts


def card_vs_cpu(batch: dict) -> None:
    """Phase 4: the same weights at f32 on the card and on the CPU."""
    from ov3det_torch.config import sunrgbd_quick
    from ov3det_torch.models.detr3d import Model3DETR

    cfg = dataclasses.replace(sunrgbd_quick().model, compute_dtype="float32")
    scene = {k: torch.from_numpy(batch[k][:1]) for k in
             ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")}
    outs = {}
    for device in ("cuda", "cpu"):
        model = Model3DETR(cfg, device=device, seed=1)
        with torch.inference_mode():
            out = model({k: t.to(device) for k, t in scene.items()})
        outs[device] = {k: v.cpu() for k, v in out.items()}
    require(torch.equal(outs["cuda"]["query_inds"], outs["cpu"]["query_inds"]),
            "query indices differ between card and CPU")
    err = (outs["cuda"]["box_corners"] - outs["cpu"]["box_corners"]).abs().max().item()
    require(err <= 1e-3, f"box corners differ between card and CPU by {err}")
    print(f"card vs CPU (f32, one scene): query indices equal, box_corners max err {err:.2e}")


def scannet_masked():
    """3DETR-m: scannet_quick with the masked encoder and the matcher and loss
    weights of reference scripts/scannet_masked_ep1080.sh, built as
    scripts/scannet_masked_timing.py builds it."""
    from ov3det_torch.config import EncoderConfig, LossConfig, MatcherConfig, scannet_quick

    base = scannet_quick()
    return dataclasses.replace(
        base, model=dataclasses.replace(base.model, encoder=EncoderConfig(kind="masked", dropout=0.3)),
        loss=LossConfig(matcher=MatcherConfig(cost_class=1.0, cost_objectness=0.0, cost_center=0.0,
                                              cost_giou=2.0),
                        giou_weight=1.0, no_object_weight=0.25))


def synthetic_batches(cfg, n: int, seed: int) -> list:
    """n seeded synthetic numpy batches of `cfg`'s data part."""
    from ov3det_torch.datasets.synthetic import make_batch

    return [make_batch(np.random.default_rng(seed + i), batch_size=cfg.data.batch_size_per_device,
                       num_points=cfg.data.num_points, max_num_obj=cfg.data.max_num_obj,
                       num_semcls=cfg.model.num_semcls, num_angle_bin=cfg.model.num_angle_bin)
            for i in range(n)]


def train(cfg, steps: int, per_step: dict, label: str, seed: int, dev: torch.device,
          teacher=None, batches=None) -> dict:
    """Phases 5, 7 and 10: training steps at full width on the card (with
    the 2D teacher and numpy `batches` of its schema in phase 10); returns
    the launch counts of the timed steps."""
    from ov3det_torch.engine.train import batch_to_device, build_training

    training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0, teacher=teacher)
    step = training.train_step
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [batch_to_device(b, dev)
               for b in batches or synthetic_batches(cfg, steps + 1, seed)]
    n_losses = 7 + (teacher is not None)  # loss_2dalignment beside the point losses

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(batches[0], gen)  # warm-up: cuBLAS handles, allocator
    print(f"{label} train warm-up step: {(time.perf_counter() - t0) * 1e3:.2f} ms, "
          f"loss {metrics['loss'].item():.4f}")
    reset_counts()
    for i, batch in enumerate(batches[1:]):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = read_counts()
        delta = {n: after[n] - before[n] for n in after}
        loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
        require(delta == per_step, f"{label} train step {i}: launches {delta}, expected {per_step}")
        require(math.isfinite(loss) and math.isfinite(gnorm),
                f"{label} train step {i}: loss {loss}, grad_norm {gnorm}")
        require(len(metrics) == cfg.model.decoder.num_layers * n_losses + 2,
                f"{label} train step {i}: {len(metrics)} metrics")
        if teacher is not None:
            align = metrics["loss_2dalignment"].item()
            require(math.isfinite(align) and align > 0,
                    f"{label} train step {i}: loss_2dalignment {align}")
        extra = "" if teacher is None else f", loss_2dalignment {align:.4f}"
        print(f"{label} train step {i}: {ms:.2f} ms, loss {loss:.4f}{extra}, grad_norm {gnorm:.4f}, "
              f"lr {training.schedule(training.optimizer.count - 1):.3e}, launches "
              f"{ {n: c for n, c in delta.items() if c} }")
    counts = read_counts()

    # a synchronised split of a step, median of 3
    rows = []
    for batch in batches[1:4]:
        marks = []

        def mark(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, gen, mark=mark)
        times = [t for _, t in marks]
        rows.append({name: (t - prev) * 1e3 for (name, t), prev in zip(marks, [t0] + times[:-1])})
    parts = ", ".join(f"{k} {np.median([r[k] for r in rows]):.2f} ms" for k in rows[0])
    L, Q, G = cfg.model.decoder.num_layers, cfg.model.num_queries, cfg.data.max_num_obj
    print(f"stages of one {label} train step (synchronised, median of 3): {parts} "
          f"(criterion = GIoU over {L}x{BATCH}x{Q}x{G} pairs, auction, losses)")

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step(batches[1], gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory of a {label} train step: {peak / 2**30:.3f} GiB "
          f"({base / 2**30:.3f} GiB held before it: weights, Adam moments, batches)")
    profile(f"profiled {label} train step", lambda: step(batches[2], gen),
            ranges=("teacher",) if teacher is not None else (), waits=teacher is not None)
    if teacher is not None:
        sync_points(f"one {label} train step under the sync debug mode",
                    lambda: step(batches[3], gen))
    return counts


def train_card_vs_cpu(base, label: str, seed: int) -> None:
    """Phases 6 and 7: one f32 training step with every dropout at 0 on one
    scene at full width, on the card and on the CPU, from the same weights."""
    from ov3det_torch.engine.train import batch_to_device, build_training
    from ov3det_torch.losses.criterion import compute_assignments

    model_cfg = dataclasses.replace(
        base.model, compute_dtype="float32", mlp_dropout=0.0,
        encoder=dataclasses.replace(base.model.encoder, dropout=0.0),
        decoder=dataclasses.replace(base.model.decoder, dropout=0.0))
    cfg = dataclasses.replace(base, model=model_cfg)
    scene = {k: v[:1] for k, v in synthetic_batches(cfg, 1, seed)[0].items()}
    res = {}
    for name in ("cuda", "cpu"):
        dev = torch.device(name)
        batch = batch_to_device(scene, dev)
        training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=1)
        model = training.model
        gen = torch.Generator(device=dev).manual_seed(0)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        model.train()
        with torch.no_grad():  # the matcher's masks of this step
            out = model({k: batch[k] for k in ("point_clouds", "point_cloud_dims_min",
                                                "point_cloud_dims_max")}, gen)
            targets = dict(batch, nactual_gt=batch["gt_box_present"].sum(1).long())
            assign = compute_assignments(out, targets, cfg.loss,
                                         rotated_boxes=cfg.model.num_angle_bin > 1)
        model.load_state_dict(start)  # the probe moved the running statistics
        t0 = time.perf_counter()
        metrics = training.train_step(batch, gen)
        res[name] = ({k: v.cpu() for k, v in assign.items()},
                     {k: v.item() for k, v in metrics.items()})
        print(f"{label} f32 train step on {name}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    (a_gpu, m_gpu), (a_cpu, m_cpu) = res["cuda"], res["cpu"]
    for k in ("per_prop_gt_inds", "proposal_matched_mask"):
        require(torch.equal(a_gpu[k], a_cpu[k]), f"{label} card vs CPU: {k} differ")
    worst = max(abs(m_gpu[k] - v) / max(abs(v), 1e-6) for k, v in m_cpu.items() if k != "grad_norm")
    g_err = abs(m_gpu["grad_norm"] - m_cpu["grad_norm"]) / m_cpu["grad_norm"]
    require(worst <= 1e-4, f"{label} card vs CPU: a loss differs by {worst} relative")
    require(g_err <= 1e-3, f"{label} card vs CPU: grad_norm differs by {g_err} relative")
    print(f"{label} card vs CPU (f32 train step, one scene, dropout 0): matched masks equal, "
          f"losses within {worst:.2e} relative, grad_norm {m_gpu['grad_norm']:.5f} vs "
          f"{m_cpu['grad_norm']:.5f} ({g_err:.2e})")


CLI_ARGV = ["--dataset_name", "synthetic", "--device", "cuda", "--num_points", "40000",
            "--batchsize_per_gpu", "8", "--compute_dtype", "bfloat16", "--max_epoch", "2",
            "--eval_every_epoch", "1", "--eval_loss", "--log_every", "4", "--log_metrics_every", "8",
            # scripts/scannet_quick.sh
            "--nqueries", "256", "--matcher_giou_cost", "2", "--matcher_cls_cost", "1",
            "--matcher_center_cost", "0", "--matcher_objectness_cost", "0",
            "--loss_giou_weight", "1", "--loss_no_object_weight", "0.25",
            "--save_separate_checkpoint_every_epoch", "-1"]


def ap_table(lines: list, header: str) -> list:
    """The AP table printed after the first line starting with `header`."""
    i = next(i for i, line in enumerate(lines) if line.startswith(header))
    table = []
    for line in lines[i + 1:]:
        if not (line.startswith(("mAP0.", "AR0.", "-----", "IOU Thresh"))
                or " Average Precision: " in line or " Recall: " in line):
            break
        table.append(line)
    return table


class CliProbe:
    """Spies on in-process runs of `ov3det_torch.main.main`, through the
    names that module and the AP calculator look up: the launches of each
    train step and eval batch, the loop's host times, the eval passes'
    parts and the checkpoints' times and sizes.  `patched()` installs the
    spies and takes them out again."""

    def __init__(self):
        self.steps, self.evals = [], []  # (host start, epoch), launch deltas
        self.epochs, self.waits, self.eval_waits, self.starts = [], [], [], []
        self.passes, self.current = [], None
        self.saves, self.restores, self.train_ap_ms = [], [], []
        self.last_pass = None  # the last eval pass's APCalculator
        self.train_boxes = []  # each train batch's scans and GT boxes, as the loader gave them

    @staticmethod
    def _delta(before: dict) -> dict:
        after = read_counts()
        return {n: after[n] - before[n] for n in after}

    def _train_step(self, step):
        def train_step(batch, generator, mark=None):
            before, t = read_counts(), time.perf_counter()
            out = step(batch, generator, mark)
            self.steps.append((t, len(self.epochs) - 1, self._delta(before)))
            return out
        return train_step

    def _eval_step(self, step):
        def eval_step(batch):
            before = read_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            self.evals.append(self._delta(before))
            if self.current is not None:
                self.current["forward"] += ms
            return out
        return eval_step

    def _timed(self, fn, part: str):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            if self.current is not None:
                self.current[part] += ms
            return out
        return timed

    @contextlib.contextmanager
    def patched(self):
        from ov3det_torch import main as cli
        from ov3det_torch.engine.checkpoint import CheckpointManager
        from ov3det_torch.eval import ap_calculator

        probe = self

        class TimedLoader(cli.DataLoader):
            def set_epoch(self, epoch):
                probe.epochs.append(time.perf_counter())
                super().set_epoch(epoch)

            def __iter__(self):
                t = time.perf_counter()
                batches = super().__iter__()  # starts the worker processes the first time
                probe.starts.append(("train" if self.shuffle else "test", (time.perf_counter() - t) * 1e3))
                while True:
                    t = time.perf_counter()
                    try:
                        batch = next(batches)
                    except StopIteration:
                        return
                    (probe.waits if self.shuffle else probe.eval_waits).append(
                        (time.perf_counter() - t) * 1e3)
                    if self.shuffle:
                        probe.train_boxes.append({k: np.asarray(batch[k]) for k in (
                            "scan_idx", "gt_box_present", "gt_box_sem_cls_label")})
                    yield batch

        def build_training(*args, **kwargs):
            tr = originals["build_training"](*args, **kwargs)
            return dataclasses.replace(tr, train_step=self._train_step(tr.train_step),
                                       eval_step=self._eval_step(tr.eval_step))

        def make_eval_step(*args, **kwargs):
            return self._eval_step(originals["make_eval_step"](*args, **kwargs))

        def evaluate(*args, **kwargs):
            self.current = dict(forward=0.0, parse=0.0, ap=0.0, start=time.perf_counter())
            try:
                return originals["evaluate"](*args, **kwargs)
            finally:
                self.passes.append(self.current)  # its AP follows in compute_metrics
                self.current = None

        def compute_metrics(calc):
            t = time.perf_counter()
            out = originals["compute_metrics"](calc)
            ms = (time.perf_counter() - t) * 1e3
            if calc.exact_eval:  # an eval pass, not the train-time AP
                self.last_pass = calc
                self.passes[-1]["ap"] = ms
                self.passes[-1]["end"] = time.perf_counter()
            else:
                self.train_ap_ms.append(ms)
            return out

        def save(mgr, model, optimizer, epoch, name="checkpoint", extra=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = originals["save"](mgr, model, optimizer, epoch, name, extra)
            self.saves.append((name, (time.perf_counter() - t) * 1e3, os.path.getsize(path) / 1e6))
            return path

        def restore(mgr, model, optimizer=None, name="checkpoint"):
            t = time.perf_counter()
            out = originals["restore"](mgr, model, optimizer, name)
            torch.cuda.synchronize()
            if out[0] is not None:
                self.restores.append((name, (time.perf_counter() - t) * 1e3,
                                      os.path.getsize(mgr._path(name)) / 1e6))
            return out

        spies = [(cli, "DataLoader", TimedLoader), (cli, "build_training", build_training),
                 (cli, "make_eval_step", make_eval_step), (cli, "evaluate", evaluate),
                 (ap_calculator, "parse_predictions",
                  self._timed(ap_calculator.parse_predictions, "parse")),
                 (ap_calculator.APCalculator, "compute_metrics", compute_metrics),
                 (CheckpointManager, "save", save), (CheckpointManager, "restore", restore)]
        originals = {name: getattr(owner, name) for owner, name, _ in spies}
        for owner, name, spy in spies:
            setattr(owner, name, spy)
        try:
            yield
        finally:
            for owner, name, _ in spies:
                setattr(owner, name, originals[name])


def detections_near_gt(batch: dict, rng, Q: int) -> dict:
    """Final-layer outputs (numpy) whose boxes are jittered copies of the
    batch's GT boxes (1 angle bin, 18 classes): the detections of a trained
    model, which random weights do not give."""
    from ov3det_torch.geometry.boxes_np import corners_from_upright_depth_param_np

    B = batch["gt_box_present"].shape[0]
    src = rng.integers(0, batch["gt_box_present"].sum(1).min(), size=(B, Q))
    take = lambda a: np.take_along_axis(a, src[..., None], 1)  # noqa: E731
    centers = take(batch["gt_box_centers"]) + rng.normal(0, 0.06, (B, Q, 3))
    sizes = take(batch["gt_box_sizes"]) * rng.uniform(0.8, 1.2, (B, Q, 3))
    corners = corners_from_upright_depth_param_np(centers, sizes, np.zeros((B, Q)))
    logits = rng.normal(size=(B, Q, 19)) * 2
    cls = take(batch["gt_box_sem_cls_label"][..., None])[..., 0]
    np.put_along_axis(logits, cls[..., None], 4.0, axis=-1)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {"box_corners": corners.astype(np.float32),
            "sem_cls_prob": probs[..., :-1].astype(np.float32),
            "objectness_prob": (1 - probs[..., -1]).astype(np.float32)}


def host_ap_iou(card: str, tested, dev: torch.device) -> None:
    """The eval's host AP (`compute_metrics`) with the rotated IoU of the C++
    core against the numpy one, in turns, on the `--test_only` pass (random
    weights: few detections) and on 16 scenes x 256 queries of detections
    near the GT boxes; both IoUs must give the same metrics within 1e-6."""
    from functools import partial

    from ov3det_torch import native
    from ov3det_torch.datasets.dataset_configs import ScannetDatasetConfig
    from ov3det_torch.datasets.synthetic import make_batch
    from ov3det_torch.eval import voc
    from ov3det_torch.eval.ap_calculator import APCalculator
    from ov3det_torch.geometry.iou_np import box3d_iou_batch_np

    require(native.native_available(), "cli: the C++ rotated IoU did not build")
    near = APCalculator(class2type_map=ScannetDatasetConfig().class2type)
    rng = np.random.default_rng(500)
    for _ in range(2):
        batch = make_batch(rng, batch_size=8, num_points=SCANNET_POINTS, num_semcls=18,
                           num_angle_bin=1)
        out = detections_near_gt(batch, rng, 256)
        near.step_meter({k: torch.from_numpy(v).to(dev) for k, v in out.items()}, batch)
    try:
        for label, calc in (("the --test_only pass", tested), ("detections near the GT", near)):
            ms, metrics = {True: [], False: []}, {}
            for _ in range(3):
                for use_native in (True, False):
                    voc.box3d_iou_batch_np = partial(box3d_iou_batch_np, allow_native=use_native)
                    t = time.perf_counter()
                    metrics[use_native] = calc.compute_metrics()
                    ms[use_native].append((time.perf_counter() - t) * 1e3)
            for t in metrics[False]:
                for k, v in metrics[False][t].items():
                    require(abs(float(metrics[True][t][k]) - float(v)) <= 1e-6,
                            f"cli host AP: C++ and numpy IoU disagree on {t} {k}")
            dets = sum(len(p[0]) for p in calc.pred_map_cls.values())
            print(f"cli host AP ({label}: {calc.scan_cnt} scenes, {dets} detections, mAP0.25 "
                  f"{metrics[False][0.25]['mAP']:.4f}): C++ IoU "
                  f"{[round(x, 2) for x in ms[True]]} ms, numpy IoU "
                  f"{[round(x, 2) for x in ms[False]]} ms, in turns ({card})")
    finally:
        voc.box3d_iou_batch_np = box3d_iou_batch_np


def run_cli(probe: CliProbe, argv: list) -> tuple:
    """`ov3det_torch.main.main(argv)` with the probe's spies and its standard
    output captured; returns (its result, the printed lines)."""
    from ov3det_torch import main as cli

    out = io.StringIO()
    with probe.patched(), contextlib.redirect_stdout(out):
        result = cli.main(argv)
    return result, out.getvalue().splitlines()


def cli_phase(card: str) -> dict:
    """Phase 8: the training CLI at full `scannet_quick` width; returns the
    launch counts of its three runs (train, guard, --test_only)."""
    import tempfile

    train_step = expect(fps=2, ball_group=1, attention_fwd=3, attention_dq=3, attention_dkv=3)
    eval_batch = expect(fps=2, ball_group=1, attention_fwd=3)
    probe = CliProbe()
    with tempfile.TemporaryDirectory(prefix="ov3det_cli_") as run:
        argv = CLI_ARGV + ["--checkpoint_dir", run]
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, lines = run_cli(probe, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        for line in lines:  # the log without the per-class rows of the AP tables
            if not (" Average Precision: " in line or " Recall: " in line):
                print(f"cli| {line}")
        for name in ("checkpoint", "checkpoint_best", "final_eval.txt"):
            require(os.path.isfile(os.path.join(run, name)), f"cli: no {name} in the run directory")
        with open(os.path.join(run, "final_eval.txt")) as fh:
            require("mAP0.25" in fh.read(), "cli: final_eval.txt holds no mAP0.25")
        require(len(probe.steps) == 16, f"cli: {len(probe.steps)} training steps, expected 2 x 8")
        require(all(d == train_step for _, _, d in probe.steps),
                f"cli: a training step launched {[d for _, _, d in probe.steps if d != train_step][:1]}, "
                f"expected {train_step}")
        # 2 train-time AP batches, 2 evals during training and the final one, 2 batches each
        require(len(probe.evals) == 2 + 3 * 2, f"cli: {len(probe.evals)} eval batches, expected 8")
        require(all(d == eval_batch for d in probe.evals),
                f"cli: an eval batch launched {[d for d in probe.evals if d != eval_batch][:1]}, "
                f"expected {eval_batch}")

        n_steps = len(probe.steps)
        _, again = run_cli(probe, argv)
        require(any(line.startswith("Found final eval file") for line in again),
                f"cli: the second call did not stop at the guard: {again[-3:]}")
        require(len(probe.steps) == n_steps, "cli: the second call trained")

        best = os.path.join(run, "checkpoint_best")
        metrics, tested = run_cli(probe, argv + ["--test_only", "--test_ckpt", best])
        require(len(probe.evals) == 10 and all(d == eval_batch for d in probe.evals),
                f"cli --test_only: eval batches launched {probe.evals[8:]}, expected 2 x {eval_batch}")
        saved = [i for i, line in enumerate(lines) if line.startswith("saved new best checkpoint")]
        require(bool(saved), "cli: no best checkpoint was saved")
        best_epoch = max(int(line.split("[")[1].split("/")[0]) for line in lines[:saved[-1]]
                         if line.startswith("Evaluate Epoch"))
        want = ap_table(lines, f"Evaluate Epoch [{best_epoch}/")
        got = ap_table(tested, "Test model")
        require(tested[0] == f"Test model (epoch {best_epoch}); Metrics:", f"cli: {tested[0]}")
        require(len(want) == 2 + 2 * (2 + 2 * 18) and got == want,
                f"cli: --test_only printed {got[:2]}, the epoch-{best_epoch} eval {want[:2]}")
        require(0.25 in metrics and math.isfinite(metrics[0.25]["mAP"]), "cli: no mAP at 0.25")
        print(f"cli --test_only on checkpoint_best (epoch {best_epoch}): the AP table equals that "
              f"epoch's, {len(got)} lines, {got[0]}")
        host_ap_iou(card, probe.last_pass, torch.device("cuda"))
    counts = read_counts()
    gc.collect()
    require(not multiprocessing.active_children(),
            f"cli: loader workers outlived the runs: {multiprocessing.active_children()}")

    def spread(xs):
        return (f"median {np.median(xs):.2f}, min {min(xs):.2f}, max {max(xs):.2f} ms "
                f"over {len(xs)}")

    print(f"cli training run: {wall:.2f} s wall (model build, 2 epochs, 3 evals, checkpoints), "
          f"peak device memory {peak / 2**30:.3f} GiB ({card})")
    for e, start in enumerate(probe.epochs):
        first = next(t for t, ep, _ in probe.steps if ep == e)
        loop_end = probe.passes[e]["start"]
        print(f"cli epoch {e}: {probe.passes[e]['end'] - start:.3f} s wall (set_epoch to the end "
              f"of its eval), {loop_end - first:.3f} s from its first step to its eval (steps, "
              f"train AP, checkpoint) ({card})")
    iters = [(b[0] - a[0]) * 1e3 for a, b in zip(probe.steps, probe.steps[1:]) if a[1] == b[1]]
    steady = [(b[0] - a[0]) * 1e3 for a, b in zip(probe.steps[1:], probe.steps[2:]) if a[1] == b[1]]
    print(f"cli iteration time (host clock, step start to step start): {spread(iters)}; "
          f"without the run's first step {spread(steady)}; each "
          f"{[round(x, 1) for x in iters]} ({card})")
    print(f"cli iter(loader), in call order (the first of each loader starts its 4 worker "
          f"processes): {[(w, round(ms, 2)) for w, ms in probe.starts]} ({card})")
    print(f"cli wait on next(loader) in the step loop: {spread(probe.waits)}; each "
          f"{[round(x, 2) for x in probe.waits]}; in the eval passes {spread(probe.eval_waits)} "
          f"({card})")
    for i, p in enumerate(probe.passes):
        total = (p["end"] - p["start"]) * 1e3
        which = ["epoch 0", "epoch 1", "final", "--test_only"][i] if i < 4 else str(i)
        print(f"cli eval pass ({which}, 16 scenes in 2 batches): {total:.2f} ms = forward "
              f"{p['forward']:.2f} + parse (NMS) {p['parse']:.2f} + host AP {p['ap']:.2f} + the rest "
              f"{total - p['forward'] - p['parse'] - p['ap']:.2f} ms ({card})")
    print(f"cli train-time AP (exact_eval off) compute_metrics: "
          f"{[round(x, 2) for x in probe.train_ap_ms]} ms ({card})")
    for name, ms, mb in probe.saves:
        print(f"cli checkpoint save {name}: {ms:.2f} ms, {mb:.2f} MB ({card})")
    for name, ms, mb in probe.restores:
        print(f"cli checkpoint restore {name}: {ms:.2f} ms, {mb:.2f} MB ({card})")
    print(f"cli launches over the three calls: { {n: c for n, c in counts.items() if c} }")
    return counts


# ------------------------------------------------------------ phase 10: the OV step
INT8_PEAK = 1979e12  # dense int8 tensor operations a second, H100 SXM data sheet
# (label, rows as (images, H, W), C_in, C_out, kernel) of three trunk convs
# of the RN50x4 teacher on 8 canvases of 530 x 730 and one chunk of 256 regions
QUANT_SHAPES = (("res4 block 3x3", (8, 33, 45), 320, 320, 3),
                ("res5 block 0 3x3, one chunk", (256, 18, 18), 640, 640, 3),
                ("res5 1x1", (256, 9, 9), 2560, 640, 1))
OV_STEPS = 3
# the int8 teacher's features, card against CPU from the same quantised state,
# over the largest value
INT8_CARD_VS_CPU = 1e-3
OV_CLI_ARGV = ["--dataset_name", "synthetic", "--device", "cuda", "--use_image",
               "--loss_2dalignment_weight", "1", "--num_points", "20000", "--batchsize_per_gpu",
               "8", "--compute_dtype", "bfloat16", "--max_epoch", "1",
               # scripts/sunrgbd_quick.sh
               "--nqueries", "128", "--base_lr", "7e-4", "--matcher_giou_cost", "3",
               "--matcher_cls_cost", "1", "--matcher_center_cost", "5",
               "--matcher_objectness_cost", "5", "--loss_giou_weight", "0",
               "--loss_no_object_weight", "0.1", "--save_separate_checkpoint_every_epoch", "-1"]


def check_quant_conv(card: str, dev: torch.device) -> None:
    """The int8 product of `QuantConv` at three of the teacher's trunk
    shapes: the int32 accumulators on the card equal the CPU's bit for bit;
    then `torch._int_mm` alone, the whole int8 conv (im2col + product) and
    cuDNN's bf16 conv of the same shape, timed in turns."""
    from ov3det_torch.models.clip_resnet import im2col_int8, int8_conv

    g = torch.Generator().manual_seed(10)
    for label, (B, H, W), cin, cout, k in QUANT_SHAPES:
        xq = torch.randint(-127, 128, (B, H, W, cin), generator=g, dtype=torch.int8)
        kq = torch.randint(-127, 128, (cout, k * k * cin), generator=g, dtype=torch.int8)
        want = int8_conv(xq, kq, k, k // 2)
        xq_d, kq_d = xq.to(dev), kq.to(dev)
        got = int8_conv(xq_d, kq_d, k, k // 2)
        torch.cuda.synchronize()
        require(got.dtype == torch.int32 and torch.equal(got.cpu(), want),
                f"QuantConv {label}: the int32 products differ between card and CPU")
        a = im2col_int8(xq_d, k, k // 2)
        x_bf = xq_d.to(torch.bfloat16).permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        w_bf = kq_d.view(cout, k, k, cin).permute(0, 3, 1, 2).to(torch.bfloat16)
        w_bf = w_bf.contiguous(memory_format=torch.channels_last)
        runs = {"int_mm": lambda: torch._int_mm(a, kq_d.t()),
                "int8 conv (im2col + int_mm)": lambda: int8_conv(xq_d, kq_d, k, k // 2),
                "cuDNN bf16 conv": lambda: torch.nn.functional.conv2d(x_bf, w_bf, padding=k // 2)}
        ms = {n: [] for n in runs}
        for order in (list(runs), list(runs)[::-1]):
            for n in order:
                ms[n].append(cuda_ms(runs[n], 10))
        M, K = a.shape
        ops = 2 * M * K * cout
        best = {n: min(v) for n, v in ms.items()}
        print(f"QuantConv {label}: {M} rows, K {K}, N {cout}: int32 equal to the CPU's; "
              + ", ".join(f"{n} {best[n]:.3f} ms ({ops / best[n] / 1e9:.0f} TOPS)" for n in best)
              + f"; bounds: int8 {ops / INT8_PEAK * 1e3:.3f} ms, bf16 {ops / BF16_PEAK * 1e3:.3f} "
              f"ms (operations) ({card})")
        del a, x_bf, w_bf, xq_d, kq_d, got


def teacher_card_vs_cpu(state: dict, image: np.ndarray, boxes: np.ndarray,
                        dev: torch.device) -> None:
    """The full RN50x4 teacher on one canvas and 8 boxes, on the card and on
    the CPU from the same weights: f32 features within 1e-3 of the largest
    value; int8 (quantised and calibrated on the card, the same state on
    both) cosine >= 0.999 per region and within INT8_CARD_VS_CPU of the
    largest value, a limit that the int8 teacher's distance from a bf16 one
    on the card (printed beside it) exceeds."""
    from ov3det_torch.models.regionclip import RegionCLIPTeacher, quantize_teacher_params

    img, bx = torch.from_numpy(image), torch.from_numpy(boxes)
    feats = {}
    for dtype in (None, "bfloat16", "int8"):
        card = RegionCLIPTeacher(compute_dtype=dtype, device=dev)
        if dtype is None:
            s_card = {k: v.to(dev) for k, v in state.items()}
        elif dtype == "bfloat16":
            s_card = quantize_teacher_params({k: v.to(dev) for k, v in state.items()}, dtype)
        else:
            t0 = time.perf_counter()
            s_card = quantize_teacher_params({k: v.to(dev) for k, v in state.items()}, "int8",
                                             teacher=card, calib=(image.astype(np.float32), boxes))
            torch.cuda.synchronize()
            print(f"teacher int8 quantisation and calibration on the card: "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        card.load(s_card)
        if dtype == "bfloat16":  # the card alone: the yardstick of the int8 limit
            with torch.no_grad():
                feats[dtype] = card(img.to(dev), bx.to(dev)).cpu()
            del card, s_card
            continue
        cpu = RegionCLIPTeacher(compute_dtype=dtype, device="cpu").load(
            {k: v.cpu() for k, v in s_card.items()})
        with torch.no_grad():
            got = card(img.to(dev), bx.to(dev)).cpu()
            t0 = time.perf_counter()
            want = cpu(img, bx)
            cpu_s = time.perf_counter() - t0
        require(got.shape == (1, 8, 640) and torch.isfinite(got).all(), "teacher: bad features")
        feats[dtype] = got
        if dtype is None:
            err = ((got - want).abs().max() / want.abs().max()).item()
            require(err <= 1e-3, f"teacher f32: card vs CPU {err} of the largest value")
            print(f"teacher f32, one canvas, 8 boxes: card vs CPU within {err:.2e} of the largest "
                  f"value (the CPU forward {cpu_s:.1f} s)")
        else:
            cos = torch.nn.functional.cosine_similarity(got[0], want[0], dim=-1)
            err = ((got - want).abs().max() / want.abs().max()).item()
            vs_bf16 = ((got - feats["bfloat16"]).abs().max() / got.abs().max()).item()
            vs_f32 = torch.nn.functional.cosine_similarity(got[0], feats[None][0], dim=-1)
            require(cos.min().item() >= 0.999, f"teacher int8: card vs CPU cosine {cos.tolist()}")
            require(err <= INT8_CARD_VS_CPU,
                    f"teacher int8: card vs CPU {err} of the largest value (bf16 is {vs_bf16})")
            print(f"teacher int8, one canvas, 8 boxes: card vs CPU cosine >= "
                  f"{cos.min().item():.7f}, within {err:.2e} of the largest value (limit "
                  f"{INT8_CARD_VS_CPU:.0e}; the bf16 teacher on the card is {vs_bf16:.2e} from "
                  f"the int8 one); int8 vs f32 on the card: cosine {vs_f32.min().item():.4f} to "
                  f"{vs_f32.max().item():.4f} (random weights, noise canvas; not a gate) "
                  f"(the CPU forward {cpu_s:.1f} s)")
        del card, cpu, s_card


def teacher_forward_times(teacher, state: dict, batch: dict, dev: torch.device) -> None:
    """The teacher's forward alone on one OV batch (8 canvases, 128 boxes
    each, 4 chunks of 256 regions): the int8 teacher the step runs against
    a bf16 one from the same weights, timed in turns (int8, bf16, bf16,
    int8)."""
    from ov3det_torch.models.regionclip import (
        RegionCLIPTeacher,
        calibration_boxes,
        quantize_teacher_params,
    )

    rng = np.random.default_rng(3)
    boxes = torch.from_numpy(np.concatenate([calibration_boxes(rng, 530.0, 730.0, n=128)
                                             for _ in range(BATCH)])).to(dev)
    images = torch.from_numpy(batch["image"]).to(dev)
    bf16 = RegionCLIPTeacher(compute_dtype="bfloat16", device=dev)
    bf16.load(quantize_teacher_params({k: v.to(dev) for k, v in state.items()}, "bfloat16"))
    ms = {"int8": [], "bfloat16": []}
    with torch.no_grad():
        for name in ("int8", "bfloat16", "bfloat16", "int8"):
            t = teacher if name == "int8" else bf16
            ms[name].append(cuda_ms(lambda: t(images, boxes), 2))
        cos = torch.nn.functional.cosine_similarity(teacher(images, boxes), bf16(images, boxes),
                                                    dim=-1)
    print(f"teacher forward alone, 8 canvases x 128 boxes: int8 {min(ms['int8']):.2f} ms, bf16 "
          f"{min(ms['bfloat16']):.2f} ms (CUDA events, in turns; each {ms}); int8 vs bf16 "
          f"cosine >= {cos.min().item():.4f}")
    del bf16


def ov_config():
    """"OV sunrgbd_quick": sunrgbd_quick() with the 2D-alignment loss at
    weight 1, as bench.py:518-530 builds it."""
    from ov3det_torch.config import sunrgbd_quick

    base = sunrgbd_quick()
    return dataclasses.replace(base, loss=dataclasses.replace(base.loss, alignment_2d_weight=1.0))


def ov_batches(cfg, n: int, seed: int) -> list:
    """n numpy batches of 8 `SyntheticOVDataset` scenes x 20 000 points
    (530 x 730 uint8 canvases), the config's classes and angle bins."""
    from ov3det_torch.datasets.loader import collate
    from ov3det_torch.datasets.synthetic import SyntheticOVDataset

    ds = SyntheticOVDataset(size=n * BATCH, seed=seed, num_points=cfg.data.num_points,
                            num_semcls=cfg.model.num_semcls, num_angle_bin=cfg.model.num_angle_bin)
    return [collate([ds[i * BATCH + j] for j in range(BATCH)]) for i in range(n)]


def ov_cli(card: str, dev: torch.device) -> dict:
    """`main(argv)` with --use_image at the full width of sunrgbd_quick: one
    epoch of 8 steps and its evals; every step launches as a training step,
    every eval batch as a request; the checkpoint holds the detector and its
    optimiser only, the same keys, shapes and size as a point-only run's."""
    import tempfile

    from ov3det_torch import main as cli
    from ov3det_torch.engine.checkpoint import CheckpointManager
    from ov3det_torch.engine.train import build_training

    train_step = expect(fps=2, ball_group=1, attention_fwd=3, attention_dq=3, attention_dkv=3)
    eval_batch = expect(fps=2, ball_group=1, attention_fwd=3)
    probe = CliProbe()
    with tempfile.TemporaryDirectory(prefix="ov3det_ov_cli_") as run:
        argv = OV_CLI_ARGV + ["--checkpoint_dir", run]
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        training, lines = run_cli(probe, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        for line in lines:
            if not (" Average Precision: " in line or " Recall: " in line):
                print(f"ov cli| {line}")
        require(training.teacher is not None and training.teacher.compute_dtype == "int8",
                "ov cli: no int8 teacher")
        require(len(probe.steps) == 8, f"ov cli: {len(probe.steps)} training steps, expected 8")
        require(all(d == train_step for _, _, d in probe.steps),
                f"ov cli: a step launched {[d for _, _, d in probe.steps if d != train_step][:1]}")
        require(bool(probe.evals) and all(d == eval_batch for d in probe.evals),
                f"ov cli: an eval batch launched {[d for d in probe.evals if d != eval_batch][:1]}")
        path = os.path.join(run, "checkpoint")
        require(os.path.isfile(path) and os.path.isfile(os.path.join(run, "final_eval.txt")),
                "ov cli: no checkpoint or final_eval.txt")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        teacher_keys = set(training.teacher.state_dict())
        require(not teacher_keys & set(payload["model"])
                and set(payload["model"]) == set(training.model.state_dict()),
                "ov cli: the checkpoint holds more than the detector")
        cfg = cli.config_from_args(cli.make_args_parser().parse_args(argv))
        point = build_training(dataclasses.replace(cfg, teacher=dataclasses.replace(
            cfg.teacher, enabled=False)), 8, device=dev, seed=cfg.seed)
        with tempfile.TemporaryDirectory(prefix="ov3det_point_ckpt_") as other:
            ref = CheckpointManager(other).save(point.model, point.optimizer, 0)
            ref_payload = torch.load(ref, map_location="cpu", weights_only=True)
            ref_size, size = os.path.getsize(ref), os.path.getsize(path)
        require({k: v.shape for k, v in payload["model"].items()}
                == {k: v.shape for k, v in ref_payload["model"].items()}
                and abs(size - ref_size) <= 0.001 * ref_size,
                f"ov cli: checkpoint {size} B against a point-only run's {ref_size} B")
    counts = read_counts()
    iters = [(b[0] - a[0]) * 1e3 for a, b in zip(probe.steps, probe.steps[1:])]
    print(f"ov cli run: {wall:.2f} s wall (teacher build and calibration, 8 steps, evals, "
          f"checkpoints), iteration (host clock, step start to step start) median "
          f"{np.median(iters):.2f} ms, {min(iters):.2f} to {max(iters):.2f}; peak device memory "
          f"{peak / 2**30:.3f} GiB; checkpoint {size / 1e6:.2f} MB, a point-only run's "
          f"{ref_size / 1e6:.2f} MB, no teacher tensor ({card})")
    print(f"ov cli launches: { {n: c for n, c in counts.items() if c} }")
    return counts


def ov_phase(card: str, dev: torch.device) -> tuple:
    """Phase 10: the open-vocabulary step; returns the launch counts of its
    training run and of its CLI run."""
    from ov3det_torch import main as cli
    from ov3det_torch.models.regionclip import (
        RegionCLIPTeacher,
        calibration_boxes,
        init_teacher_state,
    )

    t_phase = time.perf_counter()
    check_quant_conv(card, dev)
    cfg = ov_config()
    batches = ov_batches(cfg, OV_STEPS + 1, 700)
    first = {k: v[0] for k, v in batches[0].items()}
    boxes = calibration_boxes(np.random.default_rng(0), float(first["image_height"]),
                              float(first["image_width"]))
    t0 = time.perf_counter()
    state = init_teacher_state(RegionCLIPTeacher(device="cpu"), seed=0)
    print(f"teacher: RN50x4 seeded f32 weights drawn in {time.perf_counter() - t0:.1f} s, "
          f"{sum(v.numel() for v in state.values()) / 1e6:.2f} M values")
    teacher_card_vs_cpu(state, first["image"][None], boxes, dev)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    teacher = cli.build_teacher(cfg, first, dev)
    torch.cuda.synchronize()
    print(f"teacher build (seeded weights, int8 quantisation, calibration on the card): "
          f"{time.perf_counter() - t0:.2f} s")
    teacher_forward_times(teacher, state, batches[0], dev)
    del state
    nbytes = sum(v.nbytes for v in batches[0].values())
    print(f"one OV batch crossing to the card: {nbytes / 1e6:.2f} MB, of which the uint8 "
          f"canvases {batches[0]['image'].nbytes / 1e6:.2f} MB (int64 would make them "
          f"{8 * batches[0]['image'].nbytes / 1e6:.2f} MB)")
    trained = train(cfg, OV_STEPS, expect(fps=2, ball_group=1, attention_fwd=3, attention_dq=3,
                                          attention_dkv=3), "ov_sunrgbd", 700, dev,
                    teacher=teacher, batches=batches)
    del teacher, batches
    gc.collect()
    cli_counts = ov_cli(card, dev)
    print(f"phase 10 (the open-vocabulary step): {time.perf_counter() - t_phase:.1f} s")
    return trained, cli_counts



# ------------------------------------------------------------ phase 11: the pseudo-label round
PSEUDO_TRAIN, PSEUDO_VAL = 16, 8  # scans of the ScanNet-layout tree (2 and 1 batches of 8)
# the CLI at scannet_quick()'s width with the flags of scripts/scannet_quick.sh
PSEUDO_ARGV = ["--dataset_name", "scannet", "--device", "cuda", "--batchsize_per_gpu", "8",
               "--compute_dtype", "bfloat16", "--nqueries", "256", "--matcher_giou_cost", "2",
               "--matcher_cls_cost", "1", "--matcher_center_cost", "0",
               "--matcher_objectness_cost", "0", "--loss_giou_weight", "1",
               "--loss_no_object_weight", "0.25", "--save_separate_checkpoint_every_epoch", "-1",
               "--max_epoch", "1", "--log_every", "1"]
LIFT_FRAMES, LIFT_HW = 4, (240, 320)  # frames of the lifted scene; ScanNet's depth maps, halved
TEXT_CHECK_PROMPTS = 30  # prompts (2 classes x 15 templates) also run on the CPU


def write_png16(path: str, image: np.ndarray) -> None:
    """A 16-bit greyscale PNG of `image`, each scanline with the Up filter,
    written with zlib (the port reads PNGs without PIL)."""
    import struct
    import zlib

    H, W = image.shape
    rows = np.ascontiguousarray(image.astype(">u2")).view(np.uint8).reshape(H, 2 * W)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]  # modulo 256
    raw = np.concatenate([np.full((H, 1), 2, np.uint8), up], 1).tobytes()

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 16, 0, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@contextlib.contextmanager
def eval_spy(module, record: list):
    """Wrap `module.make_eval_step`: each eval batch appends (host ms to its
    sync, launch deltas) to `record`."""
    make = module.make_eval_step

    def make_eval_step(*args, **kwargs):
        step = make(*args, **kwargs)

        def eval_step(batch):
            before = read_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize()
            after = read_counts()
            record.append(((time.perf_counter() - t) * 1e3, {n: after[n] - before[n] for n in after}))
            return out
        return eval_step

    module.make_eval_step = make_eval_step
    try:
        yield
    finally:
        module.make_eval_step = make


def pseudo_pass(argv: list, label: str) -> tuple:
    """`generate_pseudo_label.main(argv)` in this process: (boxes written,
    wall s, [(batch ms, launches)], the formatter's rows before the
    thresholds)."""
    from ov3det_torch import generate_pseudo_label as gpl

    batches, rows, out = [], [], io.StringIO()
    run_inference = gpl.run_inference

    def keep_rows(cfg, args, device=None):
        formatter = run_inference(cfg, args, device)
        rows.append(np.concatenate(formatter.boxes))
        return formatter

    gpl.run_inference = keep_rows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with eval_spy(gpl, batches), contextlib.redirect_stdout(out):
            n = gpl.main(argv)
    finally:
        gpl.run_inference = run_inference
    wall = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        print(f"{label}| {line}")
    return n, wall, batches, rows[0]


def pseudo_thresholds(rows: np.ndarray, slots: int) -> tuple:
    """(conf, obj): the median score, and the median objectness raised just
    above the (slots + 1)-th largest objectness, among the rows at or over
    that score, of each scan that has more: no scan keeps more rows than
    the loader has GT slots."""
    conf = np.median(rows[:, 7])
    obj = np.median(rows[:, 8])
    over = rows[rows[:, 7] >= conf]
    for i in np.unique(over[:, 9]):
        ranked = np.sort(over[over[:, 9] == i, 8])[::-1]
        if len(ranked) > slots:
            obj = max(obj, np.nextafter(ranked[slots], np.float32(np.inf)))
    return float(conf), float(obj)


def paint_labels(tree: dict, scan_names: list, boxes: np.ndarray, out: str) -> None:
    """Label files for `--label_dir`: each scan's own point labels, over
    which each of its `boxes` (formatter rows) paints the points inside it,
    the scan's first box on top, alternately with the box's class and with
    the next class, so that the filter has boxes to keep and boxes to drop."""
    os.makedirs(out)
    for i, scan in enumerate(scan_names):
        labelled = np.load(os.path.join(tree["label_dir"], f"{scan}.npy"))
        xyz, cls = labelled[:, :3], labelled[:, 3].copy()
        mine = boxes[boxes[:, 9] == i]
        for j in range(len(mine) - 1, -1, -1):
            box = mine[j]
            inside = np.all(np.abs(xyz - box[:3]) <= box[3:6] / 2, axis=-1)
            cls[inside] = box[6] if j % 2 == 0 else (box[6] + 1) % 18
        np.save(os.path.join(out, f"{scan}.npy"), np.concatenate([xyz, cls[:, None]], 1))


def kept_reference(rows: np.ndarray, conf: float, obj: float, label_dir: str,
                   scan_names: list) -> list:
    """The boxes `--label_dir` keeps, scan by scan, by a direct count: score
    and objectness at or over the thresholds, and the box's class the most
    common one (ties to the lower) among the points inside it whose label
    is a class (below 18)."""
    kept = []
    for i, scan in enumerate(scan_names):
        labelled = np.load(os.path.join(label_dir, f"{scan}.npy"))
        xyz, cls = labelled[:, :3], labelled[:, 3].astype(np.int64)
        mine = rows[(rows[:, 9] == i) & (rows[:, 7] >= conf) & (rows[:, 8] >= obj)]
        keep = []
        for box in mine:
            inside = (np.all((xyz >= box[:3] - box[3:6] / 2) & (xyz <= box[:3] + box[3:6] / 2),
                             axis=-1) & (cls < 18))
            keep.append(bool(inside.any())
                        and np.bincount(cls[inside], minlength=18).argmax() == box[6])
        kept.append(mine[np.array(keep, bool)])
    return kept


def pseudo_card_vs_cpu(cfg, ckpt: str, dataset, dev: torch.device) -> None:
    """The first batch's formatter rows from the card and from the CPU, the
    same checkpoint at f32 (TF32 off): centres and sizes within 1e-3, score
    and objectness within 1e-4, the labels wherever the CPU's top-2 margin
    exceeds 1e-4."""
    from ov3det_torch.datasets.loader import collate
    from ov3det_torch.engine.checkpoint import restore_eval_checkpoint
    from ov3det_torch.engine.infer import make_eval_step
    from ov3det_torch.engine.train import batch_to_device
    from ov3det_torch.models.detr3d import Model3DETR
    from ov3det_torch.tools.label_formatter import LabelFormatter

    model_cfg = dataclasses.replace(cfg.model, compute_dtype="float32")
    batch = collate([dataset[i] for i in range(BATCH)])
    rows, probs, secs = {}, {}, {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = Model3DETR(model_cfg, device=device)
        restore_eval_checkpoint(model, ckpt)
        t0 = time.perf_counter()
        out = make_eval_step(model)(batch_to_device(batch, device))
        formatter = LabelFormatter(None, None, dataset.scan_names, model_cfg.num_semcls)
        formatter.step(out, batch)
        secs[name] = time.perf_counter() - t0
        rows[name], probs[name] = formatter.boxes[0], out["sem_cls_prob"].float().cpu()
        del model, out
    card, cpu = rows["card"], rows["cpu"]
    top2 = probs["cpu"].reshape(-1, probs["cpu"].shape[-1]).topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1] > 1e-4).numpy()
    geo = np.abs(card[:, :6] - cpu[:, :6]).max()
    prob = np.abs(card[:, 7:9] - cpu[:, 7:9]).max()
    require(card.shape == cpu.shape == (BATCH * model_cfg.num_queries, 10), f"pseudo rows {card.shape}")
    require(np.isfinite(card).all(), "pseudo card vs CPU: non-finite rows on the card")
    require(geo <= 1e-3, f"pseudo card vs CPU: centres and sizes differ by {geo}")
    require(prob <= 1e-4, f"pseudo card vs CPU: score or objectness differ by {prob}")
    require(np.array_equal(card[decided, 6], cpu[decided, 6]),
            "pseudo card vs CPU: a label differs where the top-2 margin exceeds 1e-4")
    require(np.array_equal(card[:, 9], cpu[:, 9]), "pseudo card vs CPU: scan indices differ")
    print(f"pseudo card vs CPU (f32 checkpoint, first batch, {len(card)} rows): centres and sizes "
          f"within {geo:.2e}, score and objectness within {prob:.2e}, labels equal on "
          f"{int(decided.sum())} rows with a top-2 margin above 1e-4 ({int((~decided).sum())} "
          f"below it; {int((card[:, 6] != cpu[:, 6]).sum())} of all rows differ); the eval forward "
          f"{secs['card']:.2f} s on the card, {secs['cpu']:.2f} s on the CPU")


def lift_scene(tree: dict, scan: str, run: str) -> int:
    """`lift_scene_scannet` on one scene seen from LIFT_FRAMES cameras: 2D
    boxes around the projections of its labelled GT boxes' points, depth
    PNGs from `write_png16`; returns the boxes lifted."""
    from ov3det_torch.tools.lift_boxes import LiftConfig, lift_scene_scannet

    H, W = LIFT_HW
    frames = os.path.join(run, "frames", scan)
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(frames, sub))
    b2d = os.path.join(run, "boxes2d", scan, "color")
    os.makedirs(b2d)
    f, cx, cy = 400.0, 320.0, 240.0  # 640 x 480 depth intrinsics, halved by the lifting
    np.savetxt(os.path.join(frames, "intrinsic_depth.txt"),
               np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
    labelled = np.load(os.path.join(tree["label_dir"], f"{scan}.npy"))
    xyz, cls = labelled[:, :3], labelled[:, 3].astype(np.int64)
    gt = np.load(os.path.join(tree["root_dir"], f"{scan}_bbox.npy"))
    nyu = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])
    rng = np.random.default_rng(1100)
    for fid in range(LIFT_FRAMES):
        # a camera 7 m back along -y looking at +y, image y down (world -z)
        pose = np.array([[1.0, 0, 0, 0], [0, 0, 1, -7.0], [0, -1, 0, 1.0], [0, 0, 0, 1]])
        pose[:3, 3] += rng.normal(0, 0.05, 3)
        cam = (np.linalg.inv(pose) @ np.concatenate([xyz, np.ones((len(xyz), 1))], 1).T)[:3]
        u = cam[0] * (f / 2) / cam[2] + cx / 2
        v = cam[1] * (f / 2) / cam[2] + cy / 2
        rows = []
        for box in gt:
            c = int(np.searchsorted(nyu, box[6]))
            inside = (cls == c) & np.all(np.abs(xyz - box[:3]) <= box[3:6] / 2, axis=-1)
            if inside.sum() < 10:
                continue
            x0, y0 = np.floor(u[inside].min()) - 2, np.floor(v[inside].min()) - 2
            x1, y1 = np.ceil(u[inside].max()) + 2, np.ceil(v[inside].max()) + 2
            if x0 > 0 and y0 > 0 and x1 < W and y1 < H:
                rows.append([x0, y0, x1 - x0, y1 - y0, rng.uniform(0.5, 1.0), c])
        np.save(os.path.join(b2d, f"{fid}.npy"), np.array(rows, np.float64).reshape(-1, 6))
        open(os.path.join(frames, "color", f"{fid}.jpg"), "wb").close()
        write_png16(os.path.join(frames, "depth", f"{fid}.png"),
                    rng.integers(500, 5000, size=(H, W)).astype(np.uint16))
        np.savetxt(os.path.join(frames, "pose", f"{fid}.txt"), pose)
    t0 = time.perf_counter()
    n = lift_scene_scannet(scan, detection_data_dir=tree["root_dir"] + "/",
                           frames_dir=os.path.join(run, "frames"),
                           label_path_fmt=os.path.join(tree["label_dir"], "{}.npy"),
                           boxes2d_dir=os.path.join(run, "boxes2d"), out_dir=os.path.join(run, "lifted"),
                           cfg=LiftConfig(use_gss=False, image_dims=LIFT_HW))
    ms = (time.perf_counter() - t0) * 1e3
    require("PIL" not in sys.modules, "lift: PIL was imported")
    require(n > 0, "lift: no box lifted")
    lifted = np.load(os.path.join(run, "lifted", f"{scan}_bbox.npy"))
    require(lifted.shape == (n, 8) and np.isfinite(lifted).all(), f"lift: rows {lifted.shape}")
    print(f"lift {scan}: {LIFT_FRAMES} frames of {H} x {W} (16-bit PNG depth read by "
          f"ov3det_torch.utils.png), {len(gt)} GT boxes, {n} boxes lifted in {ms:.1f} ms (host); "
          f"PIL not imported")
    return n


def text_tower(card: str, dev: torch.device) -> None:
    """The CLIP text tower at RN50x4's width (640, 10 heads, 12 layers, 77
    tokens, vocabulary 49 408), seeded weights, on the 18 ScanNet classes x
    PROMPT_TEMPLATES with a stub vocabulary: the card against the CPU on the
    first TEXT_CHECK_PROMPTS prompts within 1e-5 of the largest value (f32),
    the forward of all 270 timed, the class embeddings unit rows."""
    import gzip
    import tempfile

    from ov3det_torch.datasets.dataset_configs import ScannetDatasetConfig
    from ov3det_torch.models.clip_text import (
        CLIPTextEncoder,
        SimpleBPETokenizer,
        extract_class_embeddings,
        tokenize_prompts,
    )

    names = [ScannetDatasetConfig().class2type[i] for i in range(18)]
    with tempfile.TemporaryDirectory(prefix="ov3det_bpe_") as d:
        path = os.path.join(d, "bpe.txt.gz")
        with gzip.open(path, "wt", encoding="utf-8") as fh:  # a stub of CLIP's merges file
            fh.write("#version: 0.2\nt h\nth e</w>\nc h\na i\nch ai\nchai r</w>\np h\no t\n"
                     "ph ot\nphot o</w>\no f</w>\n")
        prompts = tokenize_prompts(names, SimpleBPETokenizer(path))
    flat = torch.from_numpy(prompts.reshape(-1, prompts.shape[-1]))
    t0 = time.perf_counter()
    on_card = CLIPTextEncoder(device=dev, seed=0)
    build_s = time.perf_counter() - t0
    on_cpu = CLIPTextEncoder(device="cpu", seed=0)
    ids = flat.to(dev)
    with torch.no_grad():
        got = on_card(ids)
        ms = cuda_ms(lambda: on_card(ids), 5)
        t0 = time.perf_counter()
        want = on_cpu(flat[:TEXT_CHECK_PROMPTS])
        cpu_s = time.perf_counter() - t0
    got = got.cpu()
    err = ((got[:TEXT_CHECK_PROMPTS] - want).abs().max() / want.abs().max()).item()
    require(got.shape == (len(flat), 640) and torch.isfinite(got).all(), "text tower: bad output")
    require(err <= 1e-5, f"text tower: card vs CPU {err} of the largest value")
    emb = extract_class_embeddings(on_card, prompts)
    require(emb.shape == (18, 640) and np.allclose(np.linalg.norm(emb, axis=-1), 1, atol=1e-5),
            "text tower: class embeddings are not unit rows")
    params = sum(p.numel() for p in on_card.parameters())
    print(f"text tower (RN50x4 width, {params / 1e6:.2f} M seeded weights, built in {build_s:.2f} s): "
          f"{len(flat)} prompts x {flat.shape[1]} tokens in {ms:.2f} ms on the card (CUDA events, "
          f"f32, TF32 off); card vs CPU within {err:.2e} of the largest value on "
          f"{TEXT_CHECK_PROMPTS} prompts (the CPU {cpu_s:.2f} s); class embeddings {emb.shape} ({card})")
    del on_card, on_cpu


def reference_checkpoint(card: str, dev: torch.device) -> dict:
    """A reference-layout 3DETR checkpoint at scannet_quick()'s width (the
    port's seeded model written by `to_reference_state_dict`, saved as a
    .pth) read by `load_reference_checkpoint` into a `Detector` with
    `ball_query_method="first_k"`: one request's launches (FPS twice, no
    ball-group, the attention forward 3 times), time and peak memory; the
    first-K indices card against CPU on one scene; the first-K query and its
    grouping beside the tile ball-group at 8 x 40 000, M 2048, K 64.
    Returns the request's launch counts."""
    import tempfile

    from ov3det_torch.config import scannet_quick
    from ov3det_torch.engine.infer import Detector
    from ov3det_torch.models.convert_3detr import load_reference_checkpoint, to_reference_state_dict
    from ov3det_torch.models.detr3d import Model3DETR
    from ov3det_torch.ops.kernels.ball_group import ball_group
    from ov3det_torch.ops.pointcloud import (
        ball_query,
        furthest_point_sample,
        gather_points,
        group_points,
    )

    quick = scannet_quick()
    cfg = dataclasses.replace(quick.model, ball_query_method="first_k")
    ref = to_reference_state_dict(Model3DETR(cfg, device="cpu", seed=5).state_dict())
    with tempfile.TemporaryDirectory(prefix="ov3det_ref_") as d:
        path = os.path.join(d, "checkpoint_best.pth")
        torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in ref.items()},
                    "epoch": 0}, path)
        t0 = time.perf_counter()
        state = load_reference_checkpoint(path)
        load_ms = (time.perf_counter() - t0) * 1e3
        mb = os.path.getsize(path) / 1e6
    det = Detector(cfg, state_dict=state, device=dev)
    batches = synthetic_batches(quick, 2, 900)
    det.detect(batches[0])  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dets = det.detect(batches[1])
    request_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    require(counts == expect(fps=2, attention_fwd=3),
            f"reference checkpoint request: launches {counts}, expected fps 2, attention_fwd 3")
    require(len(dets) == BATCH and all(np.isfinite(c).all() and np.isfinite(s).all()
                                       for _, c, s in dets), "reference checkpoint: bad detections")
    # the same weights and request with the bucketed ball-group, the
    # configuration's default: the yardstick of the first-K path's peak
    bucketed = Detector(quick.model, state_dict=state, device=dev)
    bucketed.detect(batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bucketed.detect(batches[1])
    bucketed_ms = (time.perf_counter() - t0) * 1e3
    bucketed_peak = torch.cuda.max_memory_allocated()
    del bucketed
    print(f"reference checkpoint ({len(ref)} tensors, {mb:.2f} MB, read and converted in "
          f"{load_ms:.1f} ms): first_k request of 8 x {SCANNET_POINTS} points {request_ms:.2f} ms, "
          f"peak device memory {peak / 2**30:.3f} GiB (the same request with the bucketed "
          f"ball-group: {bucketed_ms:.2f} ms, {bucketed_peak / 2**30:.3f} GiB), detections per "
          f"scene {[len(c) for c, _, _ in dets]}, launches "
          f"{ {n: c for n, c in counts.items() if c} } ({card})")

    xyz = torch.from_numpy(batches[1]["point_clouds"][..., :3]).to(dev).contiguous()
    centers = gather_points(xyz, furthest_point_sample(xyz, 2048)).contiguous()
    radius, K = cfg.preenc_radius, cfg.preenc_nsample
    got = ball_query(xyz[:1], centers[:1], radius, K).cpu()
    want = ball_query(xyz[:1].cpu(), centers[:1].cpu(), radius, K)
    require(torch.equal(got, want), "first_k: the card's indices differ from the CPU's")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    inds = ball_query(xyz, centers, radius, K)
    torch.cuda.synchronize()
    query_peak = torch.cuda.max_memory_allocated() - base
    ms = {}
    for name in ("first_k query", "first_k grouping", "tile ball-group", "tile ball-group",
                 "first_k grouping", "first_k query"):
        fn = {"first_k query": lambda: ball_query(xyz, centers, radius, K),
              "first_k grouping": lambda: group_points(xyz, None, centers, inds, radius),
              "tile ball-group": lambda: ball_group(xyz, None, centers, radius, K)}[name]
        ms[name] = min(ms.get(name, math.inf), cuda_ms(fn, 5))
    hits = (inds[..., 1:] != inds[..., :1]).sum(-1).float().mean().item() + 1
    print(f"first_k at 8 x {SCANNET_POINTS}, M 2048, K {K}, r {radius}: indices equal card vs CPU "
          f"on one scene; query {ms['first_k query']:.3f} ms (peak {query_peak / 2**20:.1f} MiB "
          f"above its inputs) + grouping {ms['first_k grouping']:.3f} ms against the tile "
          f"ball-group's {ms['tile ball-group']:.3f} ms (CUDA events, in turns; about {hits:.1f} "
          f"distinct neighbours a ball) ({card})")
    del det
    return counts


def pseudo_phase(card: str, dev: torch.device) -> dict:
    """Phase 11: the pseudo-label round at scannet_quick()'s width on a
    ScanNet-layout tree of synthetic scenes: train an epoch, label the train
    split (all rows, then with the label filter at thresholds taken from
    those rows), the rows card against CPU, retrain an epoch with --use_pbox
    on the kept boxes, lift a scene, the text tower and a reference
    checkpoint with the first-K ball query.  Returns the launch counts of
    its training runs, label passes and first-K request."""
    import shutil
    import tempfile

    from ov3det_torch.datasets.dataset_configs import ScannetDatasetConfig
    from ov3det_torch.datasets.registry import build_dataset
    from ov3det_torch.datasets.synthetic import write_scannet_tree
    from ov3det_torch.generate_pseudo_label import make_pseudo_label_parser
    from ov3det_torch.main import config_from_args
    from ov3det_torch.tools.format_tools import adjust_format_to_nyu40

    t_phase = time.perf_counter()
    train_step = expect(fps=2, ball_group=1, attention_fwd=3, attention_dq=3, attention_dkv=3)
    eval_batch = expect(fps=2, ball_group=1, attention_fwd=3)
    total = collections.Counter()
    with tempfile.TemporaryDirectory(prefix="ov3det_pseudo_") as run:
        t0 = time.perf_counter()
        tree = write_scannet_tree(os.path.join(run, "scannet"), PSEUDO_TRAIN, PSEUDO_VAL,
                                  SCANNET_POINTS, seed=11)
        print(f"pseudo tree: {PSEUDO_TRAIN} train + {PSEUDO_VAL} val scans of {SCANNET_POINTS} "
              f"points written in {time.perf_counter() - t0:.2f} s")
        data = ["--dataset_root_dir", tree["root_dir"], "--meta_data_dir", tree["meta_data_dir"]]
        label_argv = PSEUDO_ARGV + data
        cfg = config_from_args(make_pseudo_label_parser().parse_args(label_argv))
        Q = cfg.model.num_queries
        dataset = build_dataset(cfg.data, splits=("inference",))[0]["inference"]
        scans = list(dataset.scan_names)

        def train_run(extra: list, label: str) -> CliProbe:
            probe = CliProbe()
            reset_counts()
            t0 = time.perf_counter()
            _, lines = run_cli(probe, PSEUDO_ARGV + data + extra)
            wall = time.perf_counter() - t0
            counts = read_counts()
            for line in lines:
                if not (" Average Precision: " in line or " Recall: " in line):
                    print(f"{label}| {line}")
            require(len(probe.steps) == PSEUDO_TRAIN // BATCH
                    and all(d == train_step for _, _, d in probe.steps),
                    f"{label}: steps launched {[d for _, _, d in probe.steps]}")
            require(bool(probe.evals) and all(d == eval_batch for d in probe.evals),
                    f"{label}: eval batches launched {probe.evals}")
            total.update(counts)
            print(f"{label}: {wall:.2f} s wall ({len(probe.steps)} steps, {len(probe.evals)} eval "
                  f"batches, checkpoints), launches { {n: c for n, c in counts.items() if c} } "
                  f"({card})")
            return probe

        ckpt_dir = os.path.join(run, "train")
        train_run(["--checkpoint_dir", ckpt_dir], "pseudo train")
        ckpt = os.path.join(ckpt_dir, "checkpoint")

        label_argv += ["--test_ckpt", ckpt]
        reset_counts()
        n, wall, batches, all_rows = pseudo_pass(
            label_argv + ["--out_dir", os.path.join(run, "all"), "--conf_thresh", "0",
                          "--obj_thresh", "0"], "pseudo all")
        counts = read_counts()
        files = sorted(os.listdir(os.path.join(run, "all")))
        rows = [np.load(os.path.join(run, "all", name)) for name in files]
        require(n == PSEUDO_TRAIN * Q and sum(len(r) for r in rows) == n,
                f"pseudo all: {n} rows written, expected {PSEUDO_TRAIN} x {Q}")
        require(files == [f"{s}_bbox.npy" for s in scans] and scans == tree["train"],
                f"pseudo all: files {files}")
        require(all(r.shape == (Q, 7) and np.isfinite(r).all() for r in rows),
                "pseudo all: a file holds non-finite or misshapen rows")
        want = expect(fps=2 * 2, ball_group=2, attention_fwd=2 * 3)
        require(counts == want and [d for _, d in batches] == [eval_batch, eval_batch],
                f"pseudo all: launches {counts}, batches {[d for _, d in batches]}")
        total.update(counts)
        print(f"pseudo label pass (no filter): {n} rows in {len(files)} files, {wall:.2f} s wall "
              f"(model build, checkpoint, loader, 2 batches, formatter), batches "
              f"{[round(ms, 2) for ms, _ in batches]} ms (host clock to a sync), launches "
              f"{ {k: c for k, c in counts.items() if c} } ({card})")

        # the filtered pass: thresholds from the rows above, and label files
        # on which some boxes agree with their scene and some do not
        slots = ScannetDatasetConfig().max_num_obj
        conf, obj = pseudo_thresholds(all_rows, slots)
        passed = all_rows[(all_rows[:, 7] >= conf) & (all_rows[:, 8] >= obj)]
        painted = os.path.join(run, "painted")
        paint_labels(tree, scans, passed, painted)
        reset_counts()
        n_kept, wall, batches, kept_rows = pseudo_pass(
            label_argv + ["--out_dir", os.path.join(run, "kept"), "--label_dir", painted,
                          "--conf_thresh", repr(conf), "--obj_thresh", repr(obj)], "pseudo filtered")
        counts = read_counts()
        require(counts == want, f"pseudo filtered: launches {counts}")
        total.update(counts)
        want_kept = kept_reference(kept_rows, conf, obj, painted, scans)
        kept = {s: np.load(os.path.join(run, "kept", f"{s}_bbox.npy")) for s in scans}
        n_passed = int(((kept_rows[:, 7] >= conf) & (kept_rows[:, 8] >= obj)).sum())
        require(0 < n_kept < n_passed, f"pseudo filtered: {n_kept} boxes kept of {n_passed} over "
                                       "the thresholds: the filter must keep some and drop some")
        require(n_kept == sum(len(k) for k in want_kept)
                and all(len(kept[s]) == len(k) for s, k in zip(scans, want_kept)),
                f"pseudo filtered: kept {[len(kept[s]) for s in scans]} a scan, a direct count "
                f"gives {[len(k) for k in want_kept]}")
        for s, k in zip(scans, want_kept):  # the formatter writes them grouped by class
            order = np.argsort(k[:, 6], kind="stable")
            require(np.array_equal(kept[s], k[order, :7]), f"pseudo filtered: {s}'s rows differ")
        rerun = np.abs(kept_rows - all_rows).max()
        print(f"pseudo label pass (--label_dir, conf {conf:.6g}, obj {obj:.6g}, the thresholds "
              f"from the first pass's rows): {n_kept} boxes kept of the {n_passed} over them "
              f"(most in a scan: {max(len(k) for k in want_kept)}), equal to a direct count, "
              f"{wall:.2f} s wall, batches {[round(ms, 2) for ms, _ in batches]} ms; its rows "
              f"within {rerun:.2e} of the first pass's ({card})")

        pseudo_card_vs_cpu(cfg, ckpt, dataset, dev)

        # the retraining round: the kept boxes in nyu40 ids (ScanNet's loader
        # reads those); the val split reads --pseudo_label_dir too, and gets
        # its GT boxes there, as a lifting over every scan would give it
        pbox = os.path.join(run, "pbox")
        adjust_format_to_nyu40(os.path.join(run, "kept"), pbox, scans)
        for scan in tree["val"]:
            shutil.copy(os.path.join(tree["root_dir"], f"{scan}_bbox.npy"), pbox)
        probe = train_run(["--use_pbox", "--pseudo_label_dir", pbox, "--checkpoint_dir",
                           os.path.join(run, "retrain")], "pseudo retrain")
        carried = {}
        for b in probe.train_boxes:
            for i, present, sem in zip(b["scan_idx"], b["gt_box_present"], b["gt_box_sem_cls_label"]):
                k, scan = int(present.sum()), scans[int(i)]
                require(k == len(kept[scan])
                        and np.array_equal(sem[:k], kept[scan][:, 6].astype(np.int64)),
                        f"pseudo retrain: {scan} carries {k} GT boxes of classes {sem[:k].tolist()}, "
                        f"its pseudo-label file {kept[scan][:, 6].tolist()}")
                carried[scan] = k
        require(sorted(carried) == scans and sum(carried.values()) == n_kept,
                f"pseudo retrain: its batches carry {carried}, {n_kept} boxes kept")
        print(f"pseudo retrain: its {len(probe.train_boxes)} batches carry the {n_kept} kept boxes "
              f"as GT ({[carried[s] for s in scans]} a scan), each scan's count and classes those "
              f"of its file in --pseudo_label_dir")
        gc.collect()
        require(not multiprocessing.active_children(),
                f"pseudo: loader workers outlived the runs: {multiprocessing.active_children()}")

        lift_scene(tree, tree["train"][0], run)
    text_tower(card, dev)
    total.update(reference_checkpoint(card, dev))
    print(f"phase 11 (the pseudo-label round): {time.perf_counter() - t_phase:.1f} s")
    return dict(total)



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ov3det_torch", "csrc")):
        print("chip_smoke: the ov3det_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ov3det_torch.config import sunrgbd_quick
    from ov3det_torch.ops.kernels import _build

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'cached libraries'}")
    for name, log in sorted(logs.items()):
        lines = ptxas_summary(log)
        many = [line for line in lines if line.startswith("fps_cluster_kernel")]
        for line in lines:
            if line not in many:
                print(f"  {name}: {line}")
            require("_wgmma" not in line or ", 0 B spilled" in line, f"{line}: a wgmma kernel spills")
        if many:  # one instantiation per count of points a thread, with and without a cluster
            facts = [line.split(": ")[1].split(", ") for line in many]  # registers, spills, shared
            regs = [int(f[0].split()[0]) for f in facts]
            spilled = sum(int(f[1].split()[0]) for f in facts)
            shared = max(int(f[2].split()[0]) for f in facts)
            require(spilled == 0, f"fps_cluster_kernel spills {spilled} B: the chain must stay in "
                                  "registers")
            print(f"  {name}: fps_cluster_kernel: {len(many)} instantiations (0 to 32 points a "
                  f"thread; one CTA or a cluster), {min(regs)} to {max(regs)} registers, {spilled} B "
                  f"spilled in all, at most {shared} B static shared")
    for line in sass_summary():
        print(f"  {line}")

    dev = torch.device("cuda")
    sun, masked = sunrgbd_quick(), scannet_masked()
    batches = synthetic_batches(sun, REQUESTS, 100)
    entries = {**check_kernels(batches[0], dev), **check_attention(dev)}
    served = serve(sun, batches, expect(fps=2, ball_group=1, attention_fwd=3), "sunrgbd", dev)
    card_vs_cpu(batches[0])
    trained = train(sun, TRAIN_STEPS, expect(fps=2, ball_group=1, attention_fwd=3, attention_dq=3,
                                             attention_dkv=3), "sunrgbd", 200, dev)
    train_card_vs_cpu(sun, "sunrgbd", 200)

    m_batches = synthetic_batches(masked, REQUESTS, 300)
    extras, pre_xyz, mid_xyz = check_masked_points(m_batches[0], dev)
    for name, extra in extras.items():
        if name in entries:
            entries[name]["scannet_masked"] = extra
        else:
            entries[name] = extra
    entries.update(check_radius_attention(pre_xyz, mid_xyz, dev))
    del pre_xyz, mid_xyz
    m_served = serve(masked, m_batches, expect(fps=3, ball_group=2, attention_fwd_radius=3),
                     "scannet_masked", dev)
    m_trained = train(masked, MASKED_TRAIN_STEPS,
                      expect(fps=3, ball_group=2, slot_sources=1, attention_fwd_radius=3,
                             attention_dq_radius=3, attention_dkv_radius=3), "scannet_masked", 400, dev)
    train_card_vs_cpu(masked, "scannet_masked", 400)

    cli_counts = cli_phase(card)
    ov_trained, ov_cli_counts = ov_phase(card, dev)
    pseudo_counts = pseudo_phase(card, dev)

    kernels = []
    for name, (source, replaces) in kernel_sources().items():
        count = sum(c.get(name, 0) for c in (served, trained, m_served, m_trained, cli_counts,
                                             ov_trained, ov_cli_counts, pseudo_counts))
        require(count > 0, f"{name} was not launched on the main paths")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": count, **entries[name]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
