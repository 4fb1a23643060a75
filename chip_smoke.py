#!/usr/bin/env python3
"""On-card check of the PyTorch port (`ov3det_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `ov3det_torch/csrc/` (one nvcc per source, all
at once), then:
  1. prints the card's name and power limit, and the build time;
  2. holds each kernel against its plain PyTorch version on the card at the
     shapes the main paths give it, and times kernel, plain version and,
     where one exists, a PyTorch call as a yardstick:
       FPS 8 x 20000 -> 2048 and 8 x 2048 -> 128, indices equal;
       ball-group 8 x 20000, M = 2048, K = 64, C = 0 and C = 3, exact;
       attention BH = 32, N = 2048, D = 64 (the encoder of the training
       step): the dropout mask read back through the forward, dq and dk/dv
       kernels equals the plain hash exactly; forward, dq and dk/dv in bf16,
       with dropout 0.1 and without, within 2e-2 of the largest value of
       the plain version in f32 (LSE within 1e-3); the f32 variants within
       1e-4 of it;
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
       kernels: FPS 40000 -> 2048 -> 1024 -> 256, indices equal; the
       ball-group at 40 000 points (C = 0) and at the interim SA's shapes
       (2048 tokens, 1024 centers, K = 32, C = 256), exact, and its feature
       gradient on the card against the CPU's; the attention kernels with
       the radius bias at the three (N, r^2) of the encoder's layers, with
       token coordinates from the FPS picks above: the radius mask read
       back through the forward, dq and dk/dv kernels equals the plain
       version's bit for bit, bf16 within 2e-2 and f32 within 1e-4 of the
       plain version (dropout 0 and 0.3), each timed beside its plain
       version and `scaled_dot_product_attention` with the boolean mask;
       serving: 3 requests, each launching FPS 3 times, the ball-group
       twice, the radius forward 3 times and no backward kernel;
       training: one warm-up and 3 timed steps, each launching FPS 3 times,
       the ball-group twice and each radius kernel 3 times, with the stage
       split, peak memory and one profiled step; then one f32 step with
       every dropout at 0 on one scene, card against CPU, as in 6;
  8. prints the kernels line (launches summed over the serving and training
     runs of both configs), the card line, and last
     {"ok": true, "device": {...}}.
Launch counts are set to 0 just before each serving and training run, and
read just after it.  The radius variants of the attention kernels count
apart (`.radius_launches`) and have their own entries in the kernels line.
Exits non-zero, printing no result, without CUDA or without the package
beside this file.  Any failed check raises.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, NUM_POINTS, REQUESTS = 8, 20000, 3  # sunrgbd_quick's data part
SCANNET_POINTS = 40000  # scannet_quick's data part, batch 8 as well
TRAIN_STEPS, MASKED_TRAIN_STEPS = 5, 3
ITERS_PER_EPOCH = 1000  # sets only the learning-rate schedule of the train phase
F32_PEAK, BF16_PEAK, HBM_BYTES_PER_S = 67e12, 989e12, 3.35e12  # H100 SXM data sheet


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
        if m:
            t = re.search(r"(attn_(?:fwd|dq|dkv)_(?:bf16|f32)|fps_kernel|pick_kernel|fill_kernel)"
                          r"(?:ILi(\d+)E(?:Lb([01])E)?)?", m.group(1))
            args = [a for a in (t.group(2), {"1": "radius", "0": None}.get(t.group(3)))
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


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def kernel_counters() -> dict:
    """name -> (wrapper, attribute): each wrapper counts its kernel's launches
    in `.launches`, the attention wrappers those of the radius variant in
    `.radius_launches`."""
    from ov3det_torch.ops.kernels import attention, ball_group, fps

    counters = {"fps": (fps.fps, "launches"), "ball_group": (ball_group.ball_group, "launches")}
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
            "attention_fwd": (attention.SOURCE, attention.REPLACES),
            "attention_dq": (attention.BWD_SOURCE, attention.DQ_REPLACES),
            "attention_dkv": (attention.BWD_SOURCE, attention.DKV_REPLACES),
            "attention_fwd_radius": (attention.SOURCE, attention.FWD_RADIUS_REPLACES),
            "attention_dq_radius": (attention.BWD_SOURCE, attention.DQ_RADIUS_REPLACES),
            "attention_dkv_radius": (attention.BWD_SOURCE, attention.DKV_RADIUS_REPLACES)}


def expect(**counts) -> dict:
    """Launches of every counter: the named ones as given, the rest 0."""
    return {n: counts.get(n, 0) for n in kernel_counters()}


def check_kernels(batch: dict, dev: torch.device) -> dict:
    """Phase 2: the point kernels against their plain versions, timed;
    returns their entries for one request's work on the serving path."""
    from ov3det_torch.ops.kernels import ball_group, fps

    xyz = torch.from_numpy(batch["point_clouds"]).to(dev)
    B, N, _ = xyz.shape
    entries = {}

    # FPS: 20000 -> 2048 (pre-encoder), then 2048 -> 128 (query seeds)
    inds = fps.fps(xyz, 2048)
    require(torch.equal(inds, fps.fps_plain(xyz, 2048)), "fps 20000->2048 differs from plain")
    pre_xyz = torch.gather(xyz, 1, inds[..., None].expand(-1, -1, 3)).contiguous()
    q_inds = fps.fps(pre_xyz, 128)
    require(torch.equal(q_inds, fps.fps_plain(pre_xyz, 128)), "fps 2048->128 differs from plain")
    ms = cuda_ms(lambda: fps.fps(xyz, 2048), 5) + cuda_ms(lambda: fps.fps(pre_xyz, 128), 20)
    plain = cuda_ms(lambda: fps.fps_plain(xyz, 2048), 2) + cuda_ms(lambda: fps.fps_plain(pre_xyz, 128), 3)
    nbytes = B * N * 12 + B * 2048 * 8 + B * 2048 * 12 + B * 128 * 8
    ops = 10 * B * (2047 * N + 127 * 2048)  # 3 sub, 3 mul, 2 add, min, compare per point-step
    b_ms, b_by = bound_ms(nbytes, ops, F32_PEAK)
    print(f"fps: indices equal (8x20000->2048, 8x2048->128); kernel {ms:.3f} ms, "
          f"plain {plain:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    entries["fps"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None,
                          work="one request: 8x20000->2048 + 8x2048->128")

    # ball-group: 8 x 20000 points, 2048 centers, K = 64, r = 0.2; C = 0 and C = 3
    K, radius = 64, 0.2
    out = ball_group.ball_group(xyz, None, pre_xyz, radius, K)
    err = (out - ball_group.ball_group_plain(xyz, None, pre_xyz, radius, K)).abs().max().item()
    require(err == 0.0, f"ball_group C=0 differs from plain by {err}")
    feats = torch.randn(B, N, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    out3 = ball_group.ball_group(xyz, feats, pre_xyz, radius, K)
    err3 = (out3 - ball_group.ball_group_plain(xyz, feats, pre_xyz, radius, K)).abs().max().item()
    require(err3 == 0.0, f"ball_group C=3 differs from plain by {err3}")
    ms = cuda_ms(lambda: ball_group.ball_group(xyz, None, pre_xyz, radius, K), 10)
    plain = cuda_ms(lambda: ball_group.ball_group_plain(xyz, None, pre_xyz, radius, K), 3)
    pick, has = ball_group.bucket_picks(xyz, pre_xyz, radius, K)
    Nb = -(-N // K)
    bucket_len = torch.clamp(N - torch.arange(K, device=dev) * Nb, 0, Nb)
    scanned = torch.where(has, pick - torch.arange(K, device=dev) * Nb + 1, bucket_len)
    ops = 9 * scanned.sum().item()  # 3 sub, 3 mul, 2 add, compare per point tested
    nbytes = B * N * 12 + B * 2048 * 12 + out.numel() * 4
    b_ms, b_by = bound_ms(nbytes, ops, F32_PEAK)
    print(f"ball_group: exact (C=0 and C=3); {int(scanned.sum().item())} distance tests "
          f"with early exit; kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    entries["ball_group"] = dict(max_abs_err=max(err, err3), ms=ms, plain_ms=plain,
                                 bound_ms=b_ms, bound_by=b_by, library_ms=None,
                                 work="one request: 8x20000, M=2048, K=64, C=0")

    return entries


def reveal_masks(A, seed, rate: float, BH: int, N: int, D: int, dev, radius=None) -> dict:
    """The mask as each bf16 kernel applies it, read back exactly: the
    dropout mask, or with `radius` and no dropout the radius mask.

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
        out, _ = A.attention_fwd(zero, zero, sel, rate, seed, radius)
        seen["attention_fwd"][:, :, cols] = out != 0
        dq = A.attention_dq(zero, sel, ones, ones, lse, no_delta, rate, seed, radius)
        seen["attention_dq"][:, :, cols] = dq != 0
        _, dv = A.attention_dkv(zero, zero, zero, sel, lse, no_delta, rate, seed, radius)
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
    seen = reveal_masks(A, seed, rate, BH, N, D, dev)
    for name, mask in seen.items():
        flips = int((mask != kept).sum())
        require(flips == 0, f"{name}: the dropout mask differs from the hash at {flips} positions")
    print(f"attention dropout p={rate}: the masks of the forward, dq and dk/dv kernels equal "
          f"the hash at all {kept.numel()} positions (kept share {kept.float().mean().item():.4f})")
    del kept, seen

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
              f"lse {e_lse:.2e} (abs), dq {e_dq:.2e}, dk/dv {e_dkv:.2e}; f32 variants "
              f"{max(e32):.2e}")

    out, lse = A.attention_fwd(qb, kb, vb, rate, seed)
    delta = (dob.float() * out.float()).sum(-1, keepdim=True)
    times = {
        "attention_fwd": (lambda: A.attention_fwd(qb, kb, vb, rate, seed),
                          lambda: A.attention_fwd_plain(qb, kb, vb, rate, seed)),
        "attention_dq": (lambda: A.attention_dq(qb, kb, vb, dob, lse, delta, rate, seed),
                         lambda: A.attention_dq_plain(qb, kb, vb, dob, lse, delta, rate, seed)),
        "attention_dkv": (lambda: A.attention_dkv(qb, kb, vb, dob, lse, delta, rate, seed),
                          lambda: A.attention_dkv_plain(qb, kb, vb, dob, lse, delta, rate, seed)),
    }
    no_drop = {
        "attention_fwd": cuda_ms(lambda: A.attention_fwd(qb, kb, vb), 20),
        "attention_dq": cuda_ms(lambda: A.attention_dq(qb, kb, vb, dob, lse, delta), 20),
        "attention_dkv": cuda_ms(lambda: A.attention_dkv(qb, kb, vb, dob, lse, delta), 20),
    }
    # yardsticks: PyTorch's fused attention without dropout; its backward
    # computes dq, dk and dv in one call
    q4, k4, v4 = (t.view(8, 4, N, D).detach().requires_grad_() for t in (qb, kb, vb))
    library_fwd = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4), 20)
    o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
    g4 = dob.view(8, 4, N, D)
    library_bwd = cuda_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True), 20)
    library = {"attention_fwd": library_fwd, "attention_dq": library_bwd,
               "attention_dkv": library_bwd}
    flops = {"attention_fwd": 4, "attention_dq": 6, "attention_dkv": 8}  # x BH N^2 D
    tensor = BH * N * D * 2  # bytes of one bf16 operand
    nbytes = {"attention_fwd": 4 * tensor + BH * N * 4,  # q, k, v in; out, lse out
              "attention_dq": 5 * tensor + 2 * BH * N * 4,  # q, k, v, dO, lse, delta in; dq out
              "attention_dkv": 6 * tensor + 2 * BH * N * 4}
    entries = {}
    for name, (kernel, plain) in times.items():
        ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 3)
        b_ms, b_by = bound_ms(nbytes[name], flops[name] * BH * N * N * D, BF16_PEAK)
        print(f"{name}: per call with dropout {rate}: kernel {ms:.3f} ms (without dropout "
              f"{no_drop[name]:.3f} ms), plain {plain_ms:.3f} ms, library {library[name]:.3f} ms"
              f"{' (SDPA backward: dq, dk and dv)' if name != 'attention_fwd' else ' (SDPA)'}, "
              f"bound {b_ms:.4f} ms ({b_by})")
        entries[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=library[name], ms_no_dropout=no_drop[name],
                             work=f"one call, BH=32, N=2048, D=64 bf16, dropout {rate}; "
                                  "max_abs_err of bf16 against the plain version in f32")
    return entries


def check_masked_points(batch: dict, dev: torch.device) -> tuple:
    """Phase 7, point kernels of the masked ScanNet config: FPS and the
    ball-group at its shapes against their plain versions, timed, and the
    ball-group's feature gradient (plain PyTorch, the port of an XLA
    backward) on the card against the CPU.  Returns (extras for the fps and
    ball_group entries, the token coordinates at 2048 and 1024 tokens)."""
    from ov3det_torch.ops.kernels import ball_group as BG
    from ov3det_torch.ops.kernels import fps

    xyz = torch.from_numpy(batch["point_clouds"]).to(dev)
    B, N, _ = xyz.shape
    gather = lambda p, i: torch.gather(p, 1, i[..., None].expand(-1, -1, 3)).contiguous()  # noqa: E731
    chain, clouds = [(N, 2048), (2048, 1024), (1024, 256)], [xyz]
    for n, k in chain:
        inds = fps.fps(clouds[-1], k)
        require(torch.equal(inds, fps.fps_plain(clouds[-1], k)), f"fps {n}->{k} differs from plain")
        clouds.append(gather(clouds[-1], inds))
    ms = sum(cuda_ms(lambda c=c, k=k: fps.fps(c, k), 3) for c, (_, k) in zip(clouds, chain))
    plain = sum(cuda_ms(lambda c=c, k=k: fps.fps_plain(c, k), 1) for c, (_, k) in zip(clouds, chain))
    nbytes = sum(B * (n * 12 + k * 8) for n, k in chain)
    ops = 10 * B * sum((k - 1) * n for n, k in chain)
    b_ms, b_by = bound_ms(nbytes, ops, F32_PEAK)
    print(f"fps (masked ScanNet): indices equal (8x40000->2048->1024->256); kernel {ms:.3f} ms "
          f"(40000->2048 alone {cuda_ms(lambda: fps.fps(xyz, 2048), 3):.3f} ms), plain "
          f"{plain:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    fps_extra = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     work="one masked request: 8x40000->2048->1024->256")

    # pre-encoder 8 x 40000, M = 2048, K = 64, r = 0.2, C = 0; interim SA:
    # 2048 tokens, 1024 centers, K = 32, r = 0.4, C = 256
    pre_xyz, mid_xyz = clouds[1], clouds[2]
    out = BG.ball_group(xyz, None, pre_xyz, 0.2, 64)
    err0 = (out - BG.ball_group_plain(xyz, None, pre_xyz, 0.2, 64)).abs().max().item()
    feats = torch.randn(B, 2048, 256, generator=torch.Generator().manual_seed(2)).to(dev)
    out = BG.ball_group(pre_xyz, feats, mid_xyz, 0.4, 32)
    err = (out - BG.ball_group_plain(pre_xyz, feats, mid_xyz, 0.4, 32)).abs().max().item()
    require(err0 == 0.0 and err == 0.0, f"ball_group (masked ScanNet) differs: {err0}, {err}")
    ms_pre = cuda_ms(lambda: BG.ball_group(xyz, None, pre_xyz, 0.2, 64), 5)
    ms = cuda_ms(lambda: BG.ball_group(pre_xyz, feats, mid_xyz, 0.4, 32), 5)
    plain = cuda_ms(lambda: BG.ball_group_plain(pre_xyz, feats, mid_xyz, 0.4, 32), 2)
    pick, has = BG.bucket_picks(pre_xyz, mid_xyz, 0.4, 32)
    scanned = torch.where(has, pick - torch.arange(32, device=dev) * 64 + 1, 64).sum().item()
    nbytes = pre_xyz.numel() * 4 + feats.numel() * 4 + mid_xyz.numel() * 4 + out.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 9 * scanned, F32_PEAK)
    print(f"ball_group (masked ScanNet): exact at 8x40000 M=2048 K=64 C=0 ({ms_pre:.3f} ms) and "
          f"at the interim 8x2048 M=1024 K=32 C=256: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}; output {out.numel() * 4 / 1e6:.1f} MB)")

    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)).to(dev)
    grad = BG.feature_grad(pre_xyz, mid_xyz, 0.4, 32, g, 256)
    want = BG.feature_grad(pre_xyz.cpu(), mid_xyz.cpu(), 0.4, 32, g.cpu(), 256)
    g_err = (grad.cpu() - want).abs().max().item() / want.abs().max().item()
    # the card's index_add_ sums with atomics, in another order than the CPU
    require(g_err <= 1e-5, f"ball_group feature gradient: card vs CPU {g_err} relative")
    g_ms = cuda_ms(lambda: BG.feature_grad(pre_xyz, mid_xyz, 0.4, 32, g, 256), 5)
    print(f"ball_group feature gradient (plain PyTorch on both devices, as XLA in JAX): card vs "
          f"CPU within {g_err:.2e} of the largest value; {g_ms:.3f} ms on the card")
    bg_extra = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    ms_pre_encoder=ms_pre, feature_grad_ms=g_ms,
                    work="one interim SA call: 8x2048, M=1024, K=32, C=256")
    return {"fps": fps_extra, "ball_group": bg_extra}, pre_xyz, mid_xyz


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
    tot = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, ms_no_dropout=0.0,
                   max_abs_err=0.0, bound_time={"bytes": 0.0, "operations": 0.0}) for n in names}
    for xyz, r in ((pre_xyz, 0.4 ** 2), (mid_xyz, 0.8 ** 2), (mid_xyz, 1.2 ** 2)):
        B, N, _ = xyz.shape
        BH, r2 = B * H, r * r
        radius = (xyz, xyz, r2)
        inside = A.radius_mask(xyz, xyz, r2)
        share = inside.float().mean().item()
        want = inside.repeat_interleave(H, dim=0)
        for name, mask in reveal_masks(A, None, 0.0, BH, N, D, dev, radius).items():
            flips = int((mask != want).sum())
            require(flips == 0, f"{name} radius N={N} r2={r2:.4f}: the mask differs at {flips} positions")
        del want

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
        print(f"attention radius N={N} r2={r2:.4f}: in-radius share {share:.4f}; the masks of the "
              f"forward, dq and dk/dv kernels equal the plain version's at all {BH * N * N} "
              f"positions; bf16 error over the largest plain value {max(worst.values()):.2e}, "
              f"lse {e_lse:.2e}; f32 {e32:.2e}")

        out, lse = A.attention_fwd(qb, kb, vb, rate, seed, radius)
        delta = (dob.float() * out.float()).sum(-1, keepdim=True)
        calls = {
            "attention_fwd": (lambda: A.attention_fwd(qb, kb, vb, rate, seed, radius),
                              lambda: A.attention_fwd_plain(qb, kb, vb, rate, seed, radius),
                              lambda: A.attention_fwd(qb, kb, vb, 0.0, None, radius)),
            "attention_dq": (lambda: A.attention_dq(qb, kb, vb, dob, lse, delta, rate, seed, radius),
                             lambda: A.attention_dq_plain(qb, kb, vb, dob, lse, delta, rate, seed,
                                                          radius),
                             lambda: A.attention_dq(qb, kb, vb, dob, lse, delta, 0.0, None, radius)),
            "attention_dkv": (lambda: A.attention_dkv(qb, kb, vb, dob, lse, delta, rate, seed,
                                                      radius),
                              lambda: A.attention_dkv_plain(qb, kb, vb, dob, lse, delta, rate, seed,
                                                            radius),
                              lambda: A.attention_dkv(qb, kb, vb, dob, lse, delta, 0.0, None,
                                                      radius)),
        }
        # yardstick: PyTorch's fused attention with the (B, 1, N, N) boolean
        # mask, no dropout; its backward computes dq, dk and dv in one call
        q4, k4, v4 = (t.view(B, H, N, D).detach().requires_grad_() for t in (qb, kb, vb))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        mask4 = inside[:, None]
        lib_fwd = cuda_ms(lambda: sdpa(q4, k4, v4, attn_mask=mask4), 10)
        o4 = sdpa(q4, k4, v4, attn_mask=mask4)
        g4 = dob.view(B, H, N, D)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True), 10)
        del o4
        pairs_in = inside.sum().item() * H  # (bh, q, k) pairs inside the radius
        tensor = BH * N * D * 2
        nbytes = {"attention_fwd": 4 * tensor + BH * N * 4,
                  "attention_dq": 5 * tensor + 2 * BH * N * 4,
                  "attention_dkv": 6 * tensor + 2 * BH * N * 4}
        for n, (kernel, plain, no_drop) in calls.items():
            ms, plain_ms, nd_ms = cuda_ms(kernel, 10), cuda_ms(plain, 2), cuda_ms(no_drop, 10)
            # what this data needs: the products of the in-radius pairs (bf16)
            # and the distance test of every (b, q, k) pair (9 f32 operations)
            t_bytes = (nbytes[n] + 2 * B * N * 12) / HBM_BYTES_PER_S * 1e3
            t_ops = (flops[n] * pairs_in * D / BF16_PEAK + 9 * B * N * N / F32_PEAK) * 1e3
            lib = lib_fwd if n == "attention_fwd" else lib_bwd
            print(f"{n}_radius N={N} r2={r2:.4f}: kernel {ms:.3f} ms with dropout {rate} "
                  f"({nd_ms:.3f} ms without), plain {plain_ms:.3f} ms, library {lib:.3f} ms "
                  f"(SDPA with the boolean mask{', backward: dq, dk and dv' if n != 'attention_fwd' else ''})"
                  f", bound {max(t_bytes, t_ops):.4f} ms "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'})")
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("ms_no_dropout", nd_ms),
                             ("library_ms", lib), ("bound_ms", max(t_bytes, t_ops))):
                tot[n][key] += val
            tot[n]["bound_time"]["bytes"] += t_bytes
            tot[n]["bound_time"]["operations"] += t_ops
        del q4, k4, v4, mask4, inside
    entries = {}
    for n in names:
        e = tot[n]
        bt = e.pop("bound_time")
        entries[f"{n}_radius"] = dict(
            e, bound_by=max(bt, key=bt.get),
            work="one masked training step: N=2048 r2=0.0256 + N=1024 r2=0.4096 + N=1024 "
                 "r2=2.0736, BH=32, D=64 bf16, dropout 0.3; library: SDPA with the boolean "
                 "mask, no dropout; max_abs_err of bf16 against the plain version in f32")
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


def profile(title: str, fn) -> None:
    """Run `fn` once under torch.profiler; print the wall time, the device
    busy time (kernels only), the kernel count, the idle share and the top
    kernels and ops by device time."""
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
    rows = [e for e in prof.key_averages() if device_us(e) > 0]
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
    own = [e for e in kernels if any(k in e.key for k in
                                     ("fps_kernel", "pick_kernel", "fill_kernel", "attn_"))]
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


def train(cfg, steps: int, per_step: dict, label: str, seed: int, dev: torch.device) -> dict:
    """Phases 5 and 7: training steps at full width on the card; returns the
    launch counts of the timed steps."""
    from ov3det_torch.engine.train import batch_to_device, build_training

    training = build_training(cfg, ITERS_PER_EPOCH, device=dev, seed=0)
    step = training.train_step
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [batch_to_device(b, dev) for b in synthetic_batches(cfg, steps + 1, seed)]

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
        require(len(metrics) == 8 * 7 + 2, f"{label} train step {i}: {len(metrics)} metrics")
        print(f"{label} train step {i}: {ms:.2f} ms, loss {loss:.4f}, grad_norm {gnorm:.4f}, "
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
    profile(f"profiled {label} train step", lambda: step(batches[2], gen))
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
        for line in ptxas_summary(log):
            print(f"  {name}: {line}")

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
        entries[name]["scannet_masked"] = extra
    entries.update(check_radius_attention(pre_xyz, mid_xyz, dev))
    del pre_xyz, mid_xyz
    m_served = serve(masked, m_batches, expect(fps=3, ball_group=2, attention_fwd_radius=3),
                     "scannet_masked", dev)
    m_trained = train(masked, MASKED_TRAIN_STEPS,
                      expect(fps=3, ball_group=2, attention_fwd_radius=3, attention_dq_radius=3,
                             attention_dkv_radius=3), "scannet_masked", 400, dev)
    train_card_vs_cpu(masked, "scannet_masked", 400)

    kernels = []
    for name, (source, replaces) in kernel_sources().items():
        count = sum(c[name] for c in (served, trained, m_served, m_trained))
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
