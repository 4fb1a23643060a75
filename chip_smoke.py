#!/usr/bin/env python3
"""On-card check of the PyTorch port (`ov3det_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three CUDA kernels from `ov3det_torch/csrc/` (one nvcc each, all
at once), then:
  1. prints the card's name and power limit, and the build time;
  2. holds each kernel against its plain PyTorch version on the card at the
     shapes the serving path gives it (FPS 8 x 20000 -> 2048 and
     8 x 2048 -> 128, indices equal; ball-group 8 x 20000, M = 2048, K = 64,
     C = 0 and C = 3, exact; attention forward BH = 32, N = 2048, D = 64:
     bf16 output within 2e-2 of the plain version in f32, LSE within 1e-3;
     the f32 variant within 1e-4) and times kernel, plain version and, for
     attention, `F.scaled_dot_product_attention` as a yardstick;
  3. serves 3 requests of 8 synthetic scenes x 20 000 points through
     `Detector` at the full width of `sunrgbd_quick()` (seeded random
     weights): launch counts reset just before, read just after; each
     request must launch FPS twice, the ball-group once, attention 3 times;
  4. runs one scene at f32 on the card and on the CPU (plain versions) with
     the same weights: query indices equal, box corners within 1e-3;
  5. prints the kernels line, the card line, and last
     {"ok": true, "device": {...}}.
Exits non-zero, printing no result, without CUDA or without the package
beside this file.  Any failed check raises.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, NUM_POINTS, REQUESTS = 8, 20000, 3  # sunrgbd_quick's data part
F32_PEAK, BF16_PEAK, HBM_BYTES_PER_S = 67e12, 989e12, 3.35e12  # H100 SXM data sheet


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


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


def check_kernels(batch: dict, dev: torch.device) -> dict:
    """Phase 2: every kernel against its plain version, timed; returns the
    per-kernel entries for one request's work on the serving path."""
    from ov3det_torch.ops.kernels import attention, ball_group, fps

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

    # attention forward: the encoder's BH = 8 x 4 heads, N = 2048, D = 64, 3 layers
    g = torch.Generator().manual_seed(1)
    BH, L, D = 32, 2048, 64
    q, k, v = (torch.randn(BH, L, D, generator=g).to(dev) for _ in range(3))
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    out, lse = attention.attention_fwd(qb, kb, vb)
    ref, ref_lse = attention.attention_fwd_plain(qb.float(), kb.float(), vb.float())
    err = (out.float() - ref).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    require(err <= 2e-2 and lse_err <= 1e-3, f"attention bf16: out err {err}, lse err {lse_err}")
    out32, lse32 = attention.attention_fwd(q, k, v)
    ref32, ref_lse32 = attention.attention_fwd_plain(q, k, v)
    err32 = max((out32 - ref32).abs().max().item(), (lse32 - ref_lse32).abs().max().item())
    require(err32 <= 1e-4, f"attention f32 differs from plain by {err32}")
    ms = cuda_ms(lambda: attention.attention_fwd(qb, kb, vb), 20)
    ms32 = cuda_ms(lambda: attention.attention_fwd(q, k, v), 3)
    plain = cuda_ms(lambda: attention.attention_fwd_plain(qb, kb, vb), 5)
    q4, k4, v4 = (t.view(8, 4, L, D) for t in (qb, kb, vb))
    library = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4), 20)
    ops = 4 * BH * L * L * D
    nbytes = 4 * BH * L * D * 2 + BH * L * 4
    b_ms, b_by = bound_ms(nbytes, ops, BF16_PEAK)
    print(f"attention_fwd: bf16 out err {err:.2e} (vs plain f32), lse err {lse_err:.2e}, "
          f"f32 err {err32:.2e}; per call: kernel {ms:.3f} ms (f32 kernel {ms32:.3f} ms), "
          f"plain {plain:.3f} ms, sdpa {library:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    entries["attention_fwd"] = dict(max_abs_err=err, ms=3 * ms, plain_ms=3 * plain,
                                    bound_ms=3 * b_ms, bound_by=b_by, library_ms=3 * library,
                                    work="one request: 3 calls of BH=32, N=2048, D=64 bf16")
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
        rows.append({"pre_encoder (FPS + ball-group + SA MLP)": marks["pre_encoder"] - t0,
                     "encoder": marks["encoder"] - marks["pre_encoder"],
                     "projection + query FPS + decoder": marks["decoder"] - marks["encoder"],
                     "heads + box decode": t_fwd - marks["decoder"],
                     "parse (empty-box test + NMS)": t_parse - t_fwd,
                     "assemble (host)": t_end - t_parse})
    for h in handles:
        h.remove()
    parts = ", ".join(f"{k} {np.median([r[k] for r in rows]) * 1e3:.2f} ms" for k in rows[0])
    print(f"stages of one request (synchronised, median of {reps}): {parts}")


def serve(batches: list, dev: torch.device) -> dict:
    """Phase 3: the serving path at full width; returns the launch counts."""
    from ov3det_torch.config import sunrgbd_quick
    from ov3det_torch.engine.infer import Detector
    from ov3det_torch.ops.kernels import attention, ball_group, fps

    wrappers = {"fps": fps.fps, "ball_group": ball_group.ball_group,
                "attention_fwd": attention.attention_fwd}
    per_request = {"fps": 2, "ball_group": 1, "attention_fwd": 3}
    det = Detector(sunrgbd_quick(), device=dev, seed=0)
    det.detect(batches[0])  # warm-up: cuBLAS handles, allocator
    for w in wrappers.values():
        w.launches = 0
    for r, batch in enumerate(batches):
        before = {n: w.launches for n, w in wrappers.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = det.detect(batch)
        ms = (time.perf_counter() - t0) * 1e3
        delta = {n: w.launches - before[n] for n, w in wrappers.items()}
        require(delta == per_request, f"request {r}: launches {delta}, expected {per_request}")
        require(len(dets) == BATCH, "one detection list per scene")
        for classes, corners, scores in dets:
            require(corners.shape[1:] == (8, 3) and len(classes) == len(scores) == len(corners),
                    "detection arrays disagree in shape")
            require(np.isfinite(corners).all() and np.isfinite(scores).all(), "non-finite detections")
        print(f"request {r}: {ms:.2f} ms, detections per scene {[len(c) for c, _, _ in dets]}, "
              f"launches {delta}")
    counts = {n: w.launches for n, w in wrappers.items()}
    stage_times(det, batches[-1])

    # one more request under the profiler: device time by kernel and idle share
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        det.detect(batches[-1])
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
        print(f"profiled request: wall {wall_us / 1e3:.2f} ms, device time not measured "
              "(the profiler recorded no device events)")
    else:
        print(f"profiled request: wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
              f"in {sum(e.count for e in kernels)} kernels (idle share "
              f"{1 - busy_us / wall_us:.3f})")
    for title, group in (("kernels", kernels), ("ops, by the device time of their kernels", ops)):
        print(f" {title}:")
        for e in group[:12]:
            print(f"  {device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return counts


def card_vs_cpu(batch: dict) -> None:
    """Phase 4: the same weights at f32 on the card and on the CPU."""
    import dataclasses

    from ov3det_torch.config import sunrgbd_quick
    from ov3det_torch.models.detr3d import Model3DETR

    cfg = dataclasses.replace(sunrgbd_quick(), compute_dtype="float32")
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
    from ov3det_torch.datasets.synthetic import make_batch
    from ov3det_torch.ops.kernels import _build

    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'cached libraries'}")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    batches = [make_batch(np.random.default_rng(100 + r), batch_size=BATCH,
                          num_points=NUM_POINTS, num_semcls=20, num_angle_bin=12)
               for r in range(REQUESTS)]
    dev = torch.device("cuda")
    entries = check_kernels(batches[0], dev)
    counts = serve(batches, dev)
    card_vs_cpu(batches[0])

    from ov3det_torch.ops.kernels import attention, ball_group, fps
    modules = {"fps": fps, "ball_group": ball_group, "attention_fwd": attention}
    kernels = []
    for name, entry in entries.items():
        require(counts[name] > 0, f"{name} was not launched on the serving path")
        kernels.append({"name": name, "route": "cuda", "source": modules[name].SOURCE,
                        "replaces": modules[name].REPLACES, "launches": counts[name], **entry})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
