#!/usr/bin/env python3
"""Where the time of the trunk's quantise pass goes, on one NVIDIA GPU.

    python3 scripts/pool_quantize_parts.py

Times the first design of the pass (`pool_quantize_kernel<T, POOL>` of
`ov3det_torch/csrc/quant_conv.cu`: 8 channels a thread, 64-bit flat
indices, IEEE divisions in the pool and the quantise) at the 9 shapes of
one int8 RN50x4 teacher forward (bf16, 18 calls), as it is and with parts
changed: 32-bit indices; no division (the pool by x 0.25, the quantise by
the scale's reciprocal, which is not exact: timing only); both; and the
loads and stores alone (no pool arithmetic, no quantise).  Beside them the
redesign (`pool_quantize_vec`) as routed, with cached loads in place of
streaming ones, with its exact quantise dividing the whole flagged piece
inline (the compiler then runs the divisions for every piece, and a zero
takes __fdiv_rn's slow path) and with a grid of at most 8 CTAs an SM in
place of one wave.  Each on seeded normal data and on the same through a
ReLU, writing into one output buffer and into a new one each call.  A
variant's time beside the whole kernel's says what the part changed costs.

The variants are made here, from the kernel's text in the checkout: the
part of quant_conv.cu before the wgmma design, each change a textual
replacement inside the pass's kernel that must match exactly once, guarded
by a macro; one nvcc a variant, all at once, into
`ov3det_torch/_build/parts/`; the redesign's variants are the whole file,
each with one cut.  Both designs as they are are checked against the
plain version at every shape before anything is timed.  Prints one line per shape
and variant, the sums over a forward beside the bound, and a JSON object
last.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from ov3det_torch.ops.kernels import _build  # noqa: E402
from ov3det_torch.ops.kernels import quant_conv as qc  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "parts"
REPS = 5  # calls a timing graph, as chip_smoke times the pass
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

# the passes of one int8 RN50x4 teacher forward on 8 canvases of 530 x 730
# and 1024 regions (res5 in 4 chunks of 256): (B, H, W, C, pool, scales, calls)
TEACHER_PASSES = [
    (8, 265, 365, 40, 1, 1, 1), (8, 265, 365, 80, 2, 2, 1), (8, 132, 182, 160, 2, 1, 1),
    (8, 132, 182, 320, 2, 1, 1), (8, 66, 91, 320, 2, 1, 1), (8, 66, 91, 640, 2, 1, 1),
    (256, 18, 18, 1280, 1, 1, 4), (256, 18, 18, 640, 2, 1, 4), (256, 18, 18, 1280, 2, 1, 4),
]

VARIANTS = {
    "whole": (),
    "32-bit indices": ("IDX32",),
    "no division": ("NO_DIV",),
    "32-bit indices, no division": ("IDX32", "NO_DIV"),
    "loads and stores alone": ("RAW",),
}


def cut(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"expected exactly one match of:\n{old}")
    return text.replace(old, new)


def source() -> str:
    text = (_build.CSRC_DIR / "quant_conv.cu").read_text()
    head = text[:text.index("// ------------------------------------------------------------ the wgmma design")]
    start = head.index("template <typename T, int POOL>\n__global__ void __launch_bounds__(kPoolThreads)\n"
                       "pool_quantize_kernel(")
    end = head.index("\n}\n", start) + 3
    k = head[start:end].replace("int64_t", "IDX")
    k = cut(k, "  const float b = q1 != nullptr ? *s1 : 1.f;\n",
            "  const float b = q1 != nullptr ? *s1 : 1.f;\n"
            "  const float ra = __frcp_rn(a), rb = __frcp_rn(b);\n")
    k = cut(k, "Io<T>::round(__fdiv_rn(v[j], float(POOL * POOL)))",
            "Io<T>::round(POOL_DIV(v[j], float(POOL * POOL)))")
    k = cut(k, "    store_q8(q0 + pix * C + g * 8, v, a);\n"
               "    if (q1 != nullptr) store_q8(q1 + pix * C + g * 8, v, b);\n",
            "#if defined(RAW)\n"
            "    store_raw8(q0 + pix * C + g * 8, v);\n"
            "    if (q1 != nullptr) store_raw8(q1 + pix * C + g * 8, v);\n"
            "#elif defined(NO_DIV)\n"
            "    store_q8_mul(q0 + pix * C + g * 8, v, ra);\n"
            "    if (q1 != nullptr) store_q8_mul(q1 + pix * C + g * 8, v, rb);\n"
            "#else\n"
            "    store_q8(q0 + pix * C + g * 8, v, a);\n"
            "    if (q1 != nullptr) store_q8(q1 + pix * C + g * 8, v, b);\n"
            "#endif\n")
    helpers = r'''
#ifdef IDX32
#define IDX int
#else
#define IDX int64_t
#endif
#if defined(NO_DIV) || defined(RAW)
#define POOL_DIV(v, n) __fmul_rn(v, 1.0f / (n))
#else
#define POOL_DIV(v, n) __fdiv_rn(v, n)
#endif
// the quantise by the reciprocal, with no exact redo (timing only)
__device__ __forceinline__ void store_q8_mul(int8_t* q, const float (&v)[8], float rs) {
  alignas(8) int8_t c[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    c[e] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(v[e], rs)), -127.f), 127.f)));
  *reinterpret_cast<uint2*>(q) = *reinterpret_cast<const uint2*>(c);
}
// the values' low bits, no arithmetic (timing only)
__device__ __forceinline__ void store_raw8(int8_t* q, const float (&v)[8]) {
  alignas(8) int8_t c[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) c[e] = static_cast<int8_t>(__float_as_uint(v[e]));
  *reinterpret_cast<uint2*>(q) = *reinterpret_cast<const uint2*>(c);
}
'''
    tail = r'''
}  // namespace

extern "C" int run(const void* x, int B, int H, int W, int C, int pool, const float* s0,
                   const float* s1, int8_t* q0, int8_t* q1, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(B) * (H / pool) * (W / pool) * (C / 8);
  const int64_t want = (total + kPoolThreads - 1) / kPoolThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (pool == 1) {
    pool_quantize_kernel<__nv_bfloat16, 1><<<blocks, kPoolThreads, 0, stream>>>(xb, B, H, W, C,
                                                                                 s0, s1, q0, q1);
  } else {
    pool_quantize_kernel<__nv_bfloat16, 2><<<blocks, kPoolThreads, 0, stream>>>(xb, B, H, W, C,
                                                                                 s0, s1, q0, q1);
  }
  return cudaGetLastError();
}
'''
    return head[:start] + helpers + k + tail


def build() -> dict:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "pool_quantize.cu"
    src.write_text(source())
    jobs = {}
    for name, macros in VARIANTS.items():
        lib = OUT_DIR / f"pool_quantize-{'-'.join(macros) or 'whole'}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}",
               *(f"-D{m}" for m in macros), "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        handle.run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
        handle.run.restype = ctypes.c_int
        libs[name] = handle
    return libs


def graph_ms(fn, reps: int) -> float:
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


VEC_VARIANTS = {  # the redesign's variants: name -> (text in quant_conv.cu, its replacement)
    "redesign": None,
    "redesign, cached loads": ("__ldcs(reinterpret_cast<const uint4*>(p) + c)",
                               "__ldg(reinterpret_cast<const uint4*>(p) + c)"),
    "redesign, the exact quantise of whole pieces, inline": (
        "raw[h] = codes_q8_exact(e, s, near, raw[h]);", "raw[h] = codes_q8(v[h], s);"),
    "redesign, at most 8 CTAs an SM": ("static_cast<uint32_t>(pass_sms[dev]) * per_sm[dev];",
                                       "static_cast<uint32_t>(pass_sms[dev]) * 8u;"),
}


def build_redesign() -> dict:
    """name -> the redesign's library (the whole of quant_conv.cu, each
    variant one cut), all compiled at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC_DIR / "quant_conv.cu").read_text()
    jobs = {}
    for i, (name, change) in enumerate(VEC_VARIANTS.items()):
        src = OUT_DIR / f"pool_quantize_vec{i}.cu"
        src.write_text(cut(text, *change) if change else text)
        lib = OUT_DIR / f"pool_quantize_vec{i}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}", "-o", str(lib),
               str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        handle.ov3_pool_quantize.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6
                                             + [ctypes.c_void_p] * 5)
        handle.ov3_pool_quantize.restype = ctypes.c_int
        libs[name] = handle
    return libs


def main() -> int:
    """Both designs at the 9 shapes, on two kinds of data (seeded normal
    values; the same through a ReLU, half of them zero, as the trunk's
    activations are) and two ways of writing (into one output buffer reused
    by every call; into a new one each call, as the wrapper allocates)."""
    if not torch.cuda.is_available():
        print("pool_quantize_parts: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = res.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    libs = {**build(), **build_redesign()}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    sums, bound = {}, 0.0
    for data in ("normal", "relu"):
        for B, H, W, C, pool, n_scales, calls in TEACHER_PASSES:
            x = torch.randn((B, H, W, C), generator=g, device=dev) * 2
            x = (torch.relu(x) if data == "relu" else x).to(torch.bfloat16)
            scales = [torch.tensor(0.02 * (i + 1), device=dev) for i in range(n_scales)]
            shape = (B, H // pool, W // pool, C)
            kept = [torch.empty(shape, dtype=torch.int8, device=dev) for _ in scales]

            def call(name, fresh):
                lib = libs[name]
                outs = [torch.empty(shape, dtype=torch.int8, device=dev) for _ in scales] \
                    if fresh else kept
                fn = lib.run if name in VARIANTS else lib.ov3_pool_quantize
                args = [x.data_ptr(), B, H, W, C, pool] + ([] if name in VARIANTS else [0])
                status = fn(*args, scales[0].data_ptr(),
                            scales[1].data_ptr() if n_scales > 1 else None, outs[0].data_ptr(),
                            outs[1].data_ptr() if n_scales > 1 else None,
                            torch.cuda.current_stream().cuda_stream)
                if status != 0:
                    raise RuntimeError(f"pool_quantize parts: CUDA error {status}")
                return outs

            want = qc.pool_quantize_plain(x, pool, scales)
            for name in ("whole", "redesign"):
                got = call(name, False)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"pool_quantize parts: {name} differs from the plain "
                                         f"version at {(B, H, W, C)} pool {pool}")
            if data == "normal":
                nbytes = x.numel() * 2 + n_scales * x.numel() // (pool * pool)
                bound += calls * nbytes / HBM_BYTES_PER_S * 1e3
            for fresh in (False, True):
                ms = {name: [] for name in libs}
                for order in (list(libs), list(libs)[::-1]):
                    for name in order:
                        ms[name].append(graph_ms(lambda: call(name, fresh), REPS))
                best = {name: min(v) for name, v in ms.items()}
                writes = "new outputs" if fresh else "one output"
                for name, v in best.items():
                    key = f"{data}, {writes}: {name}"
                    sums[key] = sums.get(key, 0.0) + calls * v
                print(f"pool_quantize parts {B}x{H}x{W}x{C} bf16, pool {pool}, {n_scales} "
                      f"scale(s), {calls} call(s), {data} data, {writes}: "
                      + ", ".join(f"{n} {v:.4f} ms" for n, v in best.items()) + f" ({card})")
            del x, kept, want
    print(f"pool_quantize parts over one teacher forward (18 calls), bound {bound:.3f} ms:")
    for key, v in sums.items():
        print(f"  {key}: {v:.3f} ms ({card})")
    print(json.dumps({"card": card, "sums_ms": sums, "bound_ms": bound}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
