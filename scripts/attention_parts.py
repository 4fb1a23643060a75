#!/usr/bin/env python3
"""Where the time of the wgmma attention kernels goes, on one NVIDIA GPU.

    python3 scripts/attention_parts.py

Times `attn_fwd_wgmma` (csrc/attention_fwd.cu), `attn_dkv_wgmma` and
`attn_dq_wgmma` (csrc/attention_bwd.cu) at BH = 32, N = 2048, D = 64, bf16,
without dropout or radius, as they are and with parts taken out: the tile
loads after the first stages, the first products (S; S^T and dP^T; S and
dP), the second products (P V; dV and dK; dQ), the elementwise work between
them.  A variant
computes nothing meaningful; its time says what the part that is left costs
when it runs alone, and how much of it the whole kernel hides.

The variants are made here, from the kernels' text in the checkout: each
cut is a textual replacement that must match exactly once, guarded by a
macro, and every variant is the same file compiled with other -D flags
(one nvcc each, all at once) into `ov3det_torch/_build/parts/`.  The kernel
as it is ("whole") is checked against the plain version before it is timed.
Prints one line per variant and a JSON object last.
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
from ov3det_torch.ops.kernels import attention as A  # noqa: E402

BH, N, D, REPS = 32, 2048, 64, 30
OUT_DIR = _build.BUILD_DIR / "parts"


def cut(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"expected exactly one match of:\n{old}")
    return text.replace(old, new)


def between(text: str, start: str, end: str) -> str:
    return text[text.index(start):text.index(end)]


NO_LOAD = ("    if (t < ntiles) {\n      const uint32_t stage",
           "#ifdef NO_LOAD\n    if (t < kStages) {\n#else\n    if (t < ntiles) {\n#endif\n"
           "      const uint32_t stage")


def forward_source() -> str:
    text = (_build.CSRC_DIR / "attention_fwd.cu").read_text()
    k = between(text, "template <bool RADIUS>\n__global__ void __launch_bounds__(hopper::kCtaThreads, RADIUS",
                "constexpr int BKF = 32;")
    k = cut(k, *NO_LOAD)
    first = ("    wgmma_fence();\n    tile_times_tile_t(s, q_desc, tile_desc(stage));\n"
             "    wgmma_commit();\n    wgmma_wait();\n    fence_regs(s);\n")
    k = cut(k, first, "#ifdef NO_FIRST\n    for (int n = 0; n < 8; ++n)\n      for (int i = 0; i < 4; ++i) "
            "s[n][i] = 0.01f * (n + i + kt);\n#else\n" + first + "#endif\n")
    second = ("    wgmma_fence();\n    frags_times_tile(o, pa, tile_desc(stage + kLoopTileBytes));\n"
              "    wgmma_commit();\n    wgmma_wait();\n    fence_regs(o);\n")
    k = cut(k, second, "#ifdef NO_SECOND\n    for (int n = 0; n < 8; ++n)\n      for (int i = 0; i < 4; ++i) "
            "o[n][i] += __uint_as_float(pa[n & 3][i]);\n#else\n" + second + "#endif\n")
    k = cut(k, "    float t0 = -INFINITY, t1 = -INFINITY;\n", "#ifndef NO_ELEMENTWISE\n    float t0 = -INFINITY, t1 = -INFINITY;\n")
    k = cut(k, "    uint32_t pa[4][4];\n", "#endif\n    uint32_t pa[4][4];\n")
    return ('#include "attention_hopper.cuh"\n#include <cmath>\nusing namespace ov3;\n' + k + '''
extern "C" int run(const void* q, const void* k, const void* v, const void*, const float*,
                   const float*, int BH, int NQ, int NK, float scale, void* out, void* lse) {
  cudaFuncSetAttribute(attn_fwd_wgmma<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       hopper::kFwdSmemBytes);
  attn_fwd_wgmma<false><<<dim3(NQ / hopper::kCtaRows, BH), hopper::kCtaThreads,
                          hopper::kFwdSmemBytes>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), NQ, NK, scale, Dropout{nullptr, 1.0f, 0u, 0},
      Radius{nullptr, nullptr, 0.0f, 1}, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse));
  return cudaGetLastError();
}
''')


def dkv_source() -> str:
    text = (_build.CSRC_DIR / "attention_bwd.cu").read_text()
    k = between(text, "template <bool RADIUS>\n__global__ void __launch_bounds__(hopper::kCtaThreads, 1)",
                DQ_START)
    k = cut(k, *NO_LOAD)
    first = ("    wgmma_fence();\n    tile_times_tile_t(st, k_desc, q_desc);\n"
             "    tile_times_tile_t(dpt, v_desc, do_desc);\n    wgmma_commit();\n    wgmma_wait();\n"
             "    fence_regs(st);\n    fence_regs(dpt);\n")
    k = cut(k, first, "#ifdef NO_FIRST\n    for (int n = 0; n < 8; ++n)\n      for (int i = 0; i < 4; ++i) {\n"
            "        st[n][i] = 0.01f * (n + i + qt);\n        dpt[n][i] = 0.02f * (n - i + qt);\n      }\n"
            "#else\n" + first + "#endif\n")
    second = ("    wgmma_fence();\n    frags_times_tile(dva, pa, do_desc);  // dv += a^T dO\n"
              "    frags_times_tile(dka, dsa, q_desc);  // dk += ds^T Q\n    wgmma_commit();\n"
              "    wgmma_wait();\n    fence_regs(dva);\n    fence_regs(dka);\n")
    k = cut(k, second, "#ifdef NO_SECOND\n    for (int n = 0; n < 8; ++n)\n      for (int i = 0; i < 4; ++i) {\n"
            "        dva[n][i] += __uint_as_float(pa[n & 3][i]);\n"
            "        dka[n][i] += __uint_as_float(dsa[n & 3][i]);\n      }\n#else\n" + second + "#endif\n")
    k = cut(k, "    const int cur = qt & 1;\n", "#ifndef NO_ELEMENTWISE\n    const int cur = qt & 1;\n")
    k = cut(k, "    uint32_t pa[4][4], dsa[4][4];\n", "#endif\n    uint32_t pa[4][4], dsa[4][4];\n")
    return ('#include "attention_hopper.cuh"\n#include <cmath>\nusing namespace ov3;\n' + k + '''
extern "C" int run(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, int BH, int NQ, int NK, float scale, void* dk, void* dv) {
  cudaFuncSetAttribute(attn_dkv_wgmma<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       hopper::kDkvSmemBytes);
  attn_dkv_wgmma<false><<<dim3(NK / hopper::kCtaRows, BH), hopper::kCtaThreads,
                          hopper::kDkvSmemBytes>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      NQ, NK, scale, Dropout{nullptr, 1.0f, 0u, 0}, Radius{nullptr, nullptr, 0.0f, 1},
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv));
  return cudaGetLastError();
}
''')


DQ_START = "// ------------------------------------------- bf16 dq, D = 64: wgmma design\n"


def dq_source() -> str:
    text = (_build.CSRC_DIR / "attention_bwd.cu").read_text()
    k = between(text, DQ_START,
                "// ------------------------------------------------------------------ f32\n")
    k = cut(k, *NO_LOAD)
    first = ("    wgmma_fence();\n    tile_times_tile_t(s, q_desc, k_desc);\n"
             "    tile_times_tile_t(dp, do_desc, v_desc);\n    wgmma_commit();\n    wgmma_wait();\n"
             "    fence_regs(s);\n    fence_regs(dp);\n")
    k = cut(k, first, "#ifdef NO_FIRST\n    for (int n = 0; n < 8; ++n)\n      for (int i = 0; i < 4; ++i) {\n"
            "        s[n][i] = 0.01f * (n + i + kt);\n        dp[n][i] = 0.02f * (n - i + kt);\n      }\n"
            "#else\n" + first + "#endif\n")
    second = ("    wgmma_fence();\n    frags_times_tile(acc, dsa, k_desc);  // dq += ds K: the same K tile, "
              "read MN-major\n    wgmma_commit();\n    wgmma_wait();\n    fence_regs(acc);\n")
    k = cut(k, second, "#ifdef NO_SECOND\n    for (int n = 0; n < 8; ++n)\n      for (int i = 0; i < 4; ++i) "
            "acc[n][i] += __uint_as_float(dsa[n & 3][i]);\n#else\n" + second + "#endif\n")
    loop = "#pragma unroll\n    for (int n = 0; n < 8; ++n) {\n      float4 kp0 = "
    k = cut(k, loop, "#ifndef NO_ELEMENTWISE\n" + loop)
    k = cut(k, "    uint32_t dsa[4][4];\n", "#endif\n    uint32_t dsa[4][4];\n")
    return ('#include "attention_hopper.cuh"\n#include <cmath>\nusing namespace ov3;\n' + k + '''
extern "C" int run(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, int BH, int NQ, int NK, float scale, void* dq, void*) {
  cudaFuncSetAttribute(attn_dq_wgmma<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       hopper::kDqSmemBytes);
  attn_dq_wgmma<false><<<dim3(NQ / hopper::kDqRows, BH), hopper::kDqThreads,
                         hopper::kDqSmemBytes>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      NQ, NK, scale, Dropout{nullptr, 1.0f, 0u, 0}, Radius{nullptr, nullptr, 0.0f, 1},
      static_cast<__nv_bfloat16*>(dq));
  return cudaGetLastError();
}
''')


VARIANTS = {  # name -> macros that take parts out
    "whole": (),
    "without the tile loads": ("NO_LOAD",),
    "products alone (no elementwise, no loads)": ("NO_ELEMENTWISE", "NO_LOAD"),
    "first products alone": ("NO_ELEMENTWISE", "NO_LOAD", "NO_SECOND"),
    "second products alone": ("NO_ELEMENTWISE", "NO_LOAD", "NO_FIRST"),
    "elementwise alone (no products, no loads)": ("NO_FIRST", "NO_SECOND", "NO_LOAD"),
    "elementwise and loads (no products)": ("NO_FIRST", "NO_SECOND"),
}


def cuda_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_parts: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(f"card: {res.stdout.strip().splitlines()[0]}")
    jobs = {}
    for kernel, source in (("attn_fwd_wgmma", forward_source()), ("attn_dkv_wgmma", dkv_source()),
                           ("attn_dq_wgmma", dq_source())):
        src = OUT_DIR / f"{kernel}.cu"
        src.write_text(source)
        for name, macros in VARIANTS.items():
            lib = OUT_DIR / f"{kernel}-{'-'.join(macros) or 'whole'}.so"
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}",
                   *(f"-D{m}" for m in macros), "-o", str(lib), str(src)]
            jobs[kernel, name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True))
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(BH, N, D, generator=g).to(dev).bfloat16() for _ in range(4))
    ref_out, lse = A.attention_fwd_plain(q, k, v)
    delta = (do.float() * ref_out.float()).sum(-1, keepdim=True)
    ref_dk, ref_dv = A.attention_dkv_plain(q, k, v, do, lse, delta)
    ref_dq = A.attention_dq_plain(q, k, v, do, lse, delta)
    outs = [torch.empty_like(q), torch.empty_like(q)]
    lse_out = torch.empty_like(lse)
    rel = lambda a, b: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()  # noqa: E731
    results = {}
    for (kernel, name), (lib_path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel}, {name}:\n{log}")
        regs = [line.split("Used ")[1].split(",")[0] for line in log.splitlines() if "Used " in line][-1]
        lib = ctypes.CDLL(str(lib_path))
        lib.run.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 2
        tail = ([outs[0].data_ptr(), lse_out.data_ptr()] if kernel == "attn_fwd_wgmma"
                else [outs[0].data_ptr(), outs[1].data_ptr()])
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), BH, N, N, A._scale(D), *tail]

        def run():
            status = lib.run(*args)
            if status != 0:
                raise RuntimeError(f"{kernel}, {name}: CUDA error {status}")

        run()
        torch.cuda.synchronize()
        if name == "whole":
            err = {"attn_fwd_wgmma": lambda: rel(outs[0], ref_out),
                   "attn_dq_wgmma": lambda: rel(outs[0], ref_dq),
                   "attn_dkv_wgmma": lambda: max(rel(outs[0], ref_dk), rel(outs[1], ref_dv))}[kernel]()
            if err > 2e-2:
                raise AssertionError(f"{kernel} differs from the plain version by {err}")
        ms = min(cuda_ms(run, REPS) for _ in range(3))
        results[f"{kernel}: {name}"] = ms
        print(f"{kernel}: {name}: {ms:.4f} ms ({regs})")
    print(json.dumps({"BH": BH, "N": N, "D": D, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
