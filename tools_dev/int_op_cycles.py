#!/usr/bin/env python
"""Cycles that one warp spends on the integer instructions the serial
kernels (audiotools_tpu_torch/csrc/flac_synth.cu, tta_synth.cu,
alac_synth.cu, rice_decode.cu, tta_filter.cu, wv_chain.cu) are built
from, timed with clock64() on a CUDA card.

Each case runs one warp in one block, so it reads what a warp alone on
its scheduler pays, as the synthesis kernels' warps are:

- throughput cases: eight independent chains, an operand changed
  every iteration (an add) so that the compiler cannot hoist the
  product: cycles per instruction pair;
- latency cases: one dependent chain: cycles per link (a link is one
  serial step of a kernel: a sample, or a Rice code).

Prints one JSON line per case and the card's name and power limit.
Needs nvcc (it builds into audiotools_tpu_torch/build/).  Usage:

    python3 tools_dev/int_op_cycles.py
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ int64_t madw(int32_t a, int32_t b, int64_t c) {
  int64_t d;
  asm volatile("mad.wide.s32 %0, %1, %2, %3;"
               : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}
__device__ __forceinline__ uint32_t mad32(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm volatile("mad.lo.u32 %0, %1, %2, %3;"
               : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t add32(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("add.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t sub32(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("sub.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <int KIND>
__global__ void cycles_kernel(int iters, int32_t a, int32_t b,
                              long long* cycles, long long* sink) {
  __shared__ uint32_t words[1024];
  int64_t acc[8];
  uint32_t u[8];
  uint32_t x[8];
  for (int k = 0; k < 8; ++k) {
    acc[k] = threadIdx.x + k;
    u[k] = threadIdx.x * 5 + k;
    x[k] = threadIdx.x * 3 + k;
  }
  for (int k = threadIdx.x; k < 1024; k += 32) {
    words[k] = 0x00400000u >> (k % 9);   // a set bit every word
  }
  __syncwarp();
  const uint64_t buf = 0x0010000000200000ull;
  int32_t v = threadIdx.x;
  int64_t wv = 100 + threadIdx.x;
  int64_t y1 = 3 * threadIdx.x + 1;
  int64_t y2 = threadIdx.x;
  int32_t w32 = 100 + threadIdx.x;
  int32_t y1n = 3 * threadIdx.x + 1;
  int32_t y2n = threadIdx.x;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if constexpr (KIND == 0) {         // IMAD.WIDE + IADD, 8 chains
        acc[k] = madw(static_cast<int32_t>(x[k]), a, acc[k]);
        x[k] = add32(x[k], a);
      } else if constexpr (KIND == 1) {  // IMAD + IADD, 8 chains
        u[k] = mad32(x[k], a, u[k]);
        x[k] = add32(x[k], a);
      } else if constexpr (KIND == 2) {  // IADD, 8 chains
        x[k] = add32(x[k], a);
      } else if constexpr (KIND == 3) {  // SHFL + IADD, one chain
        u[0] = add32(__shfl_xor_sync(0xffffffffu, u[0], 1), 1u);
      } else if constexpr (KIND == 4) {  // flac_synth's step chain
        const int64_t t = madw(a, v, acc[k]);
        v = static_cast<int32_t>(static_cast<uint32_t>(b) +
                                 static_cast<uint32_t>(t >> (a & 15)));
      } else if constexpr (KIND == 5) {  // tta_synth's step chain
        const uint32_t t = mad32(static_cast<uint32_t>(v), x[k], u[k]);
        v = static_cast<int32_t>(
            add32(static_cast<uint32_t>(b),
                  static_cast<uint32_t>(static_cast<int32_t>(t) >> (a & 15))));
      } else if constexpr (KIND == 6) {  // alac_synth's step, narrow sum
        const uint32_t t = mad32(static_cast<uint32_t>(v), x[k], u[k]);
        const uint32_t y = add32(t >> (a & 15), static_cast<uint32_t>(b));
        v = static_cast<int32_t>(add32((y & 0xffffu) ^ 0x8000u, 0xffff8000u));
      } else if constexpr (KIND == 7) {  // alac_synth's step, wide sum
        const int64_t t = madw(static_cast<int32_t>(add32(v, x[k])), a,
                               acc[k]);
        const uint32_t y = add32(static_cast<uint32_t>(t >> (a & 15)),
                                 static_cast<uint32_t>(b));
        v = static_cast<int32_t>(add32((y & 0xffffu) ^ 0x8000u, 0xffff8000u));
      } else if constexpr (KIND == 8) {  // rice_decode's code, in registers
        const int q = __clzll(static_cast<long long>(buf << (v & 31)));
        v = min(v + q + 1 + (a & 7), 1 << 30);
      } else if constexpr (KIND == 9) {  // the same, a shared load a code
        const uint32_t w = static_cast<uint32_t>(v) >> 5;
        const uint64_t win = (static_cast<uint64_t>(words[w & 1023]) << 32) |
                             words[(w + 1) & 1023];
        const int q = __clzll(static_cast<long long>(win << (v & 31)));
        v = min(v + q + 1 + (a & 7), 1 << 30);
      } else if constexpr (KIND == 11) {  // wv_chain's encode step
        const int64_t src = static_cast<int32_t>(x[k]);
        x[k] = add32(x[k], a);
        const int64_t r = static_cast<int64_t>(b) - ((wv * src + 512) >> 10);
        wv += (src == 0 || r == 0) ? 0 : (((src ^ r) >= 0) ? 2 : -2);
      } else if constexpr (KIND == 12) {  // wv_chain's decode step, 18
        const int64_t src = (3 * y1 - y2) >> 1;
        const int64_t in = static_cast<int32_t>(x[k]);
        x[k] = add32(x[k], a);
        const int64_t y = ((wv * src + 512) >> 10) + in;
        wv += (src == 0 || in == 0) ? 0 : (((src ^ in) >= 0) ? 2 : -2);
        y2 = y1;
        y1 = y;
      } else if constexpr (KIND == 13) {  // wv_chain's encode step, narrow
        const int32_t src = static_cast<int32_t>(x[k]);
        x[k] = add32(x[k], a);
        const int64_t r =
            static_cast<int64_t>(b) - (madw(w32, src, 512) >> 10);
        w32 += (src == 0 || r == 0) ? 0 : (((src ^ r) >= 0) ? 2 : -2);
      } else if constexpr (KIND == 14) {  // the decode step of 18, narrow
        const int32_t src = static_cast<int32_t>(
            (3 * static_cast<int64_t>(y1n) - y2n) >> 1);
        const int32_t in = static_cast<int32_t>(x[k]);
        x[k] = add32(x[k], a);
        const int64_t y = (madw(w32, src, 512) >> 10) + in;
        w32 += (src == 0 || in == 0) ? 0 : (((src ^ in) >= 0) ? 2 : -2);
        y2n = y1n;
        y1n = static_cast<int32_t>(y);
      } else if constexpr (KIND == 15) {  // tta_filter's old loop
        // sgn -> the qm update -> the 8-term dot product, a chain of
        // IMADs as the old kernel wrote it -> acc -> shift -> subtract
        const uint32_t sgn = static_cast<uint32_t>(v >> 31) |
                             (sub32(0u, static_cast<uint32_t>(v)) >> 31);
        uint32_t dot = static_cast<uint32_t>(a);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          u[j] = mad32(sgn, x[(j + 1) & 7], u[j]);
          dot = mad32(x[j], u[j], dot);
        }
        const uint32_t t = mad32(sgn, x[k], dot);
        v = static_cast<int32_t>(sub32(
            static_cast<uint32_t>(b),
            static_cast<uint32_t>(static_cast<int32_t>(t) >> (a & 15))));
      } else {                           // tta_filter's step chain
        const uint32_t sgn = static_cast<uint32_t>(v >> 31) |
                             (sub32(0u, static_cast<uint32_t>(v)) >> 31);
        const uint32_t t = mad32(sgn, x[k], u[k]);
        v = static_cast<int32_t>(sub32(
            static_cast<uint32_t>(b),
            static_cast<uint32_t>(static_cast<int32_t>(t) >> (a & 15))));
      }
    }
  }
  const long long t1 = clock64();
  long long s = v + wv + y1 + y2 + w32 + y1n + y2n;
  for (int k = 0; k < 8; ++k) {
    s += acc[k] + u[k] + x[k];
  }
  sink[threadIdx.x] = s;
  if (threadIdx.x == 0) {
    cycles[0] = t1 - t0;
  }
}

extern "C" int run_case(int kind, int iters, int a, int b, long long* cycles,
                        long long* sink) {
  switch (kind) {
    case 0: cycles_kernel<0><<<1, 32>>>(iters, a, b, cycles, sink); break;
    case 1: cycles_kernel<1><<<1, 32>>>(iters, a, b, cycles, sink); break;
    case 2: cycles_kernel<2><<<1, 32>>>(iters, a, b, cycles, sink); break;
    case 3: cycles_kernel<3><<<1, 32>>>(iters, a, b, cycles, sink); break;
    case 4: cycles_kernel<4><<<1, 32>>>(iters, a, b, cycles, sink); break;
    case 5: cycles_kernel<5><<<1, 32>>>(iters, a, b, cycles, sink); break;
    case 6: cycles_kernel<6><<<1, 32>>>(iters, a, b, cycles, sink); break;
    case 7: cycles_kernel<7><<<1, 32>>>(iters, a, b, cycles, sink); break;
    case 8: cycles_kernel<8><<<1, 32>>>(iters, a, b, cycles, sink); break;
    case 9: cycles_kernel<9><<<1, 32>>>(iters, a, b, cycles, sink); break;
    case 10: cycles_kernel<10><<<1, 32>>>(iters, a, b, cycles, sink); break;
    case 11: cycles_kernel<11><<<1, 32>>>(iters, a, b, cycles, sink); break;
    case 12: cycles_kernel<12><<<1, 32>>>(iters, a, b, cycles, sink); break;
    case 13: cycles_kernel<13><<<1, 32>>>(iters, a, b, cycles, sink); break;
    case 14: cycles_kernel<14><<<1, 32>>>(iters, a, b, cycles, sink); break;
    default: cycles_kernel<15><<<1, 32>>>(iters, a, b, cycles, sink); break;
  }
  return static_cast<int>(cudaGetLastError());
}
"""

CASES = (
    ("IMAD.WIDE + IADD, per pair (throughput)", "throughput"),
    ("IMAD + IADD, per pair (throughput)", "throughput"),
    ("IADD (throughput)", "throughput"),
    ("SHFL + IADD, per link (latency)", "latency"),
    ("IMAD.WIDE -> SHF.R.S64 -> IADD, per link (latency)", "latency"),
    ("IMAD -> SHF.R.S32 -> IADD, per link (latency)", "latency"),
    ("alac_synth narrow: IMAD -> SHF.R.U32 -> IADD -> LOP3 -> IADD, per "
     "link (latency)", "latency"),
    ("alac_synth wide: IADD -> IMAD.WIDE -> SHF.R.S64 -> IADD -> LOP3 -> "
     "IADD, per link (latency)", "latency"),
    ("rice_decode code: SHF.L.U64 -> FLO -> IADD3 -> IMNMX, per link "
     "(latency)", "latency"),
    ("rice_decode code with a dependent LDS a code, per link (latency)",
     "latency"),
    ("tta_filter: sign (SHF, IADD, LOP3) -> IMAD -> SHF.R.S32 -> IADD, "
     "per link (latency)", "latency"),
    ("wv_chain encode: int64 multiply (IMAD.WIDE.U32, IMAD) -> add -> "
     "SHF.R.S64 -> subtract -> compares -> select -> add, per link "
     "(latency)", "latency"),
    ("wv_chain decode, term 18: the encode's link with the output feeding "
     "the next source ((3 * y1 - y2) >> 1), per link (latency)",
     "latency"),
    ("wv_chain encode, narrow: a 32-bit weight, mad.wide.s32 (w * s + "
     "512) -> SHF.R.S64 -> subtract -> compares -> select -> 32-bit add, "
     "per link (latency)", "latency"),
    ("wv_chain decode, term 18, narrow: the narrow link with the output "
     "feeding the next source, per link (latency)", "latency"),
    ("tta_filter's old loop: sign -> 8 qm IMADs -> the 8-term dot product "
     "as a chain of IMADs -> IMAD -> SHF.R.S32 -> IADD, per link "
     "(latency)", "latency"),
)
ITERS = 20000
# the cases of wv_chain.cu's int64 step chains: chip_smoke.py measures
# them in its own run for the WavPack kernels' critical paths
WV_ENCODE_CASE = 11
WV_DECODE_CASE = 12
# tta_filter.cu's loop from one step to the next (the chain warp's: the
# sign -> IMAD -> SHF -> IADD of case 10) and that of the kernel before
# it (qm -> dot product -> acc): chip_smoke.py reads both in its own run
TTA_FILTER_CASE = 10
TTA_FILTER_OLD_CASE = 15


def start_build(kernels):
    """starts nvcc on SOURCE into kernels.BUILD_DIR, with the kernels'
    own flags so that the cycles are those of how they build; returns
    what finish_build takes"""
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    src = os.path.join(kernels.BUILD_DIR, "int_op_cycles.cu")
    lib_path = os.path.join(kernels.BUILD_DIR, "libint_op_cycles.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    proc = subprocess.Popen([kernels.nvcc_path()] + kernels.NVCC_FLAGS +
                            ["-shared", "-o", lib_path, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return (proc, lib_path)


def finish_build(started):
    """waits for start_build's compile; returns the loaded library"""
    (proc, lib_path) = started
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError("int_op_cycles: nvcc failed:\n" + log)
    lib = ctypes.CDLL(lib_path)
    lib.run_case.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    return lib


def cycles(lib, kind):
    """case ``kind``'s cycles a link (latency) or a pair (throughput) on
    one warp of card 0, from the second of two runs (the first warms
    the card up)"""
    import torch
    dev = torch.device("cuda", 0)
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(32, dtype=torch.int64, device=dev)
    for _ in range(2):
        rc = lib.run_case(kind, ITERS, 7, 5, out.data_ptr(), sink.data_ptr())
        if rc != 0:
            raise RuntimeError("launch failed: CUDA error %d" % rc)
        torch.cuda.synchronize()
    return int(out.item()) / (ITERS * 8)


def main():
    import torch
    from audiotools_tpu_torch import kernels
    if not torch.cuda.is_available():
        sys.exit("int_op_cycles: needs a CUDA card")
    try:
        lib = finish_build(start_build(kernels))
    except RuntimeError as e:
        sys.exit(str(e))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for (kind, (name, what)) in enumerate(CASES):
        print(json.dumps({"case": name, "measures": what,
                          "cycles": cycles(lib, kind)}), flush=True)


if __name__ == "__main__":
    main()
