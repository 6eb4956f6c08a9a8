// Causal FIR with runtime taps: y[r, t] = sum_k taps[k] * x[r, t - k],
// zeros before the stream head.
//
// Replaces two Pallas TPU kernels of leansdr_tpu/dsp/fir_pallas.py:
//   * `_cfir_kernel` (entry point `cfir_pallas`): complex taps on one
//     (re, im) row pair, acc_r += wr*sr - wi*si, acc_i += wr*si + wi*sr
//     (the --resample filter, carrier-re-modulated taps);
//   * `_fir_kernel` (entry point `fir_pallas`): real taps on R rows, the
//     zero-imaginary case, one row at a time.
// The plain PyTorch versions of the same arithmetic are `cfir_ref` and
// `fir_ref` in leansdr_tpu_torch/dsp/fir_kernel.py; the wrappers `cfir`
// and `fir` there launch this file through `cfir_launch`/`fir_launch`.
//
// cfir computes the outputs t = start + j*step, j < count, only (the
// TPU kernel's contract is start 0, step 1, count n): the --resample
// stage keeps one output in `decim`, and asks for just those.
//
// What bounds it on an H100: per output 4*nt multiplies and 4*nt adds
// (nt for real taps), 8 (4) bytes in and out per sample. At the
// --resample path's shape (~2^17 samples, 79 taps, decim 7) a decimated
// call reads ~1 MB and does ~0.012 GFLOP: both well under 1 us, so the
// launch and one round trip to device memory set the time. At nt = 2048
// it is operation-bound.
//
// Design of cfir: a one-warp CTA per CFIR_TILE outputs, OPT per thread.
// The CTA stages its taps and the input span its outputs read into
// shared memory, interleaved (re, im) so that one 8-byte load brings a
// complex value, with 4-byte cp.async copies that are all in flight at
// once (zero-filled before the stream head and past n). Each tap pair
// read from shared memory serves all OPT outputs of the thread. At step
// 1 the thread's outputs are consecutive and its samples slide through
// registers: one new sample per tap for all OPT outputs (the loop is
// unrolled by OPT, so the slide is a renaming, not moves). At step > 1
// the thread's outputs are CFIR_THREADS apart (lanes read samples step
// apart: no bank conflicts at odd steps) and each reads its own sample.
// One-warp CTAs of 128 outputs give the decimated --resample launch
// (~18.7k outputs) 147 CTAs, all SMs in one wave; the full-rate launch
// has ~1025, ~8 per SM, also one wave. Taps are a runtime device array:
// a carrier retune uploads new taps and rebuilds nothing.
//
// Design of fir (the same unit-step design): a 128-thread CTA per
// FIR_TILE = 512 outputs of one row, 4 consecutive outputs per thread.
// Taps (zero-padded to a multiple of 4) and the tile's input span are
// staged with 4-byte cp.async copies, all in flight at once (zeros
// before the stream head and past n). The thread's samples slide
// through registers 4 at a time: per group of 4 taps one 16-byte load
// of taps (a broadcast) and one of samples (consecutive threads read
// consecutive 16 bytes: no bank conflicts) serve 16 multiplies and 16
// adds; taps past the last full group run one at a time. Outputs go
// back through shared memory and leave in coalesced rows. At 128 rows
// x 2^18 samples and 65 taps the exact order (below) needs one FMUL and
// one FADD per tap per output, ~4.4e9 FP32 instructions: ~0.13 ms at
// 128 lanes per SM per clock on 132 SMs at 1.98 GHz, above the 0.080 ms
// its bytes take at 3.35 TB/s.
//
// Exactness: built with --fmad=false, so every product and sum rounds
// once, in the plain version's order (k = 0 .. nt-1 per output), and
// the kernel equals cfir_ref / fir_ref bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FIR_THREADS = 128;   // fir: threads per CTA
constexpr int FIR_OPT = 4;         // fir: consecutive outputs per thread
constexpr int FIR_TILE = FIR_THREADS * FIR_OPT;
constexpr int OPT = 4;             // cfir: outputs per thread
constexpr int CFIR_THREADS = 32;   // cfir: one warp per CTA
constexpr int CFIR_TILE = OPT * CFIR_THREADS;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The shared memory a cfir CTA needs: taps, then the input span of a
// full tile ((CFIR_TILE - 1) * step + nt samples), as (re, im) pairs.
size_t cfir_shmem(int nt, int step) {
  return sizeof(float2) * ((size_t)nt + (size_t)(CFIR_TILE - 1) * step + nt);
}

// Complex taps on one (re, im) row pair: x is [2, n], y is [2, count],
// y[:, j] = the FIR at t = start + j * step.
template <bool UNIT>
__global__ void __launch_bounds__(CFIR_THREADS)
cfir_kernel(const float* __restrict__ taps_r, const float* __restrict__ taps_i,
            const float* __restrict__ x, float* __restrict__ y, int n, int nt,
            long long start, int step, int count) {
  extern __shared__ float2 sh2[];
  float2* tw = sh2;                        // [nt] (wr, wi)
  float2* xs = sh2 + nt;                   // xs[i] = x[lo + i] as (re, im)
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * CFIR_TILE;   // this CTA's first output
  const int jn = min(CFIR_TILE, count - j0);
  const long long lo = start + (long long)j0 * step - (nt - 1);
  const int span = (jn - 1) * step + nt;
  for (int k = tid; k < nt; k += CFIR_THREADS) {
    cp_async4(&tw[k].x, taps_r + k, true);
    cp_async4(&tw[k].y, taps_i + k, true);
  }
  for (int i = tid; i < span; i += CFIR_THREADS) {
    const long long s = lo + i;
    const bool in = s >= 0 && s < n;
    const long long sc = in ? s : 0;       // a valid address, not read
    cp_async4(&xs[i].x, x + sc, in);
    cp_async4(&xs[i].y, x + n + sc, in);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float acc_r[OPT], acc_i[OPT];
#pragma unroll
  for (int u = 0; u < OPT; ++u) acc_r[u] = acc_i[u] = 0.0f;
  // Outputs past jn read inside the allocation (a full tile's span) and
  // are not stored.
  if constexpr (UNIT) {
    // Outputs j0 + tid*OPT + u; win[u] = x[t_u - k] at tap k.
    const int base = tid * OPT + nt - 1;
    float2 win[OPT];
#pragma unroll
    for (int u = 0; u < OPT; ++u) win[u] = xs[base + u];
#pragma unroll (OPT)
    for (int k = 0; k < nt; ++k) {
      const float2 w = tw[k];
#pragma unroll
      for (int u = 0; u < OPT; ++u) {
        acc_r[u] = acc_r[u] + w.x * win[u].x - w.y * win[u].y;
        acc_i[u] = acc_i[u] + w.x * win[u].y + w.y * win[u].x;
      }
#pragma unroll
      for (int u = OPT - 1; u > 0; --u) win[u] = win[u - 1];
      // At k = nt-1 this reads one element below xs (the last tap) for
      // tid 0: inside sh2, and unused.
      win[0] = xs[base - k - 1];
    }
#pragma unroll
    for (int u = 0; u < OPT; ++u) {
      const int jl = tid * OPT + u;
      if (jl < jn) {
        y[j0 + jl] = acc_r[u];
        y[(size_t)count + j0 + jl] = acc_i[u];
      }
    }
  } else {
    // Outputs j0 + tid + u*CFIR_THREADS.
#pragma unroll 4
    for (int k = 0; k < nt; ++k) {
      const float2 w = tw[k];
#pragma unroll
      for (int u = 0; u < OPT; ++u) {
        const float2 v = xs[(tid + u * CFIR_THREADS) * step + nt - 1 - k];
        acc_r[u] = acc_r[u] + w.x * v.x - w.y * v.y;
        acc_i[u] = acc_i[u] + w.x * v.y + w.y * v.x;
      }
    }
#pragma unroll
    for (int u = 0; u < OPT; ++u) {
      const int jl = tid + u * CFIR_THREADS;
      if (jl < jn) {
        y[j0 + jl] = acc_r[u];
        y[(size_t)count + j0 + jl] = acc_i[u];
      }
    }
  }
}

// The shared memory a fir CTA needs: the taps padded to a multiple of
// 4 (ntp), then the input span of a tile (ntp + FIR_TILE samples).
size_t fir_shmem(int nt) {
  const size_t ntp = (size_t)(nt + 3) & ~(size_t)3;
  return sizeof(float) * (ntp + ntp + FIR_TILE);
}

// Real taps on R independent rows: x and y are [R, n]; grid.y = row.
__global__ void __launch_bounds__(FIR_THREADS)
fir_kernel(const float* __restrict__ taps, const float* __restrict__ x,
           float* __restrict__ y, int n, int nt) {
  extern __shared__ __align__(16) float sh[];
  const int ntp = (nt + 3) & ~3;
  float* tp = sh;                        // [ntp], zero past nt
  float* xs = sh + ntp;                  // xs[i] = x[row, j0 - ntp + i]
  const int tid = threadIdx.x;
  const size_t row = (size_t)blockIdx.y * n;
  const int j0 = blockIdx.x * FIR_TILE;  // this CTA's first output
  for (int k = tid; k < ntp; k += FIR_THREADS)
    cp_async4(&tp[k], taps + (k < nt ? k : 0), k < nt);
  for (int i = tid; i < ntp + FIR_TILE; i += FIR_THREADS) {
    const int s = j0 - ntp + i;
    const bool in = s >= 0 && s < n;
    cp_async4(&xs[i], x + row + (in ? s : 0), in);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Outputs t_u = j0 + A - ntp + u; x[t_u - k] = xs[A + u - k].
  const int A = FIR_OPT * tid + ntp;
  float acc[FIR_OPT];
#pragma unroll
  for (int u = 0; u < FIR_OPT; ++u) acc[u] = 0.0f;
  float4 hi = *reinterpret_cast<const float4*>(&xs[A]);
  const int groups = nt >> 2;
#pragma unroll 2
  for (int g = 0; g < groups; ++g) {
    // Taps 4g .. 4g+3: samples xs[A - 4g - 4 .. A - 4g + 3].
    const float4 lo = *reinterpret_cast<const float4*>(&xs[A - 4 * g - 4]);
    const float4 w4 = *reinterpret_cast<const float4*>(&tp[4 * g]);
    const float vh[4] = {hi.x, hi.y, hi.z, hi.w};
    const float vl[4] = {lo.x, lo.y, lo.z, lo.w};
    const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int u = 0; u < FIR_OPT; ++u) {
        const float v = u - i >= 0 ? vh[u - i] : vl[4 + u - i];
        acc[u] = acc[u] + w[i] * v;
      }
    }
    hi = lo;
  }
  for (int k = 4 * groups; k < nt; ++k) {
    const float w = tp[k];
#pragma unroll
    for (int u = 0; u < FIR_OPT; ++u) acc[u] = acc[u] + w * xs[A + u - k];
  }
  __syncthreads();                       // every thread is done with xs
  *reinterpret_cast<float4*>(&xs[FIR_OPT * tid]) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  const int jn = min(FIR_TILE, n - j0);
  for (int i = tid; i < jn; i += FIR_THREADS) y[row + j0 + i] = xs[i];
}

}  // namespace

extern "C" int cfir_launch(const void* taps_r, const void* taps_i,
                           const void* x, void* y, int n, int nt,
                           long long start, int step, int count,
                           void* stream) {
  const size_t shmem = cfir_shmem(nt, step);
  const int blocks = (count + CFIR_TILE - 1) / CFIR_TILE;
  const bool unit = step == 1;
  const void* fn = unit ? (const void*)cfir_kernel<true>
                        : (const void*)cfir_kernel<false>;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  if (unit)
    cfir_kernel<true><<<blocks, CFIR_THREADS, shmem, (cudaStream_t)stream>>>(
        (const float*)taps_r, (const float*)taps_i, (const float*)x,
        (float*)y, n, nt, start, step, count);
  else
    cfir_kernel<false><<<blocks, CFIR_THREADS, shmem, (cudaStream_t)stream>>>(
        (const float*)taps_r, (const float*)taps_i, (const float*)x,
        (float*)y, n, nt, start, step, count);
  return (int)cudaGetLastError();
}

extern "C" int fir_launch(const void* taps, const void* x, void* y, int R,
                          int n, int nt, void* stream) {
  const dim3 grid((n + FIR_TILE - 1) / FIR_TILE, R);
  fir_kernel<<<grid, FIR_THREADS, fir_shmem(nt), (cudaStream_t)stream>>>(
      (const float*)taps, (const float*)x, (float*)y, n, nt);
  return (int)cudaGetLastError();
}
