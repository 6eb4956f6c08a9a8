// Batched 4096-point forward DFT, one fused pass per frame: the 64 x 64
// four-step. With x[a*64 + b] (a, b, q, k1 in 0..63, W_n = e^{-2 pi i/n}):
//
//   D[b, k1]     = sum_a x[a*64 + b] W64^(a*k1)     DFT over a
//   B[b, k1]     = D[b, k1] * W4096^(b*k1)          twiddle
//   y[q*64 + k1] = sum_b B[b, k1] W64^(b*q)         DFT over b
//
// Replaces the Pallas TPU kernel leansdr_tpu/dsp/fft_pallas.py
// `_fft4096_kernel` (entry point `fft4096_pallas`), which runs both DFT
// stages as products with the packed 128 x 128 real block matrix on the
// TPU's matrix unit. The plain PyTorch version is `fft4096_ref` in
// leansdr_tpu_torch/dsp/fft_kernel.py; the wrapper `fft4096` there
// launches this file through `fft4096_launch`.
//
// What bounds it on an H100: the function moves 16 bytes per point (two
// float32 planes in, two out), 67.1 MB at B = 1024, 0.0200 ms at
// 3.35 TB/s; 5 N log2 N operations (0.0038 ms at 67e12/s) would take
// less. This design spends direct 64-term sums instead: 8 float
// operations per term, 64 terms per point and stage, ~4.3 GFLOP at
// B = 1024, so it is operation-bound at ~0.064 ms (67e12/s) and cannot
// reach the byte bound. It is the simple, correct first kernel; a
// radix-4/8 butterfly network in registers is the redesign that would
// approach the bound.
//
// Design: one 256-thread CTA per frame. The frame's two planes are read
// once, coalesced, into shared memory as [a][b] tiles padded to 65
// columns. Thread t owns column k1 = t & 63 and a quarter g = t >> 6 of
// the other index. Stage 1: for each a, one root W64^((a*k1) & 63) from
// a 64-entry shared table times 16 broadcast samples x[a][b]; the
// twiddle (a [64, 64] table in global memory, read once per point,
// coalesced) is applied in registers; B overwrites the tiles after a
// barrier. Stage 2: for each b, one sample B[b][k1] (consecutive across
// the warp) times 16 broadcast roots W64^((b*q) & 63); the results are
// stored in natural order q*64 + k1, coalesced. 33.8 KB of shared
// memory, under the 48 KB a launch gets without opting in.
//
// Accuracy: float32 sums in another order than the plain version's
// matrix products, so the two agree to float32 rounding (max|dy| /
// max|y| < 2e-5 at unit-variance input), not bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int N1 = 64;
constexpr int N = N1 * N1;
constexpr int PAD = N1 + 1;        // tile row stride (bank spread)
constexpr int THREADS = 256;
constexpr int PER = N1 * N1 / THREADS;   // 16 outputs per thread per stage

__global__ void __launch_bounds__(THREADS)
fft4096_kernel(const float* __restrict__ roots,   // [2, 64] re, im
               const float* __restrict__ twr,     // [64, 64] t[b, k1]
               const float* __restrict__ twi,
               const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ yr, float* __restrict__ yi) {
  __shared__ float sr[N1 * PAD];
  __shared__ float si[N1 * PAD];
  __shared__ float wr[N1];
  __shared__ float wi[N1];
  const int t = threadIdx.x;
  const size_t frame = (size_t)blockIdx.x * N;
  if (t < N1) {
    wr[t] = roots[t];
    wi[t] = roots[N1 + t];
  }
  for (int i = t; i < N; i += THREADS) {   // x[a*64 + b] -> tile[a][b]
    const int a = i >> 6, b = i & 63;
    sr[a * PAD + b] = xr[frame + i];
    si[a * PAD + b] = xi[frame + i];
  }
  __syncthreads();

  const int k1 = t & 63;
  const int g = (t >> 6) * PER;            // this thread's 16 b (then q)
  float ar[PER], ai[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) ar[j] = ai[j] = 0.0f;
  // Stage 1: D[b, k1] for b = g .. g+15.
  for (int a = 0; a < N1; ++a) {
    const int m = (a * k1) & 63;
    const float cr = wr[m], ci = wi[m];
    const float* rr = sr + a * PAD + g;
    const float* ri = si + a * PAD + g;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const float vr = rr[j], vi = ri[j];
      ar[j] += vr * cr - vi * ci;
      ai[j] += vr * ci + vi * cr;
    }
  }
  // Twiddle, then B[b][k1] replaces the input tiles.
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int b = g + j;
    const float tr = twr[b * N1 + k1], ti = twi[b * N1 + k1];
    const float dr = ar[j], di = ai[j];
    ar[j] = dr * tr - di * ti;
    ai[j] = dr * ti + di * tr;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    sr[(g + j) * PAD + k1] = ar[j];
    si[(g + j) * PAD + k1] = ai[j];
  }
  __syncthreads();

  // Stage 2: Y[q, k1] for q = g .. g+15.
#pragma unroll
  for (int j = 0; j < PER; ++j) ar[j] = ai[j] = 0.0f;
  for (int b = 0; b < N1; ++b) {
    const float vr = sr[b * PAD + k1], vi = si[b * PAD + k1];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int m = (b * (g + j)) & 63;
      const float cr = wr[m], ci = wi[m];
      ar[j] += vr * cr - vi * ci;
      ai[j] += vr * ci + vi * cr;
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {          // natural order q*64 + k1
    yr[frame + (size_t)(g + j) * N1 + k1] = ar[j];
    yi[frame + (size_t)(g + j) * N1 + k1] = ai[j];
  }
}

}  // namespace

extern "C" int fft4096_launch(const void* roots, const void* twr,
                              const void* twi, const void* xr,
                              const void* xi, void* yr, void* yi, int B,
                              void* stream) {
  fft4096_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)roots, (const float*)twr, (const float*)twi,
      (const float*)xr, (const float*)xi, (float*)yr, (float*)yi);
  return (int)cudaGetLastError();
}
