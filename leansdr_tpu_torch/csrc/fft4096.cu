// Batched 4096-point forward DFT as a radix-16 network: three passes of
// 16-point DFTs in registers, two exchanges through shared memory.
//
// Replaces the Pallas TPU kernel leansdr_tpu/dsp/fft_pallas.py
// `_fft4096_kernel` (entry point `fft4096_pallas`), which runs the 64 x 64
// four-step as products with a packed 128 x 128 real block matrix on the
// TPU's matrix unit. The plain PyTorch version is `fft4096_ref` in
// leansdr_tpu_torch/dsp/fft_kernel.py; the wrapper `fft4096` there
// launches this file through `fft4096_launch`.
//
// What bounds it on an H100: the function moves 16 bytes per point (two
// float32 planes in, two out), 67.1 MB at B = 1024, 0.0200 ms at
// 3.35 TB/s. An FFT needs ~5 N log2 N operations, 0.25 GFLOP at
// B = 1024 (0.0038 ms at 67e12/s), so it is byte-bound once the
// arithmetic is a butterfly network (the matrix-unit form of the TPU
// kernel, direct 64-term sums, needs ~4.3 GFLOP and cannot reach the
// byte bound; tensor cores would need TF32, which misses the 2e-5 bar).
//
// Index algebra (W_n = e^{-2 pi i / n}), with 4096 = 16 x 16 x 16,
// n = 256 n2 + 16 n1 + n0 and k = k0 + 16 k1 + 256 k2:
//
//   pass 1, thread t = 16 n1 + n0:
//     Y[k0] = W4096^(t k0) sum_n2 x[256 n2 + t] W16^(n2 k0)
//   pass 2, thread (n0, k0):
//     Z[k1] = W256^(n0 k1) sum_n1 Y[k0; 16 n1 + n0] W16^(n1 k1)
//   pass 3, thread t = 16 k1 + k0:
//     y[t + 256 k2] = sum_n0 Z[k0, k1; n0] W16^(n0 k2)
//
// so the loads (x[256 n2 + t]) and the stores (y[t + 256 k2]) are
// coalesced with 256 threads on consecutive t, and the output is in
// natural order without a bit-reversal pass (a Stockham ordering).
//
// Design: one 256-thread CTA per frame, 16 complex points per thread in
// registers, each 16-point DFT as 4 x 4 radix-4 butterflies with the
// W16 constants inline. The two exchanges go through one pair of
// shared planes (2 x 4640 floats, 37.1 KB), padded so that every read
// and write of a warp hits 32 distinct banks: exchange 1 at
// [k0 * 258 + 16 n1 + n0], exchange 2 at [k0 * 290 + 17 k1 + n0]. The
// inter-pass twiddles W4096^m (m < 4096) are the product of two 64-entry
// tables built on the host in float64 and rounded to float32 once,
// W64^(m >> 6) * W4096^(m & 63), kept in shared memory (1 KB). Several
// CTAs share an SM (registers and 38 KB of shared memory each), so one
// frame's loads are in flight while another computes.
//
// Accuracy: float32 butterflies with contraction, ~1e-6 of max|y| at
// unit-variance input; the bar is max|dy| / max|y| < 2e-5 against
// fft4096_ref and torch.fft.fft.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int N = 4096;
constexpr int R = 16;
constexpr int THREADS = 256;
constexpr int S1 = 258;            // exchange 1 row stride: k0 * S1
constexpr int S2 = 290;            // exchange 2: k0 * S2 + 17 k1 + n0
constexpr int Q2 = 17;
constexpr int PLANE = R * S2;      // 4640 >= R * S1 = 4128

struct cplx {
  float re, im;
};

__device__ __forceinline__ cplx cmul(cplx a, cplx b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// The radix-4 DFT of (a, b, c, d) in place: W4 = -i.
__device__ __forceinline__ void dft4(cplx& a, cplx& b, cplx& c, cplx& d) {
  const cplx s02 = {a.re + c.re, a.im + c.im};
  const cplx d02 = {a.re - c.re, a.im - c.im};
  const cplx s13 = {b.re + d.re, b.im + d.im};
  const cplx d13 = {b.re - d.re, b.im - d.im};
  a = {s02.re + s13.re, s02.im + s13.im};
  c = {s02.re - s13.re, s02.im - s13.im};
  b = {d02.re + d13.im, d02.im - d13.re};     // d02 - i d13
  d = {d02.re - d13.im, d02.im + d13.re};     // d02 + i d13
}

// The 16-point DFT of v[0..15] in place, natural order in and out:
// n = 4 n1 + n0, k = k1 + 4 k2; DFT4 over n1, twiddle W16^(n0 k1),
// DFT4 over n0.
__device__ __forceinline__ void dft16(cplx v[R]) {
  constexpr float C1 = 0.92387953251128674f;   // cos(pi/8)
  constexpr float S1_ = 0.38268343236508978f;  // sin(pi/8)
  constexpr float C2 = 0.70710678118654752f;   // cos(pi/4)
#pragma unroll
  for (int n0 = 0; n0 < 4; ++n0) dft4(v[n0], v[4 + n0], v[8 + n0], v[12 + n0]);
  // v[4 k1 + n0] now holds the k1-th output of column n0.
  v[5] = cmul(v[5], {C1, -S1_});                // W16^1
  v[6] = cmul(v[6], {C2, -C2});                 // W16^2
  v[7] = cmul(v[7], {S1_, -C1});                // W16^3
  v[9] = cmul(v[9], {C2, -C2});                 // W16^2
  v[10] = {v[10].im, -v[10].re};                // W16^4 = -i
  v[11] = cmul(v[11], {-C2, -C2});              // W16^6
  v[13] = cmul(v[13], {S1_, -C1});              // W16^3
  v[14] = cmul(v[14], {-C2, -C2});              // W16^6
  v[15] = cmul(v[15], {-C1, S1_});              // W16^9
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1)
    dft4(v[4 * k1], v[4 * k1 + 1], v[4 * k1 + 2], v[4 * k1 + 3]);
  // v[4 k1 + k2] holds output k1 + 4 k2: transpose to natural order.
  cplx t[R];
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1)
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) t[k1 + 4 * k2] = v[4 * k1 + k2];
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = t[j];
}

// W4096^m for 0 <= m < 4096 from the two shared 64-entry tables.
__device__ __forceinline__ cplx twiddle(const float* tw, int m) {
  const int hi = m >> 6, lo = m & 63;
  return cmul({tw[hi], tw[64 + hi]}, {tw[128 + lo], tw[192 + lo]});
}

__global__ void __launch_bounds__(THREADS)
fft4096_kernel(const float* __restrict__ tables,   // [4, 64]
               const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ yr, float* __restrict__ yi) {
  __shared__ float sr[PLANE];
  __shared__ float si[PLANE];
  __shared__ float tw[4 * 64];
  const int t = threadIdx.x;
  const size_t frame = (size_t)blockIdx.x * N;
  tw[t] = tables[t];
  cplx v[R];
#pragma unroll
  for (int j = 0; j < R; ++j)
    v[j] = {xr[frame + j * 256 + t], xi[frame + j * 256 + t]};
  __syncthreads();                       // tw

  // Pass 1: DFT over n2, twiddle W4096^(t k0), to [k0][t].
  dft16(v);
#pragma unroll
  for (int k0 = 1; k0 < R; ++k0) v[k0] = cmul(v[k0], twiddle(tw, t * k0));
#pragma unroll
  for (int k0 = 0; k0 < R; ++k0) {
    sr[k0 * S1 + t] = v[k0].re;
    si[k0 * S1 + t] = v[k0].im;
  }
  __syncthreads();

  // Pass 2: thread (n0, k0) = (t >> 4, t & 15); DFT over n1, twiddle
  // W256^(n0 k1) = W4096^(16 n0 k1), to [k0][k1][n0].
  {
    const int n0 = t >> 4, k0 = t & 15;
#pragma unroll
    for (int n1 = 0; n1 < R; ++n1) {
      const int a = k0 * S1 + n1 * R + n0;
      v[n1] = {sr[a], si[a]};
    }
    dft16(v);
#pragma unroll
    for (int k1 = 1; k1 < R; ++k1)
      v[k1] = cmul(v[k1], twiddle(tw, 16 * n0 * k1));
    __syncthreads();                     // every exchange-1 read is done
#pragma unroll
    for (int k1 = 0; k1 < R; ++k1) {
      const int a = k0 * S2 + k1 * Q2 + n0;
      sr[a] = v[k1].re;
      si[a] = v[k1].im;
    }
  }
  __syncthreads();

  // Pass 3: thread t = 16 k1 + k0; DFT over n0; y[t + 256 k2].
  {
    const int k1 = t >> 4, k0 = t & 15;
#pragma unroll
    for (int n0 = 0; n0 < R; ++n0) {
      const int a = k0 * S2 + k1 * Q2 + n0;
      v[n0] = {sr[a], si[a]};
    }
    dft16(v);
#pragma unroll
    for (int k2 = 0; k2 < R; ++k2) {
      yr[frame + k2 * 256 + t] = v[k2].re;
      yi[frame + k2 * 256 + t] = v[k2].im;
    }
  }
}

}  // namespace

extern "C" int fft4096_launch(const void* tables, const void* xr,
                              const void* xi, void* yr, void* yi, int B,
                              void* stream) {
  fft4096_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)tables, (const float*)xr, (const float*)xi, (float*)yr,
      (float*)yi);
  return (int)cudaGetLastError();
}
