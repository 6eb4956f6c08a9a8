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
// What bounds it on an H100: per output 4*nt multiplies and adds (nt
// for real taps), 8 (4) bytes in and out per sample. At the --resample
// path's shape (~2^17 samples, ~79 taps) the call moves ~2 MB and does
// ~0.08 GFLOP: both well under 10 us, so launch overhead sets the time.
// At nt = 2048 it is operation-bound.
//
// Design: one CTA per TILE outputs of one row (pair). The tile and its
// nt-1 samples of history are staged in shared memory once, so each
// input sample is read from device memory about (TILE+nt-1)/TILE times;
// the taps sit in shared memory too (<= 16 KB at nt = 2048) and are
// broadcast to the warp. One output per thread, accumulating k = 0 ..
// nt-1 in the plain version's order. Taps are a runtime device array:
// a carrier retune uploads new taps and rebuilds nothing.
//
// Exactness: built with --fmad=false, so every product and sum rounds
// once, in the plain version's order, and the kernel equals cfir_ref /
// fir_ref bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;      // outputs per CTA, one per thread

// Complex taps on one (re, im) row pair: x and y are [2, n].
__global__ void cfir_kernel(const float* __restrict__ taps_r,
                            const float* __restrict__ taps_i,
                            const float* __restrict__ x,
                            float* __restrict__ y, int n, int nt) {
  extern __shared__ float sh[];
  float* tr = sh;                        // [nt]
  float* ti = tr + nt;                   // [nt]
  float* xr = ti + nt;                   // [nt - 1 + TILE]
  float* xi = xr + (nt - 1 + TILE);
  const int t0 = blockIdx.x * TILE;
  const int span = nt - 1 + TILE;
  for (int k = threadIdx.x; k < nt; k += blockDim.x) {
    tr[k] = taps_r[k];
    ti[k] = taps_i[k];
  }
  // xr[j] holds x[t0 - (nt - 1) + j]; zero before the head and past n.
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    const int s = t0 - (nt - 1) + j;
    const bool in = s >= 0 && s < n;
    xr[j] = in ? x[s] : 0.0f;
    xi[j] = in ? x[n + s] : 0.0f;
  }
  __syncthreads();
  const int t = t0 + threadIdx.x;
  if (t >= n) return;
  float acc_r = 0.0f, acc_i = 0.0f;
  const int base = threadIdx.x + nt - 1;   // x[t - k] = xr[base - k]
  for (int k = 0; k < nt; ++k) {
    const float wr = tr[k], wi = ti[k];
    const float sr = xr[base - k], si = xi[base - k];
    acc_r = acc_r + wr * sr - wi * si;
    acc_i = acc_i + wr * si + wi * sr;
  }
  y[t] = acc_r;
  y[n + t] = acc_i;
}

// Real taps on R independent rows: x and y are [R, n]; grid.y = row.
__global__ void fir_kernel(const float* __restrict__ taps,
                           const float* __restrict__ x,
                           float* __restrict__ y, int n, int nt) {
  extern __shared__ float sh[];
  float* tp = sh;                        // [nt]
  float* xs = tp + nt;                   // [nt - 1 + TILE]
  const float* xrow = x + (size_t)blockIdx.y * n;
  const int t0 = blockIdx.x * TILE;
  const int span = nt - 1 + TILE;
  for (int k = threadIdx.x; k < nt; k += blockDim.x) tp[k] = taps[k];
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    const int s = t0 - (nt - 1) + j;
    xs[j] = (s >= 0 && s < n) ? xrow[s] : 0.0f;
  }
  __syncthreads();
  const int t = t0 + threadIdx.x;
  if (t >= n) return;
  float acc = 0.0f;
  const int base = threadIdx.x + nt - 1;
  for (int k = 0; k < nt; ++k) acc = acc + tp[k] * xs[base - k];
  y[(size_t)blockIdx.y * n + t] = acc;
}

}  // namespace

extern "C" int cfir_launch(const void* taps_r, const void* taps_i,
                           const void* x, void* y, int n, int nt,
                           void* stream) {
  const size_t shmem = sizeof(float) * (2 * nt + 2 * (nt - 1 + TILE));
  cfir_kernel<<<(n + TILE - 1) / TILE, TILE, shmem, (cudaStream_t)stream>>>(
      (const float*)taps_r, (const float*)taps_i, (const float*)x,
      (float*)y, n, nt);
  return (int)cudaGetLastError();
}

extern "C" int fir_launch(const void* taps, const void* x, void* y, int R,
                          int n, int nt, void* stream) {
  const size_t shmem = sizeof(float) * (nt + (nt - 1 + TILE));
  const dim3 grid((n + TILE - 1) / TILE, R);
  fir_kernel<<<grid, TILE, shmem, (cudaStream_t)stream>>>(
      (const float*)taps, (const float*)x, (float*)y, n, nt);
  return (int)cudaGetLastError();
}
