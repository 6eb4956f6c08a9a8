// ACS kernel: rate-1/2, K=7, 64-state soft-decision Viterbi
// add-compare-select with register-exchange paths, one lane per
// channel x sync replica (reference viterbi.h:202-293, dvb.h:1173-1416).
//
// Replaces the Pallas TPU kernel leansdr_tpu/fec/viterbi_device.py
// `_acs_kernel` (entry point `viterbi_acs`). The plain PyTorch version of
// the same integer arithmetic is `viterbi_acs_ref` in
// leansdr_tpu_torch/fec/viterbi_device.py; the wrapper `viterbi_acs`
// there launches this kernel through `acs_launch`.
//
// What bounds it on an H100: each lane is a serial chain of T blocks
// (block t+1's metrics need block t's minimum), and per block the work
// is 64 states x a few integer operations plus two 64-way min
// reductions. The bytes are small (8 bytes in, 8 bytes out per block
// per lane), so the bound is the latency of one block's dependency
// chain (shuffles and reductions) times T, with lanes in parallel.
//
// Design: one warp per lane. Thread j holds states j and j+32 (metric
// and u32 path word) in registers. The constant-geometry butterfly needs
// predecessors 2j and 2j+1 for both of its new states, which arrive by
// __shfl_sync from threads (2j)&31 and (2j+1)&31. The best key and the
// second-best key are warp-shuffle min reductions. Per-block inputs are
// loaded 32 blocks at a time (thread j loads block t0+j) and broadcast
// by shuffle; us/q are gathered the same way and stored 32 at a time.
//
// Exactness: integer arithmetic only, in the TPU kernel's order. Ties
// follow the reference through the scan-order select and the packed key
// ((metric*64 | state) << 1 | traceback bit); metric normalisation
// subtracts the best metric every block; the second-best exclusion
// compares whole keys.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BIG = 1 << 30;
constexpr int WARPS_PER_BLOCK = 4;

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// One half (h = 0: new state j, h = 1: new state j+32) of the butterfly.
__device__ __forceinline__ void half_step(
    int h, int j, int cse, int cso, int swp, int cs_b, int c_b, int me,
    int mo, uint32_t pe, uint32_t po, int shift, int& new_m,
    uint32_t& new_p, int& key) {
  const int Me = me + (cse == cs_b ? c_b : 0);
  const int Mo = mo + (cso == cs_b ? c_b : 0);
  new_m = min(Me, Mo);
  // Reference scan order [provided, cs-ascending branches], '<=': the
  // last minimum wins.
  const int m_first = swp ? mo : me;
  const int m_second = swp ? me : mo;
  const int k_match_odd = cso == cs_b;
  const int sel_odd = (m_second == new_m) ? 1 - swp
                      : (m_first == new_m) ? swp : k_match_odd;
  new_p = ((sel_odd ? po : pe) << 1) | (uint32_t)h;
  key = ((new_m * 64 + j + 32 * h) * 2) | (int)((new_p >> shift) & 1u);
}

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
acs_kernel(const int32_t* __restrict__ tbl, const int32_t* __restrict__ m_in,
           const int32_t* __restrict__ p_in, const int32_t* __restrict__ cs,
           const int32_t* __restrict__ cost, int32_t* __restrict__ m_out,
           int32_t* __restrict__ p_out, int32_t* __restrict__ us_out,
           int32_t* __restrict__ q_out, int T, int N, int shift,
           int cheap_q) {
  const int j = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (n >= N) return;                       // whole warps only
  // tbl [3, 2, 32]: cs_even, cs_odd, swap per half and j.
  const int cse0 = tbl[0 * 64 + j], cse1 = tbl[0 * 64 + 32 + j];
  const int cso0 = tbl[1 * 64 + j], cso1 = tbl[1 * 64 + 32 + j];
  const int swp0 = tbl[2 * 64 + j], swp1 = tbl[2 * 64 + 32 + j];
  int m_lo = m_in[j * N + n], m_hi = m_in[(j + 32) * N + n];
  uint32_t p_lo = (uint32_t)p_in[j * N + n];
  uint32_t p_hi = (uint32_t)p_in[(j + 32) * N + n];
  const int src_e = (2 * j) & 31, src_o = (2 * j + 1) & 31;
  const bool lo_half = j < 16;              // preds 2j, 2j+1 < 32

  int cs_next = cs[(size_t)j * N + n];
  int c_next = cost[(size_t)j * N + n];
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int cs_reg = cs_next, c_reg = c_next;
    if (t0 + 32 < T) {                       // prefetch the next group
      cs_next = cs[(size_t)(t0 + 32 + j) * N + n];
      c_next = cost[(size_t)(t0 + 32 + j) * N + n];
    }
    int us_reg = 0, q_reg = 0;
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
      const int cs_b = __shfl_sync(FULL, cs_reg, k);
      const int c_b = __shfl_sync(FULL, c_reg, k);
      const int me_l = __shfl_sync(FULL, m_lo, src_e);
      const int me_h = __shfl_sync(FULL, m_hi, src_e);
      const int mo_l = __shfl_sync(FULL, m_lo, src_o);
      const int mo_h = __shfl_sync(FULL, m_hi, src_o);
      const uint32_t pe_l = __shfl_sync(FULL, p_lo, src_e);
      const uint32_t pe_h = __shfl_sync(FULL, p_hi, src_e);
      const uint32_t po_l = __shfl_sync(FULL, p_lo, src_o);
      const uint32_t po_h = __shfl_sync(FULL, p_hi, src_o);
      const int me = lo_half ? me_l : me_h, mo = lo_half ? mo_l : mo_h;
      const uint32_t pe = lo_half ? pe_l : pe_h, po = lo_half ? po_l : po_h;
      int nm0, nm1, k0, k1;
      uint32_t np0, np1;
      half_step(0, j, cse0, cso0, swp0, cs_b, c_b, me, mo, pe, po, shift,
                nm0, np0, k0);
      half_step(1, j, cse1, cso1, swp1, cs_b, c_b, me, mo, pe, po, shift,
                nm1, np1, k1);
      const int best_key = warp_min(min(k0, k1));
      const int best_m = best_key >> 7;      // arithmetic: floor
      int q = 0;
      if (!cheap_q || ((t0 + k) & 3) == 0) {
        const int x0 = k0 == best_key ? BIG : k0;
        const int x1 = k1 == best_key ? BIG : k1;
        q = (warp_min(min(x0, x1)) >> 7) - best_m;
      }
      if (j == k) {
        us_reg = best_key & 1;
        q_reg = q;
      }
      m_lo = nm0 - best_m;
      m_hi = nm1 - best_m;
      p_lo = np0;
      p_hi = np1;
    }
    us_out[(size_t)(t0 + j) * N + n] = us_reg;
    q_out[(size_t)(t0 + j) * N + n] = q_reg;
  }
  m_out[j * N + n] = m_lo;
  m_out[(j + 32) * N + n] = m_hi;
  p_out[j * N + n] = (int32_t)p_lo;
  p_out[(j + 32) * N + n] = (int32_t)p_hi;
}

}  // namespace

extern "C" int acs_launch(const void* tbl, const void* m_in,
                          const void* p_in, const void* cs, const void* cost,
                          void* m_out, void* p_out, void* us, void* q,
                          int T, int N, int shift, int cheap_q,
                          void* stream) {
  const int blocks = (N + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  acs_kernel<<<blocks, 32 * WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tbl, (const int32_t*)m_in, (const int32_t*)p_in,
      (const int32_t*)cs, (const int32_t*)cost, (int32_t*)m_out,
      (int32_t*)p_out, (int32_t*)us, (int32_t*)q, T, N, shift, cheap_q);
  return (int)cudaGetLastError();
}
