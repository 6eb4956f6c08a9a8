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
// What bounds it on an H100: each lane is a serial chain of T blocks,
// and per block the work is 64 states x a few integer operations plus
// one or two 64-way min reductions (the best key; the second-best key
// for q). The bytes are small (8 bytes in, 8 bytes out per block per
// lane), and the fleet has fewer lanes (64 to 256) than the card has
// warp schedulers (528), so one warp per lane issues alone on its
// scheduler, in order: the bound is the latency of one block's
// loop-carried chain times T, or the warp's instruction count per block
// where that is larger.
//
// Design: one warp per lane and one warp per CTA, so the lanes spread
// over the SMs and the compiler schedules for one warp (with four-warp
// CTAs it kept to 40 registers and a schedule that stalls longer:
// tools/acs_variants.py times both). Thread j holds states j and j+32
// (metric and u32 path word) in registers. The constant-geometry
// butterfly needs predecessors 2j and 2j+1 for both of its new states,
// which arrive by __shfl_sync from threads (2j)&31 and (2j+1)&31.
// Per-block inputs are loaded 32 blocks at a time (thread j loads block
// t0+j) and broadcast by shuffle; us/q are gathered by select and stored
// 32 at a time. cheap_q is a template parameter, and the unrolled loop
// body has no branch, so the compiler can interleave one block's
// reductions with the next block's butterfly.
//
// Lagged normalisation. The reference subtracts each block's best
// metric from its new metrics, so block t+1 waits for block t's 64-way
// reduction. Subtracting one constant from all 64 metrics of a lane
// changes no output of a block (the selects compare metrics of one lane;
// the key (metric*64 + state)*2 | bit orders states alike; us = the best
// key's low bit and q = second - best do not move). So block t subtracts
// s_t = the least metric of its INPUT planes, known one block early:
// s_t = r_{t-1} - s_{t-1}, where r_{t-1} is block t-1's best key >> 7
// (the least of its new metrics before its own subtraction), and s_0 is
// one reduction over the input planes. Block t's reductions (one
// REDUX.MIN each: the best key, and in ACQUIRE the second) then overlap
// block t+1's butterfly; the loop-carried chain per block is the
// butterfly (metric shuffle, select, add, min) and one subtraction, with
// the reduction spread over two blocks. After the last block the lane
// subtracts s_T, which makes m_out the reference's normalised planes.
//
// Headroom. With this subtraction block t's new metrics are the
// reference's un-normalised ones (its normalised input plus this
// block's branch costs) shifted by s_t's lag, so a key's metric lies
// within 2 |cost| of the reference's normalised range [0, spread]. The
// 64 metrics of a lane spread at most by the sum of |cost| over 6
// blocks (every state is 6 steps from the best one), plus the input
// planes' own spread for the first blocks. For the callers' costs
// (int16 ring costs, |cost| <= 2^15, one symbol per block at rate 1/2)
// and input planes this kernel wrote (spread <= 6 * 2^15), every metric
// on a key stays within +-(6 + 2 + 6) * 2^15 < 2^19, so every key stays
// within +-2^26, under BIG = 2^30 (and far from the int32 limits).
//
// Exactness: integer arithmetic only, in the TPU kernel's order. Ties
// follow the reference through the scan-order select and the packed key
// ((metric*64 | state) << 1 | traceback bit); the second-best exclusion
// compares whole keys.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BIG = 1 << 30;
constexpr int WARPS_PER_BLOCK = 1;
constexpr int GROUP = 32;      // blocks per input load and us/q store
constexpr int QSTEP = 4;       // cheap_q: q on blocks 4i only

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

template <bool CHEAP_Q>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
acs_kernel(const int32_t* __restrict__ tbl, const int32_t* __restrict__ m_in,
           const int32_t* __restrict__ p_in, const int32_t* __restrict__ cs,
           const int32_t* __restrict__ cost, int32_t* __restrict__ m_out,
           int32_t* __restrict__ p_out, int32_t* __restrict__ us_out,
           int32_t* __restrict__ q_out, int T, int N, int shift) {
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
  // The constant block 0 subtracts: the least input metric.
  int s = __reduce_min_sync(FULL, min(m_lo, m_hi));

  // Blocks per loop pass, a multiple of QSTEP: the faster of 8 and 16
  // for each mode on the card (tools/acs_variants.py).
  constexpr int UNROLL = CHEAP_Q ? 8 : 16;
  int cs_next = cs[(size_t)j * N + n];
  int c_next = cost[(size_t)j * N + n];
  for (int t0 = 0; t0 < T; t0 += GROUP) {
    const int cs_reg = cs_next, c_reg = c_next;
    if (t0 + GROUP < T) {                    // prefetch the next group
      cs_next = cs[(size_t)(t0 + GROUP + j) * N + n];
      c_next = cost[(size_t)(t0 + GROUP + j) * N + n];
    }
    int us_reg = 0, q_reg = 0;
#pragma unroll 1
    for (int k0 = 0; k0 < GROUP; k0 += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = k0 + u;
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
        const uint32_t pe = lo_half ? pe_l : pe_h;
        const uint32_t po = lo_half ? po_l : po_h;
        int nm0, nm1, k0_, k1_;
        uint32_t np0, np1;
        half_step(0, j, cse0, cso0, swp0, cs_b, c_b, me, mo, pe, po, shift,
                  nm0, np0, k0_);
        half_step(1, j, cse1, cso1, swp1, cs_b, c_b, me, mo, pe, po, shift,
                  nm1, np1, k1_);
        // The next block's input: this block's metrics less s (its
        // input's least metric), off the reduction below.
        m_lo = nm0 - s;
        m_hi = nm1 - s;
        p_lo = np0;
        p_hi = np1;
        const int best_key = __reduce_min_sync(FULL, min(k0_, k1_));
        const int r = best_key >> 7;         // arithmetic: floor
        if (!CHEAP_Q || u % QSTEP == 0) {
          const int x0 = k0_ == best_key ? BIG : k0_;
          const int x1 = k1_ == best_key ? BIG : k1_;
          const int q = (__reduce_min_sync(FULL, min(x0, x1)) >> 7) - r;
          q_reg = j == k ? q : q_reg;
        }
        us_reg = j == k ? best_key : us_reg;
        s = r - s;                           // the least of m_lo, m_hi
      }
    }
    us_out[(size_t)(t0 + j) * N + n] = us_reg & 1;
    q_out[(size_t)(t0 + j) * N + n] = q_reg;
  }
  m_out[j * N + n] = m_lo - s;
  m_out[(j + 32) * N + n] = m_hi - s;
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
  auto kernel = cheap_q ? acs_kernel<true> : acs_kernel<false>;
  kernel<<<blocks, 32 * WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tbl, (const int32_t*)m_in, (const int32_t*)p_in,
      (const int32_t*)cs, (const int32_t*)cost, (int32_t*)m_out,
      (int32_t*)p_out, (int32_t*)us, (int32_t*)q, T, N, shift);
  return (int)cudaGetLastError();
}
