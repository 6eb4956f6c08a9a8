// Banked ACS kernel: the punctured DVB-S rates (4/6, 3/4, 5/6, 7/8),
// K=7, 64-state soft-decision Viterbi add-compare-select with 2^B
// branches per state and 64-bit register-exchange paths, one lane per
// channel x sync replica (reference viterbi.h:202-293, dvb.h:1179-1416).
//
// Replaces the Pallas TPU kernel leansdr_tpu/fec/viterbi_banked.py
// `_acs_banked_kernel` (entry point `viterbi_acs_banked`). The plain
// PyTorch version of the same integer arithmetic is
// `viterbi_acs_banked_ref` in leansdr_tpu_torch/fec/viterbi_banked.py;
// the wrapper `viterbi_acs_banked` there launches this kernel through
// `acs_banked_launch`, with the tables of `kernel_tables` there.
//
// What bounds it on an H100: each lane is a serial chain of T blocks
// (block t+1's candidates need block t's metrics). Per block a lane
// evaluates 64 rows x K predecessors (K = 8, 16, 32; 64 at 7/8) keys,
// and the bytes are small (8 in and 8 out per block per lane). With
// many lanes (ACQUIRE, 512-1024) the bound is the instruction issue
// per candidate; with few (TRACK, 64 lanes on 528 warp schedulers) a
// warp is alone on its scheduler, and the bound is its in-order issue
// of the compiled block and the latency of one block's loop-carried
// chain.
//
// Design: one 64-thread CTA per lane, thread r owning stored output row
// r (state nat[r]). Per block, in shared memory: each predecessor's
// word P_p (its metric << rb), written once per block by the row that
// owns p, and the 64-bit paths, both double-buffered by natural state
// so that a bank's K predecessors are contiguous (16-byte loads,
// broadcast within a bank); and a ring of the last 64 blocks' state
// keys and us.
//
//   * Candidate keys. A plain key is (m_p << rb) | rank with a rank
//     static per (row, predecessor). Each row keeps its K ranks in
//     registers and folds each key into a running minimum with one
//     Hopper fused add-min (__viaddmin_s32, VIADDMNMX), reading the
//     predecessors' words 16 bytes at a time. At 7/8 a predecessor feeds
//     a row through two branches that share its metric, so only the
//     smaller rank can win: 64 candidates per row, not 128. (Keys by
//     XOR, P_p ^ xkey[r] with no per-slot registers, which the trellis's
//     linearity allows, were slower at 7/8 and no faster elsewhere.)
//     Keys are unique per (row, lane) (their low bits are
//     distinct ranks), so the minimum is split over NACC independent
//     running minima merged by a tree: the order does not matter.
//   * The provided branch (the one whose coded symbol is the block's)
//     and the winner come from one decode: x = tl[rank] ^ rdec[r] names
//     the branch of row r with that rank (its predecessor in bits 0-5,
//     at 7/8 its first input bit in bit 6; bits 8+ are its syndrome,
//     nonzero when the row has no such branch). tl[rcs] for the block is
//     staged with its inputs, so the provided key costs one load of
//     P_p*, an add and a min, not a compare and select per candidate;
//     the winner's rank (or the provided branch) gives its predecessor
//     and uncoded symbol the same way.
//   * No reduction on the per-block chain. A per-lane constant moves no
//     output (keys of one row shift alike; us and q read differences),
//     so the metrics are not normalised by their least: blocks t = 7
//     (mod 8) subtract natural state 0's input word, the others nothing.
//     Block t's paths advance in body t+1 (by its winner's decode), which
//     also puts block t's best-state key (metric << 6) | state and the
//     us at the row's path into a ring in shared memory, one row of 64
//     per block. Once per 64 blocks, after one extra barrier, thread j
//     reduces block j's row (least and second least key, two running
//     pairs; the us at the least) and writes its us and q. The per-block
//     chain is the barrier, the loads of P, the split minima, the winner
//     and its store, and a warp issuing in order waits on no warp
//     reduction (the compiler moves a REDUX's result out of its uniform
//     register at once, so even one read a barrier later stalls the
//     warp for the REDUX's latency). The last block's metrics less their
//     least (its key from the last ring) are m_out.
//
// Headroom. Let M_t(s) be the reference's metrics of block t's input
// (up to a lane constant). Every state's plain branches add nothing, so
// the least metric changes over a block by d_t, -|cost_t| <= d_t <= 0,
// and the 64 metrics spread at most by the costs of the ceil(6/B)
// blocks it takes from the best state to any other (for input planes
// this kernel wrote, or zeros). A word is M_t(s) - M_u(0) for the last u
// = 7 (mod 8) before t (M_0 itself before the first), u >= t - 8, so it
// lies within (ceil(6/B) + 8) max|cost|. Block costs are sums of
// nshifts int16 softsymbol costs (fec/viterbi_device.py:347-372): |cost|
// <= 2^16 at 3/4, 3 * 2^15 at 4/6 and 5/6, 2^17 at 7/8. A key's metric
// (the provided key adds one more cost) then stays within 11 * 2^16 <
// 2^20 at 3/4 (rb 5: |key| < 2^25), 11 * 3 * 2^15 < 2^21 at 4/6 and 5/6
// (rb 7: 2^28) and 10 * 2^17 < 2^21 at 7/8 (rb 9: 10 * 2^26 < 2^30):
// inside int32 at every rate, and the best-state key within 2^27.
// tests/test_torch_banked_kernel.py models this arithmetic in NumPy and
// holds it bit for bit against the reference at the int16 extremes.
//
// Exactness: integer arithmetic only. Ties as the reference breaks
// them: candidate keys "provided first, then cs-ascending, last minimum
// wins" through the rank in the key's low bits; the best state through
// the key (metric << 6) | state, first minimum; the second best
// excludes the best key. Left shifts go through uint32_t; right shifts
// of keys are arithmetic (floor); path words shift as uint32_t, which
// equals the TPU kernel's arithmetic shift followed by its mask.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int STAGE = 64;      // blocks staged per load of the inputs
constexpr int KEY_PITCH = 68;  // s_key row pitch: conflict-free 16-byte reads
// kernel_tables' aux rows (fec/viterbi_banked.py), 64 ints each, then tl.
constexpr int AUX_RDEC = 0 * 64, AUX_U0 = 1 * 64, AUX_U1 = 2 * 64,
              AUX_NAT = 3 * 64, AUX_TL = 4 * 64;

__device__ __forceinline__ int shl(int v, int s) {
  return (int)((uint32_t)v << s);
}

// min(a + b, c): one VIADDMNMX on Hopper.
__device__ __forceinline__ int add_min(int a, int b, int c) {
  return __viaddmin_s32(a, b, c);
}

template <int B>
__global__ void __launch_bounds__(64, 8)
acs_banked_kernel(const int32_t* __restrict__ rk_tbl,
                  const int32_t* __restrict__ aux,
                  const int32_t* __restrict__ m_in,
                  const int32_t* __restrict__ hi_in,
                  const int32_t* __restrict__ lo_in,
                  const int32_t* __restrict__ cs,
                  const int32_t* __restrict__ cost,
                  int32_t* __restrict__ m_out, int32_t* __restrict__ hi_out,
                  int32_t* __restrict__ lo_out, int32_t* __restrict__ us_out,
                  int32_t* __restrict__ q_out, int T, int N, int nbits,
                  int sh, int rb, int ncs) {
  constexpr int K = B == 7 ? 64 : 1 << B;     // predecessors per row
  constexpr int NACC = K >= 32 ? 8 : 4;       // independent running minima
  __shared__ __align__(16) int32_t s_P[2][64];  // by natural state
  __shared__ uint2 s_H[2][64];                  // (hi, lo) paths
  __shared__ int4 s_in[STAGE];  // (tl[rcs], cost << rb + ncs, rcs, -)
  __shared__ __align__(16) int32_t s_key[STAGE][KEY_PITCH];  // [block][row]
  __shared__ uint8_t s_us[STAGE][64];           // [block][natural state]
  __shared__ int32_t s_tl[257];
  __shared__ int32_t s_bm;

  const int r = threadIdx.x;                  // stored output row
  const int n = blockIdx.x;                   // lane
  const int nat = aux[AUX_NAT + r];
  const int rdec = aux[AUX_RDEC + r];
  const int u0 = aux[AUX_U0 + r], u1 = aux[AUX_U1 + r];
  const int pb = B == 7 ? 0 : (r >> B) << B;  // the bank's first pred
  int rk[K];                                   // the row's ranks
#pragma unroll
  for (int k = 0; k < K; ++k) rk[k] = rk_tbl[k * 64 + r];
  for (int i = r; i <= ncs; i += 64) s_tl[i] = i < ncs ? aux[AUX_TL + i] : 0;
  const int rmask = (1 << rb) - 1;
  const int umask = (1 << nbits) - 1;

  // The input planes. The paths go in as block -1's, so that block 0's
  // path step (shift in its us) gives them back: its winner is the row
  // itself, its us the input's low bits.
  const int m0 = m_in[r * N + n];
  const uint32_t h0 = (uint32_t)hi_in[r * N + n];
  const uint32_t l0 = (uint32_t)lo_in[r * N + n];
  s_P[0][nat] = shl(m0, rb);
  s_H[1][nat] = make_uint2(h0 >> nbits, (l0 >> nbits) | (h0 << (32 - nbits)));
  __syncthreads();

  int xr = nat ^ rdec;               // block t-1's decode, less rdec
  int bk = 0;                        // block t-1's state key
  int win = 0;
  uint32_t nh = 0, nl = 0;
  int4 e = make_int4(0, 0, 0, 0);    // block t's staged inputs

  // One block t (LAST false), or the path step of block T-1 (t = T).
  // Body t also advances block t-1's paths and puts its state key and
  // the us at this row's path into the ring.
  auto body = [&](auto par, auto last, int t, int k) {
    constexpr int U = decltype(par)::value;        // t mod 8
    constexpr bool LAST = decltype(last)::value;
    constexpr int P = U & 1;
    // Block t-1's paths: its winner's path and its us shifted in.
    const int x = xr ^ rdec;
    const uint2 hp = s_H[P ^ 1][x & 63];
    int ub = (B == 7 && ((x >> 6) & 1)) ? u1 : u0;
    if (U == 0 && !LAST) ub = t > 0 ? ub : (int)(l0 & umask);
    int bkn = 0;
    if constexpr (!LAST) {
      // Block t's candidate keys from the predecessors' words.
      const int xprov = e.x ^ rdec;
      const int cprov = e.y;
      const int rcs = e.z;
      if (k + 1 < STAGE) e = s_in[k + 1];
      const int32_t* Pc = s_P[P];
      int acc[NACC];
#pragma unroll
      for (int a = 0; a < NACC; ++a) acc[a] = INT_MAX;
#pragma unroll
      for (int k4 = 0; k4 < K; k4 += 4) {
        const int4 v = *reinterpret_cast<const int4*>(Pc + pb + k4);
        const int vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int& a = acc[(k4 + j) % NACC];
          a = add_min(vv[j], rk[k4 + j], a);
        }
      }
#pragma unroll
      for (int s = NACC / 2; s > 0; s >>= 1) {
#pragma unroll
        for (int a = 0; a < s; ++a) acc[a] = min(acc[a], acc[a + s]);
      }
      const int praw = Pc[xprov & 63];
      const int prov = (unsigned)xprov < 256u ? praw + cprov : INT_MAX;
      win = min(acc[0], prov);
      int base = win & ~rmask;
      // Blocks t = 7 (mod 8) subtract natural state 0's input word.
      if (U == 7) base -= Pc[0];
      s_P[P ^ 1][nat] = base;
      // Block t's winner, decoded in body t+1 (the provided branch's
      // rank is the block's rcs).
      const int rank = win & rmask;
      xr = s_tl[rank == ncs ? rcs : rank];
      bkn = shl(win >> rb, 6) | nat;               // block t's state key
    }
    nh = (hp.x << nbits) | (hp.y >> (32 - nbits));
    nl = (hp.y << nbits) | (uint32_t)ub;
    if constexpr (!LAST) s_H[P][nat] = make_uint2(nh, nl);
    if (LAST || U != 0 || t > 0) {                 // block t-1's entry
      const int i = (t - 1) & (STAGE - 1);
      s_key[i][r] = bk;
      s_us[i][nat] = (uint8_t)((nh >> sh) & umask);
    }
    bk = bkn;
    __syncthreads();
  };
  // Blocks tb .. tb+STAGE-1 from the ring, one per thread (r): the least
  // and second least state key over the 64 rows (two running pairs),
  // the us at the least. Returns the block's least key.
  auto reduce = [&](int tb) {
    const int32_t* kr = s_key[r];
    int b0 = INT_MAX, s0 = INT_MAX, b1 = INT_MAX, s1 = INT_MAX;
#pragma unroll
    for (int i = 0; i < 64; i += 8) {
      const int4 a = *reinterpret_cast<const int4*>(kr + i);
      const int4 c = *reinterpret_cast<const int4*>(kr + i + 4);
      const int va[4] = {a.x, a.y, a.z, a.w}, vc[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s0 = min(s0, max(b0, va[j]));
        b0 = min(b0, va[j]);
        s1 = min(s1, max(b1, vc[j]));
        b1 = min(b1, vc[j]);
      }
    }
    const int best = min(b0, b1);
    const int second = min(max(b0, b1), min(s0, s1));
    const size_t o = (size_t)(tb + r) * N + n;
    us_out[o] = s_us[r][best & 63];
    q_out[o] = (second >> 6) - (best >> 6);       // arithmetic: floor
    return best;
  };
  using I0 = std::integral_constant<int, 0>;
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  using I3 = std::integral_constant<int, 3>;
  using I4 = std::integral_constant<int, 4>;
  using I5 = std::integral_constant<int, 5>;
  using I6 = std::integral_constant<int, 6>;
  using I7 = std::integral_constant<int, 7>;
  using F = std::false_type;

  for (int t0 = 0; t0 < T; t0 += STAGE) {
    {
      const size_t i = (size_t)(t0 + r) * N + n;
      const int rcs = (ncs - 1) - cs[i];
      s_in[r] = make_int4(
          (unsigned)rcs < (unsigned)ncs ? s_tl[rcs] : 1 << 30,
          shl(cost[i], rb) + ncs, rcs, 0);
    }
    __syncthreads();
    e = s_in[0];
#pragma unroll 1
    for (int k = 0; k < STAGE; k += 8) {
      body(I0(), F(), t0 + k, k);
      if (k == 0 && t0 > 0) {
        // The last stage's ring is whole (body t0 wrote block t0-1).
        reduce(t0 - STAGE);
        __syncthreads();
      }
      body(I1(), F(), t0 + k + 1, k + 1);
      body(I2(), F(), t0 + k + 2, k + 2);
      body(I3(), F(), t0 + k + 3, k + 3);
      body(I4(), F(), t0 + k + 4, k + 4);
      body(I5(), F(), t0 + k + 5, k + 5);
      body(I6(), F(), t0 + k + 6, k + 6);
      body(I7(), F(), t0 + k + 7, k + 7);
    }
  }
  // T is a multiple of 64: block T-1's paths and ring entry, then the
  // last stage's reduction; m_out is the last block's metrics less their
  // least, whose key thread STAGE-1 holds.
  const int wlast = win;
  body(I0(), std::true_type(), T, STAGE);
  const int best = reduce(T - STAGE);
  if (r == STAGE - 1) s_bm = best >> 6;
  __syncthreads();
  m_out[r * N + n] = (wlast >> rb) - s_bm;
  hi_out[r * N + n] = (int32_t)nh;
  lo_out[r * N + n] = (int32_t)nl;
}

template <int B>
int launch(const void* rk, const void* aux, const void* m_in,
           const void* hi_in, const void* lo_in, const void* cs,
           const void* cost, void* m_out, void* hi_out, void* lo_out,
           void* us, void* q, int T, int N, int nbits, int sh, int rb,
           int ncs, cudaStream_t stream) {
  acs_banked_kernel<B><<<N, 64, 0, stream>>>(
      (const int32_t*)rk, (const int32_t*)aux, (const int32_t*)m_in,
      (const int32_t*)hi_in, (const int32_t*)lo_in, (const int32_t*)cs,
      (const int32_t*)cost, (int32_t*)m_out, (int32_t*)hi_out,
      (int32_t*)lo_out, (int32_t*)us, (int32_t*)q, T, N, nbits, sh, rb,
      ncs);
  return (int)cudaGetLastError();
}

}  // namespace

// T a positive multiple of 64 (even), any N >= 1; rk [K, 64] and aux
// from fec/viterbi_banked.kernel_tables.
extern "C" int acs_banked_launch(const void* rk, const void* aux,
                                 const void* m_in, const void* hi_in,
                                 const void* lo_in, const void* cs,
                                 const void* cost, void* m_out, void* hi_out,
                                 void* lo_out, void* us, void* q, int T,
                                 int N, int B, int nbits, int sh, int rb,
                                 int ncs, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (B) {
    case 3:
      return launch<3>(rk, aux, m_in, hi_in, lo_in, cs, cost, m_out,
                       hi_out, lo_out, us, q, T, N, nbits, sh, rb, ncs, s);
    case 4:
      return launch<4>(rk, aux, m_in, hi_in, lo_in, cs, cost, m_out,
                       hi_out, lo_out, us, q, T, N, nbits, sh, rb, ncs, s);
    case 5:
      return launch<5>(rk, aux, m_in, hi_in, lo_in, cs, cost, m_out,
                       hi_out, lo_out, us, q, T, N, nbits, sh, rb, ncs, s);
    case 7:
      return launch<7>(rk, aux, m_in, hi_in, lo_in, cs, cost, m_out,
                       hi_out, lo_out, us, q, T, N, nbits, sh, rb, ncs, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
