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
// `acs_banked_launch`.
//
// What bounds it on an H100: each lane is a serial chain of T blocks
// (block t+1's candidates need block t's planes and best metric). Per
// block a lane evaluates 64 rows x K predecessors (K = 8, 16, 32; 64
// predecessors x 2 coded symbols for 7/8) candidate keys of a few
// integer operations each, then two 64-way min reductions. The bytes
// are small (8 in and 8 out per block per lane), so the bound is the
// INT32 issue rate at many lanes and the per-block dependency chain
// (candidate sweep, reductions, one barrier) at few.
//
// Design: one 64-thread CTA per lane, thread r owning stored output row
// r. The lane's metric/hi/lo planes are double-buffered in shared
// memory (2 x 3 x 64 i32); a thread reads its predecessors' rows from
// the previous buffer (for 7/8 all threads read the same row at once:
// a broadcast) and writes its own row of the next one. The static
// branch tables (K x 64 packed words, 16 KB for 7/8) sit in shared
// memory, loaded once. The candidate sweep is a strict-< running min
// over the predecessor slots: keys are unique per (row, lane), so the
// order does not matter. Best and second-best state keys come from a
// pair-min warp-shuffle reduction per warp and one exchange through
// shared memory; that exchange is the block's only barrier. Metrics are
// stored un-normalised and the previous block's best metric is
// subtracted on read, so normalisation needs no second barrier. Block
// inputs are staged 64 blocks at a time (thread r loads block t0+r);
// thread r keeps block t0+r's us and q and stores them at the next
// stage.
//
// Exactness: integer arithmetic only, in the TPU kernel's order. Left
// shifts go through uint32_t and wrap; right shifts of keys are
// arithmetic (floor); path words shift as uint32_t, which equals the TPU
// kernel's arithmetic shift followed by its mask. The discriminant q is
// computed on every block (the punctured TRACK mode keeps the full q).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BIG = 1 << 30;
constexpr int STAGE = 64;        // blocks staged per barrier

__device__ __forceinline__ int shl(int v, int s) {
  return (int)((uint32_t)v << s);
}

// (smallest, second smallest) of the warp's 32 keys.
__device__ __forceinline__ void warp_min2(int& a1, int& a2) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int b1 = __shfl_xor_sync(FULL, a1, o);
    const int b2 = __shfl_xor_sync(FULL, a2, o);
    a2 = min(max(a1, b1), min(a2, b2));
    a1 = min(a1, b1);
  }
}

template <int B>
__global__ void __launch_bounds__(64)
acs_banked_kernel(const int32_t* __restrict__ tbl,
                  const int32_t* __restrict__ prow,
                  const int32_t* __restrict__ m_in,
                  const int32_t* __restrict__ hi_in,
                  const int32_t* __restrict__ lo_in,
                  const int32_t* __restrict__ cs,
                  const int32_t* __restrict__ cost,
                  int32_t* __restrict__ m_out, int32_t* __restrict__ hi_out,
                  int32_t* __restrict__ lo_out, int32_t* __restrict__ us_out,
                  int32_t* __restrict__ q_out, int T, int N, int nbits,
                  int sh, int rb, int ncs) {
  constexpr int K = B == 7 ? 64 : 1 << B;     // predecessor slots
  constexpr int G = B == 7 ? 1 : 64 / K;      // banks
  __shared__ int32_t s_tbl[K * 64];
  __shared__ int32_t s_prow[64];
  __shared__ int32_t s_m[2][64];
  __shared__ uint32_t s_hi[2][64], s_lo[2][64];
  __shared__ int32_t s_cs[STAGE], s_c[STAGE];
  __shared__ int32_t s_red[2][2][3];          // [parity][warp][min1, min2, us]

  const int r = threadIdx.x;                  // stored output row
  const int n = blockIdx.x;                   // lane
  const int w = r >> 5;
  for (int i = r; i < K * 64; i += 64) s_tbl[i] = tbl[i];
  s_prow[r] = prow[r];
  s_m[0][r] = m_in[r * N + n];
  s_hi[0][r] = (uint32_t)hi_in[r * N + n];
  s_lo[0][r] = (uint32_t)lo_in[r * N + n];
  const int pbase = B == 7 ? 0 : (r >> B) * K;           // bank g * K
  const int ocol = B == 7 ? r : (r & (K - 1)) * G + (r >> B);
  const int rmask = (1 << rb) - 1;
  const int umask = (1 << nbits) - 1;

  int cur = 0, bm = 0;        // planes in s_*[cur], metrics offset by bm
  int us_reg = 0, q_reg = 0;  // block t0 + r of the current stage
  for (int t0 = 0; t0 < T; t0 += STAGE) {
    if (t0 > 0) {
      us_out[(size_t)(t0 - STAGE + r) * N + n] = us_reg;
      q_out[(size_t)(t0 - STAGE + r) * N + n] = q_reg;
    }
    s_cs[r] = cs[(size_t)(t0 + r) * N + n];
    s_c[r] = cost[(size_t)(t0 + r) * N + n];
    __syncthreads();
    for (int k = 0; k < STAGE; ++k) {
      const int rcs = (ncs - 1) - s_cs[k];
      const int cshift = shl(s_c[k], rb);
      int run_key = BIG, run_j = 0, run_tc = 0;
#pragma unroll 8
      for (int j = 0; j < K; ++j) {
        const int pr = B == 7 ? j : s_prow[pbase + j];
        const int base = shl(s_m[cur][pr] - bm, rb);
        const int tc = s_tbl[j * 64 + r];
        const int rk = tc & 0xFF;
        const int plain = base | rk;
        int key;
        if (B == 7) {
          const int rk2 = (tc >> 8) & 0xFF;
          const int prov = (rk == rcs || rk2 == rcs)
                               ? ((base + cshift) | ncs) : BIG;
          key = min(min(plain, base | rk2), prov);
        } else {
          key = rk == rcs ? min(plain, (base + cshift) | ncs) : plain;
        }
        if (key < run_key) {
          run_key = key;
          run_j = j;
          run_tc = tc;
        }
      }
      const int pr = B == 7 ? run_j : s_prow[pbase + run_j];
      const uint32_t hk = s_hi[cur][pr], lk = s_lo[cur][pr];
      int usv = (run_tc >> 16) & 0x7F;
      if (B == 7) {
        const int ul = (run_tc >> 23) & 0x7F;
        const int rank = run_key & rmask;
        usv = rank == ncs ? (((run_tc & 0xFF) == rcs) ? usv : ul)
                          : (rank == ((run_tc >> 8) & 0xFF) ? ul : usv);
      }
      const int wm = run_key >> rb;           // arithmetic: floor
      const uint32_t nh = (hk << nbits) | (lk >> (32 - nbits));
      const uint32_t nl = (lk << nbits) | (uint32_t)usv;
      const int nxt = cur ^ 1;
      s_m[nxt][r] = wm;
      s_hi[nxt][r] = nh;
      s_lo[nxt][r] = nl;

      // Best / second-best state ('<' first minimum by original state).
      const int key = shl(wm, 6) | ocol;
      const int usp = (int)(nh >> sh) & umask;
      int a1 = key, a2 = INT_MAX;
      warp_min2(a1, a2);
      const unsigned who = __ballot_sync(FULL, key == a1);
      const int uw = __shfl_sync(FULL, usp, __ffs(who) - 1);
      if ((r & 31) == 0) {
        s_red[k & 1][w][0] = a1;
        s_red[k & 1][w][1] = a2;
        s_red[k & 1][w][2] = uw;
      }
      __syncthreads();
      const int x1 = s_red[k & 1][0][0], x2 = s_red[k & 1][0][1];
      const int y1 = s_red[k & 1][1][0], y2 = s_red[k & 1][1][1];
      const int bk = min(x1, y1);
      const int second = min(max(x1, y1), min(x2, y2));
      bm = bk >> 6;
      if (r == k) {
        us_reg = x1 < y1 ? s_red[k & 1][0][2] : s_red[k & 1][1][2];
        q_reg = (second >> 6) - bm;
      }
      cur = nxt;
    }
  }
  us_out[(size_t)(T - STAGE + r) * N + n] = us_reg;
  q_out[(size_t)(T - STAGE + r) * N + n] = q_reg;
  m_out[r * N + n] = s_m[cur][r] - bm;
  hi_out[r * N + n] = (int32_t)s_hi[cur][r];
  lo_out[r * N + n] = (int32_t)s_lo[cur][r];
}

template <int B>
int launch(const void* tbl, const void* prow, const void* m_in,
           const void* hi_in, const void* lo_in, const void* cs,
           const void* cost, void* m_out, void* hi_out, void* lo_out,
           void* us, void* q, int T, int N, int nbits, int sh, int rb,
           int ncs, cudaStream_t stream) {
  acs_banked_kernel<B><<<N, 64, 0, stream>>>(
      (const int32_t*)tbl, (const int32_t*)prow, (const int32_t*)m_in,
      (const int32_t*)hi_in, (const int32_t*)lo_in, (const int32_t*)cs,
      (const int32_t*)cost, (int32_t*)m_out, (int32_t*)hi_out,
      (int32_t*)lo_out, (int32_t*)us, (int32_t*)q, T, N, nbits, sh, rb,
      ncs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int acs_banked_launch(const void* tbl, const void* prow,
                                 const void* m_in, const void* hi_in,
                                 const void* lo_in, const void* cs,
                                 const void* cost, void* m_out, void* hi_out,
                                 void* lo_out, void* us, void* q, int T,
                                 int N, int B, int nbits, int sh, int rb,
                                 int ncs, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (B) {
    case 3:
      return launch<3>(tbl, prow, m_in, hi_in, lo_in, cs, cost, m_out,
                       hi_out, lo_out, us, q, T, N, nbits, sh, rb, ncs, s);
    case 4:
      return launch<4>(tbl, prow, m_in, hi_in, lo_in, cs, cost, m_out,
                       hi_out, lo_out, us, q, T, N, nbits, sh, rb, ncs, s);
    case 5:
      return launch<5>(tbl, prow, m_in, hi_in, lo_in, cs, cost, m_out,
                       hi_out, lo_out, us, q, T, N, nbits, sh, rb, ncs, s);
    case 7:
      return launch<7>(tbl, prow, m_in, hi_in, lo_in, cs, cost, m_out,
                       hi_out, lo_out, us, q, T, N, nbits, sh, rb, ncs, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
