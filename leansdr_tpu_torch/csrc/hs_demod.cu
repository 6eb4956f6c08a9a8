// --hs demod kernel: the integer fast-QPSK receiver (reference
// fast_qpsk_receiver, sdr.h:946-1189), one sequential recurrence per
// channel: a 16-bit fixed-point PLL and an integer modified
// Mueller&Muller loop over table lookups, hard symbols by quadrant.
//
// There is no Pallas kernel behind it: the JAX package runs this path as
// a `lax.scan` (leansdr_tpu/dsp/receiver_hs.py:102-231, `run_chunks_hs`).
// The plain PyTorch version of the same arithmetic is
// `run_chunks_hs_ref` in leansdr_tpu_torch/dsp/receiver_hs.py; the
// wrapper `run_chunks_hs` there launches this kernel through
// `hs_demod_launch`.
//
// What bounds it on an H100: the recurrence is serial per channel (the
// PLL phase and freqw, mu and the history feed the next sample): per
// sample a rect gather at an index that depends on the phase, a float
// multiply and truncation by mu, a polar gather at the interpolated
// point, and the loop's integer and float operations. The bound is that
// chain's latency times the samples, not bytes or operations;
// parallelism comes only from channels.
//
// Design: one warp per block of 32 channels, one thread per channel, the
// loop state in registers, and every load the chain waits for in shared
// memory:
//   * The polar word (angle | radius << 16) of every sample is state-
//     independent. The wrapper gathers it in bulk, as JAX hoists it out of
//     its scan, and hands [nsamp+1, C] int32 rows; each thread stages its
//     channel's next chunk (CHUNK + 1 rows) into a two-stage ring with
//     cp.async while it runs the current one, so no load of a chunk's
//     polar words sits on its first sample's path.
//   * The tables live in shared memory, loaded once per launch: the polar
//     angle plane (i16, 65536 entries) and the rect planes packed as one
//     u16 plane (rect_re | rect_im << 8), radius-major. A radius is at most
//     181 (trunc(hypot(128, 128))), so of the rect index a * 256 + (r >> 1)
//     only the columns r >> 1 <= 90 are reachable: 91 x 256 entries. One
//     u16 gather gives both components where there were two u8 gathers.
//     The sincos table's only reachable entries, ((arg & 0xC000) + 8192) &
//     0xFFFF, are four (u8): the wrapper passes them in the arguments, and
//     the kernel keeps them as the bytes of two registers.
// Shared memory, bytes:
//     polar angle   i16 [65536]                    131,072
//     rect          u16 [91][256]                   46,592
//     polar ring    i32 [2][CHUNK + 1][32]          33,024
//     word tile     i32 [CHUNK][32]                 16,384
//     total                                        227,072  (<= 232,448)
// Symbols and valid flags leave as one packed word per sample (bits
// 16..23 symbol, bit 24 valid, as the demod kernels), staged per chunk
// in the word tile; per chunk freq, nmeas and the last emitted point.
//
// Exactness: all arithmetic is int32 as in JAX (arithmetic >> on signed
// int32, & masks) but for mu: float(d) * mu truncated with
// __float2int_rz, and mu + mucorr + omega, built with --fmad=false.

#include <cstdint>
#include <cuda_runtime.h>

#define CHUNK 128

struct HsArgs {
  float omega, gain_mu, max_mucorr;
  int freq_alpha, freq_beta, min_freqw, max_freqw, mid_freqw, allow_drift;
  int meas_decimation;
  int sc_re[4], sc_im[4];
};

namespace {

constexpr int LANES = 32;          // channels per block: one warp
constexpr int RLUT_BITS = 8;
constexpr int RECT_COLS = 91;      // reachable r >> 1: 0..90
constexpr int POLAR_BYTES = 65536 * 2;
constexpr int RECT_BYTES = RECT_COLS * 256 * 2;
constexpr int RING_ROWS = CHUNK + 1;
constexpr int RING_BYTES = 2 * RING_ROWS * LANES * 4;
constexpr int WORD_BYTES = CHUNK * LANES * 4;
constexpr int SMEM_BYTES = POLAR_BYTES + RECT_BYTES + RING_BYTES + WORD_BYTES;
static_assert(SMEM_BYTES <= 232448, "hs_demod: shared memory");

__device__ __forceinline__ int s8(int v) { return ((v & 0xFF) ^ 0x80) - 0x80; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every group but the newest has landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows base .. base + CHUNK of channel c's polar words into this lane's
// column of one ring stage (zeros for a lane past C).
__device__ __forceinline__ void stage_rows(int* stage,
                                           const int* __restrict__ pw, int C,
                                           int c, bool active, int base) {
  const int* src = pw + (size_t)base * C + (active ? c : 0);
  int* dst = stage + threadIdx.x;
  for (int r = 0; r < RING_ROWS; ++r)
    cp_async4(dst + r * LANES, src + (size_t)r * C, active);
}

__global__ void __launch_bounds__(LANES)
hs_kernel(const HsArgs A, const short* __restrict__ polar_a,
          const unsigned short* __restrict__ rect,
          const int* __restrict__ pw, const float* __restrict__ mu_in,
          float* __restrict__ mu_out, const int* __restrict__ ist_in,
          int* __restrict__ ist_out, int32_t* __restrict__ out,
          float* __restrict__ freq, int* __restrict__ meta, int C,
          int nsamp) {
  extern __shared__ __align__(16) unsigned char smem[];
  short* pa = reinterpret_cast<short*>(smem);
  unsigned short* rs = reinterpret_cast<unsigned short*>(smem + POLAR_BYTES);
  int* ring = reinterpret_cast<int*>(smem + POLAR_BYTES + RECT_BYTES);
  int32_t* os = reinterpret_cast<int32_t*>(smem + POLAR_BYTES + RECT_BYTES +
                                           RING_BYTES);
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * LANES;
  const int c = c0 + lane;
  const bool active = c < C;
  const int nchunks = nsamp / CHUNK;
  const int nl = min(LANES, C - c0);

  // The tables (16-byte pieces across the warp), then chunk 0's rows.
  for (int i = lane; i < POLAR_BYTES / 16; i += LANES)
    cp_async16(smem + 16 * i, reinterpret_cast<const char*>(polar_a) + 16 * i);
  for (int i = lane; i < RECT_BYTES / 16; i += LANES)
    cp_async16(smem + POLAR_BYTES + 16 * i,
               reinterpret_cast<const char*>(rect) + 16 * i);
  if (nchunks > 0) stage_rows(ring, pw, C, c, active, 0);
  cp_async_commit();

  // The four sincos entries as the bytes of a word each: a lookup by the
  // quadrant with no dynamically indexed array (which would sit in local
  // memory).
  const int sc_re = A.sc_re[0] | A.sc_re[1] << 8 | A.sc_re[2] << 16 |
                    A.sc_re[3] << 24;
  const int sc_im = A.sc_im[0] | A.sc_im[1] << 8 | A.sc_im[2] << 16 |
                    A.sc_im[3] << 24;
  float mu = active ? mu_in[c] : 0.0f;
  int st[15];
#pragma unroll
  for (int k = 0; k < 15; ++k) st[k] = active ? ist_in[k * C + c] : 0;
  int phase = st[0], freqw = st[1], meas_count = st[2];
  int hp0r = st[3], hp0i = st[4], hp1r = st[5], hp1i = st[6];
  int hp2r = st[7], hp2i = st[8];
  int hc0r = st[9], hc0i = st[10], hc1r = st[11], hc1i = st[12];
  int hc2r = st[13], hc2i = st[14];
  cp_async_wait_all();
  __syncwarp();                            // every lane's table pieces

  for (int ck = 0; ck < nchunks; ++ck) {
    const int base = ck * CHUNK;
    if (ck + 1 < nchunks)
      stage_rows(ring + ((ck + 1) & 1) * RING_ROWS * LANES, pw, C, c, active,
                 base + CHUNK);
    cp_async_commit();
    cp_async_wait_prior();                 // this chunk's rows are in
    const int* q = ring + (ck & 1) * RING_ROWS * LANES + lane;
    int l_re = 0, l_im = 0, l_ok = 0;
    for (int t = 0; t < CHUNK; ++t) {
      const int q0 = q[t * LANES], q1 = q[(t + 1) * LANES];
      const int p0a = (int)(short)(q0 & 0xFFFF);
      const int p1a = (int)(short)(q1 & 0xFFFF);
      const bool emit = mu < 1.0f;
      // rect[(r >> 1) * 256 + a]: the radius part of the index is known
      // before the phase.
      const int a0 = ((p0a - phase) & 0xFFFF) >> (16 - RLUT_BITS);
      const int a1 = ((p1a - (phase + freqw)) & 0xFFFF) >> (16 - RLUT_BITS);
      const int v0 = rs[((q0 >> 17) << 8) + a0];
      const int v1 = rs[((q1 >> 17) << 8) + a1];
      const int p0r_re = v0 & 0xFF, p0r_im = v0 >> 8;
      const int p1r_re = v1 & 0xFF, p1r_im = v1 >> 8;
      // s = p0r + (p1r-p0r)*mu: float multiply, truncation, u8 wrap
      const int s_re =
          (p0r_re + __float2int_rz((float)(p1r_re - p0r_re) * mu)) & 0xFF;
      const int s_im =
          (p0r_im + __float2int_rz((float)(p1r_im - p0r_im) * mu)) & 0xFF;
      const int arg = (int)pa[s_re * 256 + s_im] & 0xFFFF;
      const int quadrant = arg >> 14;
      // PLL in 16-bit fixed point (sdr.h:1072-1075)
      const int pe = (arg & 16383) - 8192;
      const int phase_u = phase + ((pe * A.freq_alpha + 32768) >> 16);
      const int freqw_u = freqw + ((pe * A.freq_beta + 32768 * 256) >> 24);
      // Integer modified M&M (sdr.h:1099-1108)
      const int c_re = (sc_re >> (8 * quadrant)) & 0xFF;
      const int c_im = (sc_im >> (8 * quadrant)) & 0xFF;
      const int muerr =
          (s8(s_re - hp1r) * (hc0r - 128) + s8(s_im - hp1i) * (hc0i - 128)) -
          (s8(c_re - hc1r) * (hp0r - 128) + s8(c_im - hc1i) * (hp0i - 128));
      const float mucorr = fminf(
          fmaxf((float)muerr * A.gain_mu, -A.max_mucorr), A.max_mucorr);
      if (emit) {
        mu = mu + mucorr + A.omega;
        phase = phase_u;
        freqw = freqw_u;
        hp2r = hp1r; hp2i = hp1i; hp1r = hp0r; hp1i = hp0i;
        hp0r = s_re; hp0i = s_im;
        hc2r = hc1r; hc2i = hc1i; hc1r = hc0r; hc1i = hc0i;
        hc0r = c_re; hc0i = c_im;
        l_re = s_re;
        l_im = s_im;
        l_ok = 1;
      }
      mu = mu - 1.0f;
      // phase is a u16 angle in the reference: kept wrapped.
      phase = (phase + freqw) & 0xFFFF;
      // Symbols of the quadrants 0..3: 0, 2, 3, 1 (2-bit fields of 0x78).
      os[t * LANES + lane] =
          (((0x78 >> (2 * quadrant)) & 3) << 16) | ((int)emit << 24);
    }
    if (!A.allow_drift && (freqw < A.min_freqw || freqw > A.max_freqw))
      freqw = A.mid_freqw;
    meas_count += CHUNK;
    const int nm = meas_count / A.meas_decimation;
    meas_count = meas_count % A.meas_decimation;
    if (active) {
      const size_t kc = (size_t)nchunks * C, at = (size_t)ck * C + c;
      freq[at] = (float)freqw / 65536.0f;
      meta[at] = nm;
      meta[kc + at] = l_re;
      meta[2 * kc + at] = l_im;
      meta[3 * kc + at] = l_ok;
    }
    // The chunk's words, [CHUNK, nl] of out at row base.
    __syncwarp();
    int32_t* dst = out + (size_t)base * C + c0;
    if ((C & 3) == 0) {                    // nl % 4 == 0: 16-byte stores
      const int q4 = nl >> 2;
      for (int i = lane; i < CHUNK * q4; i += LANES) {
        const int r = i / q4, j = i - r * q4;
        *reinterpret_cast<int4*>(dst + (size_t)r * C + 4 * j) =
            *reinterpret_cast<const int4*>(os + r * LANES + 4 * j);
      }
    } else if (active) {
      for (int r = 0; r < CHUNK; ++r)
        dst[(size_t)r * C + lane] = os[r * LANES + lane];
    }
    __syncwarp();
  }
  if (!active) return;
  mu_out[c] = mu;
  const int fin[15] = {phase, freqw, meas_count, hp0r, hp0i, hp1r, hp1i,
                       hp2r, hp2i, hc0r, hc0i, hc1r, hc1i, hc2r, hc2i};
#pragma unroll
  for (int k = 0; k < 15; ++k) ist_out[k * C + c] = fin[k];
}

}  // namespace

// polar_a: i16 [65536]; rect: u16 [91 * 256] (rect_re | rect_im << 8 at
// (r >> 1) * 256 + a); pw: i32 [nsamp + 1, C] polar words (angle & 0xFFFF
// | radius << 16). Both tables 16-byte aligned.
extern "C" int hs_demod_launch(const HsArgs* a, const void* polar_a,
                               const void* rect, const void* pw,
                               const void* mu_in, void* mu_out,
                               const void* ist_in, void* ist_out, void* out,
                               void* freq, void* meta, int C, int nsamp,
                               void* stream) {
  if (C < 1 || nsamp < 0 || nsamp % CHUNK || a->meas_decimation < 1 ||
      ((uintptr_t)polar_a | (uintptr_t)rect) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (C + LANES - 1) / LANES;
  hs_kernel<<<blocks, LANES, SMEM_BYTES, (cudaStream_t)stream>>>(
      *a, (const short*)polar_a, (const unsigned short*)rect, (const int*)pw,
      (const float*)mu_in, (float*)mu_out, (const int*)ist_in, (int*)ist_out,
      (int32_t*)out, (float*)freq, (int*)meta, C, nsamp);
  return (int)cudaGetLastError();
}
