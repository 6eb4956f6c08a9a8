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
// sample two rect gathers at indices that depend on the phase, a float
// multiply and truncation by mu, a polar gather at the interpolated
// point, and the loop's integer and float operations. The bound is that
// chain's latency times the samples, not bytes or operations;
// parallelism comes only from channels.
//
// Design (simple first): one warp per block of 32 channels, one thread
// per channel, the loop state in registers. The wrapper hands the polar
// index (re * 256 + im) of every sample as [nsamp+1, C] int32 rows; at
// each chunk's start a thread gathers its channel's CHUNK + 1 polar
// angles and radii (state-independent, as JAX hoists them out of its
// scan) into a shared-memory tile, so only the state-dependent gathers
// stay in the loop. The rect planes (u8, 64 KB each) and the polar angle
// plane (i16, 128 KB) are read with __ldg; a later PR could hold the two
// rect planes in shared memory (128 KB). The sincos table's only
// reachable entries, ((arg & 0xC000) + 8192) & 0xFFFF, are four: the
// wrapper reads them from the table and passes them in the arguments.
// Symbols and valid flags leave as one packed word per sample (bits
// 16..23 symbol, bit 24 valid, as the demod kernels), staged per chunk
// in shared memory; per chunk freq, nmeas and the last emitted point.
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

__device__ __forceinline__ int s8(int v) { return ((v & 0xFF) ^ 0x80) - 0x80; }

__global__ void __launch_bounds__(LANES)
hs_kernel(const HsArgs A, const short* __restrict__ polar_a,
          const unsigned char* __restrict__ polar_r,
          const unsigned char* __restrict__ rect_re,
          const unsigned char* __restrict__ rect_im,
          const int* __restrict__ flat, const float* __restrict__ mu_in,
          float* __restrict__ mu_out, const int* __restrict__ ist_in,
          int* __restrict__ ist_out, int32_t* __restrict__ out,
          float* __restrict__ freq, int* __restrict__ meta, int C,
          int nsamp) {
  __shared__ int pol[(CHUNK + 1) * LANES];   // polar angle | radius << 16
  __shared__ int32_t os[CHUNK * LANES];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * LANES;
  const int c = c0 + lane;
  const bool active = c < C;
  const int nchunks = nsamp / CHUNK;
  const int nl = min(LANES, C - c0);
  float mu = active ? mu_in[c] : 0.0f;
  int st[15];
#pragma unroll
  for (int k = 0; k < 15; ++k) st[k] = active ? ist_in[k * C + c] : 0;
  int phase = st[0], freqw = st[1], meas_count = st[2];
  int hp0r = st[3], hp0i = st[4], hp1r = st[5], hp1i = st[6];
  int hp2r = st[7], hp2i = st[8];
  int hc0r = st[9], hc0i = st[10], hc1r = st[11], hc1i = st[12];
  int hc2r = st[13], hc2i = st[14];

  for (int ck = 0; ck < nchunks; ++ck) {
    const int base = ck * CHUNK;
    // The chunk's polar coordinates (its CHUNK + 1 samples).
    for (int r = 0; r <= CHUNK; ++r) {     // (zeros past C)
      const int f = active ? __ldg(flat + (size_t)(base + r) * C + c) : -1;
      pol[r * LANES + lane] = f < 0 ? 0
                                    : ((int)__ldg(polar_a + f) & 0xFFFF) |
                                          ((int)__ldg(polar_r + f) << 16);
    }
    int l_re = 0, l_im = 0, l_ok = 0;
    for (int t = 0; t < CHUNK; ++t) {
      const int q0 = pol[t * LANES + lane], q1 = pol[(t + 1) * LANES + lane];
      const int p0a = (int)(short)(q0 & 0xFFFF), p0r = q0 >> 16;
      const int p1a = (int)(short)(q1 & 0xFFFF), p1r = q1 >> 16;
      const bool emit = mu < 1.0f;
      const int a0 = ((p0a - phase) & 0xFFFF) >> (16 - RLUT_BITS);
      const int r0 = a0 * 256 + (p0r >> 1);
      const int a1 = ((p1a - (phase + freqw)) & 0xFFFF) >> (16 - RLUT_BITS);
      const int r1 = a1 * 256 + (p1r >> 1);
      const int p0r_re = __ldg(rect_re + r0), p0r_im = __ldg(rect_im + r0);
      const int p1r_re = __ldg(rect_re + r1), p1r_im = __ldg(rect_im + r1);
      // s = p0r + (p1r-p0r)*mu: float multiply, truncation, u8 wrap
      const int s_re =
          (p0r_re + __float2int_rz((float)(p1r_re - p0r_re) * mu)) & 0xFF;
      const int s_im =
          (p0r_im + __float2int_rz((float)(p1r_im - p0r_im) * mu)) & 0xFF;
      const int arg = (int)__ldg(polar_a + s_re * 256 + s_im) & 0xFFFF;
      const int quadrant = arg >> 14;
      // PLL in 16-bit fixed point (sdr.h:1072-1075)
      const int pe = (arg & 16383) - 8192;
      const int phase_u = phase + ((pe * A.freq_alpha + 32768) >> 16);
      const int freqw_u = freqw + ((pe * A.freq_beta + 32768 * 256) >> 24);
      // Integer modified M&M (sdr.h:1099-1108)
      const int c_re = A.sc_re[quadrant], c_im = A.sc_im[quadrant];
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
      const int q = nl >> 2;
      for (int i = lane; i < CHUNK * q; i += LANES) {
        const int r = i / q, j = i - r * q;
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

extern "C" int hs_demod_launch(const HsArgs* a, const void* polar_a,
                               const void* polar_r, const void* rect_re,
                               const void* rect_im, const void* flat,
                               const void* mu_in, void* mu_out,
                               const void* ist_in, void* ist_out, void* out,
                               void* freq, void* meta, int C, int nsamp,
                               void* stream) {
  if (C < 1 || nsamp < 0 || nsamp % CHUNK || a->meas_decimation < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (C + LANES - 1) / LANES;
  hs_kernel<<<blocks, LANES, 0, (cudaStream_t)stream>>>(
      *a, (const short*)polar_a, (const unsigned char*)polar_r,
      (const unsigned char*)rect_re, (const unsigned char*)rect_im,
      (const int*)flat, (const float*)mu_in, (float*)mu_out,
      (const int*)ist_in, (int*)ist_out, (int32_t*)out, (float*)freq,
      (int*)meta, C, nsamp);
  return (int)cudaGetLastError();
}
