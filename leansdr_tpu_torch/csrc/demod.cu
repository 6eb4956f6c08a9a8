// Demod kernel: carrier PLL + Mueller&Muller timing + soft demap, one
// sequential recurrence per channel (reference sdr.h:697-938).
//
// Replaces the Pallas TPU kernel leansdr_tpu/dsp/receiver_pallas.py
// `_demod_kernel` (entry point `demod_pallas`). The plain PyTorch version
// of the same arithmetic is `demod_ref` in
// leansdr_tpu_torch/dsp/receiver_kernel.py; the wrapper `demod` there
// launches this kernel through `demod_launch`.
//
// What bounds it on an H100: the per-sample recurrence is strictly
// serial (the PLL phase, M&M mu and the 3-deep history feed the next
// sample), so one channel is one dependency chain of float operations
// and a sincosf per sample. Each channel's data is tiny (8 bytes in, 4
// bytes out per sample), so the bound is the latency of that chain times
// the number of samples, not bytes or peak FLOP/s; parallelism comes
// only from channels. chip_smoke.py counts the chain from this kernel's
// SASS.
//
// Design: one warp per block of 32 channels, one thread per channel, all
// loop state in registers. The wrapper transposes the input to
// [nsamp+1, C] float2, so a warp's 32 channels are one contiguous row
// per sample. Nothing on the chain waits for device memory: each
// thread stages its own channel's next chunk (CHUNK + 1 rows, the last
// one the linear sampler's lookahead) into a two-stage ring in shared
// memory with cp.async while it runs the current chunk, and reads x0 and
// x1 from shared memory. (In a fleet each sample's row is C * 8 bytes
// past the last and a chunk's input exceeds the L2, so a load inside the
// loop would wait a device-memory latency per sample.) The packed words
// go to a [CHUNK, 32] int32 tile in shared memory and leave once per
// chunk (16 bytes per store where C % 4 == 0). The constellation tables sit in
// shared memory. Lanes past C run on zero-filled rows and store nothing.
//
// The QPSK phase error (PE_TABLE). For QPSK the decision's phase error
// pe16 is a function of the quantized sample (i8, q8) alone: the symbol's
// phase follows from their signs. So the QPSK instance looks pe16 up in a
// 256 x 256 int16 table, index (i8 + 128) * 256 + (q8 + 128), one 16-bit
// shared-memory load where the polynomial atan2, its division and the
// fold took ~110 cycles of the chain. pe16_table_kernel fills the table
// once per constellation on the card from the very functions the loop
// would call (atan2_poly, pe16_of), so the words and state stay equal to
// the plain version's bit for bit; each block copies it into shared
// memory with cp.async behind its first chunk's rows. Off the grid (the
// halving cap of 12 binds, or the sample is NaN) the loop calls pe16_of
// itself: a rare, exact path, out of line. Shared memory per block:
// 66,048 B of input ring + 16,384 B of out tile + 131,072 B of table +
// 48 B of constellation (213,552 B of the 232,448 a block may have), so
// one block per SM: the wrapper takes this instance while the blocks
// (32 channels each) fit on the SMs in one wave, which covers every
// main path (C <= 512). Wider launches, and every other constellation
// (whose phase comes from the nearest-symbol search), keep the 82.4 KB
// layout without the table: two blocks per SM, 8192 channels one wave.
//
// Exactness: symbol, valid and cost must equal the plain version's, and
// the recurrence amplifies any rounding difference. This file is built
// with --fmad=false and without fast math (leansdr_tpu_torch/device.py),
// uses IEEE sqrtf and division and the IEEE sincosf (one range reduction
// for both; chip_smoke.py holds it against torch.cos and torch.sin on
// all 65536 u16 angles the loop can see, through demod_sincos_launch),
// and writes every expression in the plain version's operation order,
// so each operation rounds once, exactly as the PyTorch ops do. Bit
// tricks are kept as in the TPU kernel: the truncate-then-wrap of the
// u16 angle, the halving count from exponent bits, and the pe16 sign
// fold.

#include <cstdint>
#include <cuda_runtime.h>

#define CHUNK 128
#define NSTATE 19

struct DemodArgs {
  float omega, freq_alpha, freq_beta, gain_mu, kest, one_minus_kest;
  float min_freqw, max_freqw, mid_freqw, max_mucorr, sig_scale;
  float atan_c[7];
  int nsym, qpsk, bpsk_mer, allow_drift;
};

namespace {

constexpr float K2PI = (float)(2 * 3.14159265358979323846 / 65536);
constexpr float K16 = (float)(65536 / (2 * 3.14159265358979323846));
constexpr float PI_F = (float)3.14159265358979323846;
constexpr float HALF_PI_F = (float)(3.14159265358979323846 / 2);
constexpr int B_HI = 0x42FE0000;   // bits(127.0f)
constexpr int B_LO = 0x43000000;   // bits(128.0f)

// expi(float a): truncate toward zero, then wrap mod 65536, as radians.
__device__ __forceinline__ float wrap_angle(float v) {
  float idx = truncf(v);
  idx = idx - floorf(idx / 65536.0f) * 65536.0f;
  return idx * K2PI;
}

// cos and sin of a u16 angle in radians (the rotation's cosf/sinf).
__device__ __forceinline__ void rotation(float a, float& c, float& s) {
  sincosf(a, &s, &c);
}

__device__ __forceinline__ int kceil(float v, int bref, float bound) {
  if (!(v > bound)) return 0;
  int b = __float_as_int(v);
  return (b - bref + 0x7FFFFF) >> 23;
}

__device__ __forceinline__ float atan2_poly(const DemodArgs& A, float q,
                                            float i) {
  float ax = fabsf(i), ay = fabsf(q);
  float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  float r = mx > 0.0f ? mn / mx : 0.0f;
  float u = r * r;
  float p = A.atan_c[6];
#pragma unroll
  for (int k = 5; k >= 0; --k) p = p * u + A.atan_c[k];
  float t = r * p;
  t = ay > ax ? HALF_PI_F - t : t;
  t = i < 0.0f ? PI_F - t : t;
  return q < 0.0f ? -t : t;
}

// The phase error of the decision at (i8, q8) against the symbol phase
// ph_sym, in u16 angle units, truncated and sign-folded to int16.
__device__ __forceinline__ int pe16_of(const DemodArgs& A, float q8,
                                       float i8, float ph_sym) {
  const float ph_err = atan2_poly(A, q8, i8) - ph_sym;
  const int pe_i = (int)truncf(ph_err * K16);
  return ((pe_i & 0xFFFF) ^ 0x8000) - 0x8000;
}

// pe16_of off the table's grid: out of line, so that the rare path
// (the halving cap binds, or NaN) keeps its division and polynomial off
// the table instance's loop.
__device__ __noinline__ int pe16_off_grid(const DemodArgs& A, float q8,
                                          float i8, float ph_sym) {
  return pe16_of(A, q8, i8, ph_sym);
}

// truncf(v) as an int clamped to [-128, 127] (a float-to-integer cvt
// saturates to its type; NaN gives 0): a grid index that is always in
// the table, computed beside the float truncf.
__device__ __forceinline__ int trunc_s8(float v) {
  int r;
  asm("cvt.rzi.s8.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// The QPSK symbol's phase from the signs of (i8, q8): the symbol order
// of the sign-quadrant grid, 0:(+,+) 1:(+,-) 2:(-,+) 3:(-,-).
__device__ __forceinline__ float qpsk_phase(const float qph[4], bool neg_i,
                                            bool neg_q) {
  return neg_q ? (neg_i ? qph[3] : qph[1]) : (neg_i ? qph[2] : qph[0]);
}

constexpr int LANES = 32;          // channels per block: one warp
constexpr int ROWS = CHUNK + 1;    // a chunk's samples and its lookahead
constexpr int STAGES = 2;          // input ring: the chunk run, the next
constexpr size_t X_BYTES = (size_t)STAGES * ROWS * LANES * sizeof(float2);
constexpr size_t OUT_BYTES = (size_t)CHUNK * LANES * sizeof(int32_t);
constexpr int MAX_SYM = 256;
constexpr int PE_ENTRIES = 256 * 256;   // the QPSK phase-error table
constexpr size_t PE_BYTES = PE_ENTRIES * sizeof(int16_t);

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Every group but the newest has landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows base .. base + CHUNK of channel c into this lane's column of one
// ring stage (zeros for a lane past C).
__device__ __forceinline__ void stage_rows(float2* stage,
                                           const float2* __restrict__ x,
                                           int C, int c, bool active,
                                           int base) {
  const float2* src = x + (size_t)base * C + (active ? c : 0);
  float2* dst = stage + threadIdx.x;
  for (int r = 0; r < ROWS; ++r)
    cp_async8(dst + r * LANES, src + (size_t)r * C, active);
}

// PE_TABLE (QPSK only): pe16 from the table pe_tab [PE_ENTRIES] that
// pe16_table_kernel filled, copied into shared memory behind the first
// chunk's rows.
template <bool QPSK, bool PE_TABLE>
__global__ void __launch_bounds__(LANES)
demod_kernel(const DemodArgs A, const float* __restrict__ sym,
             const int16_t* __restrict__ pe_tab,
             const float2* __restrict__ x, const float* __restrict__ st_in,
             float* __restrict__ st_out, int32_t* __restrict__ out, int C,
             int nsamp) {
  static_assert(QPSK || !PE_TABLE, "the table is QPSK's");
  extern __shared__ __align__(16) unsigned char smem[];
  float2* xs = reinterpret_cast<float2*>(smem);
  int32_t* os = reinterpret_cast<int32_t*>(smem + X_BYTES);
  int16_t* pe = reinterpret_cast<int16_t*>(smem + X_BYTES + OUT_BYTES);
  float* tab = reinterpret_cast<float*>(smem + X_BYTES + OUT_BYTES +
                                        (PE_TABLE ? PE_BYTES : 0));
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * LANES;
  const int c = c0 + lane;
  const bool active = c < C;
  const int nchunks = nsamp / CHUNK;
  if (nchunks > 0) stage_rows(xs, x, C, c, active, 0);
  cp_async_commit();
  if (PE_TABLE && nchunks > 0) {
    for (int i = lane; i < (int)(PE_BYTES / 16); i += LANES)
      cp_async16(reinterpret_cast<unsigned char*>(pe) + 16 * i,
                 reinterpret_cast<const unsigned char*>(pe_tab) + 16 * i);
    cp_async_commit();
  }

  for (int i = lane; i < 3 * A.nsym; i += LANES) tab[i] = sym[i];
  float st[NSTATE];
#pragma unroll
  for (int k = 0; k < NSTATE; ++k) st[k] = active ? st_in[k * C + c] : 0.0f;
  float mu = st[0], phase = st[1], freqw = st[2], agc_gain = st[3];
  float est_insp = st[4], est_sp = st[5], est_ep = st[6];
  float p0r = st[7], p0i = st[8], p1r = st[9], p1i = st[10];
  float p2r = st[11], p2i = st[12];
  float c0r = st[13], c0i = st[14], c1r = st[15], c1i = st[16];
  float c2r = st[17], c2i = st[18];
  __syncwarp();

  // Constellation tables [3, nsym]: re, im, phase.
  const float* sym_re = tab;
  const float* sym_im = tab + A.nsym;
  const float* sym_phase = tab + 2 * A.nsym;
  const float a = sym_re[0];
  float qph[4] = {0.f, 0.f, 0.f, 0.f};
  if (QPSK)
    for (int k = 0; k < 4; ++k) qph[k] = sym_phase[k];
  const int nl = min(LANES, C - c0);       // this block's channels
  for (int ck = 0; ck < nchunks; ++ck) {
    const int base = ck * CHUNK;
    if (ck + 1 < nchunks)
      stage_rows(xs + ((ck + 1) & 1) * ROWS * LANES, x, C, c, active,
                 base + CHUNK);
    cp_async_commit();
    cp_async_wait_prior();                 // this chunk's rows are in
    if (PE_TABLE && ck == 0) __syncwarp();   // and every lane's table share
    const float2* xk = xs + (ck & 1) * ROWS * LANES + lane;
    // pin1's rotation = pin0's advanced by the chunk-constant step.
    const float a_d = wrap_angle(-freqw);
    float dcos, dsin;
    rotation(a_d, dcos, dsin);
    float lsg_re = 0.f, lsg_im = 0.f, ls_re = 0.f, ls_im = 0.f;
    float lc_re = 0.f, lc_im = 0.f;
    bool any_sym = false;
    for (int t = 0; t < CHUNK; ++t) {
      const float2 x0 = xk[t * LANES];
      const float2 x1 = xk[(t + 1) * LANES];
      const bool emit = mu < 1.0f;
      const float a0 = wrap_angle(-phase);
      float cr0, sr0;
      rotation(a0, cr0, sr0);
      const float cr1 = cr0 * dcos - sr0 * dsin;
      const float sr1 = sr0 * dcos + cr0 * dsin;
      const float sg0_re = x0.x * cr0 - x0.y * sr0;
      const float sg0_im = x0.x * sr0 + x0.y * cr0;
      const float sg1_re = x1.x * cr1 - x1.y * sr1;
      const float sg1_im = x1.x * sr1 + x1.y * cr1;
      const float omu = 1.0f - mu;
      const float sg_re = sg0_re * omu + sg1_re * mu;
      const float sg_im = sg0_im * omu + sg1_im * mu;
      const float s_re = sg_re * agc_gain;
      const float s_im = sg_im * agc_gain;

      // Out-of-range halving (sdr.h:470-485) as one exact power of 2.
      int k_half = max(max(kceil(s_re, B_HI, 127.0f),
                           kceil(-s_re, B_LO, 128.0f)),
                       max(kceil(s_im, B_HI, 127.0f),
                           kceil(-s_im, B_LO, 128.0f)));
      k_half = min(k_half, 12);
      const float scale = __int_as_float((127 - k_half) << 23);
      const float i8 = truncf(s_re * scale);
      const float q8 = truncf(s_im * scale);

      float d1, d2, cpt_re, cpt_im, ph_sym;
      int near;
      if (QPSK) {
        const float ai = fabsf(i8), aq = fabsf(q8);
        const float di = ai - a, dq = aq - a;
        d1 = di * di + dq * dq;
        d2 = d1 + (4.0f * a) * fminf(ai, aq);
        const bool neg_i = i8 < 0.0f, neg_q = q8 < 0.0f;
        near = (int)neg_i * 2 + (int)neg_q;
        cpt_re = neg_i ? -a : a;
        cpt_im = neg_q ? -a : a;
        ph_sym = qpsk_phase(qph, neg_i, neg_q);
      } else {
        d1 = 3.4e38f;
        d2 = 3.4e38f;
        near = 0;
        cpt_re = cpt_im = ph_sym = 0.0f;
        for (int s = 0; s < A.nsym; ++s) {
          const float sre = sym_re[s], sim = sym_im[s];
          const float dr = i8 - sre;
          const float dim = q8 - sim;
          const float ds = dr * dr + dim * dim;
          const bool better = ds < d1;
          d2 = better ? d1 : fminf(d2, ds);
          if (better) {
            d1 = ds;
            near = s;
            cpt_re = sre;
            cpt_im = sim;
            ph_sym = sym_phase[s];
          }
        }
      }
      const float cost = fminf(d1, 32767.0f) - fminf(d2, 32767.0f);

      int pe16;
      if (PE_TABLE) {
        // One shared load, indexed from the products that truncf rounds
        // (clamped: the load waits for no range test); off the grid
        // [-128, 127]^2 (the halving cap binds, or NaN) computed.
        pe16 = pe[(trunc_s8(s_re * scale) + 128) * 256 +
                  trunc_s8(s_im * scale) + 128];
        if (!(i8 >= -128.0f && i8 <= 127.0f && q8 >= -128.0f && q8 <= 127.0f))
          pe16 = pe16_off_grid(A, q8, i8, ph_sym);
      } else {
        pe16 = pe16_of(A, q8, i8, ph_sym);
      }
      const float perr_f = (float)pe16;

      // PLL (sdr.h:813-815)
      const float phase_u = phase + perr_f * A.freq_alpha;
      const float freqw_u = freqw + perr_f * A.freq_beta;
      // modified M&M (sdr.h:817-840)
      const float muerr = ((s_re - p1r) * c0r + (s_im - p1i) * c0i) -
                          ((cpt_re - c1r) * p0r + (cpt_im - c1i) * p0i);
      const float mucorr = fminf(fmaxf(muerr * A.gain_mu, -A.max_mucorr),
                                 A.max_mucorr);
      const float mu_u = mu + mucorr + A.omega;

      if (emit) {
        mu = mu_u;
        phase = phase_u;
        freqw = freqw_u;
        p2r = p1r; p2i = p1i; p1r = p0r; p1i = p0i; p0r = s_re; p0i = s_im;
        c2r = c1r; c2i = c1i; c1r = c0r; c1i = c0i;
        c0r = cpt_re; c0i = cpt_im;
        lsg_re = sg_re; lsg_im = sg_im;
        ls_re = s_re; ls_im = s_im;
        lc_re = cpt_re; lc_im = cpt_im;
        any_sym = true;
      }
      os[t * LANES + lane] =
          (int32_t)(-cost) | (near << 16) | ((int)emit << 24);
      mu = mu - 1.0f;
      phase = phase + freqw;
    }

    // ---- chunk-end updates (sdr.h:852-898) ----
    phase = phase - truncf(phase / 65536.0f) * 65536.0f;   // fmodf
    if (any_sym) {
      const float insp = lsg_re * lsg_re + lsg_im * lsg_im;
      est_insp = insp * A.kest + est_insp * A.one_minus_kest;
      if (est_insp > 0.0f) agc_gain = 75.0f / sqrtf(est_insp);
      const float ev_re = ls_re - lc_re, ev_im = ls_im - lc_im;
      float sig_power, ev_power;
      if (A.bpsk_mer) {
        const float sig_r = (lc_re + lc_im) * A.sig_scale;
        const float evr = (ev_re + ev_im) * A.sig_scale;
        sig_power = sig_r * sig_r;
        ev_power = evr * evr;
      } else {
        sig_power = lc_re * lc_re + lc_im * lc_im;
        ev_power = ev_re * ev_re + ev_im * ev_im;
      }
      est_sp = sig_power * A.kest + est_sp * A.one_minus_kest;
      est_ep = ev_power * A.kest + est_ep * A.one_minus_kest;
    }
    if (!A.allow_drift && (freqw < A.min_freqw || freqw > A.max_freqw))
      freqw = A.mid_freqw;

    // The chunk's packed words, [CHUNK, nl] of out at row base.
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
  const float fin[NSTATE] = {mu, phase, freqw, agc_gain, est_insp, est_sp,
                             est_ep, p0r, p0i, p1r, p1i, p2r, p2i,
                             c0r, c0i, c1r, c1i, c2r, c2i};
#pragma unroll
  for (int k = 0; k < NSTATE; ++k) st_out[k * C + c] = fin[k];
}

// The QPSK phase-error table: pe16_of at every (i8, q8) of the grid,
// entry (i8 + 128) * 256 + (q8 + 128), against the phase of the symbol
// their signs choose (qph: the constellation's four phases).
__global__ void pe16_table_kernel(const DemodArgs A,
                                  const float* __restrict__ qph,
                                  int16_t* __restrict__ pe_tab) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= PE_ENTRIES) return;
  const float i8 = (float)((k >> 8) - 128), q8 = (float)((k & 255) - 128);
  const float ph[4] = {qph[0], qph[1], qph[2], qph[3]};
  pe_tab[k] = (int16_t)pe16_of(A, q8, i8,
                               qpsk_phase(ph, i8 < 0.0f, q8 < 0.0f));
}

__global__ void sincos_kernel(const float* __restrict__ a,
                              float* __restrict__ c, float* __restrict__ s,
                              int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) rotation(a[i], c[i], s[i]);
}

}  // namespace

// pe_tab: the QPSK phase-error table (demod_pe_table_launch) for the
// table instance, or null for the layout without it.
extern "C" int demod_launch(const DemodArgs* args, const void* sym,
                            const void* pe_tab, const void* x,
                            const void* st_in, void* st_out, void* out,
                            int C, int nsamp, void* stream) {
  if (args->nsym < 1 || args->nsym > MAX_SYM || (pe_tab && !args->qpsk))
    return (int)cudaErrorInvalidValue;
  const size_t smem = X_BYTES + OUT_BYTES + (pe_tab ? PE_BYTES : 0) +
                      3 * sizeof(float) * args->nsym;
  const int blocks = (C + LANES - 1) / LANES;
  auto kernel = pe_tab       ? demod_kernel<true, true>
                : args->qpsk ? demod_kernel<true, false>
                             : demod_kernel<false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, LANES, smem, (cudaStream_t)stream>>>(
      *args, (const float*)sym, (const int16_t*)pe_tab, (const float2*)x,
      (const float*)st_in, (float*)st_out, (int32_t*)out, C, nsamp);
  return (int)cudaGetLastError();
}

// Fill pe_tab [65536] int16 with the QPSK phase-error table for the four
// symbol phases qph (float32 on the device).
extern "C" int demod_pe_table_launch(const DemodArgs* args, const void* qph,
                                     void* pe_tab, void* stream) {
  pe16_table_kernel<<<PE_ENTRIES / 256, 256, 0, (cudaStream_t)stream>>>(
      *args, (const float*)qph, (int16_t*)pe_tab);
  return (int)cudaGetLastError();
}

// The loop's rotation on n angles, for the check against torch.cos and
// torch.sin (chip_smoke.py); not a launch of the demod.
extern "C" int demod_sincos_launch(const void* a, void* c, void* s, int n,
                                   void* stream) {
  sincos_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)a, (float*)c, (float*)s, n);
  return (int)cudaGetLastError();
}
