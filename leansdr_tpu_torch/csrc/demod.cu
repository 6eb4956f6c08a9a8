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
// sample), so one channel is one dependency chain of ~100 float
// operations plus a sinf/cosf pair per sample. Each channel's data is
// tiny (8 bytes in, 4 bytes out per sample), so the bound is the
// latency of that chain times the number of samples, not bytes or peak
// FLOP/s; parallelism comes only from channels.
//
// Design: one thread per channel, all loop state in registers, inputs
// pre-transposed by the wrapper to [nsamp+1, C] float2 so a warp's 32
// channels load one contiguous 256-byte row per sample, and the packed
// output [nsamp, C] int32 is stored the same way. Each sample's
// lookahead (the linear sampler's pin1) is the next sample, carried in
// registers so every input is read once. 32-thread blocks spread small
// fleets over as many SMs as there are warps. At 64 channels that fills
// two SMs of 132: the segmented demod (a later slice) is what widens it.
//
// Exactness: symbol, valid and cost must equal the plain version's, and
// the recurrence amplifies any rounding difference. This file is built
// with --fmad=false and without fast math (leansdr_tpu_torch/device.py),
// uses IEEE cosf/sinf/sqrtf and division, and writes every expression in
// the plain version's operation order, so each operation rounds once,
// exactly as the PyTorch ops do. Bit tricks are kept as in the TPU
// kernel: the truncate-then-wrap of the u16 angle, the halving count
// from exponent bits, and the pe16 sign fold.

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

__global__ void __launch_bounds__(32)
demod_kernel(const DemodArgs A, const float* __restrict__ sym,
             const float2* __restrict__ x, const float* __restrict__ st_in, float* __restrict__ st_out,
             int32_t* __restrict__ out, int C, int nsamp) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float mu = st_in[0 * C + c], phase = st_in[1 * C + c];
  float freqw = st_in[2 * C + c], agc_gain = st_in[3 * C + c];
  float est_insp = st_in[4 * C + c], est_sp = st_in[5 * C + c];
  float est_ep = st_in[6 * C + c];
  float p0r = st_in[7 * C + c], p0i = st_in[8 * C + c];
  float p1r = st_in[9 * C + c], p1i = st_in[10 * C + c];
  float p2r = st_in[11 * C + c], p2i = st_in[12 * C + c];
  float c0r = st_in[13 * C + c], c0i = st_in[14 * C + c];
  float c1r = st_in[15 * C + c], c1i = st_in[16 * C + c];
  float c2r = st_in[17 * C + c], c2i = st_in[18 * C + c];

  // Constellation tables [3, nsym]: re, im, phase.
  const float* sym_re = sym;
  const float* sym_im = sym + A.nsym;
  const float* sym_phase = sym + 2 * A.nsym;
  const float a = sym_re[0];
  float qph[4] = {0.f, 0.f, 0.f, 0.f};
  if (A.qpsk)
    for (int k = 0; k < 4; ++k) qph[k] = sym_phase[k];
  float2 xnext = x[c];
  for (int base = 0; base < nsamp; base += CHUNK) {
    // pin1's rotation = pin0's advanced by the chunk-constant step.
    const float a_d = wrap_angle(-freqw);
    const float dcos = cosf(a_d), dsin = sinf(a_d);
    float lsg_re = 0.f, lsg_im = 0.f, ls_re = 0.f, ls_im = 0.f;
    float lc_re = 0.f, lc_im = 0.f;
    bool any_sym = false;
    for (int t = 0; t < CHUNK; ++t) {
      const int g = base + t;
      const float2 x0 = xnext;
      const float2 x1 = x[(size_t)(g + 1) * C + c];
      xnext = x1;
      const bool emit = mu < 1.0f;
      const float a0 = wrap_angle(-phase);
      const float cr0 = cosf(a0), sr0 = sinf(a0);
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
      if (A.qpsk) {
        const float ai = fabsf(i8), aq = fabsf(q8);
        const float di = ai - a, dq = aq - a;
        d1 = di * di + dq * dq;
        d2 = d1 + (4.0f * a) * fminf(ai, aq);
        const bool neg_i = i8 < 0.0f, neg_q = q8 < 0.0f;
        near = (int)neg_i * 2 + (int)neg_q;
        cpt_re = neg_i ? -a : a;
        cpt_im = neg_q ? -a : a;
        ph_sym = neg_q ? (neg_i ? qph[3] : qph[1]) : (neg_i ? qph[2] : qph[0]);
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

      const float ph_err = atan2_poly(A, q8, i8) - ph_sym;
      const int pe_i = (int)truncf(ph_err * K16);
      const int pe16 = ((pe_i & 0xFFFF) ^ 0x8000) - 0x8000;
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
      out[(size_t)g * C + c] =
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
  }
  const float fin[NSTATE] = {mu, phase, freqw, agc_gain, est_insp, est_sp,
                             est_ep, p0r, p0i, p1r, p1i, p2r, p2i,
                             c0r, c0i, c1r, c1i, c2r, c2i};
#pragma unroll
  for (int k = 0; k < NSTATE; ++k) st_out[k * C + c] = fin[k];
}

}  // namespace

extern "C" int demod_launch(const DemodArgs* args, const void* sym,
                            const void* x,
                            const void* st_in, void* st_out, void* out,
                            int C, int nsamp, void* stream) {
  const int threads = 32;
  const int blocks = (C + threads - 1) / threads;
  demod_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *args, (const float*)sym, (const float2*)x, (const float*)st_in, (float*)st_out,
      (int32_t*)out, C, nsamp);
  return (int)cudaGetLastError();
}
