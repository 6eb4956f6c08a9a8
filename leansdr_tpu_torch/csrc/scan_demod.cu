// Scan demod kernel: carrier PLL + Mueller&Muller timing + decisions, one
// sequential recurrence per channel (reference sdr.h:697-938), with the
// nearest, linear or polyphase rrc sampler and the exact-LUT or computed
// decisions.
//
// There is no Pallas kernel behind it: the JAX package runs this path as
// a `lax.scan` (leansdr_tpu/dsp/receiver.py:177-440, `run_chunks_impl`:
// `sample_step` per sample, `chunk_step` per chunk of 128). The plain
// PyTorch version of the same arithmetic is `run_chunks_ref` in
// leansdr_tpu_torch/dsp/receiver.py; the wrapper `run_chunks` there
// launches this kernel through `scan_demod_launch`.
//
// What bounds it on an H100: the per-sample recurrence is serial (PLL
// phase, M&M mu and the 3-deep history feed the next sample), so one
// channel is one dependency chain per emitted symbol: a table gather (or
// sincosf) at an index that depends on the phase, the sampler, a LUT
// gather (or the computed decision with its IEEE division) at an index
// that depends on the sample, and the loop's float operations. The bound
// is that chain's latency times the samples, not bytes or peak FLOP/s;
// parallelism comes only from channels.
//
// Design: one block of one thread per channel, the loop state in
// registers. A warp of one active lane has no neighbours that emit at
// other samples (a warp of 32 channels takes the emitting step whenever
// one of its lanes does), gathers one line per table load (not 32), and
// needs a few KB of shared memory, so the SM keeps the rest of its 256 KB
// as L1 for the table gathers (each launch asks for the least carveout
// that holds the blocks an SM gets).
// The fleet's 64 channels take 64 SMs; the segmented fleet's 512, about
// four warps per SM, one per scheduler. The wrapper transposes the input
// to [n, C] float2 rows, and the thread stages its channel's next chunk
// (CHUNK + readahead rows: the linear sampler's lookahead or the rrc
// window's taps) into a two-stage ring in shared memory with cp.async
// while it runs the current one, so no input load sits on the chain.
// Samples where no symbol is emitted (mu >= 1) change no state but mu and
// phase and output a zero word. Each sample's packed word is stored as it
// is made; the chunk's measurements (last AGC'd sample, freq, ss, mer,
// nmeas) leave once per chunk.
//
// Per-channel omega (the candidate scan, JAX's omega_per_channel: one
// symbol rate per channel): the loop constants that follow omega (omega,
// freq_beta, min_freqw, max_freqw and the clamp's midpoint) come from a
// [5, C] float plane instead of the scalars in ScanArgs. The block loads
// its channel's five values once, into the registers the scalars would
// be read into, so nothing is added to the serial chain; a null plane
// (every other caller) takes the scalars, and those instances compute
// what they computed before, bit for bit.
//
// The rrc sampler: the channel's shifted coefficients live in shared
// memory (read in from the state plane at launch and written back at the
// end), re-shifted once per ncoeffs*16 samples (sdr.h:667-682). The CLI's
// geometries have instances of their own, the tap count and step as
// template parameters (16 taps in steps of 32 at 4 Msps: 499
// coefficients; 10 in steps of 53 at 2.4 Msps: 497): the window is
// unrolled, all of a symbol's coefficient and input loads issue before
// the sum (at offsets known at compile time), and while only the last tap
// can fall past ncoeffs (mu > -0.37) the others add their products
// unmasked (the mask is 1.0, and x * 1.0 == x). The sum stays in tap
// order from 0. Other geometries run a general instance with a loop.
// Shared memory at 4 Msps: the ring 2 x 144 x 8 = 2,304 bytes, the taps
// 499 x 8 = 3,992, the constellation rows 3 x nsym x 4 = 48; 6,344 in
// all (2.4 Msps: 2,208 + 3,976 + 48 = 6,232). Taps that do not fit
// beside the ring in 232,448 bytes (past 29,000 coefficients) run the
// device-memory instance: the coefficients stay in the [ncoeffs, C] state
// plane and are read through L1, chosen on the host by size
// (dsp/receiver.py, `taps_in_shared`).
//
// Tables: the trig16 table (65536 float2, 512 KB) and the LUT planes
// (cost i16, symbol u8, phase i16; 320 KB) are read with __ldg. The LUT
// gathers stay near the constellation's points, in L1; the trig16 index
// follows the phase, which moves by freqw per sample, so a carrier off
// 0 Hz meets a new line every symbol or two, from L2.
//
// Exactness: every output word and state plane must equal the plain
// version's. This file is built with --fmad=false and without fast math
// (leansdr_tpu_torch/device.py), uses IEEE sqrtf, logf, division and
// sincosf (the demod kernel's rotation, which chip_smoke.py holds against
// torch.cos / torch.sin on all 65536 u16 angles), and writes every
// expression in the plain version's (and the JAX scan's) order: the
// interpolation sg0*(1-mu) + sg1*mu, the muerr brackets, the estimators'
// insp*kest + est*(1-kest), fmodf(phase, 65536), the rrc window summed in
// tap order from 0, the computed phase error (ph_err * 65536) / 2pi. The
// twelve rounds of overflow halving (sdr.h:470-485) are one exact
// multiplication by a power of 2 read from the exponent bits.

#include <cstdint>
#include <cuda_runtime.h>

#define CHUNK 128
#define NSTATE 19

struct ScanArgs {
  float omega, freq_alpha, freq_beta, gain_mu, kest, one_minus_kest;
  float min_freqw, max_freqw, mid_freqw, max_mucorr, sig_scale, ln10;
  float atan_c[7];
  int sampler, exact, nsym, bpsk_mer, allow_drift, meas_decimation;
  int ncoeffs, sub, ntaps, readahead, taps_shared;
};

namespace {

constexpr double PI_D = 3.14159265358979323846;
constexpr float K2PI = (float)(2 * PI_D / 65536);   // u16 angle -> radians
constexpr float TWO_PI_F = (float)(2 * PI_D);
constexpr float PI_F = (float)PI_D;
constexpr float HALF_PI_F = (float)(PI_D / 2);
constexpr int B_HI = 0x42FE0000;   // bits(127.0f)
constexpr int B_LO = 0x43000000;   // bits(128.0f)
constexpr int MAX_SYM = 256;
enum { NEAREST = 0, LINEAR = 1, RRC = 2 };

// expi(float a): the u16 angle trunc(a) & 0xFFFF, as (cos, sin) from the
// trig16 table (EXACT) or computed with sincosf of the angle in radians.
template <bool EXACT>
__device__ __forceinline__ void expi(const float2* __restrict__ trig,
                                     float a, float& c, float& s) {
  const int i = __float2int_rz(a) & 0xFFFF;
  if (EXACT) {
    const float2 e = __ldg(trig + i);
    c = e.x;
    s = e.y;
  } else {
    sincosf((float)i * K2PI, &s, &c);
  }
}

__device__ __forceinline__ int kceil(float v, int bref, float bound) {
  if (!(v > bound)) return 0;
  const int b = __float_as_int(v);
  return (b - bref + 0x7FFFFF) >> 23;
}

__device__ __forceinline__ float atan2_poly(const ScanArgs& A, float q,
                                            float i) {
  const float ax = fabsf(i), ay = fabsf(q);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const float r = mx > 0.0f ? mn / mx : 0.0f;
  const float u = r * r;
  float p = A.atan_c[6];
#pragma unroll
  for (int k = 5; k >= 0; --k) p = p * u + A.atan_c[k];
  float t = r * p;
  t = ay > ax ? HALF_PI_F - t : t;
  t = i < 0.0f ? PI_F - t : t;
  return q < 0.0f ? -t : t;
}

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
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

// Rows base .. base + rows - 1 of channel c into one ring stage.
__device__ __forceinline__ void stage_rows(float2* stage,
                                           const float2* __restrict__ x,
                                           int C, int c, int base, int rows) {
  const float2* src = x + (size_t)base * C + c;
  for (int r = 0; r < rows; ++r) cp_async8(stage + r, src + (size_t)r * C);
}

// The rrc window (fir_sampler.interp, sdr.h:646-665): taps at phase index
// idx0, stride sub, summed in tap order from 0, each masked by okf = (pc <
// ncoeffs) at the clamped index min(pc, ncoeffs - 1). co(pc) reads one
// shifted coefficient. NT > 0 (an instance for NT taps in steps of SUB):
// unrolled, every load issued before the sum; while idx0 + (NT - 2) * SUB
// < ncoeffs (at the CLI's two geometries: for any mu > -0.37) only the
// last tap can be masked, so the others add their product as it is (okf
// 1: x * 1.0 == x) at an index that needs no clamp and an offset known at
// compile time. Otherwise, and for NT == 0, the general loop over
// A.ntaps.
template <int NT, int SUB, typename Co>
__device__ __forceinline__ void rrc_window(const ScanArgs& A, int idx0,
                                           const float2* xk, int t, Co co,
                                           float& acc_re, float& acc_im) {
  acc_re = 0.0f;
  acc_im = 0.0f;
  if (NT > 0 && idx0 < A.ncoeffs - (NT - 2) * SUB) {
    constexpr int N = NT > 0 ? NT : 1;
    float2 cv[N], wv[N];
#pragma unroll
    for (int j = 0; j + 1 < NT; ++j) {
      cv[j] = co(idx0 + j * SUB);
      wv[j] = xk[t + j];
    }
    const int pl = idx0 + (N - 1) * SUB;
    const float okl = pl < A.ncoeffs ? 1.0f : 0.0f;
    cv[N - 1] = co(min(pl, A.ncoeffs - 1));
    wv[N - 1] = xk[t + N - 1];
#pragma unroll
    for (int j = 0; j + 1 < NT; ++j) {
      acc_re = acc_re + (cv[j].x * wv[j].x - cv[j].y * wv[j].y);
      acc_im = acc_im + (cv[j].x * wv[j].y + cv[j].y * wv[j].x);
    }
    const float2 c = cv[N - 1], w = wv[N - 1];
    acc_re = acc_re + okl * (c.x * w.x - c.y * w.y);
    acc_im = acc_im + okl * (c.x * w.y + c.y * w.x);
  } else {
#pragma unroll 1
    for (int j = 0; j < A.ntaps; ++j) {
      const int pc = idx0 + j * A.sub;
      const float okf = pc < A.ncoeffs ? 1.0f : 0.0f;
      const float2 c = co(min(pc, A.ncoeffs - 1));
      const float2 w = xk[t + j];
      acc_re = acc_re + okf * (c.x * w.x - c.y * w.y);
      acc_im = acc_im + okf * (c.x * w.y + c.y * w.x);
    }
  }
}

// SAMPLER x EXACT; for the rrc sampler NT and SUB (NT taps in steps of
// SUB unrolled; NT 0: the general loop) and TAPS_SHARED (the shifted
// coefficients in shared memory, or in the device-memory state plane
// `shifted`). One thread, channel blockIdx.x.
template <int SAMPLER, bool EXACT, int NT, int SUB, bool TAPS_SHARED>
__global__ void __launch_bounds__(1)
scan_kernel(const ScanArgs A, const float2* __restrict__ trig,
            const short* __restrict__ lut_cost,
            const unsigned char* __restrict__ lut_sym,
            const short* __restrict__ lut_phase,
            const float* __restrict__ sym3, const float* __restrict__ coeffs,
            const float* __restrict__ chan, const float2* __restrict__ x,
            const float* __restrict__ fst_in,
            float* __restrict__ fst_out, const int* __restrict__ ist_in,
            int* __restrict__ ist_out, float2* __restrict__ shifted,
            int32_t* __restrict__ out, float* __restrict__ meta,
            int* __restrict__ nmeas, int C, int nsamp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = CHUNK + A.readahead;
  float2* xs = reinterpret_cast<float2*>(smem);           // [2][rows]
  float2* cs = xs + 2 * rows;                             // [ncoeffs]
  float* tab = reinterpret_cast<float*>(
      cs + (SAMPLER == RRC && TAPS_SHARED ? A.ncoeffs : 0));
  const int c = blockIdx.x;
  const int nchunks = nsamp / CHUNK;
  if (SAMPLER == RRC && TAPS_SHARED)         // the state plane's taps
    for (int i = 0; i < A.ncoeffs; ++i)
      cp_async8(cs + i, shifted + (size_t)i * C + c);
  if (nchunks > 0) stage_rows(xs, x, C, c, 0, rows);
  cp_async_commit();
  // The shifted coefficient pc (shared memory or device memory).
  auto co = [&](int pc) {
    return TAPS_SHARED ? cs[pc] : shifted[(size_t)pc * C + c];
  };

  for (int i = 0; i < 3 * A.nsym; ++i) tab[i] = sym3[i];
  float st[NSTATE];
#pragma unroll
  for (int k = 0; k < NSTATE; ++k) st[k] = fst_in[k * C + c];
  float mu = st[0], phase = st[1], freqw = st[2], agc_gain = st[3];
  float est_insp = st[4], est_sp = st[5], est_ep = st[6];
  float p0r = st[7], p0i = st[8], p1r = st[9], p1i = st[10];
  float p2r = st[11], p2i = st[12];
  float c0r = st[13], c0i = st[14], c1r = st[15], c1i = st[16];
  float c2r = st[17], c2i = st[18];
  int meas_count = ist_in[c];
  int rrc_phase = ist_in[C + c];
  const float* sym_re = tab;
  const float* sym_im = tab + A.nsym;
  const float* sym_phase = tab + 2 * A.nsym;
  // The loop constants that follow omega: the scalars, or this channel's
  // column of the per-channel plane.
  float omega = A.omega, freq_beta = A.freq_beta;
  float min_freqw = A.min_freqw, max_freqw = A.max_freqw;
  float mid_freqw = A.mid_freqw;
  if (chan != nullptr) {
    omega = chan[c];
    freq_beta = chan[C + c];
    min_freqw = chan[2 * C + c];
    max_freqw = chan[3 * C + c];
    mid_freqw = chan[4 * C + c];
  }

  for (int ck = 0; ck < nchunks; ++ck) {
    const int base = ck * CHUNK;
    if (ck + 1 < nchunks)
      stage_rows(xs + ((ck + 1) & 1) * rows, x, C, c, base + CHUNK, rows);
    cp_async_commit();
    cp_async_wait_prior();                 // this chunk's rows are in
    const float2* xk = xs + (ck & 1) * rows;
    // sampler->update_freq (sdr.h:790): the chunk-start freqw.
    const float chunk_freqw = freqw;
    float dcos = 1.0f, dsin = 0.0f;
    if (SAMPLER == LINEAR && !EXACT) {
      // The second rotation = the first advanced by the chunk-constant
      // step (the JAX scan's fast path).
      float idx_d = truncf(-chunk_freqw);
      idx_d = idx_d - floorf(idx_d / 65536.0f) * 65536.0f;
      sincosf(idx_d * K2PI, &dsin, &dcos);
    }
    if (SAMPLER == RRC) {
      // Throttled coefficient re-shift (sdr.h:667-682).
      int ph = rrc_phase - CHUNK;
      if (ph <= 0) {
        ph = A.ncoeffs * 16;
        const float f = freqw / (float)A.sub;
        const float half = (float)(A.ncoeffs / 2);
        for (int i = 0; i < A.ncoeffs; ++i) {
          float ec, es;
          expi<EXACT>(trig, -f * ((float)i - half), ec, es);
          const float cf = __ldg(coeffs + i);
          const float2 v = make_float2(ec * cf, es * cf);
          if (TAPS_SHARED)
            cs[i] = v;
          else
            shifted[(size_t)i * C + c] = v;
        }
      }
      rrc_phase = ph;
    }
    float lsg_re = 0.f, lsg_im = 0.f, ls_re = 0.f, ls_im = 0.f;
    float lc_re = 0.f, lc_im = 0.f;
    bool any_sym = false;
    int32_t* words = out + (size_t)base * C + c;
    for (int t = 0; t < CHUNK; ++t) {
      int32_t word = 0;
      if (mu < 1.0f) {     // emit (non-emitted samples: no effect)
        float cr0, sr0;
        expi<EXACT>(trig, -phase, cr0, sr0);
        float sg_re, sg_im;
        if (SAMPLER == LINEAR) {
          const float2 x0 = xk[t];
          const float2 x1 = xk[t + 1];
          float cr1, sr1;
          if (EXACT) {
            expi<true>(trig, -(phase + chunk_freqw), cr1, sr1);
          } else {
            cr1 = cr0 * dcos - sr0 * dsin;
            sr1 = sr0 * dcos + cr0 * dsin;
          }
          const float sg0_re = x0.x * cr0 - x0.y * sr0;
          const float sg0_im = x0.x * sr0 + x0.y * cr0;
          const float sg1_re = x1.x * cr1 - x1.y * sr1;
          const float sg1_im = x1.x * sr1 + x1.y * cr1;
          const float omu = 1.0f - mu;
          sg_re = sg0_re * omu + sg1_re * mu;
          sg_im = sg0_im * omu + sg1_im * mu;
        } else if (SAMPLER == NEAREST) {
          const float2 x0 = xk[t];
          sg_re = x0.x * cr0 - x0.y * sr0;
          sg_im = x0.x * sr0 + x0.y * cr0;
        } else {
          // fir_sampler.interp (sdr.h:646-665): taps at phase index
          // (1-mu)*subsampling, stride subsampling, summed in tap order,
          // then one derotation of the sum.
          const int idx0 = __float2int_rz((1.0f - mu) * (float)A.sub);
          float acc_re, acc_im;
          rrc_window<NT, SUB>(A, idx0, xk, t, co, acc_re, acc_im);
          sg_re = cr0 * acc_re - sr0 * acc_im;
          sg_im = cr0 * acc_im + sr0 * acc_re;
        }
        const float s_re = sg_re * agc_gain;
        const float s_im = sg_im * agc_gain;

        // Out-of-range halving (sdr.h:470-485) as one exact power of 2.
        int k_half = max(max(kceil(s_re, B_HI, 127.0f),
                             kceil(-s_re, B_LO, 128.0f)),
                         max(kceil(s_im, B_HI, 127.0f),
                             kceil(-s_im, B_LO, 128.0f)));
        k_half = min(k_half, 12);
        const float scale = __int_as_float((127 - k_half) << 23);
        const float hi = s_re * scale, hq = s_im * scale;
        int cost, near;
        float cpt_re, cpt_im, perr_f;
        if (EXACT) {
          // lookup_float: the 256x256 LUT at the s8-truncated point.
          const int idx = ((__float2int_rz(hi) & 255) << 8) |
                          (__float2int_rz(hq) & 255);
          cost = __ldg(lut_cost + idx);
          near = __ldg(lut_sym + idx);
          perr_f = (float)__ldg(lut_phase + idx);
          cpt_re = sym_re[near];
          cpt_im = sym_im[near];
        } else {
          // The same decision computed: integer squared distances over
          // the s8 grid, first minimum, second minimum, polynomial atan2.
          const float i8 = truncf(hi), q8 = truncf(hq);
          float d1 = INFINITY, d2 = INFINITY;
          near = 0;
          for (int s = 0; s < A.nsym; ++s) {
            const float dr = i8 - sym_re[s];
            const float di = q8 - sym_im[s];
            const float ds = dr * dr + di * di;
            if (ds < d1) {
              d2 = d1;
              d1 = ds;
              near = s;
            } else {
              d2 = fminf(d2, ds);
            }
          }
          cost = (int)(fminf(d1, 32767.0f) - fminf(d2, 32767.0f));
          cpt_re = sym_re[near];
          cpt_im = sym_im[near];
          const float ph_err = atan2_poly(A, q8, i8) - sym_phase[near];
          const int pe = __float2int_rz((ph_err * 65536.0f) / TWO_PI_F);
          perr_f = (float)(((pe & 0xFFFF) ^ 0x8000) - 0x8000);
        }

        // PLL (sdr.h:813-815)
        const float phase_u = phase + perr_f * A.freq_alpha;
        const float freqw_u = freqw + perr_f * freq_beta;
        // modified M&M (sdr.h:817-840)
        const float muerr = ((s_re - p1r) * c0r + (s_im - p1i) * c0i) -
                            ((cpt_re - c1r) * p0r + (cpt_im - c1i) * p0i);
        const float mucorr =
            fminf(fmaxf(muerr * A.gain_mu, -A.max_mucorr), A.max_mucorr);
        mu = mu + mucorr + omega;
        phase = phase_u;
        freqw = freqw_u;
        p2r = p1r; p2i = p1i; p1r = p0r; p1i = p0i; p0r = s_re; p0i = s_im;
        c2r = c1r; c2i = c1i; c1r = c0r; c1i = c0i;
        c0r = cpt_re; c0i = cpt_im;
        lsg_re = sg_re; lsg_im = sg_im;
        ls_re = s_re; ls_im = s_im;
        lc_re = cpt_re; lc_im = cpt_im;
        any_sym = true;
        word = (int32_t)(-cost) | (near << 16) | (1 << 24);
      }
      words[(size_t)t * C] = word;
      mu = mu - 1.0f;
      phase = phase + freqw;
    }

    // ---- end of chunk (sdr.h:852-913) ----
    phase = fmodf(phase, 65536.0f);
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
    if (!A.allow_drift && (freqw < min_freqw || freqw > max_freqw))
      freqw = mid_freqw;
    meas_count += CHUNK;
    const int nm = meas_count / A.meas_decimation;
    meas_count = meas_count % A.meas_decimation;
    const size_t kc = (size_t)nchunks * C, at = (size_t)ck * C + c;
    meta[at] = ls_re;
    meta[kc + at] = ls_im;
    meta[2 * kc + at] = freqw / 65536.0f;
    meta[3 * kc + at] = sqrtf(est_insp);
    meta[4 * kc + at] =
        est_ep > 0.0f ? (10.0f * logf(est_sp / est_ep)) / A.ln10 : 0.0f;
    nmeas[at] = nm;
  }

  if (SAMPLER == RRC && TAPS_SHARED) {       // the state plane out
    asm volatile("cp.async.wait_all;\n" ::: "memory");   // (no chunks)
    for (int i = 0; i < A.ncoeffs; ++i) shifted[(size_t)i * C + c] = cs[i];
  }
  const float fin[NSTATE] = {mu, phase, freqw, agc_gain, est_insp, est_sp,
                             est_ep, p0r, p0i, p1r, p1i, p2r, p2i,
                             c0r, c0i, c1r, c1i, c2r, c2i};
#pragma unroll
  for (int k = 0; k < NSTATE; ++k) fst_out[k * C + c] = fin[k];
  ist_out[c] = meas_count;
  ist_out[C + c] = rrc_phase;
}

template <int SAMPLER, bool EXACT, int NT = 0, int SUB = 0,
          bool TAPS_SHARED = false>
cudaError_t launch(const ScanArgs* a, size_t smem, cudaStream_t stream,
                   const void* trig, const void* lut_cost,
                   const void* lut_sym, const void* lut_phase,
                   const void* sym3, const void* coeffs, const void* chan,
                   const void* x, const void* fst_in, void* fst_out,
                   const void* ist_in, void* ist_out, void* shifted,
                   void* out, void* meta, void* nmeas, int C, int nsamp) {
  auto kernel = scan_kernel<SAMPLER, EXACT, NT, SUB, TAPS_SHARED>;
  int dev = 0, sms = 1, sm_smem = 1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // The least shared-memory carveout that holds the blocks one SM gets
  // (C over the SMs, each with its 1 KB reserve): the rest of the SM's
  // 256 KB is L1, where the table gathers hit. (The least carveout that
  // holds one block would run C = 512 in four waves.)
  const long long per_sm = (C + sms - 1) / sms;
  const long long pct =
      (100 * per_sm * ((long long)smem + 1024) + sm_smem - 1) / sm_smem;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               pct < 100 ? (int)pct : 100);
  if (err != cudaSuccess) return err;
  kernel<<<C, 1, smem, stream>>>(
      *a, (const float2*)trig, (const short*)lut_cost,
      (const unsigned char*)lut_sym, (const short*)lut_phase,
      (const float*)sym3, (const float*)coeffs, (const float*)chan,
      (const float2*)x,
      (const float*)fst_in, (float*)fst_out, (const int*)ist_in,
      (int*)ist_out, (float2*)shifted, (int32_t*)out, (float*)meta,
      (int*)nmeas, C, nsamp);
  return cudaGetLastError();
}

#define SCAN_ARGS                                                       \
  a, smem, s, trig, lut_cost, lut_sym, lut_phase, sym3, coeffs, chan, x, \
      fst_in, fst_out, ist_in, ist_out, shifted, out, meta, nmeas, C, nsamp

// The rrc instances of one decision mode: the taps in shared memory for
// the CLI's geometries (16 taps in steps of 32 at 4 Msps, 10 in steps of
// 53 at 2.4 Msps) or any other, or in device memory.
template <bool EXACT>
cudaError_t launch_rrc(const ScanArgs* a, size_t smem, cudaStream_t s,
                       const void* trig, const void* lut_cost,
                       const void* lut_sym, const void* lut_phase,
                       const void* sym3, const void* coeffs,
                       const void* chan, const void* x, const void* fst_in,
                       void* fst_out, const void* ist_in, void* ist_out,
                       void* shifted, void* out, void* meta, void* nmeas,
                       int C, int nsamp) {
  if (!a->taps_shared) return launch<RRC, EXACT, 0, 0, false>(SCAN_ARGS);
  if (a->ntaps == 16 && a->sub == 32)
    return launch<RRC, EXACT, 16, 32, true>(SCAN_ARGS);
  if (a->ntaps == 10 && a->sub == 53)
    return launch<RRC, EXACT, 10, 53, true>(SCAN_ARGS);
  return launch<RRC, EXACT, 0, 0, true>(SCAN_ARGS);
}

}  // namespace

// shifted: the rrc state plane [ncoeffs, C] float2, read at launch and
// written at the end (updated in place by the device-memory instance).
// chan: null, or the per-channel plane [5, C] float (omega, freq_beta,
// min_freqw, max_freqw, mid_freqw), read at launch.
extern "C" int scan_demod_launch(const ScanArgs* a, const void* trig,
                                 const void* lut_cost, const void* lut_sym,
                                 const void* lut_phase, const void* sym3,
                                 const void* coeffs, const void* chan,
                                 const void* x,
                                 const void* fst_in, void* fst_out,
                                 const void* ist_in, void* ist_out,
                                 void* shifted, void* out, void* meta,
                                 void* nmeas, int C, int nsamp,
                                 void* stream) {
  const bool rrc = a->sampler == RRC;
  if (a->nsym < 1 || a->nsym > MAX_SYM || a->sampler < NEAREST ||
      a->sampler > RRC || C < 1 || nsamp < 0 || nsamp % CHUNK ||
      a->meas_decimation < 1 ||
      (rrc && (a->ncoeffs < 1 || a->sub < 1 ||
               a->ntaps != (a->ncoeffs + a->sub - 1) / a->sub)))
    return (int)cudaErrorInvalidValue;
  // The input ring, the rrc taps where they are shared, the constellation
  // rows (dsp/receiver.py, smem_bytes).
  const size_t smem = 2 * (size_t)(CHUNK + a->readahead) * 8 +
                      (rrc && a->taps_shared ? (size_t)a->ncoeffs * 8 : 0) +
                      3 * sizeof(float) * a->nsym;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (a->sampler * 2 + (a->exact ? 1 : 0)) {
    case NEAREST * 2: err = launch<NEAREST, false>(SCAN_ARGS); break;
    case NEAREST * 2 + 1: err = launch<NEAREST, true>(SCAN_ARGS); break;
    case LINEAR * 2: err = launch<LINEAR, false>(SCAN_ARGS); break;
    case LINEAR * 2 + 1: err = launch<LINEAR, true>(SCAN_ARGS); break;
    case RRC * 2: err = launch_rrc<false>(SCAN_ARGS); break;
    default: err = launch_rrc<true>(SCAN_ARGS); break;
  }
  return (int)err;
}
#undef SCAN_ARGS
