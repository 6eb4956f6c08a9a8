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
// Design (a simple kernel that is right first): one warp per block of 32
// channels, one thread per channel, the loop state in registers. The
// wrapper transposes the input to [n, C] float2 rows, and each thread
// stages its own channel's next chunk (CHUNK + readahead rows: the linear
// sampler's lookahead or the rrc window's taps) into a two-stage ring in
// shared memory with cp.async while it runs the current one, so no input
// load sits on the chain. Samples where no symbol is emitted (mu >= 1)
// change no state and output a zero word, so they skip all work. The
// packed words ([CHUNK, 32] tile in shared memory) and the chunk's
// measurements (last AGC'd sample, freq, ss, mer, nmeas) leave once per
// chunk. The rrc sampler's shifted coefficients live in device memory as
// [ncoeffs, C] float2, re-shifted by their own thread once per
// ncoeffs*16 samples (sdr.h:667-682) and read through L1.
//
// Tables: the trig16 table (65536 float2, 512 KB) and the LUT planes
// (cost i16, symbol u8, phase i16; 320 KB) exceed the 227 KB of shared
// memory a block can have, so they are read with __ldg and stay in L2
// (the indices a locked carrier visits stay in a few lines of L1). A
// later PR could move into shared memory: the LUT's symbol and cost
// planes (192 KB, without the input ring), or per block the trig rows
// near each channel's phase; for the rrc sampler, the shifted
// coefficients (32 x ncoeffs x 8 bytes, 128 KB at 499 taps).
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
  int ncoeffs, sub, ntaps, readahead;
};

namespace {

constexpr double PI_D = 3.14159265358979323846;
constexpr float K2PI = (float)(2 * PI_D / 65536);   // u16 angle -> radians
constexpr float TWO_PI_F = (float)(2 * PI_D);
constexpr float PI_F = (float)PI_D;
constexpr float HALF_PI_F = (float)(PI_D / 2);
constexpr int B_HI = 0x42FE0000;   // bits(127.0f)
constexpr int B_LO = 0x43000000;   // bits(128.0f)
constexpr int LANES = 32;          // channels per block: one warp
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

// Every group but the newest has landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows base .. base + rows - 1 of channel c into this lane's column of
// one ring stage (zeros for a lane past C).
__device__ __forceinline__ void stage_rows(float2* stage,
                                           const float2* __restrict__ x,
                                           int C, int c, bool active,
                                           int base, int rows) {
  const float2* src = x + (size_t)base * C + (active ? c : 0);
  float2* dst = stage + threadIdx.x;
  for (int r = 0; r < rows; ++r)
    cp_async8(dst + r * LANES, src + (size_t)r * C, active);
}

template <int SAMPLER, bool EXACT>
__global__ void __launch_bounds__(LANES)
scan_kernel(const ScanArgs A, const float2* __restrict__ trig,
            const short* __restrict__ lut_cost,
            const unsigned char* __restrict__ lut_sym,
            const short* __restrict__ lut_phase,
            const float* __restrict__ sym3, const float* __restrict__ coeffs,
            const float2* __restrict__ x, const float* __restrict__ fst_in,
            float* __restrict__ fst_out, const int* __restrict__ ist_in,
            int* __restrict__ ist_out, float2* shifted,
            int32_t* __restrict__ out, float* __restrict__ meta,
            int* __restrict__ nmeas, int C, int nsamp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = CHUNK + A.readahead;
  float2* xs = reinterpret_cast<float2*>(smem);
  int32_t* os = reinterpret_cast<int32_t*>(smem + 2 * rows * LANES * 8);
  float* tab = reinterpret_cast<float*>(smem + 2 * rows * LANES * 8 +
                                        CHUNK * LANES * 4);
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * LANES;
  const int c = c0 + lane;
  const bool active = c < C;
  const int nchunks = nsamp / CHUNK;
  if (nchunks > 0) stage_rows(xs, x, C, c, active, 0, rows);
  cp_async_commit();

  for (int i = lane; i < 3 * A.nsym; i += LANES) tab[i] = sym3[i];
  float st[NSTATE];
#pragma unroll
  for (int k = 0; k < NSTATE; ++k) st[k] = active ? fst_in[k * C + c] : 0.0f;
  float mu = st[0], phase = st[1], freqw = st[2], agc_gain = st[3];
  float est_insp = st[4], est_sp = st[5], est_ep = st[6];
  float p0r = st[7], p0i = st[8], p1r = st[9], p1i = st[10];
  float p2r = st[11], p2i = st[12];
  float c0r = st[13], c0i = st[14], c1r = st[15], c1i = st[16];
  float c2r = st[17], c2i = st[18];
  int meas_count = active ? ist_in[c] : 0;
  int rrc_phase = active ? ist_in[C + c] : 0;
  __syncwarp();
  const float* sym_re = tab;
  const float* sym_im = tab + A.nsym;
  const float* sym_phase = tab + 2 * A.nsym;
  const int nl = min(LANES, C - c0);       // this block's channels

  for (int ck = 0; ck < nchunks; ++ck) {
    const int base = ck * CHUNK;
    if (ck + 1 < nchunks)
      stage_rows(xs + ((ck + 1) & 1) * rows * LANES, x, C, c, active,
                 base + CHUNK, rows);
    cp_async_commit();
    cp_async_wait_prior();                 // this chunk's rows are in
    const float2* xk = xs + (ck & 1) * rows * LANES + lane;
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
    if (SAMPLER == RRC && active) {
      // Throttled coefficient re-shift (sdr.h:667-682).
      int ph = rrc_phase - CHUNK;
      if (ph <= 0) {
        ph = A.ncoeffs * 16;
        const float f = freqw / (float)A.sub;
        const float half = (float)(A.ncoeffs / 2);
        for (int i = 0; i < A.ncoeffs; ++i) {
          float ec, es;
          expi<EXACT>(trig, -f * ((float)i - half), ec, es);
          const float co = __ldg(coeffs + i);
          shifted[(size_t)i * C + c] = make_float2(ec * co, es * co);
        }
      }
      rrc_phase = ph;
    }
    float lsg_re = 0.f, lsg_im = 0.f, ls_re = 0.f, ls_im = 0.f;
    float lc_re = 0.f, lc_im = 0.f;
    bool any_sym = false;
    for (int t = 0; t < CHUNK; ++t) {
      int32_t word = 0;
      if (active && mu < 1.0f) {   // emit (non-emitted samples: no effect)
        float cr0, sr0;
        expi<EXACT>(trig, -phase, cr0, sr0);
        float sg_re, sg_im;
        if (SAMPLER == LINEAR) {
          const float2 x0 = xk[t * LANES];
          const float2 x1 = xk[(t + 1) * LANES];
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
          const float2 x0 = xk[t * LANES];
          sg_re = x0.x * cr0 - x0.y * sr0;
          sg_im = x0.x * sr0 + x0.y * cr0;
        } else {
          // fir_sampler.interp (sdr.h:646-665): taps at phase index
          // (1-mu)*subsampling, stride subsampling, summed in tap order,
          // then one derotation of the sum.
          const int idx0 = __float2int_rz((1.0f - mu) * (float)A.sub);
          float acc_re = 0.0f, acc_im = 0.0f;
          for (int j = 0; j < A.ntaps; ++j) {
            const int pc = idx0 + j * A.sub;
            const float okf = pc < A.ncoeffs ? 1.0f : 0.0f;
            const float2 co = shifted[(size_t)min(pc, A.ncoeffs - 1) * C + c];
            const float2 w = xk[(t + j) * LANES];
            acc_re = acc_re + okf * (co.x * w.x - co.y * w.y);
            acc_im = acc_im + okf * (co.x * w.y + co.y * w.x);
          }
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
        const float freqw_u = freqw + perr_f * A.freq_beta;
        // modified M&M (sdr.h:817-840)
        const float muerr = ((s_re - p1r) * c0r + (s_im - p1i) * c0i) -
                            ((cpt_re - c1r) * p0r + (cpt_im - c1i) * p0i);
        const float mucorr =
            fminf(fmaxf(muerr * A.gain_mu, -A.max_mucorr), A.max_mucorr);
        mu = mu + mucorr + A.omega;
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
      os[t * LANES + lane] = word;
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
    if (!A.allow_drift && (freqw < A.min_freqw || freqw > A.max_freqw))
      freqw = A.mid_freqw;
    meas_count += CHUNK;
    const int nm = meas_count / A.meas_decimation;
    meas_count = meas_count % A.meas_decimation;
    if (active) {
      const size_t kc = (size_t)nchunks * C, at = (size_t)ck * C + c;
      meta[at] = ls_re;
      meta[kc + at] = ls_im;
      meta[2 * kc + at] = freqw / 65536.0f;
      meta[3 * kc + at] = sqrtf(est_insp);
      meta[4 * kc + at] =
          est_ep > 0.0f ? (10.0f * logf(est_sp / est_ep)) / A.ln10 : 0.0f;
      nmeas[at] = nm;
    }

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
  for (int k = 0; k < NSTATE; ++k) fst_out[k * C + c] = fin[k];
  ist_out[c] = meas_count;
  ist_out[C + c] = rrc_phase;
}

template <int SAMPLER, bool EXACT>
cudaError_t launch(const ScanArgs* a, size_t smem, cudaStream_t stream,
                   int blocks, const void* trig, const void* lut_cost,
                   const void* lut_sym, const void* lut_phase,
                   const void* sym3, const void* coeffs, const void* x,
                   const void* fst_in, void* fst_out, const void* ist_in,
                   void* ist_out, void* shifted, void* out, void* meta,
                   void* nmeas, int C, int nsamp) {
  auto kernel = scan_kernel<SAMPLER, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, LANES, smem, stream>>>(
      *a, (const float2*)trig, (const short*)lut_cost,
      (const unsigned char*)lut_sym, (const short*)lut_phase,
      (const float*)sym3, (const float*)coeffs, (const float2*)x,
      (const float*)fst_in, (float*)fst_out, (const int*)ist_in,
      (int*)ist_out, (float2*)shifted, (int32_t*)out, (float*)meta,
      (int*)nmeas, C, nsamp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int scan_demod_launch(const ScanArgs* a, const void* trig,
                                 const void* lut_cost, const void* lut_sym,
                                 const void* lut_phase, const void* sym3,
                                 const void* coeffs, const void* x,
                                 const void* fst_in, void* fst_out,
                                 const void* ist_in, void* ist_out,
                                 void* shifted, void* out, void* meta,
                                 void* nmeas, int C, int nsamp,
                                 void* stream) {
  if (a->nsym < 1 || a->nsym > MAX_SYM || a->sampler < NEAREST ||
      a->sampler > RRC || C < 1 || nsamp < 0 || nsamp % CHUNK ||
      a->meas_decimation < 1 ||
      (a->sampler == RRC && (a->ncoeffs < 1 || a->sub < 1 ||
                             a->ntaps != (a->ncoeffs + a->sub - 1) / a->sub)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)(CHUNK + a->readahead) * LANES * 8 +
                      CHUNK * LANES * 4 + 3 * sizeof(float) * a->nsym;
  const int blocks = (C + LANES - 1) / LANES;
  cudaStream_t s = (cudaStream_t)stream;
#define SCAN_ARGS                                                         \
  a, smem, s, blocks, trig, lut_cost, lut_sym, lut_phase, sym3, coeffs, x, \
      fst_in, fst_out, ist_in, ist_out, shifted, out, meta, nmeas, C, nsamp
  cudaError_t err;
  switch (a->sampler * 2 + (a->exact ? 1 : 0)) {
    case NEAREST * 2: err = launch<NEAREST, false>(SCAN_ARGS); break;
    case NEAREST * 2 + 1: err = launch<NEAREST, true>(SCAN_ARGS); break;
    case LINEAR * 2: err = launch<LINEAR, false>(SCAN_ARGS); break;
    case LINEAR * 2 + 1: err = launch<LINEAR, true>(SCAN_ARGS); break;
    case RRC * 2: err = launch<RRC, false>(SCAN_ARGS); break;
    default: err = launch<RRC, true>(SCAN_ARGS); break;
  }
#undef SCAN_ARGS
  return (int)err;
}
