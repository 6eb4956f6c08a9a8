// Dependent-instruction latencies on the card, for the serial bounds of
// the demod, ACS and scan-demod kernels (chip_smoke.py reads a kernel's loop
// from its SASS with tools/sass_chain.py and prices each instruction
// with these).
//
// Each probe is one warp running REP dependent instructions of one kind
// between two clock64 reads (all 32 lanes, so that the shuffles move
// data between lanes and the reduction has its whole mask); run_probes
// writes the cycles of each probe to cyc[op] (every lane writes the same
// value). Inline PTX keeps the compiler from folding the chain; some
// kinds have no chain of their own and are probed in pairs
// (chip_smoke.py subtracts the partner's latency or halves the pair):
//
//   0 FADD   1 FMUL   2 FFMA   3 FMNMX   4 FSEL   5 FSETP + FSEL
//   6 SHF    7 IMAD   8 F2I + I2FP       9 FRND.TRUNC   10 FRND.FLOOR
//   11 MUFU.RCP + FADD   12 FMUL.RZ + MUFU.SIN   13 MUFU.RSQ + FADD
//   14 LDS (a pointer chase in shared memory)
//   15 SHFL.IDX (from the next lane)   16 SHFL.BFLY   17 integer min
//   (IMNMX/VIMNMX)   18 SEL   19 ISETP + SEL (a select that is no min
//   or max, which the compiler would fuse)   20 REDUX.MIN (its
//   uniform-register result moved back to a register for the next one,
//   as the ACS uses it)
//   21 STS + BAR.SYNC + LDS: one round of a shared-memory exchange
//   between two warps (a 64-thread CTA: each thread stores, the barrier,
//   each loads a neighbour's word; the banked ACS's per-block exchange)
//   22 STS + __syncwarp + LDS: the same round within one warp
//   23 VIADDMNMX (Hopper's fused add-min, __viaddmin_s32)
//   24 LDG (a pointer chase in device memory that stays in L1: the
//   scan demods' table gathers at indices a locked loop revisits)
//   25 LDG that hits L2 (the same chase with ld.global.cg, which does not
//   cache in L1: a table gather whose line has left L1)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC tools/latency_probe.cu -o liblatency_probe.so

#include <cuda_runtime.h>

#define REP 512
#define NPROBE 26

// Probe 24's chase: the word points at itself (set by the probe).
__device__ unsigned long long chase_word;

template <int OP>
__global__ void probe(const float* fin, const int* iin, float* fout,
                      long long* cyc) {
  __shared__ unsigned sh[32];
  __shared__ int xch[64];                  // probes 21, 22
  const unsigned base = (unsigned)__cvta_generic_to_shared(sh);
  sh[0] = base;                            // sh[0] points at itself
  __syncthreads();
  float x = fin[0];
  const float fa = fin[1], fb = fin[2];    // 1.0, 0.999
  int k = iin[threadIdx.x & 1];          // 1, not known to be uniform
  const int ia = iin[1];                   // 1
  const int ia0 = ia - 1;                  // 0
  const int next = (threadIdx.x + ia) & 31;  // the next lane
  unsigned u = base;
  if (OP == 24 || OP == 25) {
    chase_word = (unsigned long long)&chase_word;
    __threadfence();
  }
  unsigned long long g = (unsigned long long)&chase_word;
  const bool p = fa > 0.5f;                // true, known only at run time
  const long long t0 = clock64();
  // Every chain starts from the clock read (adds 0: the compiler cannot
  // read the clock after the chain has begun).
  const int zero = (int)(t0 >> 62);
  k += zero;
  u += zero;
  x = __int_as_float(__float_as_int(x) + zero);
  g += zero;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (OP == 0) asm volatile("add.f32 %0, %0, %1;" : "+f"(x) : "f"(fb));
    if (OP == 1) asm volatile("mul.f32 %0, %0, %1;" : "+f"(x) : "f"(fa));
    if (OP == 2)
      asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(x) : "f"(fa), "f"(fb));
    if (OP == 3) asm volatile("min.f32 %0, %0, %1;" : "+f"(x) : "f"(fa));
    if (OP == 4)
      asm volatile("{.reg .pred q; setp.ne.s32 q, %1, 0;"
                   " selp.f32 %0, %0, %2, q;}"
                   : "+f"(x) : "r"((int)p), "f"(fb));
    if (OP == 5)
      asm volatile("{.reg .pred q; setp.lt.f32 q, %0, %1;"
                   " selp.f32 %0, %2, %0, q;}"
                   : "+f"(x) : "f"(fa), "f"(fb));
    if (OP == 6)
      asm volatile("shf.l.wrap.b32 %0, %0, %0, %1;" : "+r"(k) : "r"(ia));
    if (OP == 7)
      asm volatile("mad.lo.s32 %0, %0, %1, %1;" : "+r"(k) : "r"(ia));
    if (OP == 8)
      asm volatile("{.reg .s32 t; cvt.rzi.s32.f32 t, %0;"
                   " cvt.rn.f32.s32 %0, t;}" : "+f"(x));
    if (OP == 9) asm volatile("cvt.rzi.f32.f32 %0, %0;" : "+f"(x));
    if (OP == 10) asm volatile("cvt.rmi.f32.f32 %0, %0;" : "+f"(x));
    if (OP == 11)
      asm volatile("{.reg .f32 t; rcp.approx.ftz.f32 t, %0;"
                   " add.f32 %0, t, %1;}" : "+f"(x) : "f"(fb));
    if (OP == 12) asm volatile("sin.approx.f32 %0, %0;" : "+f"(x));
    if (OP == 13)
      asm volatile("{.reg .f32 t; rsqrt.approx.ftz.f32 t, %0;"
                   " add.f32 %0, t, %1;}" : "+f"(x) : "f"(fb));
    if (OP == 14) asm volatile("ld.shared.u32 %0, [%0];" : "+r"(u));
    if (OP == 15)
      asm volatile("shfl.sync.idx.b32 %0, %0, %1, 0x1f, -1;"
                   : "+r"(k) : "r"(next));
    if (OP == 16)
      asm volatile("shfl.sync.bfly.b32 %0, %0, %1, 0x1f, -1;"
                   : "+r"(k) : "r"(ia));
    if (OP == 17) asm volatile("min.s32 %0, %0, %1;" : "+r"(k) : "r"(ia));
    if (OP == 18)
      asm volatile("{.reg .pred q; setp.ne.s32 q, %1, 0;"
                   " selp.b32 %0, %0, %2, q;}"
                   : "+r"(k) : "r"((int)p), "r"(ia));
    if (OP == 19)
      asm volatile("{.reg .pred q; setp.lt.s32 q, %0, %1;"
                   " selp.b32 %0, %2, %0, q;}"
                   : "+r"(k) : "r"(ia), "r"(ia0));
    if (OP == 20)
      asm volatile("redux.sync.min.s32 %0, %0, -1;" : "+r"(k));
    if (OP == 21 || OP == 22) {
      xch[threadIdx.x] = k;
      if (OP == 21)
        __syncthreads();
      else
        __syncwarp();
      k = xch[threadIdx.x ^ ia] + ia0;     // the neighbour's word
    }
    if (OP == 23) k = __viaddmin_s32(k, ia, k + 2);
    if (OP == 24) asm volatile("ld.global.ca.u64 %0, [%0];" : "+l"(g));
    if (OP == 25) asm volatile("ld.global.cg.u64 %0, [%0];" : "+l"(g));
  }
  // A branch on every chain's result: the clock is read after the last
  // instruction of the chain has finished (the compiler would otherwise
  // be free to sink a chain that only the final store reads past it).
  if (x == 0.125f && k == 7 && u == 3u && g == 5ull) fout[NPROBE] = 0.0f;
  const long long t1 = clock64();
  fout[OP] = x + (float)k + (float)u + (float)(g & 1);  // keeps chains live
  cyc[OP] = t1 - t0;
}

template <int OP>
void launch(const float* fin, const int* iin, float* fout, long long* cyc) {
  probe<OP><<<1, OP == 21 ? 64 : 32>>>(fin, iin, fout, cyc);
  if constexpr (OP + 1 < NPROBE) launch<OP + 1>(fin, iin, fout, cyc);
}

// fin = {1.5, 1.0, 0.999}, iin = {1, 1}; fout[NPROBE + 1]; cyc[NPROBE].
extern "C" int run_probes(const void* fin, const void* iin, void* fout,
                          void* cyc) {
  launch<0>((const float*)fin, (const int*)iin, (float*)fout,
            (long long*)cyc);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return (int)err;
}

extern "C" int probe_rep() { return REP; }
