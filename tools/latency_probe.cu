// Dependent-instruction latencies on the card, for the demod's serial
// bound (chip_smoke.py reads the demod's loop from its SASS with
// tools/sass_chain.py and prices each instruction with these).
//
// Each probe is one thread running REP dependent instructions of one
// kind between two clock64 reads; run_probes writes the cycles of each
// probe to cyc[op]. Inline PTX keeps the compiler from folding the
// chain; some kinds have no chain of their own and are probed in pairs
// (chip_smoke.py subtracts the partner's latency or halves the pair):
//
//   0 FADD   1 FMUL   2 FFMA   3 FMNMX   4 FSEL   5 FSETP + FSEL
//   6 SHF    7 IMAD   8 F2I + I2FP       9 FRND.TRUNC   10 FRND.FLOOR
//   11 MUFU.RCP + FADD   12 FMUL.RZ + MUFU.SIN   13 MUFU.RSQ + FADD
//   14 LDS (a pointer chase in shared memory)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC tools/latency_probe.cu -o liblatency_probe.so

#include <cuda_runtime.h>

#define REP 512
#define NPROBE 15

template <int OP>
__global__ void probe(const float* fin, const int* iin, float* fout,
                      long long* cyc) {
  __shared__ unsigned sh[32];
  const unsigned base = (unsigned)__cvta_generic_to_shared(sh);
  sh[0] = base;                            // sh[0] points at itself
  __syncthreads();
  float x = fin[0];
  const float fa = fin[1], fb = fin[2];    // 1.0, 0.999
  int k = iin[0];
  const int ia = iin[1];                   // 1
  unsigned u = base;
  const bool p = fa > 0.5f;                // true, known only at run time
  const long long t0 = clock64();
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
  }
  const long long t1 = clock64();
  fout[OP] = x + (float)k + (float)u;      // keeps every chain live
  cyc[OP] = t1 - t0;
}

template <int OP>
void launch(const float* fin, const int* iin, float* fout, long long* cyc) {
  probe<OP><<<1, 1>>>(fin, iin, fout, cyc);
  if constexpr (OP + 1 < NPROBE) launch<OP + 1>(fin, iin, fout, cyc);
}

// fin = {1.5, 1.0, 0.999}, iin = {1, 1}; fout[NPROBE]; cyc[NPROBE].
extern "C" int run_probes(const void* fin, const void* iin, void* fout,
                          void* cyc) {
  launch<0>((const float*)fin, (const int*)iin, (float*)fout,
            (long long*)cyc);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return (int)err;
}

extern "C" int probe_rep() { return REP; }
