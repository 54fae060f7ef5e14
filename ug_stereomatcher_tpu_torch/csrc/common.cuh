// Shared helpers of the port's CUDA kernels.
//
// Built with --fmad=false: every multiply and add below rounds on its
// own, in the order written, which is the order of the plain PyTorch
// versions (ops/conv.py conv1d: weight kernel[radius - k] at offset k,
// zero taps skipped, terms summed in offset order).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#define UGSM_API extern "C" __attribute__((visibility("default")))

namespace ugsm {

// Five taps in conv1d storage: the weight at offset k is t[2 - k].
struct Taps5 {
  float t[5];
};

__host__ __device__ inline Taps5 make_taps5(float t0, float t1, float t2,
                                            float t3, float t4) {
  Taps5 tp;
  tp.t[0] = t0;
  tp.t[1] = t1;
  tp.t[2] = t2;
  tp.t[3] = t3;
  tp.t[4] = t4;
  return tp;
}

// The early-exit guard of warp, direction and smooth: whether the flag
// is given and set.  A kernel tests it first thing and returns, so a
// launch after its level's exit reads and writes nothing.  The flag is
// set by an earlier launch on the stream, never during this one.
__device__ __forceinline__ bool stopped(const int* stop) {
  return stop != nullptr && __ldg(stop) != 0;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One 5-tap pass over samples at offsets -2..2, in conv1d's term order,
// for taps that are all nonzero (conv1d skips a zero tap; the Gaussian
// has none).
__device__ __forceinline__ float pass5_all(const Taps5& tp, float xm2,
                                           float xm1, float x0, float xp1,
                                           float xp2) {
  float acc = tp.t[4] * xm2;
  acc = acc + tp.t[3] * xm1;
  acc = acc + tp.t[2] * x0;
  acc = acc + tp.t[1] * xp1;
  return acc + tp.t[0] * xp2;
}

// Asynchronous copy of one float from device memory to shared memory
// (cp.async through L1, for planes no block writes during the launch);
// fill == false writes 0 and reads nothing.  Complete after
// cp_async_wait_all() and, for other threads, a block barrier.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(fill ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace ugsm
