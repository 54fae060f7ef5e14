// The convergence test of one early-exit iteration and the level's exit
// flag: the device side of the JAX package's lax.while_loop
// (ug_stereomatcher_tpu/match.py:392-414), whose condition
//   (m < mi) & (max(weighted_difference(h), weighted_difference(v)) >= thr)
// never leaves the device.  The JAX package computes the two
// weighted_difference values (ops/convergence.py:19-28) in plain XLA; it
// has no Pallas kernel for them.
//
//   dh = sum(|new_h - old_h| * c) / sum(c),  dv likewise,  c = new_c;
//   0 where sum(c) is not > 0 (a NaN sum too, as jnp.where gives).
//
// Then, unless the flag is already set, the level stops after iteration m
// (stop = 1, last = m) when !(max(dh, dv) >= thr), with a NaN in either
// carried through the max as jnp.maximum carries it: a NaN change stops
// the level.  The kernel writes (dh, dv) of iteration m and last = m in
// any case.  With the flag set it returns before any load, as the guarded
// warp, direction and smooth do (common.cuh stopped()), so a level's whole
// schedule is enqueued and no iteration after its exit reads or writes a
// plane.  may_exit == 0 (the convergence trace) never sets the flag and
// never reads it.
//
// Bound: device memory, 20 bytes a pixel (new_h, new_v, new_c, old_h,
// old_v read once; 0.096 ms at 16 MP on 3.35 TB/s).  The torch chain it
// replaces ran about ten launches an iteration and moved about 80.
// Design:
// * one pass: a grid of at most max_blocks blocks of 256 threads strides
//   over the pixels, four at a time in 16-byte loads where the planes
//   allow, and each thread sums |d| * c (the product rounded in float32,
//   as the plain version rounds it) and c in float64;
// * no float atomics: each block reduces its threads in a fixed shuffle
//   order and writes its three partial sums; the last block to finish (an
//   integer ticket) adds the partials in block order and writes the
//   result, so a run repeats bit for bit;
// * float64 sums keep the result within about 1e-7 of the exact quotient
//   at 16 MP, where float32 sums in any order drift further.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Sums {
  double h, v, c;
};

__device__ __forceinline__ void add_pixel(Sums& s, float nh, float oh,
                                          float nv, float ov, float c) {
  s.h += (double)(fabsf(nh - oh) * c);
  s.v += (double)(fabsf(nv - ov) * c);
  s.c += (double)c;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// The block's sums, in thread 0 (fixed order: lanes, then warps).
__device__ __forceinline__ Sums block_sum(Sums s, double (*scratch)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s.h = warp_sum(s.h);
  s.v = warp_sum(s.v);
  s.c = warp_sum(s.c);
  if (lane == 0) {
    scratch[0][warp] = s.h;
    scratch[1][warp] = s.v;
    scratch[2][warp] = s.c;
  }
  __syncthreads();
  Sums t{0.0, 0.0, 0.0};
  if (warp == 0) {
    if (lane < kWarps) {
      t.h = scratch[0][lane];
      t.v = scratch[1][lane];
      t.c = scratch[2][lane];
    }
    t.h = warp_sum(t.h);
    t.v = warp_sum(t.v);
    t.c = warp_sum(t.c);
  }
  return t;
}

// max(a, b) that carries a NaN in either, as jnp.maximum does (fmaxf
// drops it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

__global__ void __launch_bounds__(kThreads)
    convergence_kernel(const float* __restrict__ nw,
                       const float* __restrict__ old, int hw, bool vec4,
                       float thr, int may_exit, int m, int* flags,
                       double* partials, float* deltas) {
  // flags: [0] stop, [1] last, [2] the ticket of the last block
  if (may_exit && *reinterpret_cast<volatile int*>(flags) != 0) return;
  __shared__ double scratch[3][kWarps];
  __shared__ bool last_block;
  const size_t p = (size_t)hw;
  Sums s{0.0, 0.0, 0.0};
  const int stride = gridDim.x * kThreads;
  if (vec4) {
    const float4* nh = reinterpret_cast<const float4*>(nw);
    const float4* nv = reinterpret_cast<const float4*>(nw + p);
    const float4* nc = reinterpret_cast<const float4*>(nw + 2 * p);
    const float4* oh = reinterpret_cast<const float4*>(old);
    const float4* ov = reinterpret_cast<const float4*>(old + p);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < hw / 4;
         i += stride) {
      const float4 a = __ldg(nh + i), b = __ldg(oh + i), c = __ldg(nc + i),
                   d = __ldg(nv + i), e = __ldg(ov + i);
      add_pixel(s, a.x, b.x, d.x, e.x, c.x);
      add_pixel(s, a.y, b.y, d.y, e.y, c.y);
      add_pixel(s, a.z, b.z, d.z, e.z, c.z);
      add_pixel(s, a.w, b.w, d.w, e.w, c.w);
    }
  } else {
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < hw; i += stride) {
      add_pixel(s, __ldg(nw + i), __ldg(old + i), __ldg(nw + p + i),
                __ldg(old + p + i), __ldg(nw + 2 * p + i));
    }
  }
  const Sums b = block_sum(s, scratch);
  if (threadIdx.x == 0) {
    partials[3 * blockIdx.x] = b.h;
    partials[3 * blockIdx.x + 1] = b.v;
    partials[3 * blockIdx.x + 2] = b.c;
    __threadfence();  // the partials before the ticket
    const unsigned ticket =
        atomicAdd(reinterpret_cast<unsigned*>(flags + 2), 1u);
    last_block = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  Sums t{0.0, 0.0, 0.0};
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kThreads) {
    t.h += __ldcg(partials + 3 * k);
    t.v += __ldcg(partials + 3 * k + 1);
    t.c += __ldcg(partials + 3 * k + 2);
  }
  __syncthreads();  // scratch is reused
  const Sums r = block_sum(t, scratch);
  if (threadIdx.x == 0) {
    float dh = 0.0f, dv = 0.0f;
    if (r.c > 0.0) {
      dh = (float)(r.h / r.c);
      dv = (float)(r.v / r.c);
    }
    deltas[2 * m] = dh;
    deltas[2 * m + 1] = dv;
    flags[1] = m;
    if (may_exit && !(nan_max(dh, dv) >= thr)) flags[0] = 1;
    flags[2] = 0;  // the ticket, for the next launch
  }
}

}  // namespace

// new_state, old_state: (3, H, W) float32 states [disp_h, disp_v, conf]
// with hw = H * W (old_state's confidence is not read); thr: the
// float32-rounded threshold; may_exit: set the flag (early exit) or not
// (the trace); m: the iteration; flags: int32 [stop, last, ticket]
// (ticket 0 between launches); partials: max_blocks * 3 doubles of
// scratch; deltas: (mi, 2) float32, row m written.
UGSM_API int ugsm_convergence(const float* new_state, const float* old_state,
                              int hw, float thr, int may_exit, int m,
                              int* flags, double* partials, float* deltas,
                              int max_blocks, void* stream) {
  if (hw < 1 || m < 0 || max_blocks < 1 || hw > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const bool vec4 = hw % 4 == 0 && (size_t)new_state % 16 == 0 &&
                    (size_t)old_state % 16 == 0;
  const int units = vec4 ? hw / 4 : hw;
  int blocks = (units + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  convergence_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      new_state, old_state, hw, vec4, thr, may_exit, m, flags, partials,
      deltas);
  return (int)cudaGetLastError();
}
