// Level-resident matcher: all mi iterations of one pyramid level in one
// cooperative launch.  The Hopper form of level_resident_match
// (ug_stereomatcher_tpu/ops/pallas/level.py).
//
// Each iteration is warp -> G(W^2) -> direction update -> n smoothing
// passes -> 3-tap average, as in match_level's per-iteration path; G(L^2)
// is computed once per level.  The TPU kernel keeps every plane in VMEM
// to cut its dispatch floor.  Bound on the card: on the coarse levels it
// runs on, neither memory nor arithmetic but latency (a level-8 plane is
// 247 KB, the whole working set about 5 MB), and on the per-iteration path
// the host's launch rate.  Design:
//
// * one cooperative launch per level, with as many 512-thread blocks as
//   the level needs and the card can hold at once (the occupancy
//   calculator times the SM count); the C entry point refuses a larger
//   grid instead of launching one that could deadlock;
// * every plane lives in device memory, so the working set sits in the
//   50 MB L2; planes written during the launch are read with ld.global.cg
//   (L2, never the non-coherent L1), the inputs with plain loads;
// * one grid barrier between dependent phases: after the warp, after
//   G(W^2), after the direction update, after each smoothing pass and
//   after the average, 4 + n per iteration.  A separable blur needs no
//   barrier between its passes: the column pass recomputes the five
//   row-pass values it reads (sep5_clamp_at), which rounds exactly like
//   the two-pass tile;
// * the per-pixel and per-tile math is the per-iteration kernels' own
//   (stencils.cuh), compiled under the same --fmad=false, so the result is
//   bit-exact against the per-iteration chain.  The port's warp is an
//   exact gather, so unlike the TPU kernel there is no warp window, no
//   overflow flag and no recompute path.
//
// The grid barrier is an arrival counter and a generation word in device
// memory (zeroed on the stream before each launch), in the pattern of
// cooperative_groups' grid sync, so the library needs no relocatable
// device code.
#include <climits>

#include "stencils.cuh"

namespace {

using ugsm::kDirBX;
using ugsm::kDirBY;

constexpr int kThreads = kDirBX * kDirBY;  // one direction tile per block
constexpr int kMaxIters = 256;

struct LevelArgs {
  const float* left;   // (3, H, W), never written
  const float* right;  // (3, H, W), never written
  const float* disp;   // (3, H, W) input state, never written
  float* state;        // (3, H, W): state between iterations; the result
  float* warped;       // (3, H, W) scratch planes from here on
  float* bw2;
  float* bl2;
  float* upd;
  float* ping;
  float* pong;
  unsigned int* bar;   // [arrivals, generation]
  int H, W, mi, n_smooth, replace_first;
  ugsm::Taps5 gauss, avg;
  ugsm::DirConsts k;
  float thr[kMaxIters];
};

// Every block of the (co-resident) grid arrives before any leaves; the
// writes of every block before the barrier are visible after it.
__device__ __forceinline__ void grid_sync(unsigned int* bar,
                                          unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;  // read before arriving
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

template <bool BILINEAR>
__global__ void __launch_bounds__(kThreads, 1)
    level_kernel(const LevelArgs a) {
  using ugsm::LdL2;
  using ugsm::LdPlain;
  const int H = a.H, W = a.W, HW = H * W;
  const size_t plane = (size_t)HW;
  const int first = blockIdx.x * kThreads + threadIdx.y * kDirBX + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const unsigned int nblocks = gridDim.x;
  const int ntx = (W + kDirBX - 1) / kDirBX;
  const int ntiles = ntx * ((H + kDirBY - 1) / kDirBY);
  const ugsm::RowBlock whole = ugsm::whole_image(H);

  // The input state, and G(L^2), which holds for the whole level.
  for (int p = first; p < HW; p += stride) {
    const int r = p / W, x = p - r * W;
    for (int c = 0; c < 3; ++c) {
      a.state[c * plane + p] = a.disp[c * plane + p];
      a.bl2[c * plane + p] = ugsm::sep5_clamp_at<LdPlain, true>(
          a.left + c * plane, r, x, H, W, a.gauss);
    }
  }
  grid_sync(a.bar, nblocks);

  for (int m = 0; m < a.mi; ++m) {
    for (int p = first; p < HW; p += stride) {
      const int r = p / W, x = p - r * W;
      ugsm::warp_px<BILINEAR>(a.right, a.warped, 3, H, W, plane, p, r, x,
                              LdL2::ld(a.state + p),
                              LdL2::ld(a.state + plane + p));
    }
    grid_sync(a.bar, nblocks);

    for (int p = first; p < HW; p += stride) {
      const int r = p / W, x = p - r * W;
      for (int c = 0; c < 3; ++c) {
        a.bw2[c * plane + p] = ugsm::sep5_clamp_at<LdL2, true>(
            a.warped + c * plane, r, x, H, W, a.gauss);
      }
    }
    grid_sync(a.bar, nblocks);

    // The coarsest level's first iteration replaces the confidence.
    const bool replace = a.replace_first && m == 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int tr = t / ntx;
      ugsm::direction_tile<LdL2>(a.left, a.warped, a.bl2, a.bw2, a.state,
                                 a.upd, whole, W, tr * kDirBY,
                                 (t - tr * ntx) * kDirBX, a.thr[m], replace,
                                 a.gauss, a.k);
    }
    grid_sync(a.bar, nblocks);

    const float* src = a.upd;
    for (int i = 0; i < a.n_smooth; ++i) {
      float* dst = (i & 1) ? a.pong : a.ping;
      for (int p = first; p < HW; p += stride) {
        const int r = p / W;
        ugsm::smooth_px<LdL2>(src, dst, whole, W, r, p - r * W);
      }
      grid_sync(a.bar, nblocks);
      src = dst;
    }

    for (int p = first; p < HW; p += stride) {
      const int r = p / W, x = p - r * W;
      for (int c = 0; c < 3; ++c) {
        a.state[c * plane + p] = ugsm::sep5_clamp_at<LdL2, false>(
            src + c * plane, r, x, H, W, a.avg);
      }
    }
    grid_sync(a.bar, nblocks);
  }
}

template <bool BILINEAR>
cudaError_t max_coresident(int* out) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, level_kernel<BILINEAR>, kThreads, 0);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

// The largest grid of level-kernel blocks the current device holds at
// once (0 if the kernel does not fit on an SM at all).
UGSM_API int ugsm_level_max_grid(int bilinear, int* out) {
  return (int)(bilinear ? max_coresident<true>(out)
                        : max_coresident<false>(out));
}

// left/right/disp/out: (3, H, W); scratch: 18 planes of H * W floats;
// bar: 2 words of device memory; thr: mi host floats.  grid_req = 0
// sizes the grid from the level; a larger request than the device holds
// at once is refused with cudaErrorCooperativeLaunchTooLarge.
UGSM_API int ugsm_level_resident(
    const float* left, const float* right, const float* disp, float* out,
    float* scratch, unsigned int* bar, const float* thr, int mi, int H,
    int W, int n_smooth, int replace_first, int bilinear, float g_outer,
    float g_inner, float g_centre, float avg_tap, float no_peak,
    float aff_scale, float aff_bias, float w_new, float w_old, int grid_req,
    void* stream) {
  if (H < 1 || W < 1 || mi < 0 || mi > kMaxIters || n_smooth < 0 ||
      (long long)H * W > INT_MAX / 4)
    return (int)cudaErrorInvalidValue;
  int max_grid = 0;
  cudaError_t e = bilinear ? max_coresident<true>(&max_grid)
                           : max_coresident<false>(&max_grid);
  if (e != cudaSuccess) return (int)e;
  const int HW = H * W;
  const int ntiles = ((W + kDirBX - 1) / kDirBX) * ((H + kDirBY - 1) / kDirBY);
  const int pix_blocks = (HW + kThreads - 1) / kThreads;
  const int want = ntiles > pix_blocks ? ntiles : pix_blocks;
  const int grid = grid_req > 0 ? grid_req : (want < max_grid ? want : max_grid);
  if (grid < 1 || grid > max_grid)
    return (int)cudaErrorCooperativeLaunchTooLarge;

  LevelArgs a;
  const size_t plane = (size_t)HW;
  a.left = left;
  a.right = right;
  a.disp = disp;
  a.state = out;
  a.warped = scratch;
  a.bw2 = scratch + 3 * plane;
  a.bl2 = scratch + 6 * plane;
  a.upd = scratch + 9 * plane;
  a.ping = scratch + 12 * plane;
  a.pong = scratch + 15 * plane;
  a.bar = bar;
  a.H = H;
  a.W = W;
  a.mi = mi;
  a.n_smooth = n_smooth;
  a.replace_first = replace_first;
  a.gauss = ugsm::make_taps5(g_outer, g_inner, g_centre, g_inner, g_outer);
  a.avg = ugsm::make_taps5(0.0f, avg_tap, avg_tap, avg_tap, 0.0f);
  a.k = ugsm::DirConsts{no_peak, aff_scale, aff_bias, w_new, w_old};
  for (int m = 0; m < mi; ++m) a.thr[m] = thr[m];

  const cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  const void* fn = bilinear ? (const void*)level_kernel<true>
                            : (const void*)level_kernel<false>;
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kDirBX, kDirBY), args,
                                  0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
