// Level-resident matcher: all mi iterations of one pyramid level in one
// cooperative launch.  The Hopper form of level_resident_match
// (ug_stereomatcher_tpu/ops/pallas/level.py).
//
// Each iteration is warp -> G(W^2) -> direction update -> n smoothing
// passes -> 3-tap average, as in match_level's per-iteration path; G(L^2)
// is computed once per level.  The TPU kernel keeps every plane in VMEM
// to cut its dispatch floor.
//
// Bound on the card: neither bytes nor operations (a level-8 plane is
// 247 KB, the working set a few MB in the 50 MB L2, and the arithmetic a
// few microseconds of the card) but the count of dependent phases and the
// latency of each: a grid-wide phase costs an L2 round trip, a barrier
// and a block's pass over its tile, whatever the level's size.  With a
// barrier after every step (warp, G(W^2), direction, each smoothing pass,
// average: 4 + n per iteration) a level takes about 1.3 ms on an H100 at
// every level from 8 to 13.  Design: two phases per iteration, each a
// loop over 16 x 32 tiles that recomputes its halo in shared memory
// instead of waiting for the neighbouring blocks:
//
// * phase A (warp -> G(W^2) -> direction): the block stages L and warps
//   the right image by the state into shared memory over the tile +- 3
//   rows and columns, clamped to the image (the W halo of the direction
//   tile), blurs W^2 there over the tile +- 1 (the clamped shifted reads;
//   row pass, then column pass, each value rounded as the blur kernel
//   rounds it), and runs the direction tile body of direction.cu
//   (stencils.cuh, one row per thread here) from those; writes `upd`;
// * phase B (n smoothing passes -> average): the block loads `upd` over
//   the tile +- (n + 1), clipped to the image, runs the passes in shared
//   memory (ping-pong, a pass spoils one more line at each side of the
//   window that is not the image's edge) and the 3-tap average of the
//   tile; writes the state.
//
// That is 2 grid barriers per iteration (the last one of the level is
// left out: 2 mi - 1 in all), and none before the first iteration, since
// G(L^2) at a pixel is written and read by the same thread.  The grid is
// one block per tile, up to two 512-thread blocks per SM (64 registers a
// thread): on a level with more tiles than that, a block takes several
// in turn, and the SM's second block hides some of a tile's latency.  Tiles at
// the image's edge compute the edge pixels themselves, so every clamped
// lookup lands in the tile's own shared window.  Phase B's window lives
// in dynamic shared memory, 24 (16 + 2(n + 1)) (32 + 2(n + 1)) bytes
// (phase A borrows it for the row pass of G(W^2)); ugsm_level_limits
// says how large an n the card holds, and a larger one is refused.
//
// Every value is computed by the per-iteration kernels' own functions
// (stencils.cuh) on the same inputs, compiled under the same
// --fmad=false, so the result is bit-exact against the per-iteration
// chain.  The port's warp is an exact gather, so unlike the TPU kernel
// there is no warp window, no overflow flag and no recompute path.
//
// The grid barrier is one arrival word in device memory (zeroed on the
// stream before each launch), in the pattern of cooperative_groups' grid
// sync: one release atomic add per block, block 0 adding the complement
// that flips the word's top bit when the last block arrives, and an
// acquire poll of that bit; planes written during the launch are read
// with ld.global.cg (L2, never the non-coherent L1).  The library needs
// no relocatable device code.
//
// Block 0 also reports, in the words after the arrival word, the
// barriers it passed and the SM clock cycles its thread (0, 0) spent in
// each phase, summed over the iterations (stamps after the block's
// __syncthreads at each phase boundary: a few instructions a phase),
// which the host may read after the launch.
#include <climits>

#include "stencils.cuh"

namespace {

// One direction tile per block, one row per thread: the prologue's G(L^2)
// at a pixel is written by the thread that reads it in phase A.
using Tile = ugsm::DirTile<32, 16, 1>;
constexpr int kTW = Tile::kTW, kTH = Tile::kTH;
constexpr int kThreads = Tile::kThreads;
constexpr int kMaxIters = 256;
constexpr int kMaxSmooth = 1024;  // far above what shared memory holds
// Clock stamps of block 0, in the order of ops/cuda/level.py PHASES:
// G(L^2); phase A's warp (with the staging of L), Gc(W^2), direction and
// barrier; phase B's window load, passes, average and barrier.
enum Phase { kPrologue, kWarp, kGW2, kDirection, kBarrierA, kLoad, kPasses,
             kAverage, kBarrierB, kPhases };
constexpr int kBarWords = 2 + kPhases;  // arrivals, barriers, cycles

struct LevelArgs {
  const float* left;   // (3, H, W), never written
  const float* right;  // (3, H, W), never written
  const float* disp;   // (3, H, W) input state, never written
  float* state;        // (3, H, W): state between iterations; the result
  float* bl2;          // (3, H, W) scratch: G(L^2)
  float* upd;          // (3, H, W) scratch: the direction update
  unsigned int* bar;   // kBarWords: arrivals, barriers passed, cycles
  int H, W, mi, n_smooth, replace_first;
  ugsm::Taps5 gauss, avg;
  ugsm::DirConsts k;
  float thr[kMaxIters];
};

// Bytes of phase B's window: two buffers of 3 planes over the tile
// +- (n + 1).
size_t window_bytes(int n_smooth) {
  const size_t h = (size_t)n_smooth + 1;
  return 2 * 3 * (kTH + 2 * h) * (kTW + 2 * h) * sizeof(float);
}

// Block 0's thread (0, 0) adds the cycles since its previous stamp to
// phase k; clk[kPhases] holds that stamp.
__device__ __forceinline__ void stamp(long long* clk, Phase k) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    const long long now = clock64();
    clk[k] += now - clk[kPhases];
    clk[kPhases] = now;
  }
}

// Every block of the (co-resident) grid arrives before any leaves; the
// writes of every block before the barrier are visible after it.
__device__ __forceinline__ void grid_sync(unsigned int* bar,
                                          unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    // the arrivals of one barrier add up to 0x80000000: the top bit flips
    // once, when the last block arrives
    const unsigned int inc = blockIdx.x == 0 ? 0x80000000u - (nblocks - 1)
                                             : 1u;
    unsigned int old, now;
    asm volatile("atom.release.gpu.add.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(bar), "r"(inc)
                 : "memory");
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];"
                   : "=r"(now)
                   : "l"(bar)
                   : "memory");
    } while (((old ^ now) & 0x80000000u) == 0);
    if (blockIdx.x == 0) bar[1] += 1;
  }
  __syncthreads();
}

// Phase A of the tile at (r0, c0): warp -> Gc(W^2) -> direction update
// from the state `src`, into a.upd.  `rows` (3 WR GC floats of shared
// memory) holds Gc(W^2)'s row pass.
template <bool BILINEAR>
__device__ __forceinline__ void phase_a(const LevelArgs& a, const float* src,
                                        int m, Tile& t, float* rows,
                                        long long* clk, int r0, int c0) {
  using ugsm::clampi;
  using ugsm::LdL2;
  using ugsm::LdPlain;
  const int H = a.H, W = a.W;
  const size_t plane = (size_t)H * W;
  const ugsm::RowBlock g = ugsm::whole_image(H);
  // L over the tile +- 2 (left is never written: cp.async through L1),
  // while the block warps W into t.w over the tile +- 3, clamped: row i
  // is image row clamp(r0 - 3 + i), column j image column clamp(c0 - 3 +
  // j)
  ugsm::direction_stage_left<false>(t, a.left, g, W, r0, c0);
  for (int i = ugsm::block_tid(); i < Tile::WR * Tile::WC; i += kThreads) {
    const int rr = clampi(r0 - 3 + i / Tile::WC, 0, H - 1);
    const int cc = clampi(c0 - 3 + i % Tile::WC, 0, W - 1);
    const size_t p = (size_t)rr * W + cc;
    ugsm::warp_px<BILINEAR>(a.right, &t.w[0][0][0], 3, H, W,
                            Tile::WR * Tile::WC, i, rr, cc, LdL2::ld(src + p),
                            LdL2::ld(src + plane + p));
  }
  ugsm::cp_async_wait_all();
  __syncthreads();
  stamp(clk, kWarp);
  ugsm::direction_gw2<3>(t, rows, H, W, r0, c0, a.gauss);
  stamp(clk, kGW2);
  // The coarsest level's first iteration replaces the confidence.  G(L^2)
  // at a pixel was written by this thread: it may come through L1.
  ugsm::direction_update_tile<LdL2, false, LdPlain>(
      t, a.bl2, src, a.upd, g, W, r0, c0, a.thr[m],
      a.replace_first && m == 0, a.gauss, a.k);
  __syncthreads();  // every read of t done before the block's next tile
  stamp(clk, kDirection);
}

// Phase B of the tile at (r0, c0): n smoothing passes over the tile
// +- (n + 1), clipped to the image, in the shared `win`, then the 3-tap
// average of the tile into a.state.
__device__ __forceinline__ void phase_b(const LevelArgs& a, float* win,
                                        long long* clk, int r0, int c0) {
  using ugsm::LdL2;
  using ugsm::LdPlain;
  const int H = a.H, W = a.W, n = a.n_smooth, h = n + 1;
  const size_t plane = (size_t)H * W;
  const int tid = ugsm::block_tid();
  const int ra = max(r0 - h, 0), rb = min(r0 + kTH + h, H);
  const int ca = max(c0 - h, 0), cb = min(c0 + kTW + h, W);
  const int rw = cb - ca, wp = (rb - ra) * rw;
  for (int i = tid; i < wp; i += kThreads) {
    const size_t g = (size_t)(ra + i / rw) * W + ca + i % rw;
    for (int c = 0; c < 3; ++c) win[c * wp + i] = LdL2::ld(a.upd + c * plane + g);
  }
  __syncthreads();
  stamp(clk, kLoad);
  const float* fin = ugsm::smooth_window_passes(win, wp, ra, rb, ca, cb, H, W,
                                                n);
  stamp(clk, kPasses);
  const int r = r0 + threadIdx.y, x = c0 + threadIdx.x;
  if (r < H && x < W) {
    for (int c = 0; c < 3; ++c) {
      a.state[c * plane + (size_t)r * W + x] = ugsm::sep5_clamp_at<false, 1>(
          ugsm::PlaneAt<LdPlain, int>{fin + c * wp, rw, ra, ca}, r, x, H, W,
          a.avg);
    }
  }
  __syncthreads();  // the window is free for the block's next tile
  stamp(clk, kAverage);
}

template <bool BILINEAR>
__global__ void __launch_bounds__(kThreads, 2)
    level_kernel(const LevelArgs a) {
  __shared__ Tile t;
  extern __shared__ float win[];  // phase B's window; phase A's row pass
  __shared__ long long clk[kPhases + 1];  // block 0's stamps
  const int H = a.H, W = a.W;
  const size_t plane = (size_t)H * W;
  const unsigned int nblocks = gridDim.x;
  const int ntx = (W + kTW - 1) / kTW;
  const int ntiles = ntx * ((H + kTH - 1) / kTH);

  if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    for (int k = 0; k < kPhases; ++k) clk[k] = 0;
    clk[kPhases] = clock64();
  }
  if (a.mi == 0) {
    for (size_t p = blockIdx.x * kThreads + ugsm::block_tid();
         p < 3 * plane; p += (size_t)gridDim.x * kThreads)
      a.state[p] = a.disp[p];
    return;
  }
  // G(L^2), which holds for the whole level, at each pixel by the thread
  // that reads it in phase A (the same tiles, in the same order)
  for (int i = blockIdx.x; i < ntiles; i += gridDim.x) {
    const int r = (i / ntx) * kTH + threadIdx.y;
    const int x = (i % ntx) * kTW + threadIdx.x;
    if (r >= H || x >= W) continue;
    for (int c = 0; c < 3; ++c) {
      a.bl2[c * plane + (size_t)r * W + x] = ugsm::sep5_clamp_at<true, 2>(
          ugsm::PlaneAt<ugsm::LdPlain>{a.left + c * plane, W, 0, 0}, r, x, H,
          W, a.gauss);
    }
  }
  stamp(clk, kPrologue);

  for (int m = 0; m < a.mi; ++m) {
    const float* src = m == 0 ? a.disp : a.state;
    for (int i = blockIdx.x; i < ntiles; i += gridDim.x) {
      phase_a<BILINEAR>(a, src, m, t, win, clk, (i / ntx) * kTH,
                        (i % ntx) * kTW);
    }
    grid_sync(a.bar, nblocks);
    stamp(clk, kBarrierA);
    for (int i = blockIdx.x; i < ntiles; i += gridDim.x) {
      phase_b(a, win, clk, (i / ntx) * kTH, (i % ntx) * kTW);
    }
    if (m + 1 < a.mi) grid_sync(a.bar, nblocks);
    stamp(clk, kBarrierB);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    for (int k = 0; k < kPhases; ++k) a.bar[2 + k] = (unsigned int)clk[k];
  }
}

// The largest co-resident grid for n_smooth (0 if the window does not fit
// beside the static shared memory), after raising the kernel's dynamic
// shared memory limit to all that fits beside the static shared memory:
// the limit only ever rises, so a launch captured in a CUDA graph with a
// larger window than a later eager launch's stays within it on replay.
template <bool BILINEAR>
cudaError_t max_coresident(int n_smooth, int* out) {
  int dev = 0, coop = 0, sms = 0, optin = 0, per_sm = 0;
  *out = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, level_kernel<BILINEAR>);
  if (e != cudaSuccess) return e;
  const size_t dyn = window_bytes(n_smooth);
  if (attr.sharedSizeBytes + dyn > (size_t)optin) return cudaSuccess;
  e = cudaFuncSetAttribute(level_kernel<BILINEAR>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - (int)attr.sharedSizeBytes);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, level_kernel<BILINEAR>, kThreads, dyn);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}

// The largest n_smooth whose window fits beside the static shared memory.
template <bool BILINEAR>
cudaError_t max_smooth_passes(int* out) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, level_kernel<BILINEAR>);
  if (e != cudaSuccess) return e;
  int n = -1;
  while (n < kMaxSmooth && attr.sharedSizeBytes + window_bytes(n + 1) <=
                               (size_t)optin)
    ++n;
  *out = n;
  return cudaSuccess;
}

}  // namespace

// The largest n_smooth whose window the current device holds (-1 if
// none), and for n_smooth passes (0 <= n_smooth <= that) the largest grid
// of level-kernel blocks it holds at once.
UGSM_API int ugsm_level_limits(int bilinear, int n_smooth, int* max_smooth,
                               int* max_grid) {
  if (n_smooth < 0 || n_smooth > kMaxSmooth)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = bilinear ? max_smooth_passes<true>(max_smooth)
                           : max_smooth_passes<false>(max_smooth);
  if (e != cudaSuccess) return (int)e;
  return (int)(bilinear ? max_coresident<true>(n_smooth, max_grid)
                        : max_coresident<false>(n_smooth, max_grid));
}

// left/right/disp/out: (3, H, W); scratch: 6 planes of H * W floats;
// bar: kBarWords (11) words of device memory: after the launch the second
// holds the barriers passed and the rest block 0's cycles per phase; thr:
// mi host floats.  max_grid: ugsm_level_limits' grid for this n_smooth on
// the current device (queried once by the caller, which also raises the
// kernel's shared memory limit; 0 where the window does not fit).
// grid_req = 0 sizes the grid from the level (one block per tile); a
// larger request than max_grid is refused with
// cudaErrorCooperativeLaunchTooLarge, and so is an n_smooth whose window
// does not fit.  Stream capture takes the cooperative launch as a
// cooperative kernel node (CUDA 12.9 runtime on an H100), so a CUDA graph
// replays it as it is.
UGSM_API int ugsm_level_resident(
    const float* left, const float* right, const float* disp, float* out,
    float* scratch, unsigned int* bar, const float* thr, int mi, int H,
    int W, int n_smooth, int replace_first, int bilinear, float g_outer,
    float g_inner, float g_centre, float avg_tap, float no_peak,
    float aff_scale, float aff_bias, float w_new, float w_old, int grid_req,
    int max_grid, void* stream) {
  if (H < 1 || W < 1 || mi < 0 || mi > kMaxIters || n_smooth < 0 ||
      n_smooth > kMaxSmooth || (long long)H * W > INT_MAX / 4 ||
      g_outer == 0.0f || g_inner == 0.0f || g_centre == 0.0f ||
      avg_tap == 0.0f)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  const int ntiles = ((W + kTW - 1) / kTW) * ((H + kTH - 1) / kTH);
  const int grid = grid_req > 0 ? grid_req
                                : (ntiles < max_grid ? ntiles : max_grid);
  if (grid < 1 || grid > max_grid)
    return (int)cudaErrorCooperativeLaunchTooLarge;

  LevelArgs a;
  const size_t plane = (size_t)H * W;
  a.left = left;
  a.right = right;
  a.disp = disp;
  a.state = out;
  a.bl2 = scratch;
  a.upd = scratch + 3 * plane;
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
  e = cudaMemsetAsync(bar, 0, kBarWords * sizeof(unsigned int), s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  const void* fn = bilinear ? (const void*)level_kernel<true>
                            : (const void*)level_kernel<false>;
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kTW, kTH), args,
                                  window_bytes(n_smooth), s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
