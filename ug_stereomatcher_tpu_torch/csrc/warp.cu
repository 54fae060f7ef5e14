// Backward warp by a two-axis disparity field, nearest and bilinear: the
// Hopper form of warp_windowed_dyn and warp_windowed with their
// sweep_nearest / sweep_bilinear (ug_stereomatcher_tpu/ops/pallas/
// warp.py), which replaces both of them, the planner plan_dyn_warp and
// the tier fallbacks of match.py.
//
//   nearest:  out[c, r, x] = src[c, clamp(floor((r + 0.5) + dv)),
//                                   clamp(floor((x + 0.5) + dh))]
//   bilinear: the four clamped taps around ((x + 0.5) + dh) - 0.5 and
//             ((r + 0.5) + dv) - 0.5, weights in float32 (nearest_tap,
//             bilinear_taps and bilinear_mix in stencils.cuh, which
//             level.cu warps with too).
//
// The TPU kernels exist because Mosaic has no 2-D gather: they sweep a
// source window per row tile and need a planner and an exact fallback
// for fields that leave the window.  A GPU thread can read any address,
// so one direct gather per output value is exact for every field and
// needs no window.  Coordinates are computed in float32 exactly as
// _dest_coords + tex_gather do, so the result is bit-exact.
//
// Bound: device memory (read dh, dv and 3 gathered floats, write 3: 32
// bytes a pixel).  Every gather depends on the field load before it, so
// what limits a thread is how many loads it keeps in flight.  Design:
// * a block of 32 x 8 threads; each thread owns K pixels of one row, 32
//   columns apart (K = 4 nearest, 2 bilinear), so each store of a warp is
//   one coalesced run of 32 floats whatever the row's alignment, and a
//   block covers 8 rows: a smooth field's source rows, and a bilinear
//   pixel's second tap row, are mostly rows its neighbours read too,
//   already in L1;
// * a thread loads the field of its K pixels, computes every tap, then
//   issues all 3K (nearest) or 12K (bilinear) gathers of three channels
//   before it stores any, through the read-only path (ld.global.nc);
// * 32-bit offsets (the wrapper refuses C * H * W >= 2^31).
//
// Row-sharded form (warp_windowed / warp_windowed_dyn with row_halo=True,
// warp.py:356-385, :631-664): the output is a shard's rows [row0, row0 +
// Hl) of the level, from its own (Hl, W) disparity planes, and the source
// is the whole (C, H, W) right image of the level, gathered once per level
// by the caller; sources and clamps are in global rows.  The TPU form
// gathers from the shard's block plus a window of halo rows and needs the
// overflow guard when a field leaves it; the whole image needs neither.
//
// Early-exit guard: given a flag (`stop`, not null), every block returns
// before its first load or store while the flag is set, so a level's
// schedule can be enqueued whole and the iterations after its exit cost
// a launch each (match.match_level; the flag is set by convergence.cu).
// Null on the fixed schedule and the row-sharded form.
#include <climits>

#include "stencils.cuh"

namespace {

constexpr int kBX = 32, kBY = 8;

// NC channels from img (planes of `plane` floats) at the K pixels' taps
// into out (planes of out_plane floats) at offsets q + 32 k, those with
// x0 + 32 k < W: every load before any store.
template <int NC, int K>
__device__ __forceinline__ void gather_nearest(const float* __restrict__ img,
                                               float* __restrict__ out,
                                               int plane, int out_plane,
                                               const int (&src)[K], int q,
                                               int x0, int W) {
  float v[NC][K];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[c][k] = __ldg(img + c * plane + src[k]);
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (x0 + 32 * k < W) out[c * out_plane + q + 32 * k] = v[c][k];
    }
  }
}

template <int NC, int K>
__device__ __forceinline__ void gather_bilinear(
    const float* __restrict__ img, float* __restrict__ out, int plane,
    int out_plane, const ugsm::BilinearTaps (&tp)[K], int q, int x0, int W) {
  float v[NC][K][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* __restrict__ s = img + c * plane;
      v[c][k][0] = __ldg(s + tp[k].p00);
      v[c][k][1] = __ldg(s + tp[k].p01);
      v[c][k][2] = __ldg(s + tp[k].p10);
      v[c][k][3] = __ldg(s + tp[k].p11);
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (x0 + 32 * k < W) {
        out[c * out_plane + q + 32 * k] =
            ugsm::bilinear_mix(v[c][k][0], v[c][k][1], v[c][k][2],
                               v[c][k][3], tp[k].ax, tp[k].ay);
      }
    }
  }
}

template <bool BILINEAR, int K>
__global__ void __launch_bounds__(kBX * kBY)
    warp_kernel(const float* __restrict__ img, const float* __restrict__ dh,
                const float* __restrict__ dv, float* __restrict__ out, int C,
                int H, int W, int Hl, int row0,
                const int* __restrict__ stop) {
  if (ugsm::stopped(stop)) return;
  const int plane = H * W, out_plane = Hl * W;
  const int x0 = blockIdx.x * (kBX * K) + threadIdx.x;
  for (int r = blockIdx.y * kBY + threadIdx.y; r < Hl;
       r += gridDim.y * kBY) {
    const int q = r * W + x0;
    float fh[K], fv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool in = x0 + 32 * k < W;  // else any in-range tap will do
      fh[k] = in ? __ldg(dh + q + 32 * k) : 0.0f;
      fv[k] = in ? __ldg(dv + q + 32 * k) : 0.0f;
    }
    if (BILINEAR) {
      ugsm::BilinearTaps tp[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        tp[k] = ugsm::bilinear_taps(H, W, row0 + r, x0 + 32 * k, fh[k],
                                    fv[k]);
      }
      int c = 0;
      for (; c + 3 <= C; c += 3) {
        gather_bilinear<3, K>(img + c * plane, out + c * out_plane, plane,
                              out_plane, tp, q, x0, W);
      }
      for (; c < C; ++c) {
        gather_bilinear<1, K>(img + c * plane, out + c * out_plane, plane,
                              out_plane, tp, q, x0, W);
      }
    } else {
      int src[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        src[k] = ugsm::nearest_tap(H, W, row0 + r, x0 + 32 * k, fh[k], fv[k]);
      }
      int c = 0;
      for (; c + 3 <= C; c += 3) {
        gather_nearest<3, K>(img + c * plane, out + c * out_plane, plane,
                             out_plane, src, q, x0, W);
      }
      for (; c < C; ++c) {
        gather_nearest<1, K>(img + c * plane, out + c * out_plane, plane,
                             out_plane, src, q, x0, W);
      }
    }
  }
}

template <bool BILINEAR, int K>
void launch(const float* img, const float* dh, const float* dv, float* out,
            int C, int H, int W, int Hl, int row0, const int* stop,
            cudaStream_t s) {
  const int strips = (Hl + kBY - 1) / kBY;
  const dim3 grid((W + kBX * K - 1) / (kBX * K),
                  strips < 65535 ? strips : 65535);
  warp_kernel<BILINEAR, K><<<grid, dim3(kBX, kBY), 0, s>>>(
      img, dh, dv, out, C, H, W, Hl, row0, stop);
}

}  // namespace

// img: (C, H, W) with C * H * W < 2^31; dh, dv, out: rows [row0, row0 +
// Hl) of the (H, W) grid (Hl = H, row0 = 0 for the whole image).
// bilinear == 0: point sampling; != 0: CUDA linear filtering with float32
// weights (never the texture unit's 9-bit filter).  stop: the early-exit
// flag, or null.
UGSM_API int ugsm_warp(const float* img, const float* dh, const float* dv,
                       float* out, int C, int H, int W, int Hl, int row0,
                       int bilinear, const int* stop, void* stream) {
  if (C < 1 || H < 1 || W < 1 || Hl < 1 || row0 < 0 || row0 + Hl > H ||
      (long long)C * H * W > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bilinear) {
    launch<true, 2>(img, dh, dv, out, C, H, W, Hl, row0, stop, s);
  } else {
    launch<false, 4>(img, dh, dv, out, C, H, W, Hl, row0, stop, s);
  }
  return (int)cudaGetLastError();
}
