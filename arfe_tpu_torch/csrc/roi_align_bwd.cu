// FPN RoIAlign feature gradient for Hopper (sm_90a), the transpose of
// roi_align.cu:
//   grad[l][b, y, x, c] += g[r, py, px, c] / sn^2 * wy * wx
// for every RoI r on level l = target_lvls[r], image b = rois[r, 0], every
// sample of bin (py, px) and every bilinear corner (y, x) of that sample with
// its weights wy, wx. There is no gradient for the RoIs.
//
// Replaces the TPU kernel arfe_tpu/ops/pallas_roi_align.py::
// roi_align_pallas_bwd (pallas_call at :759; bodies _bwd_kernel :495-554,
// _bwd_kernel_pipe :557-655, _bwd_base_rows :452-492), reached from the
// feature VJP of roi_align_auto (arfe_tpu/ops/pallas_roi_align.py:407-435).
// None of the TPU machinery carries over: no window buckets, no scalar
// prefetch, no SMEM chunking, no one-hot matmuls, and no serialised
// read-modify-write over nbuf disjoint buffer sets. Overlapping RoIs add into
// the same pixels with f32 atomics instead.
//
// What bounds it on this card: bytes and atomics. It reads the f32 cotangent
// once and adds into the f32 gradient levels, which the wrapper zero-fills
// first (at bs2, 800x1344, 256 channels: 51 MB of cotangent, 183 MB of zero
// fill). Each cotangent element issues 4 corners x sn^2 samples = 16 atomic
// adds at sn = 2; pixels that many RoIs cover (RoIs crowd around the ground
// truth) take many adds, which the L2 serialises per address.
//
// Design: one block per RoI, as in the forward. The block computes its
// per-axis sample tables (corners, weights, validity) into shared memory
// with the forward's own code (roi_align_common.cuh), so both kernels place
// every sample bit for bit alike. Its threads walk the (bin, channel)
// cotangent elements with the channel fastest: the 32 lanes of a warp add
// into 32 neighbouring channels of one NHWC pixel, so each warp's atomics
// cover whole 128-byte lines. A zero cotangent element (RoI slots whose loss
// weight is 0) adds nothing and is skipped. The sum order differs from run
// to run, so results agree with the plain version to f32 rounding only.
#include <cuda_runtime.h>
#include <math.h>

#include "roi_align_common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
roi_align_bwd_kernel(arfe::Levels lv, const float* __restrict__ grad_out,
                     const float* __restrict__ rois,
                     const int* __restrict__ target_lvls, int batch,
                     int channels, int out_h, int out_w, int sn, int aligned) {
  extern __shared__ __align__(16) int smem[];
  const int ny = out_h * sn, ns = (out_h + out_w) * sn;
  const arfe::AxisTables tab = arfe::axis_tables(smem, ns);

  const int r = blockIdx.x;
  const float* roi = rois + (size_t)r * 5;
  const int l = arfe::roi_level(target_lvls, r, lv.num);
  const int b = arfe::roi_batch(roi, batch);
  const int h = lv.h[l], w = lv.w[l];
  if (threadIdx.x < ns)
    arfe::fill_axis_sample(tab, threadIdx.x, roi, lv.scale[l], h, w, out_h,
                           out_w, sn, aligned);
  __syncthreads();

  float* grad = static_cast<float*>(lv.data[l]) + (size_t)b * h * w * channels;
  const float* g = grad_out + (size_t)r * out_h * out_w * channels;
  const int total = out_h * out_w * channels;
  const float count = (float)(sn * sn);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const float gv = __fdiv_rn(g[idx], count);
    if (gv == 0.f) continue;
    const int c = idx % channels;
    const int bin = idx / channels;
    const int py = bin / out_w, px = bin % out_w;
    for (int sy = 0; sy < sn; ++sy) {
      const int ty = py * sn + sy;
      if (!tab.valid[ty]) continue;
      float* row0 = grad + (size_t)tab.i0[ty] * w * channels + c;
      float* row1 = grad + (size_t)tab.i1[ty] * w * channels + c;
      const float wy0 = tab.w0[ty], wy1 = tab.w1[ty];
      for (int sx = 0; sx < sn; ++sx) {
        const int tx = ny + px * sn + sx;
        if (!tab.valid[tx]) continue;
        const int x0 = tab.i0[tx] * channels, x1 = tab.i1[tx] * channels;
        const float wx0 = tab.w0[tx], wx1 = tab.w1[tx];
        atomicAdd(row0 + x0, __fmul_rn(gv, __fmul_rn(wy0, wx0)));
        atomicAdd(row0 + x1, __fmul_rn(gv, __fmul_rn(wy0, wx1)));
        atomicAdd(row1 + x0, __fmul_rn(gv, __fmul_rn(wy1, wx0)));
        atomicAdd(row1 + x1, __fmul_rn(gv, __fmul_rn(wy1, wx1)));
      }
    }
  }
}

}  // namespace

// grad_levels[l]: (batch, level_h[l], level_w[l], channels) NHWC contiguous
// f32, zero-filled by the caller; level_scale[l] = 1 / stride. grad_out:
// (num_rois, out_h, out_w, channels) f32 cotangent; rois: (num_rois, 5) f32
// [b, x1, y1, x2, y2]; target_lvls: (num_rois,) int32. Launches on `stream`;
// returns the cudaError_t of the launch (0 on success).
extern "C" int arfe_roi_align_backward(
    void* const* grad_levels, const int* level_h, const int* level_w,
    const float* level_scale, int num_levels, int batch, int channels,
    const void* grad_out, const void* rois, const void* target_lvls,
    int num_rois, int out_h, int out_w, int sample_num, int aligned,
    void* stream) {
  if (num_levels < 1 || num_levels > arfe::MAX_LEVELS || sample_num < 1)
    return (int)cudaErrorInvalidValue;
  if (num_rois <= 0) return (int)cudaSuccess;
  const int ns = (out_h + out_w) * sample_num;
  if (ns > THREADS) return (int)cudaErrorInvalidValue;
  const arfe::Levels lv = arfe::make_levels(grad_levels, level_h, level_w,
                                            level_scale, num_levels);
  roi_align_bwd_kernel<<<num_rois, THREADS, arfe::axis_tables_bytes(ns),
                         static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(grad_out), static_cast<const float*>(rois),
      static_cast<const int*>(target_lvls), batch, channels, out_h, out_w,
      sample_num, aligned);
  return (int)cudaGetLastError();
}
