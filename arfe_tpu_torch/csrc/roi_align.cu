// FPN RoIAlign forward for Hopper (sm_90a), detectron2-aligned:
//   out[r, py, px, c] = mean over the sn x sn samples of bin (py, px) of the
//   bilinear value at channel c of level target_lvls[r], image rois[r, 0].
//
// Replaces the TPU kernel arfe_tpu/ops/pallas_roi_align.py::roi_align_pallas
// (Pallas `_kernel`, pallas_call at :339), reached from the bbox RoI
// extractor (arfe_tpu/models/roi_heads/roi_extractors/single_level.py:66-74).
// None of the TPU machinery carries over: no window DMA, no window buckets,
// no one-hot matmuls. Coordinates follow the plain version
// (arfe_tpu_torch/ops/roi_align.py::roi_align_pyramid_plain, after
// arfe_tpu/ops/roi_align.py:209-248): f32 arithmetic in the same order with
// no fused multiply-add, clamp to [0, size-1], i1 = min(i0 + 1, size - 1),
// zero weight outside (-1, size), and a division by sn^2 always.
//
// What bounds it on this card: memory. Each output element reads 4 corners
// for each of sn^2 samples (16 reads at sn = 2) and does a few FMAs per read;
// the least traffic is the output plus the distinct feature pixels the
// samples touch, which neighbouring samples and RoIs share.
//
// Design: one block per RoI. The block first computes its 2 * 7 * sn
// per-axis sample parameters (corner rows / columns, weights, validity) into
// shared memory, once, instead of once per channel, with the code that the
// gradient kernel (roi_align_bwd.cu) shares (roi_align_common.cuh). Then its threads walk the
// (bin, channel) output elements with the channel fastest: features are
// NHWC, so the 32 lanes of a warp read 32 neighbouring channels of one pixel
// (coalesced) and write 32 neighbouring outputs. Corner reads go straight to
// device memory through L1/L2, which hold the small per-RoI footprint.
// Accumulation is f32; the output is written in the feature dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "roi_align_common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
roi_align_kernel(arfe::Levels lv, const float* __restrict__ rois,
                 const int* __restrict__ target_lvls, T* __restrict__ out,
                 int batch, int channels, int out_h, int out_w, int sn,
                 int aligned) {
  extern __shared__ __align__(16) int smem[];
  const int ny = out_h * sn, ns = (out_h + out_w) * sn;
  const arfe::AxisTables tab = arfe::axis_tables(smem, ns);
  const int* i0s = tab.i0;
  const int* i1s = tab.i1;
  const float* w0s = tab.w0;
  const float* w1s = tab.w1;
  const int* vs = tab.valid;

  const int r = blockIdx.x;
  const float* roi = rois + (size_t)r * 5;
  const int l = arfe::roi_level(target_lvls, r, lv.num);
  const int b = arfe::roi_batch(roi, batch);
  const int h = lv.h[l], w = lv.w[l];
  if (threadIdx.x < ns)
    arfe::fill_axis_sample(tab, threadIdx.x, roi, lv.scale[l], h, w, out_h,
                           out_w, sn, aligned);
  __syncthreads();

  const T* feat = static_cast<const T*>(lv.data[l]) + (size_t)b * h * w * channels;
  T* o = out + (size_t)r * out_h * out_w * channels;
  const int total = out_h * out_w * channels;
  const float count = (float)(sn * sn);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int c = idx % channels;
    const int bin = idx / channels;
    const int py = bin / out_w, px = bin % out_w;
    float acc = 0.f;
    for (int sy = 0; sy < sn; ++sy) {
      const int ty = py * sn + sy;
      if (!vs[ty]) continue;
      const T* row0 = feat + (size_t)i0s[ty] * w * channels + c;
      const T* row1 = feat + (size_t)i1s[ty] * w * channels + c;
      const float wy0 = w0s[ty], wy1 = w1s[ty];
      for (int sx = 0; sx < sn; ++sx) {
        const int tx = ny + px * sn + sx;
        if (!vs[tx]) continue;
        const int x0 = i0s[tx] * channels, x1 = i1s[tx] * channels;
        const float wx0 = w0s[tx], wx1 = w1s[tx];
        float val = __fmul_rn(wy0, wx0) * to_float(row0[x0]);
        val += __fmul_rn(wy0, wx1) * to_float(row0[x1]);
        val += __fmul_rn(wy1, wx0) * to_float(row1[x0]);
        val += __fmul_rn(wy1, wx1) * to_float(row1[x1]);
        acc += val;
      }
    }
    store(o + idx, acc / count);
  }
}

template <typename T>
cudaError_t launch(const arfe::Levels& lv, const float* rois, const int* lvls, void* out,
                   int num_rois, int batch, int channels, int out_h, int out_w,
                   int sn, int aligned, cudaStream_t stream) {
  const int ns = (out_h + out_w) * sn;
  if (ns > THREADS) return cudaErrorInvalidValue;
  const size_t smem = arfe::axis_tables_bytes(ns);
  roi_align_kernel<T><<<num_rois, THREADS, smem, stream>>>(
      lv, rois, lvls, static_cast<T*>(out), batch, channels, out_h, out_w, sn, aligned);
  return cudaGetLastError();
}

}  // namespace

// level_data[l]: (batch, level_h[l], level_w[l], channels) NHWC contiguous,
// f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); level_scale[l] = 1 / stride.
// rois: (num_rois, 5) f32 [b, x1, y1, x2, y2]; target_lvls: (num_rois,)
// int32; out: (num_rois, out_h, out_w, channels) in the feature dtype.
// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int arfe_roi_align_forward(
    const void* const* level_data, const int* level_h, const int* level_w,
    const float* level_scale, int num_levels, int batch, int channels,
    const void* rois, const void* target_lvls, void* out, int num_rois,
    int out_h, int out_w, int sample_num, int aligned, int is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > arfe::MAX_LEVELS || sample_num < 1)
    return (int)cudaErrorInvalidValue;
  if (num_rois <= 0) return (int)cudaSuccess;
  const arfe::Levels lv = arfe::make_levels(const_cast<void* const*>(level_data),
                                            level_h, level_w, level_scale,
                                            num_levels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* t = static_cast<const int*>(target_lvls);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(lv, r, t, out, num_rois, batch, channels,
                                      out_h, out_w, sample_num, aligned, s)
              : launch<float>(lv, r, t, out, num_rois, batch, channels, out_h,
                              out_w, sample_num, aligned, s);
  return (int)err;
}
