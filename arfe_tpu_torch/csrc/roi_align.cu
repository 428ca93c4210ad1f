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
// What bounds it on this card: memory. The least traffic is the output plus
// the distinct feature pixels the samples touch (neighbouring samples and
// RoIs share them): at R = 2000, bs2 800x1344, C = 256 in bf16 about 108 MB,
// 0.032 ms. Each output element still reads 4 corners for each of sn^2
// samples, 16 reads at sn = 2, which L1 and L2 serve: a RoI spans 14-28
// pixels of its level per side, so its corner reads sum to a few hundred MB
// of L2-to-SM traffic at R = 2000. The kernel is held to that traffic and to
// its instruction count.
//
// Design: one block per RoI. The block first computes its 2 * 7 * sn
// per-axis sample parameters (corner rows / columns, weights, validity) into
// shared memory, once, with the code that the gradient kernel
// (roi_align_bwd.cu) shares (roi_align_common.cuh). Each thread then owns 8
// contiguous channels (16 bytes of bf16, two float4 of f32) for the whole
// RoI: its channel group is fixed, and it walks the bins with a plain loop,
// so no division by a run-time divisor is left in the loop. For each sample
// of a bin it reads the four corners as one 16-byte load each (two in f32)
// and forms the four weights __fmul_rn(wy, wx) once for its 8 channels;
// at C = 256 a warp reads one whole 512-byte pixel per corner and writes its
// bin's 256 outputs in one 16-byte store per lane. Samples outside the
// level (validity 0) take weight 0: their clamped corners are valid
// addresses, and 0 * f adds nothing, as in the plain version's weights. The
// block has channels / 8 x P threads, P bins at a time, with P chosen so
// the passes over the 7 x 7 bins are even (224 threads at C = 256).
// Accumulation is f32 in the plain version's order (corner 00, 01, 10, 11
// of a sample, then the sample into the bin's sum, samples row by row),
// each product and sum rounded on its own (__fmul_rn, __fadd_rn: no
// contraction into fused multiply-adds), as the plain version's tensor ops
// round them, so f32 outputs equal the plain version's at any magnitude; the
// output is written in the feature dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "roi_align_common.cuh"

namespace {

constexpr int MAX_THREADS = 256;

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[8]) {
  uint32_t words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    words[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
}

// SN > 0: sn is SN, known to the compiler (the 2 x 2 grid of the flagship),
// so the samples' 16 corner loads are all in flight at once; SN = 0: sn is
// the run-time argument.
template <typename T, int SN>
__global__ void __launch_bounds__(MAX_THREADS)
roi_align_kernel(arfe::Levels lv, const float* __restrict__ rois,
                 const int* __restrict__ target_lvls, T* __restrict__ out,
                 int batch, int channels, int out_h, int out_w, int sn_arg,
                 int aligned) {
  extern __shared__ __align__(16) int smem[];
  const int sn = SN > 0 ? SN : sn_arg;
  const int ny = out_h * sn, ns = (out_h + out_w) * sn;
  const arfe::AxisTables tab = arfe::axis_tables(smem, ns);

  const int r = blockIdx.x;
  const float* roi = rois + (size_t)r * 5;
  const int l = arfe::roi_level(target_lvls, r, lv.num);
  const int b = arfe::roi_batch(roi, batch);
  const int h = lv.h[l], w = lv.w[l];
  for (int t = threadIdx.x; t < ns; t += blockDim.x)
    arfe::fill_axis_sample(tab, t, roi, lv.scale[l], h, w, out_h, out_w, sn, aligned);
  __syncthreads();

  const int groups = channels / 8;
  const int per_pass = blockDim.x / groups;  // bins at a time
  const int bin0 = threadIdx.x / groups;
  if (bin0 >= per_pass) return;
  const int c0 = (threadIdx.x - bin0 * groups) * 8;
  const size_t row_stride = (size_t)w * channels;
  const T* feat = static_cast<const T*>(lv.data[l]) + (size_t)b * h * row_stride + c0;
  const int bins = out_h * out_w;
  T* o = out + (size_t)r * bins * channels + c0;
  const float count = (float)(sn * sn);
  // (py, px) of the thread's bin, stepped by per_pass bins without division
  int py = bin0 / out_w;
  int px = bin0 - py * out_w;
  const int step_y = per_pass / out_w, step_x = per_pass - step_y * out_w;
  for (int bin = bin0; bin < bins; bin += per_pass) {
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
#pragma unroll
    for (int sy = 0; sy < sn; ++sy) {
      const int ty = py * sn + sy;
      const float vy = tab.valid[ty] ? 1.f : 0.f;
      const T* row0 = feat + tab.i0[ty] * row_stride;
      const T* row1 = feat + tab.i1[ty] * row_stride;
      const float wy0 = tab.w0[ty] * vy, wy1 = tab.w1[ty] * vy;
#pragma unroll
      for (int sx = 0; sx < sn; ++sx) {
        const int tx = ny + px * sn + sx;
        const float vx = tab.valid[tx] ? 1.f : 0.f;
        const int x0 = tab.i0[tx] * channels, x1 = tab.i1[tx] * channels;
        const float wx0 = tab.w0[tx] * vx, wx1 = tab.w1[tx] * vx;
        const float w00 = __fmul_rn(wy0, wx0), w01 = __fmul_rn(wy0, wx1);
        const float w10 = __fmul_rn(wy1, wx0), w11 = __fmul_rn(wy1, wx1);
        float f00[8], f01[8], f10[8], f11[8];
        load8(row0 + x0, f00);
        load8(row0 + x1, f01);
        load8(row1 + x0, f10);
        load8(row1 + x1, f11);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float val = __fmul_rn(w00, f00[c]);
          val = __fadd_rn(val, __fmul_rn(w01, f01[c]));
          val = __fadd_rn(val, __fmul_rn(w10, f10[c]));
          val = __fadd_rn(val, __fmul_rn(w11, f11[c]));
          acc[c] = __fadd_rn(acc[c], val);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = acc[c] / count;
    store8(o + (size_t)bin * channels, acc);
    px += step_x;
    py += step_y;
    if (px >= out_w) {
      px -= out_w;
      ++py;
    }
  }
}

template <typename T, int SN>
cudaError_t launch_sn(const arfe::Levels& lv, const float* rois, const int* lvls, void* out,
                      int num_rois, int batch, int channels, int out_h, int out_w, int sn,
                      int aligned, cudaStream_t stream) {
  const int groups = channels / 8;
  const int bins = out_h * out_w;
  int per_pass = std::min(std::max(MAX_THREADS / groups, 1), bins);
  const int passes = (bins + per_pass - 1) / per_pass;
  per_pass = (bins + passes - 1) / passes;  // even passes
  const size_t smem = arfe::axis_tables_bytes((out_h + out_w) * sn);
  roi_align_kernel<T, SN><<<num_rois, groups * per_pass, smem, stream>>>(
      lv, rois, lvls, static_cast<T*>(out), batch, channels, out_h, out_w, sn, aligned);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const arfe::Levels& lv, const float* rois, const int* lvls, void* out,
                   int num_rois, int batch, int channels, int out_h, int out_w, int sn,
                   int aligned, cudaStream_t stream) {
  if (channels % 8 != 0 || channels / 8 > MAX_THREADS || out_h < 1 || out_w < 1)
    return cudaErrorInvalidValue;
  if (sn == 2)
    return launch_sn<T, 2>(lv, rois, lvls, out, num_rois, batch, channels, out_h, out_w, sn,
                           aligned, stream);
  return launch_sn<T, 0>(lv, rois, lvls, out, num_rois, batch, channels, out_h, out_w, sn,
                         aligned, stream);
}

}  // namespace

// level_data[l]: (batch, level_h[l], level_w[l], channels) NHWC contiguous,
// f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), 16-byte aligned, channels a
// multiple of 8 (at most 2048); level_scale[l] = 1 / stride. rois:
// (num_rois, 5) f32 [b, x1, y1, x2, y2]; target_lvls: (num_rois,) int32;
// out: (num_rois, out_h, out_w, channels) in the feature dtype, 16-byte
// aligned. Launches on `stream`; returns the cudaError_t of the launch (0 on
// success).
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
