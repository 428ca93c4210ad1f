// Shared by the RoIAlign forward (roi_align.cu) and its feature gradient
// (roi_align_bwd.cu): the level table and the per-axis sampling parameters,
// so that the two kernels place every sample and weight bit for bit alike.
//
// Coordinates follow the plain version
// (arfe_tpu_torch/ops/roi_align.py::sample_corners, after
// arfe_tpu/ops/roi_align.py:209-248): f32 arithmetic in the same order with
// no fused multiply-add (__fmul_rn / __fadd_rn / __fdiv_rn), clamp to
// [0, size - 1], i1 = min(i0 + 1, size - 1), zero weight outside (-1, size).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace arfe {

constexpr int MAX_LEVELS = 4;

struct Levels {
  void* data[MAX_LEVELS];  // (batch, h, w, channels) NHWC, contiguous
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  float scale[MAX_LEVELS];  // 1 / stride, as f32
  int num;
};

// Levels past `num` repeat level 0, so that every entry is a valid pointer.
inline Levels make_levels(void* const* data, const int* h, const int* w,
                          const float* scale, int num) {
  Levels lv;
  lv.num = num;
  for (int i = 0; i < MAX_LEVELS; ++i) {
    const int j = i < num ? i : 0;
    lv.data[i] = data[j];
    lv.h[i] = h[j];
    lv.w[i] = w[j];
    lv.scale[i] = scale[j];
  }
  return lv;
}

// Per-axis sample tables in shared memory. Entry t < ns = (out_h + out_w) * sn
// (the out_h * sn y samples first, then the out_w * sn x samples) holds the
// corner indices i0, i1, the weights w0, w1 and the validity.
struct AxisTables {
  int* i0;
  int* i1;
  float* w0;
  float* w1;
  int* valid;
};

inline size_t axis_tables_bytes(int ns) { return (size_t)ns * 5 * sizeof(int); }

__device__ __forceinline__ AxisTables axis_tables(int* smem, int ns) {
  AxisTables t;
  t.i0 = smem;
  t.i1 = t.i0 + ns;
  t.w0 = reinterpret_cast<float*>(t.i1 + ns);
  t.w1 = t.w0 + ns;
  t.valid = reinterpret_cast<int*>(t.w1 + ns);
  return t;
}

// The level of RoI r, clamped into [0, num).
__device__ __forceinline__ int roi_level(const int* target_lvls, int r, int num) {
  return min(max(target_lvls[r], 0), num - 1);
}

// The image of a RoI [b, x1, y1, x2, y2], clamped into [0, batch).
__device__ __forceinline__ int roi_batch(const float* roi, int batch) {
  return min(max((int)roi[0], 0), batch - 1);  // (int) truncates, as astype does
}

// Entry t of the tables of RoI `roi` on a level of h x w pixels and scale sc.
__device__ __forceinline__ void fill_axis_sample(
    const AxisTables& tab, int t, const float* roi, float sc, int h, int w,
    int out_h, int out_w, int sn, int aligned) {
  const int ny = out_h * sn;
  const bool is_y = t < ny;
  const int s = is_y ? t : t - ny;
  const float off = aligned ? 0.5f : 0.f;
  // roi corners in level coordinates: x1, y1, x2, y2
  const float lo = __fsub_rn(__fmul_rn(roi[is_y ? 2 : 1], sc), off);
  const float hi = __fsub_rn(__fmul_rn(roi[is_y ? 4 : 3], sc), off);
  float extent = __fsub_rn(hi, lo);
  if (!aligned) extent = fmaxf(extent, 1.f);
  const float bin = __fdiv_rn(extent, (float)(is_y ? out_h : out_w));
  // sample s of bin s / sn sits at (s / sn) + ((s % sn) + 0.5) / sn bins
  const float frac = (float)((double)(s / sn) + ((double)(s % sn) + 0.5) / (double)sn);
  const float coord = __fadd_rn(lo, __fmul_rn(frac, bin));
  const int size = is_y ? h : w;
  const float fsize = (float)size;
  const float c = fminf(fmaxf(coord, 0.f), __fsub_rn(fsize, 1.f));
  const int i0 = (int)floorf(c);
  const float w1 = __fsub_rn(c, (float)i0);
  tab.i0[t] = i0;
  tab.i1[t] = min(i0 + 1, size - 1);
  tab.w0[t] = __fsub_rn(1.f, w1);
  tab.w1[t] = w1;
  tab.valid[t] = coord > -1.f && coord < fsize;
}

}  // namespace arfe
