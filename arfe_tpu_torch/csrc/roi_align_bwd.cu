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
// fill). The adds are the cost: one scalar atomic per (sample, corner,
// channel) would be 4 corners x sn^2 samples = 16 per cotangent element
// (2.06e8 at R = 1024, C = 256), and pixels that neighbouring samples or
// overlapping RoIs share take many adds, which the L2 serialises per address.
//
// Design: reduce each RoI's contribution before the global atomics. A RoI's
// gradient is separable: with Wy (out_h x rows) and Wx (out_w x columns) the
// per-axis weights, each bin's corner weights summed over its samples (zero
// for an invalid sample), the RoI adds Wy^T g[:, :, c] Wx / sn^2 to its
// level. The rows it touches are the distinct corners i0, i1 of its
// out_h * sn y samples, at most 2 * out_h * sn (28 for the flagship's 7 x 7
// bins, 56 for Mask R-CNN's 14 x 14), and likewise the columns: its
// footprint is at most 28 x 28 (56 x 56) pixels, however large the RoI, and
// fewer where samples share pixels (RoIs under 14 (28) pixels on their
// level, the small RoIs that level 0 takes).
// One block per RoI:
//   1. the per-axis sample tables, from the forward's own code
//      (roi_align_common.cuh), so that B and C place every sample bit for bit
//      alike;
//   2. the distinct rows (columns) of the valid samples' corners, sorted: one
//      thread per corner candidate finds whether it is its pixel's first
//      occurrence and its pixel's rank (a RoI with x2 < x1 runs its samples
//      backwards, so the corners are not sorted by sample);
//   3. the dense Wy, Wx over those compacted rows and columns, one thread per
//      bin summing its samples' corner weights in sample order, 1 / sn^2
//      folded into Wy; and for each row (column) the bins that weigh on it,
//      a range since the sample coordinates are monotone;
//   4. each thread owns 4 channels and walks the footprint's pixels; a pixel's
//      value sums Wy[py][row] Wx[px][col] g[py, px] over those bins only
//      (16-byte loads of g, L1-resident: one RoI's g is 50 KB), and is added
//      to the level with one 16-byte reduction (red.global.add.v4.f32) for
//      its 4 channels. A warp's 32 lanes cover 128 consecutive channels of
//      one pixel, 512 contiguous bytes. A pixel whose 4 sums are 0 (a zero
//      cotangent) is skipped.
// So a RoI issues one vector reduction per footprint pixel and channel
// group: at most 28 x 28 x C / 4, against 49 x C x 16 scalar atomics before,
// 4x fewer for a large RoI and more for a small one. The sum order differs
// from the plain version's and, through the atomics, from run to run: results
// agree with it to f32 rounding of the sum of the terms' magnitudes.
// ptxas (-v, sm_90a): 80 registers, 8 bytes of spill (a 96-byte stack frame:
// the level table indexed at run time); 3,480 B of dynamic shared memory at
// 7 x 7 bins of 2 x 2 samples, 10,088 B at 14 x 14 (112 corner candidates,
// within the 256 threads).
#include <cuda_runtime.h>
#include <math.h>

#include "roi_align_common.cuh"

namespace {

constexpr int THREADS = 256;

// dst[0..3] += v as one 16-byte reduction in L2 (sm_90); dst 16-byte aligned
__device__ __forceinline__ void red_add_v4(float* dst, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

// Shared-memory tables of one RoI beyond the axis tables: nc = 2 * ns corner
// candidates (candidate k is corner k & 1 of sample k >> 1: y samples first,
// then x), and the compacted rows then columns.
struct Footprint {
  int* cand;   // nc: candidate k's pixel row (column), -1 for an invalid sample
  int* first;  // nc: whether candidate k is its pixel's first occurrence
  int* slot;   // nc: candidate k's compacted row (column) in its axis, or -1
  int* pix;    // nc: compacted row (column) -> level row (column); rows at 0, columns at 2 * ny
  int* lo;     // nc: the first bin with a nonzero weight on the row (column)
  int* hi;     // nc: the last such bin (hi < lo: none)
  int* count;  // 2: distinct rows, distinct columns
  float* wy;   // out_h x 2 * ny: bin py's weight on compacted row s, / sn^2
  float* wx;   // out_w x 2 * nx: bin px's weight on compacted column s
};

inline size_t footprint_bytes(int out_h, int out_w, int sn) {
  const int ny = out_h * sn, nx = out_w * sn, nc = 2 * (ny + nx);
  return sizeof(int) * ((size_t)6 * nc + 2) +
         sizeof(float) * ((size_t)out_h * 2 * ny + (size_t)out_w * 2 * nx);
}

__device__ __forceinline__ Footprint footprint(int* smem, int nc, int out_h, int ny) {
  Footprint f;
  f.cand = smem;
  f.first = f.cand + nc;
  f.slot = f.first + nc;
  f.pix = f.slot + nc;
  f.lo = f.pix + nc;
  f.hi = f.lo + nc;
  f.count = f.hi + nc;
  f.wy = reinterpret_cast<float*>(f.count + 2);
  f.wx = f.wy + out_h * 2 * ny;
  return f;
}

__global__ void __launch_bounds__(THREADS)
roi_align_bwd_kernel(arfe::Levels lv, const float* __restrict__ grad_out,
                     const float* __restrict__ rois,
                     const int* __restrict__ target_lvls, int batch,
                     int channels, int out_h, int out_w, int sn, int aligned) {
  extern __shared__ __align__(16) int smem[];
  const int ny = out_h * sn, ns = (out_h + out_w) * sn, nc = 2 * ns;
  const int ry = 2 * ny, rx = nc - ry;  // row and column candidates
  const arfe::AxisTables tab = arfe::axis_tables(smem, ns);
  const Footprint fp = footprint(tab.valid + ns, nc, out_h, ny);
  const int tid = threadIdx.x;

  const int r = blockIdx.x;
  const float* roi = rois + (size_t)r * 5;
  const int l = arfe::roi_level(target_lvls, r, lv.num);
  const int b = arfe::roi_batch(roi, batch);
  const int h = lv.h[l], w = lv.w[l];

  // 1. sample tables; zero weights
  if (tid < ns)
    arfe::fill_axis_sample(tab, tid, roi, lv.scale[l], h, w, out_h, out_w, sn, aligned);
  if (tid < 2) fp.count[tid] = 0;
  for (int i = tid; i < out_h * ry + out_w * rx; i += THREADS) fp.wy[i] = 0.f;
  __syncthreads();

  // 2. distinct rows and columns, sorted
  const bool is_y = tid < ry;
  const int axis0 = is_y ? 0 : ry, axis1 = is_y ? ry : nc;
  if (tid < nc) {
    const int t = tid >> 1;
    fp.cand[tid] = tab.valid[t] ? ((tid & 1) ? tab.i1[t] : tab.i0[t]) : -1;
  }
  __syncthreads();
  if (tid < nc) {
    const int v = fp.cand[tid];
    bool f = v >= 0;
    for (int j = axis0; j < tid && f; ++j) f = fp.cand[j] != v;
    fp.first[tid] = f;
  }
  __syncthreads();
  if (tid < nc) {
    const int v = fp.cand[tid];
    int rank = -1;
    if (v >= 0) {
      rank = 0;
      for (int j = axis0; j < axis1; ++j) rank += fp.first[j] && fp.cand[j] < v;
    }
    fp.slot[tid] = rank;
    if (fp.first[tid]) {
      fp.pix[axis0 + rank] = v;
      atomicAdd(&fp.count[is_y ? 0 : 1], 1);
    }
  }
  __syncthreads();

  // 3. dense weights by bin, in sample order; 1 / sn^2 folded into Wy
  if (tid < out_h + out_w) {
    const bool bin_y = tid < out_h;
    const int p = bin_y ? tid : tid - out_h;
    const int width = bin_y ? ry : rx;
    float* row = bin_y ? fp.wy + p * ry : fp.wx + p * rx;
    for (int s = 0; s < sn; ++s) {
      const int t = (bin_y ? 0 : ny) + p * sn + s;
      if (!tab.valid[t]) continue;
      row[fp.slot[2 * t]] += tab.w0[t];
      row[fp.slot[2 * t + 1]] += tab.w1[t];
    }
    if (bin_y) {
      const float count = (float)(sn * sn);
      for (int j = 0; j < width; ++j) row[j] = __fdiv_rn(row[j], count);
    }
  }
  __syncthreads();
  // the bins that weigh on each compacted row (column)
  if (tid < nc) {
    const int s = tid - axis0;
    const int bins = is_y ? out_h : out_w, stride = is_y ? ry : rx;
    const float* col = (is_y ? fp.wy : fp.wx) + s;
    int first_bin = bins, last_bin = -1;
    for (int p = 0; p < bins; ++p) {
      if (col[p * stride] != 0.f) {
        first_bin = min(first_bin, p);
        last_bin = p;
      }
    }
    fp.lo[tid] = first_bin;
    fp.hi[tid] = last_bin;
  }
  __syncthreads();

  // 4. one 16-byte reduction per footprint pixel and 4 channels
  const int quads = channels / 4;
  const int lanes = THREADS / quads;  // pixels in flight
  const int quad = tid % quads, lane = tid / quads;
  if (lane >= lanes) return;
  const int rows = fp.count[0], cols = fp.count[1];
  float* grad = static_cast<float*>(lv.data[l]) + (size_t)b * h * w * channels + 4 * quad;
  const float* g = grad_out + (size_t)r * out_h * out_w * channels + 4 * quad;
  for (int o = lane; o < rows * cols; o += lanes) {
    const int yr = o / cols, xc = o - yr * cols;
    const int y_lo = fp.lo[yr], y_hi = fp.hi[yr];
    const int x_lo = fp.lo[ry + xc], x_hi = fp.hi[ry + xc];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int py = y_lo; py <= y_hi; ++py) {
      const float wyv = fp.wy[py * ry + yr];
      if (wyv == 0.f) continue;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int px = x_lo; px <= x_hi; ++px) {
        const float wxv = fp.wx[px * rx + xc];
        if (wxv == 0.f) continue;
        const float4 gv =
            __ldg(reinterpret_cast<const float4*>(g + (size_t)(py * out_w + px) * channels));
        sum.x = fmaf(wxv, gv.x, sum.x);
        sum.y = fmaf(wxv, gv.y, sum.y);
        sum.z = fmaf(wxv, gv.z, sum.z);
        sum.w = fmaf(wxv, gv.w, sum.w);
      }
      acc.x = fmaf(wyv, sum.x, acc.x);
      acc.y = fmaf(wyv, sum.y, acc.y);
      acc.z = fmaf(wyv, sum.z, acc.z);
      acc.w = fmaf(wyv, sum.w, acc.w);
    }
    if (acc.x != 0.f || acc.y != 0.f || acc.z != 0.f || acc.w != 0.f)
      red_add_v4(grad + ((size_t)fp.pix[yr] * w + fp.pix[ry + xc]) * channels, acc);
  }
}

}  // namespace

// grad_levels[l]: (batch, level_h[l], level_w[l], channels) NHWC contiguous
// f32, zero-filled by the caller, 16-byte aligned; level_scale[l] = 1 /
// stride. grad_out: (num_rois, out_h, out_w, channels) f32 cotangent,
// 16-byte aligned; rois: (num_rois, 5) f32 [b, x1, y1, x2, y2]; target_lvls:
// (num_rois,) int32. channels a multiple of 4, at most 4 * 256; 2 * (out_h +
// out_w) * sample_num at most 256. Launches on `stream`; returns the
// cudaError_t of the launch (0 on success).
extern "C" int arfe_roi_align_backward(
    void* const* grad_levels, const int* level_h, const int* level_w,
    const float* level_scale, int num_levels, int batch, int channels,
    const void* grad_out, const void* rois, const void* target_lvls,
    int num_rois, int out_h, int out_w, int sample_num, int aligned,
    void* stream) {
  if (num_levels < 1 || num_levels > arfe::MAX_LEVELS || sample_num < 1 || out_h < 1 ||
      out_w < 1 || channels < 4 || channels % 4 || channels / 4 > THREADS)
    return (int)cudaErrorInvalidValue;
  if (num_rois <= 0) return (int)cudaSuccess;
  const int ns = (out_h + out_w) * sample_num;
  if (2 * ns > THREADS) return (int)cudaErrorInvalidValue;
  const arfe::Levels lv = arfe::make_levels(grad_levels, level_h, level_w,
                                            level_scale, num_levels);
  const size_t smem = arfe::axis_tables_bytes(ns) + footprint_bytes(out_h, out_w, sample_num);
  roi_align_bwd_kernel<<<num_rois, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(grad_out), static_cast<const float*>(rois),
      static_cast<const int*>(target_lvls), batch, channels, out_h, out_w,
      sample_num, aligned);
  return (int)cudaGetLastError();
}
