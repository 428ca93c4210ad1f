// Fused softmax attention forward for Hopper (sm_90a):
//   out = softmax(q @ k^T * scale) @ v,  q, k, v: (B, N, C) f32 or bf16,
//   out: (B, N, C) f32.
//
// Replaces the TPU kernel arfe_tpu/ops/pallas_attention.py::
// fused_softmax_attention (Pallas `_kernel`, pallas_call at :102), the
// NonLocal2D refine inside AR-FPN (arfe_tpu/ops/non_local.py:79-81).
//
// What bounds it on this card: at the AR-FPN shape (N = 4200 tokens of the
// stride-16 level at 800x1344, C = 256) the two products are 4*N^2*C =
// 1.8e10 operations per image against 4*N*C elements moved (a few MB), so it
// is bound by operations. This first version runs them on the f32 FMA units
// (67 TFLOP/s peak), not on the tensor cores; wgmma is later work.
//
// Design: one block per (64-query tile, image). The (N, N) score matrix never
// reaches device memory: the block walks over key tiles of 64 with an online
// softmax (running max m and sum l per row, a 64 x C f32 accumulator in
// registers), as flash attention does. The Q, K and V tiles live in dynamic
// shared memory as f32 (bf16 is widened on load, so every product of two
// bf16 inputs is exact and sums are f32, as with preferred_element_type on
// the TPU). Warp w owns query rows 8w..8w+7 in both products: row max and row
// sum are warp shuffles, and the probabilities a warp stores to shared memory
// are read back by that warp only. Q and K rows are padded by 4 floats so the
// 32 lanes of a warp, each reading its own key row at one column, hit
// distinct banks. The max is subtracted in f32 before exp: with scale = 1
// (AR-FPN's use_scale=False) the logits are large. Keys past N, in the ragged
// last tile, are masked to -inf.
//
// Probabilities stay f32 for the PV product. The plain version (and the TPU
// kernel) round the normalised probabilities to the value dtype first, so in
// bf16 the two differ by at most 2^-9 * max|v| per output element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 8 warps
constexpr int ROWS = 8;       // query rows per warp
constexpr int PAD = 4;        // floats of padding per Q / K / P row

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Rows [row0, row0 + 64) of an (n, C) matrix into shared memory as f32 with
// row stride ld; rows at or past n are zero.
template <typename T, int C>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int row0, int n) {
  constexpr int V4 = C / 4;
  for (int i = threadIdx.x; i < 64 * V4; i += THREADS) {
    const int r = i / V4;
    const int c = (i % V4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = load4(src + (size_t)(row0 + r) * C + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int C>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(BQ + BK) * (C + PAD) + (size_t)BK * C + (size_t)BQ * (BK + PAD));
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ out, int n,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDQ = C + PAD;
  constexpr int LDP = BK + PAD;
  constexpr int CPL = C / 32;  // output columns per lane: lane + 32 * j
  float* qs = smem;            // BQ x LDQ
  float* ks = qs + BQ * LDQ;   // BK x LDQ
  float* vs = ks + BK * LDQ;   // BK x C
  float* ps = vs + BK * C;     // BQ x LDP

  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * n * C;
  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * ROWS;

  load_tile<T, C>(qs, LDQ, q + base, q0, n);

  float acc[ROWS][CPL];
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K / V tile
    load_tile<T, C>(ks, LDQ, k + base, k0, n);
    load_tile<T, C>(vs, C, v + base, k0, n);
    __syncthreads();

    // scores of rows row0..row0+7 against keys k0+lane and k0+lane+32
    float s[ROWS][2];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i][0] = s[i][1] = 0.f;
    const float* ka_row = ks + lane * LDQ;
    const float* kb_row = ks + (lane + 32) * LDQ;
#pragma unroll 2
    for (int c = 0; c < C; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(ka_row + c);
      const float4 kb = *reinterpret_cast<const float4*>(kb_row + c);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (row0 + i) * LDQ + c);
        s[i][0] = fmaf(qv.x, ka.x, s[i][0]);
        s[i][0] = fmaf(qv.y, ka.y, s[i][0]);
        s[i][0] = fmaf(qv.z, ka.z, s[i][0]);
        s[i][0] = fmaf(qv.w, ka.w, s[i][0]);
        s[i][1] = fmaf(qv.x, kb.x, s[i][1]);
        s[i][1] = fmaf(qv.y, kb.y, s[i][1]);
        s[i][1] = fmaf(qv.z, kb.z, s[i][1]);
        s[i][1] = fmaf(qv.w, kb.w, s[i][1]);
      }
    }

    // online softmax update; every tile holds at least one valid key (k0 < n)
    const bool valid_a = k0 + lane < n;
    const bool valid_b = k0 + lane + 32 < n;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float sa = valid_a ? s[i][0] * scale : -INFINITY;
      const float sb = valid_b ? s[i][1] * scale : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(sa, sb)));
      const float alpha = expf(m[i] - m_new);  // exp(-inf) = 0 on the first tile
      const float pa = expf(sa - m_new);
      const float pb = expf(sb - m_new);
      l[i] = l[i] * alpha + warp_sum(pa + pb);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[i][j] *= alpha;
      ps[(row0 + i) * LDP + lane] = pa;
      ps[(row0 + i) * LDP + lane + 32] = pb;
    }
    __syncwarp();

    // acc += P V over this tile's keys
#pragma unroll 1
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        p4[i] = *reinterpret_cast<const float4*>(ps + (row0 + i) * LDP + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = vs + (kk + t) * C + lane;
        float vv[CPL];
#pragma unroll
        for (int j = 0; j < CPL; ++j) vv[j] = vrow[32 * j];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float p = t == 0 ? p4[i].x : t == 1 ? p4[i].y : t == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int j = 0; j < CPL; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = q0 + row0 + i;
    if (r < n) {
      float* orow = out + base + (size_t)r * C + lane;
#pragma unroll
      for (int j = 0; j < CPL; ++j) orow[32 * j] = acc[i][j] / l[i];
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int n, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BQ - 1) / BQ, batch);
  attention_kernel<T, C><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(out), n, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int batch, int n, int c, float scale, cudaStream_t stream) {
  switch (c) {
    case 64: return launch<T, 64>(q, k, v, out, batch, n, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, batch, n, scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, batch, n, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (batch, n, c) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// 16-byte aligned; out: (batch, n, c) f32. c is 64, 128 or 256. Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).
extern "C" int arfe_fused_attention(const void* q, const void* k, const void* v,
                                    void* out, int batch, int n, int c, float scale,
                                    int is_bf16, void* stream) {
  if (batch <= 0 || n <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, batch, n, c, scale, s)
              : dispatch<float>(q, k, v, out, batch, n, c, scale, s);
  return (int)err;
}
