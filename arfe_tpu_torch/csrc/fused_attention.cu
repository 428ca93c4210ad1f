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
// is bound by operations. The input dtype picks one of two designs.
//
// bf16 inputs: the tensor cores (attention_tc_kernel).
//   Both products are Hopper warpgroup MMAs (wgmma) with f32 accumulation:
//   S = Q K^T as m64n64k16 with Q and K read from shared memory, O += P V as
//   m64nCk16 with P from registers and V from shared memory. Q, K and V stay
//   bf16 in shared memory, in wgmma's 128-byte-swizzled layout, and each
//   operand tile is read once per warpgroup (with mma.sync each of 4 warps
//   would read the whole K and V tile, and shared-memory bandwidth, not the
//   tensor cores, would set the pace). The tiles are copied by cp.async,
//   not TMA, and there is no warp specialisation: a block is one warpgroup
//   whose loads, products and softmax follow each other, and the second
//   block on the SM fills the gaps.
//   One block of 4 warps (one warpgroup) owns 64 query rows (warp w rows
//   16w..16w+15) and walks 64-key tiles with an online softmax, as flash
//   attention does. One shared-memory stage each of Q, K and V: a tile's V
//   is copied while Q K^T runs, and the next tile's K while P V runs. Per
//   block at C = 256: shared memory 3 x 64 x 256 x 2 B = 98,304 B (+1 KB to
//   align the swizzle), so two blocks share an SM; registers per thread at
//   most 255 (two blocks of 128 threads), of which the 64 x 256 f32 O tile
//   of the warpgroup takes 128, the 64 x 64 f32 scores 32 and the bf16
//   probabilities 16 (ptxas's count is in PERF.md).
//   Key split: the grid is (query tiles, splits, B). At B = 1, N = 4200
//   there are only 66 query tiles for 2 x 132 block slots, so the wrapper
//   splits the 66 key tiles four ways (264 blocks; two ways at B = 2).
//   Split s takes key tiles [s * tps, (s + 1) * tps) and writes its
//   unnormalised O_s, its row max m_s (log2 units) and row sum l_s to
//   scratch; merge_kernel then forms O = sum_s 2^(m_s - M) O_s /
//   sum_s 2^(m_s - M) l_s, M = max_s m_s. A split with no key (only if the
//   caller forces more splits than tiles) has m_s = -inf and l_s = 0 and is
//   skipped by the merge, so it adds 0, not NaN. With one split the kernel
//   normalises and writes `out` itself.
//   Softmax in f32: logits are scaled by scale * log2(e) and the running max
//   is subtracted before exp2; AR-FPN's logits are unscaled (use_scale =
//   False) and reach hundreds. Keys at or past N, in the ragged last tile,
//   are -inf. Every key tile holds a valid key (its first key is < N), so
//   the running max of every row is finite after a split's first tile.
//   Tolerance (2^-8 * max|v| against attention_plain): both round each
//   probability to bf16 once before the PV product, relative error at most
//   u = 2^-8. The plain version rounds the normalised w_j = p_j / l; the
//   kernel the unnormalised p_j = 2^(x_j - m) and divides the f32 sum by the
//   f32 l (the sum of the unrounded p_j). Each side is thus within
//   u * sum_j w_j |v_j| <= u * max|v| of the exact result. The kernel's
//   largest term of a row is exact: when its key is read the running max is
//   its own logit, p = 2^0 = 1, which bf16 holds, and later rescalings are
//   f32. So where one key dominates (w_max -> 1, the regime of AR-FPN's
//   large logits) the kernel's error vanishes and the difference is the
//   plain version's alone, <= u * max|v|; where many keys share the weight,
//   the two sides' independent roundings of many small terms average out
//   far below it.
//
// f32 inputs: the f32 FMA units (attention_f32_kernel), for the f32
//   requests, the f32 training step and the card-against-CPU checks. One
//   block of 8 warps per (64-query tile, image), no key split; Q, K, V tiles
//   in f32 shared memory, rows padded by 4 floats; warp w owns query rows
//   8w..8w+7 in both products, so row max and row sum are warp shuffles.
//   Probabilities stay f32, so it agrees with the plain version to f32
//   summation order. Tensor cores in f32 (TF32 or 3xTF32) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile (KEY_TILE in ops/fused_attention.py)
constexpr float LOG2E = 1.4426950408889634f;

// Lets `Kernel` take `bytes` of dynamic shared memory on the current
// device. Set once per kernel and device, so that later launches (and CUDA
// graph captures of them) make no attribute call.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static bool done[64] = {};  // one flag per kernel (not per kernel type)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done[dev] = err == cudaSuccess;
  return err;
}

// ---------------------------------------------------------------------------
// f32: FMA units
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;  // 8 warps
constexpr int ROWS = 8;           // query rows per warp
constexpr int F32_PAD = 4;        // floats of padding per Q / K / P row

// Rows [row0, row0 + 64) of an (n, C) f32 matrix into shared memory with row
// stride ld; rows at or past n are zero.
template <int C>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const float* src,
                                              int row0, int n) {
  constexpr int V4 = C / 4;
  for (int i = threadIdx.x; i < 64 * V4; i += F32_THREADS) {
    const int r = i / V4;
    const int c = (i % V4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * C + c);
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
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + BK) * (C + F32_PAD) + (size_t)BK * C +
                          (size_t)BQ * (BK + F32_PAD));
}

template <int C>
__global__ void __launch_bounds__(F32_THREADS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int n,
                     float scale) {
  extern __shared__ __align__(16) float smem_f32[];
  constexpr int LDQ = C + F32_PAD;
  constexpr int LDP = BK + F32_PAD;
  constexpr int CPL = C / 32;  // output columns per lane: lane + 32 * j
  float* qs = smem_f32;        // BQ x LDQ
  float* ks = qs + BQ * LDQ;   // BK x LDQ
  float* vs = ks + BK * LDQ;   // BK x C
  float* ps = vs + BK * C;     // BQ x LDP

  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * n * C;
  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * ROWS;

  load_tile_f32<C>(qs, LDQ, q + base, q0, n);

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
    load_tile_f32<C>(ks, LDQ, k + base, k0, n);
    load_tile_f32<C>(vs, C, v + base, k0, n);
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

template <int C>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int batch, int n, float scale, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<C>();
  cudaError_t err = allow_smem<attention_f32_kernel<C>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BQ - 1) / BQ, batch);
  attention_f32_kernel<C><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // one warpgroup; warp w owns query rows 16w..16w+15

// A 64-row tile of C bf16 columns in shared memory, in wgmma's canonical
// layout with the 128-byte swizzle: blocks of 64 columns, each 64 rows of
// 128 bytes (8 KB), whose 16-byte chunk c of row r sits at chunk
// c ^ (r % 8) of the row, so that the 8 rows of an 8 x 8 core matrix fall
// in 8 distinct bank groups. Q and K are read K-major (the reduction over
// channels runs along a row): the next 8 rows are 1024 bytes on (stride
// byte offset), and a 16-channel step moves the start 32 bytes along the
// row. V is read MN-major (the reduction over keys runs down the rows,
// channels are contiguous): the next 64 channels are a block (8 KB, leading
// byte offset) on, the next 8 keys 1024 bytes (stride).
constexpr uint32_t ROW = 128;          // bytes of a row of a 64-column block
constexpr uint32_t BLOCK = 64 * ROW;   // bytes of a 64-column block
constexpr uint32_t ATOM = 8 * ROW;     // 8 rows, the swizzle's period

template <int C>
constexpr size_t tc_smem_bytes() {
  // Q, K, V, and room to align the tiles to the swizzle's 1024 bytes
  return sizeof(__nv_bfloat16) * 3 * (size_t)BQ * C + ATOM;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units, layout type 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// 16 bytes global -> shared; zero-filled where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// this thread's writes to shared memory (cp.async's included) become visible
// to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wgmma reads and writes its registers asynchronously, but the compiler
// sees the asm statement as the point of use: these empty volatile
// statements pin every access of the registers before a wgmma.fence or after
// a wgmma.wait_group where the program puts it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (m64n64, 32 f32 per thread) += A B over 16 k; A and B from shared
// memory through their descriptors, both K-major; d is zeroed first when
// accumulate is 0
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64n64, 32 f32 per thread) += A B over 16 k; A (4 x 2 bf16 per
// thread, the mma.m16n8k16 A layout per warp) from registers, B from shared
// memory through its descriptor, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n128, 64 f32 per thread) += A B over 16 k; A (4 x 2 bf16 per
// thread, the mma.m16n8k16 A layout per warp) from registers, B from shared
// memory through its descriptor, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n256, 128 f32 per thread) += A B over 16 k; A (4 x 2 bf16 per
// thread, the mma.m16n8k16 A layout per warp) from registers, B from shared
// memory through its descriptor, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of an (n, C) bf16 matrix into the tile layout above
// at shared address `dst` by cp.async; rows at or past n are zero. A warp
// copies 32 consecutive 16-byte chunks of the source; each 8 lanes write
// one 128-byte row (no bank conflict).
template <int C>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* src,
                                                int row0, int n) {
  constexpr int CHUNKS = C / 8;
#pragma unroll
  for (int j = 0; j < 64 * CHUNKS / TC_THREADS; ++j) {
    const int i = threadIdx.x + j * TC_THREADS;
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool valid = row0 + r < n;
    const __nv_bfloat16* s = src + (size_t)(valid ? row0 + r : 0) * C + c * 8;
    cp_async16(dst + (c / 8) * BLOCK + r * ROW + ((c % 8) ^ (r % 8)) * 16, s, valid);
  }
}

// Register layouts (g = lane / 4, t = lane % 4, warp w of the warpgroup): an
// m64nN f32 accumulator holds, for 8-column block j, (row 16w + g, cols
// 8j + 2t, 8j + 2t + 1) in [4j], [4j + 1] and (row 16w + g + 8, the same
// cols) in [4j + 2], [4j + 3]; a register A operand holds (row 16w + g,
// k 2t..2t+1), (row + 8, k 2t..), (row, k 2t+8..), (row + 8, k 2t+8..). So
// the scores of two neighbouring 8-key blocks, rounded to bf16, are the A
// operand of the next product over those 16 keys without any shuffle.
//
// One stage each of Q, K and V (3 x 64 x 256 x 2 B = 98,304 B at C = 256,
// 99,328 B with the alignment, two blocks per SM): a tile's V is copied
// while Q K^T runs, and the next tile's K while P V runs.
template <int C>
__global__ void __launch_bounds__(TC_THREADS, 2)
attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ part_o, float2* __restrict__ part_ml, int n,
                    float scale_log2, int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  constexpr uint32_t TILE = BQ * C * 2;  // bytes of one 64-row tile
  const uint32_t q_addr = (smem_addr(smem_tc) + ATOM - 1) & ~(ATOM - 1);
  const uint32_t k_addr = q_addr + TILE, v_addr = k_addr + TILE;

  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * n * C;
  const int k_tiles = (n + BK - 1) / BK;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, k_tiles);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane & 3;

  float o[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) o[i] = 0.f;
  float s[32];
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the row sums

  if (t_begin < t_end) {
    load_tile_async<C>(q_addr, q + base, q0, n);
    load_tile_async<C>(k_addr, k + base, t_begin * BK, n);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    load_tile_async<C>(v_addr, v + base, t * BK, n);
    cp_async_commit();
    cp_async_wait<1>();  // Q and this tile's K have landed
    fence_async_shared();
    __syncthreads();

    // S = Q K^T: the warpgroup's 64 rows x 64 keys, C / 16 steps of 16
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      wgmma_ss(s, smem_desc(q_addr + (kk / 4) * BLOCK + (kk % 4) * 32, 16, ATOM),
               smem_desc(k_addr + (kk / 4) * BLOCK + (kk % 4) * 32, 16, ATOM), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax in f32 (log2 units); keys at or past n are -inf
    const int key0 = t * BK + 2 * quad;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = key0 + (i / 4) * 8 + (i & 1) < n ? s[i] * scale_log2 : -INFINITY;
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);  // finite: the tile has a valid key
      alpha[i] = exp2f(m[i] - m_new);          // 0 on the split's first tile
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    uint32_t pf[4][4];  // A operand of P V: 4 steps of 16 keys
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float p0 = exp2f(s[4 * nb] - m[0]);
      const float p1 = exp2f(s[4 * nb + 1] - m[0]);
      const float p2 = exp2f(s[4 * nb + 2] - m[1]);
      const float p3 = exp2f(s[4 * nb + 3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[nb >> 1][(nb & 1) * 2] = pack_bf16(p0, p1);      // row g
      pf[nb >> 1][(nb & 1) * 2 + 1] = pack_bf16(p2, p3);  // row g + 8
    }
#pragma unroll
    for (int i = 0; i < C / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    cp_async_wait<0>();  // this tile's V has landed
    fence_async_shared();
    __syncthreads();     // ... for every warp, and every warp is done with K
    if (t + 1 < t_end) {
      load_tile_async<C>(k_addr, k + base, (t + 1) * BK, n);
      cp_async_commit();
    }

    // O += P V over the tile's 4 steps of 16 keys
    fence_regs(o);
#pragma unroll
    for (int ks16 = 0; ks16 < 4; ++ks16) fence_regs(pf[ks16]);
    wgmma_fence();
#pragma unroll
    for (int ks16 = 0; ks16 < 4; ++ks16)
      wgmma_rs(o, pf[ks16], smem_desc(v_addr + ks16 * 2 * ATOM, BLOCK, ATOM));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();  // every warp is done with V before the next tile's copy
  }

  // the row sums over the quad's 4 threads
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int row[2] = {q0 + warp * 16 + (lane >> 2), q0 + warp * 16 + (lane >> 2) + 8};
  const int col = 2 * quad;
  if (part_o == nullptr) {  // one split: normalise here
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= n) continue;
      float* orow = out + base + (size_t)row[i] * C + col;
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
        *reinterpret_cast<float2*>(orow + j * 8) =
            make_float2(o[4 * j + 2 * i] / l[i], o[4 * j + 2 * i + 1] / l[i]);
    }
  } else {  // partials of split `split`: (splits, B, n, C) and (splits, B, n)
    const size_t slab = (size_t)split * gridDim.z + b;
    float* po = part_o + slab * n * C;
    float2* pml = part_ml + slab * n;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= n) continue;
      float* orow = po + (size_t)row[i] * C + col;
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
        *reinterpret_cast<float2*>(orow + j * 8) =
            make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
      if (quad == 0) pml[row[i]] = make_float2(m[i], l[i]);
    }
  }
}

// out[row, c..c+3] = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s over the
// splits with a key (l_s > 0); rows = B * n, one thread per 4 channels.
template <int C>
__global__ void __launch_bounds__(256)
merge_kernel(const float* __restrict__ part_o, const float2* __restrict__ part_ml,
             float* __restrict__ out, int rows, int splits) {
  constexpr int V4 = C / 4;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * V4) return;
  const size_t r = i / V4;
  const int c = (int)(i % V4) * 4;
  float big = -INFINITY;
  for (int s = 0; s < splits; ++s) big = fmaxf(big, part_ml[(size_t)s * rows + r].x);
  float sum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float2 ml = part_ml[(size_t)s * rows + r];
    if (!(ml.y > 0.f)) continue;  // a split with no key adds nothing
    const float w = exp2f(ml.x - big);
    const float4 po =
        *reinterpret_cast<const float4*>(part_o + ((size_t)s * rows + r) * C + c);
    sum += w * ml.y;
    acc.x += w * po.x;
    acc.y += w * po.y;
    acc.z += w * po.z;
    acc.w += w * po.w;
  }
  *reinterpret_cast<float4*>(out + r * C + c) =
      make_float4(acc.x / sum, acc.y / sum, acc.z / sum, acc.w / sum);
}

template <int C>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, void* part_o,
                      void* part_ml, int batch, int n, float scale, int splits,
                      cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<C>();
  cudaError_t err = allow_smem<attention_tc_kernel<C>>(smem);
  if (err != cudaSuccess) return err;
  const int k_tiles = (n + BK - 1) / BK;
  const int tiles_per_split = (k_tiles + splits - 1) / splits;
  const bool merge = splits > 1;
  const dim3 grid((n + BQ - 1) / BQ, splits, batch);
  attention_tc_kernel<C><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out),
      merge ? static_cast<float*>(part_o) : nullptr,
      merge ? static_cast<float2*>(part_ml) : nullptr, n, scale * LOG2E, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return err;
  const size_t threads = (size_t)batch * n * (C / 4);
  merge_kernel<C><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float2*>(part_ml),
      static_cast<float*>(out), batch * n, splits);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* part_o,
                   void* part_ml, int batch, int n, float scale, int is_bf16, int splits,
                   cudaStream_t stream) {
  if (is_bf16) return launch_tc<C>(q, k, v, out, part_o, part_ml, batch, n, scale, splits, stream);
  if (splits != 1) return cudaErrorInvalidValue;
  return launch_f32<C>(q, k, v, out, batch, n, scale, stream);
}

}  // namespace

// q, k, v: (batch, n, c) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// 16-byte aligned; out: (batch, n, c) f32. c is 64, 128 or 256. `splits`
// key splits (bf16 only; 1 for f32): with splits > 1, part_o is f32 scratch
// of (splits, batch, n, c) and part_ml of (splits, batch, n, 2), and a
// second kernel merges them into out. Launches on `stream` and returns the
// cudaError_t of the launches (0 on success).
extern "C" int arfe_fused_attention(const void* q, const void* k, const void* v, void* out,
                                    void* part_o, void* part_ml, int batch, int n, int c,
                                    float scale, int is_bf16, int splits, void* stream) {
  if (batch <= 0 || n <= 0) return cudaSuccess;
  if (splits < 1 || (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 64: return (int)launch<64>(q, k, v, out, part_o, part_ml, batch, n, scale, is_bf16, splits, s);
    case 128: return (int)launch<128>(q, k, v, out, part_o, part_ml, batch, n, scale, is_bf16, splits, s);
    case 256: return (int)launch<256>(q, k, v, out, part_o, part_ml, batch, n, scale, is_bf16, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
