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
// f32 inputs: the tensor cores in 3xTF32 (attention_f32_kernel), for the
//   f32 requests, the f32 training step and the card-against-CPU checks.
//   Arithmetic: each f32 operand x is split into big = tf32(x) (cvt.rna)
//   and small = x - big (read as tf32 by the tensor cores, which drop its
//   low bits), and each product a b is taken as a_big b_big + a_small
//   b_big + a_big b_small, accumulated in f32 (the small x small term,
//   ~2^-22 |a b|, is dropped). One TF32 product alone
//   keeps 10 mantissa bits: at the f32 check's inputs (randn q, k, v, C =
//   256) its logits are off by ~1e-2 and the output by ~1.5e-2, against the
//   1e-4 tolerance; 3xTF32 by ~7e-6 (tests/test_torch_attention.py emulates
//   both). The bound is thus 3 x 4 B N^2 C operations at the dense TF32
//   peak. The tensor cores' f32 accumulation is coarser than an f32 FMA's:
//   run over all 256 channels (96 MMAs into one accumulator of logits that
//   reach ~100), Q K^T left the output 1.3e-4 off the plain version at N =
//   4200, over the 1e-4 tolerance. So each 16 channels of Q K^T go into a
//   fresh accumulator, added to the scores in f32 (round to nearest): the
//   output is then 1.8e-5 to 2.8e-5 off an f64 reference, closer than the
//   plain version (cuBLAS f32, 4.8e-5 to 9.1e-5) and SDPA in f32 (2.1e-5 to
//   3.5e-5) come (tools/attention_accuracy.py, PERF.md), so the distance to
//   the plain version is mostly the plain version's own error. Chunks of 8
//   channels, or of 8 keys in P V, gained nothing and cost time.
//   Instructions: mma.sync.m16n8k8 tf32, not wgmma. wgmma's tf32 form takes
//   both shared-memory operands K-major only, so P V would need V
//   transposed in shared memory, and big and small copies of the Q, K and
//   V^T tiles exceed 227 KB at C = 256. With mma.sync each fragment is read
//   from shared memory once, split in registers, and feeds three MMAs, so
//   the shared-memory traffic per MMA is a third of a plain TF32 kernel's
//   (the limit that sank earlier bf16 mma.sync designs, PERF.md).
//   Block: 8 warps own 128 query rows (warp w rows 16w..16w+15) and walk
//   32-key tiles with an online softmax. Shared memory holds the f32 Q tile
//   (128 rows) and one stage each of K and V (32 rows); rows are padded so
//   that every fragment load is free of bank conflicts: 207,360 B at C =
//   256, one block per SM. A tile's V is copied (cp.async) while Q K^T runs,
//   the next tile's K while P V runs. Fragments are read as float4: within
//   a step of 16 channels, thread (g, t) (g = lane / 4, t = lane % 4) takes
//   channels 4t..4t+3 of its Q rows and K row, which serve as k = t, t + 4
//   of two k-steps (Q and K use the same channel order, and the product
//   sums over channels). In P V the scores' accumulator layout (keys 2t,
//   2t + 1 of each 8-key block) is used as the A operand directly by
//   taking k = t as key 2t and k = t + 4 as key 2t + 1, and V's rows are
//   read in that order; V's columns are read as float4 by giving n-block
//   j = 4i + e, column g, the channel 32i + 4g + e, which the epilogue
//   undoes (a thread's 8 outputs of a row are channels 32i + 8t .. + 7).
//   Key split and merge as in the bf16 path, with the f32 kernel's own tile
//   counts (key_splits in ops/fused_attention.py): 4 splits x 33 query
//   tiles = 132 blocks at B = 1, N = 4200; 2 x 66 at B = 2. Softmax as in
//   the bf16 path (f32, log2 units, running max subtracted, keys past N
//   -inf, an empty split skipped by the merge); the probabilities stay f32
//   (split like any operand).
//   ptxas (-v, sm_90a): 255 registers at C = 256 (199 at 128, 157 at 64),
//   no spills; 207,360 B of dynamic shared memory at C = 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile (TILES in ops/fused_attention.py)
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

// The merge of `splits` partials into out (the tc and f32 kernels write the
// same partials).
template <int C>
cudaError_t launch_merge(void* part_o, void* part_ml, void* out, int rows, int splits,
                         cudaStream_t stream) {
  const size_t threads = (size_t)rows * (C / 4);
  merge_kernel<C><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float2*>(part_ml),
      static_cast<float*>(out), rows, splits);
  return cudaGetLastError();
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
  return launch_merge<C>(part_o, part_ml, out, batch * n, splits, stream);
}

// ---------------------------------------------------------------------------
// f32: tensor cores in 3xTF32
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;  // 8 warps; warp w owns query rows 16w..16w+15
constexpr int BQ32 = 128;         // query rows per block
constexpr int BK32 = 32;          // keys per tile (TILES in ops/fused_attention.py)

// Floats per shared-memory row. Q and K rows are read as float4 at channel
// 4t by the 8 lanes of a quarter warp, rows g and g + 1: a stride of 16 mod
// 32 floats puts the two rows in the two halves of the 32 banks. V rows are
// read as float4 at channel 4g by rows 2t (t = 0..3) and g = 0, 1: a stride
// of 4 mod 16 puts the four rows 8 banks apart.
template <int C>
__host__ __device__ constexpr int ld_qk() { return C + 16; }
template <int C>
__host__ __device__ constexpr int ld_v() { return C + 4; }

template <int C>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((size_t)(BQ32 + BK32) * ld_qk<C>() + (size_t)BK32 * ld_v<C>());
}

// x = big + small: big = x rounded to tf32 (to nearest, ties away from
// zero), small = x - big, exact in f32. The tensor cores read small as tf32
// by dropping its low 13 bits, an error below 2^-10 |small| <= 2^-21 |x|.
// Rounding small with a second cvt left the kernel's error as it was
// (PERF.md) and cost a third of the split's instructions, which compete
// with the MMAs for issue slots.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  small = __float_as_uint(x - __uint_as_float(big));
}

// d (16 x 8 f32 of the warp) += a b over 8 k in one TF32 product. Lane (g,
// t): a holds (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b (k t,
// col g), (t + 4, g); d (g, cols 2t, 2t + 1), (g + 8, the same cols).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, a already split; b = (b0, b1) is split here. The
// order of the three products changed neither the error nor the time
// measurably; this one left ptxas no spills (PERF.md).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], float b0, float b1) {
  uint32_t b0_big, b0_small, b1_big, b1_small;
  split_tf32(b0, b0_big, b0_small);
  split_tf32(b1, b1_big, b1_small);
  mma_tf32(d, a_big, b0_big, b1_big);
  mma_tf32(d, a_small, b0_big, b1_big);
  mma_tf32(d, a_big, b0_small, b1_small);
}

__device__ __forceinline__ void split_frag(float x0, float x1, float x2, float x3,
                                           uint32_t (&big)[4], uint32_t (&small)[4]) {
  split_tf32(x0, big[0], small[0]);
  split_tf32(x1, big[1], small[1]);
  split_tf32(x2, big[2], small[2]);
  split_tf32(x3, big[3], small[3]);
}

// Rows [row0, row0 + ROWS) of an (n, C) f32 matrix into shared memory at
// `dst` (row stride ld floats) by cp.async; rows at or past n are zero.
template <int C, int ROWS>
__device__ __forceinline__ void load_rows_async(float* dst, int ld, const float* src, int row0,
                                                int n) {
  constexpr int CHUNKS = C / 4;  // 16-byte chunks per row
  static_assert(ROWS * CHUNKS % F32_THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < ROWS * CHUNKS / F32_THREADS; ++j) {
    const int i = threadIdx.x + j * F32_THREADS;
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool valid = row0 + r < n;
    const float* s = src + (size_t)(valid ? row0 + r : 0) * C + c * 4;
    cp_async16(smem_addr(dst + r * ld + c * 4), s, valid);
  }
}

template <int C>
__global__ void __launch_bounds__(F32_THREADS, 1)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ part_o, float2* __restrict__ part_ml, int n,
                     float scale_log2, int tiles_per_split) {
  extern __shared__ __align__(16) float smem_f32[];
  constexpr int LDQ = ld_qk<C>(), LDV = ld_v<C>();
  float* qs = smem_f32;         // BQ32 x LDQ
  float* ks = qs + BQ32 * LDQ;  // BK32 x LDQ
  float* vs = ks + BK32 * LDQ;  // BK32 x LDV

  const int q0 = blockIdx.x * BQ32;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * n * C;
  const int k_tiles = (n + BK32 - 1) / BK32;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, k_tiles);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, quad = lane & 3;

  float o[C / 8][4];  // n-block j of the warp's 16 x C output (channels: see the end)
#pragma unroll
  for (int j = 0; j < C / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the row sums

  // this thread's Q rows g, g + 8 of the warp and K row g, at channel 4 quad;
  // V rows 2 quad, 2 quad + 1 of an 8-key step, at channel 4 g
  const float* qa = qs + (warp * 16 + g) * LDQ + 4 * quad;
  const float* kb = ks + g * LDQ + 4 * quad;
  const float* vb = vs + 2 * quad * LDV + 4 * g;

  if (t_begin < t_end) {
    load_rows_async<C, BQ32>(qs, LDQ, q + base, q0, n);
    load_rows_async<C, BK32>(ks, LDQ, k + base, t_begin * BK32, n);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    load_rows_async<C, BK32>(vs, LDV, v + base, t * BK32, n);
    cp_async_commit();
    cp_async_wait<1>();  // Q and this tile's K have landed
    __syncthreads();

    // S = Q K^T: the warp's 16 rows x 32 keys, 4 n-blocks of 8 keys. A step
    // of 16 channels is two k-steps: channels (4t, 4t + 1) as k = (t, t + 4),
    // then (4t + 2, 4t + 3).
    float s[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll 2
    for (int c0 = 0; c0 < C; c0 += 16) {
      const float4 lo = *reinterpret_cast<const float4*>(qa + c0);
      const float4 hi = *reinterpret_cast<const float4*>(qa + 8 * LDQ + c0);
      uint32_t a_big[2][4], a_small[2][4];
      split_frag(lo.x, hi.x, lo.y, hi.y, a_big[0], a_small[0]);
      split_frag(lo.z, hi.z, lo.w, hi.w, a_big[1], a_small[1]);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const float4 kv = *reinterpret_cast<const float4*>(kb + nb * 8 * LDQ + c0);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(part, a_big[0], a_small[0], kv.x, kv.y);
        mma_3xtf32(part, a_big[1], a_small[1], kv.z, kv.w);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] += part[e];
      }
    }

    // online softmax in f32 (log2 units); keys at or past n are -inf
    const int key0 = t * BK32 + 2 * quad;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = key0 + nb * 8 + (e & 1) < n ? s[nb][e] * scale_log2 : -INFINITY;
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - m[e >> 1]);
        s[nb][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

    cp_async_wait<0>();  // this tile's V has landed
    __syncthreads();     // ... for every warp, and every warp is done with K
    if (t + 1 < t_end) {
      load_rows_async<C, BK32>(ks, LDQ, k + base, (t + 1) * BK32, n);
      cp_async_commit();
    }

    // O += P V over the tile's 4 steps of 8 keys. The A operand is the
    // scores' n-block kk as it lies: (g, k t) is key 2t, (g, k t + 4) key
    // 2t + 1. B's column g of n-block 4i + e is channel 32i + 4g + e.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t p_big[4], p_small[4];
      split_frag(s[kk][0], s[kk][2], s[kk][1], s[kk][3], p_big, p_small);
      const float* v0 = vb + kk * 8 * LDV;
#pragma unroll
      for (int i = 0; i < C / 32; ++i) {
        const float4 x0 = *reinterpret_cast<const float4*>(v0 + 32 * i);        // key 2t
        const float4 x1 = *reinterpret_cast<const float4*>(v0 + LDV + 32 * i);  // key 2t + 1
        mma_3xtf32(o[4 * i], p_big, p_small, x0.x, x1.x);
        mma_3xtf32(o[4 * i + 1], p_big, p_small, x0.y, x1.y);
        mma_3xtf32(o[4 * i + 2], p_big, p_small, x0.z, x1.z);
        mma_3xtf32(o[4 * i + 3], p_big, p_small, x0.w, x1.w);
      }
    }
    __syncthreads();  // every warp is done with V before the next tile's copy
  }

  // the row sums over the quad's 4 threads
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // o[4i + e] holds, for row g (g + 8), channel 32i + 8t + e in [0] ([2])
  // and channel 32i + 8t + 4 + e in [1] ([3])
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const bool merge = part_o != nullptr;
  float* dst = merge ? part_o + ((size_t)split * gridDim.z + b) * n * C : out + base;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= n) continue;
    const float inv_l = merge ? 1.f : 1.f / l[r];
    float* orow = dst + (size_t)row[r] * C + 8 * quad;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      float4 lo, hi;
      lo.x = o[4 * i][2 * r] * inv_l;
      lo.y = o[4 * i + 1][2 * r] * inv_l;
      lo.z = o[4 * i + 2][2 * r] * inv_l;
      lo.w = o[4 * i + 3][2 * r] * inv_l;
      hi.x = o[4 * i][2 * r + 1] * inv_l;
      hi.y = o[4 * i + 1][2 * r + 1] * inv_l;
      hi.z = o[4 * i + 2][2 * r + 1] * inv_l;
      hi.w = o[4 * i + 3][2 * r + 1] * inv_l;
      *reinterpret_cast<float4*>(orow + 32 * i) = lo;
      *reinterpret_cast<float4*>(orow + 32 * i + 4) = hi;
    }
    if (merge && quad == 0)
      part_ml[((size_t)split * gridDim.z + b) * n + row[r]] = make_float2(m[r], l[r]);
  }
}

template <int C>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, void* part_o,
                       void* part_ml, int batch, int n, float scale, int splits,
                       cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<C>();
  cudaError_t err = allow_smem<attention_f32_kernel<C>>(smem);
  if (err != cudaSuccess) return err;
  const int k_tiles = (n + BK32 - 1) / BK32;
  const int tiles_per_split = (k_tiles + splits - 1) / splits;
  const bool merge = splits > 1;
  const dim3 grid((n + BQ32 - 1) / BQ32, splits, batch);
  attention_f32_kernel<C><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), merge ? static_cast<float*>(part_o) : nullptr,
      merge ? static_cast<float2*>(part_ml) : nullptr, n, scale * LOG2E, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return err;
  return launch_merge<C>(part_o, part_ml, out, batch * n, splits, stream);
}

template <int C>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* part_o,
                   void* part_ml, int batch, int n, float scale, int is_bf16, int splits,
                   cudaStream_t stream) {
  if (is_bf16) return launch_tc<C>(q, k, v, out, part_o, part_ml, batch, n, scale, splits, stream);
  return launch_f32<C>(q, k, v, out, part_o, part_ml, batch, n, scale, splits, stream);
}

}  // namespace

// q, k, v: (batch, n, c) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// 16-byte aligned; out: (batch, n, c) f32. c is 64, 128 or 256. `splits`
// key splits, in key tiles of the dtype's kernel (64 keys in bf16, 32 in
// f32): with splits > 1, part_o is f32 scratch of (splits, batch, n, c) and
// part_ml of (splits, batch, n, 2), and a second kernel merges them into
// out. Launches on `stream` and returns the cudaError_t of the launches (0
// on success).
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
