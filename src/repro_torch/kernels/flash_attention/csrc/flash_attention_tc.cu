// Flash attention forward on Hopper's tensor cores (bf16): causal, sliding
// window, chunked.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` / `_kernel`
// (src/repro/kernels/flash_attention/kernel.py:23-74) and its GQA wrapper
// for bf16 inputs, the main path's type; f32 inputs keep the CUDA-core
// kernel of flash_attention.cu (ops.py picks by dtype). What it computes,
// for query i and key j, both counted from position 0:
//   mask     j <= i;  kind swa: also i - j < window;
//            kind chunked: also i / window == j / window (window 0: causal)
//   s        (q_i . k_j) * (1 / sqrt(d)) in f32 from bf16 products,
//            masked entries -1e30
//   out_i    sum_j p_ij v_j / max(sum_j p_ij, 1e-30), p = exp(s - running
//            max) in f32; the sum takes the unrounded p (kernel.py:56), P.V
//            takes p rounded to bf16 (kernel.py:58); the output is bf16.
// Query head h reads KV head h / (Hq / Hkv). q and o are [B, S, Hq, d], k
// and v [B, T, Hkv, d], contiguous, read in place; d = 16, 32, 64, 128,
// 256.
// The plain PyTorch version is `flash_attention_ref` in ../ref.py.
//
// Bound. The two products take 4 * d flops per visible (query, key) pair
// and head. gemma3-1b's global layer of a 2,048-token prefill (Hq = 4,
// Hkv = 1, d = 256, full) is 8.6 GFLOP, 0.0087 ms at the bf16 tensor-core
// peak (989 TFLOP/s) against 10 MB of q, k, v and o, 0.0031 ms at
// 3.35 TB/s; mixtral-8x22b's layer of a 3,000-token prefill (Hq = 48,
// Hkv = 8, d = 128, swa 4,096, which binds no query) is 110.6 GFLOP,
// 0.112 ms, against 86 MB, 0.026 ms. Both are bound by operations, so the
// products have to run on the tensor cores.
//
// Design (warp specialised, one block per SM).
//  * A block is one 64-row query tile of kWG query heads that share a KV
//    head: one consumer warpgroup per head, so the warpgroups share every
//    K/V stage and visit the same KV tiles under the same mask, and one
//    producer warpgroup. kWG = 2 where Hq / Hkv is even and the launch
//    is bound by its total work rather than its heaviest query tile
//    (auto_heads), else 1: at mixtral's layer pairs take 0.67 of one
//    head a block's time, at gemma's global layer 1.20 of it, where one
//    head a block leaves no SM idle while the heaviest tiles run
//    (chip_smoke, NVIDIA H100 80GB HBM3, 700 W; the rule matches the
//    faster of the two at 9 measured shapes). Blocks run heaviest query
//    tile first (the causal tiles differ up to S / 64 times in work).
//  * The producer's one thread loads the Q tiles once, then the K and V
//    tiles of a ring of kStages = 2 stages in shared memory with TMA (4-D
//    tensor maps over the model's own layout, dims d, H, S|T, B innermost
//    first: a box never crosses into the next batch, and rows past S or T
//    are zero-filled by the hardware), each stage with its own full
//    barriers for K and for V and one empty barrier, so S = Q.K^T of a
//    stage starts before its V has landed while the next stage loads.
//    The tiles are 128-byte swizzled (64-byte at d = 32, 32-byte at d =
//    16): a box is at most 64 bf16 wide, so a d = 128 or 256 tile is 2 or
//    4 boxes.
//  * Each consumer computes S = Q.K^T with wgmma m64nBKk16 (Q and K
//    K-major from shared memory), applies the mask, the online softmax in
//    registers (row max over the quad that shares a row), and then
//    O += P.V with wgmma m64nDk16 taking P as the A operand from
//    registers: the S accumulator's fragment is the A fragment once
//    converted to bf16, so P never goes to shared memory. V is the B
//    operand in its [key, d] layout through the instruction's transpose
//    bit (MN-major), not transposed in shared memory.
//  * With two consumer warpgroups, setmaxnreg gives the producer 24
//    registers a thread and each consumer 240 (the 64 x 256 f32 O
//    accumulator alone is 128 a thread at d = 256); with one, the 256
//    threads may each take 255.
//  * BK = 128 keys a stage for d <= 128, 64 at d = 256 (shared memory:
//    Q 64 KB + 2 stages x 64 KB at d = 256, kWG = 2).
//  * Only the KV tiles the mask can reach are visited: keys up to the
//    tile's last query, and from q0 - window + 1 (swa) or the chunk start
//    (chunked). A skipped tile is fully masked for every row. In a fully
//    masked tile the Pallas code adds exp(-1e30 - (-1e30)) = 1 per key
//    until a real key sets the max and alpha = exp(-1e30 - m) = 0 wipes
//    it; since every query row sees its own key (the wrapper requires
//    S <= T), every row meets a real key, so skipping changes nothing.
//    Visited tiles keep the Pallas arithmetic, partly masked rows
//    included. The element mask is applied only on tiles that cross the
//    causal diagonal, the window's edge, a chunk edge or T (a zero key
//    past T scores 0, not -1e30); interior tiles take no compare.
//  * exp is taken as exp2 of scores pre-scaled by log2(e), the same
//    function to within an f32 rounding.
//
// The tensor maps are encoded on the host at each launch with libcuda's
// cuTensorMapEncodeTiled, found with dlopen("libcuda.so.1"), so
// the library links no -lcuda. The dynamic shared-memory limit is set
// once per (instantiation, device).
//
// Measured (chip_smoke.py, in one call and in turns, device ms by CUDA
// graph replay, the mean of two turns; NVIDIA H100 80GB HBM3, 700.00 W):
//   gemma3-1b global layer, 2,048 tokens: 0.048704 (bound 0.008690, so
//     0.178 of it; SDPA 0.050989; the CUDA-core design 0.625269)
//   gemma3-1b swa-512 layer, 2,048 tokens: 0.023803 (bound 0.003801,
//     0.160; SDPA with a boolean mask 0.133292; CUDA-core 0.188139)
//   mixtral-8x22b layer 0, 3,000 tokens: 0.297075 (bound 0.111859,
//     0.377; SDPA is_causal 0.215477; CUDA-core 4.957785)
// What holds it back: each consumer warpgroup waits for its S product
// before the softmax and for P.V before the next tile (no intra-
// warpgroup overlap of the two), so the tensor cores idle while the
// softmax runs unless the other warpgroup fills them.
// ptxas: 0 spill bytes in every instance.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsWG = 64;  // query rows per consumer warpgroup
constexpr int kStages = 2;   // K/V ring depth
constexpr int kMaxDevices = 64;
// registers a thread with two consumer warpgroups: the producer's few,
// the rest to the consumers (the block's 384 x 168 of the launch bounds);
// with one, every thread may take 255 and no register moves
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;

template <int D>
struct Tile {
  static constexpr int kBK = D == 256 ? 64 : 128;  // keys per stage
  static constexpr int kBoxC = D < 64 ? D : 64;    // columns per TMA box
  static constexpr int kRowBytes = kBoxC * 2;      // the swizzle span
  static constexpr int kBoxes = D / kBoxC;
  // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64-byte, 3 = 32-byte
  static constexpr int kLayout =
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kQBox = kRowsWG * kRowBytes;  // bytes of a Q box
  static constexpr int kKVBox = kBK * kRowBytes;     // bytes of a K/V box
  static constexpr int kQTile = kQBox * kBoxes;
  static constexpr int kKVTile = kKVBox * kBoxes;
};

template <int D, int kWG>
constexpr int smem_bytes() {
  // Q tiles, K and V rings, 7 barriers, and slack to align to 1,024 B
  return kWG * Tile<D>::kQTile + 2 * kStages * Tile<D>::kKVTile + 64 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one TMA box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
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

// keep the compiler from moving accumulator reads or writes across a
// wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 16] += A[64 x 16] . B[16 x 16], A in registers, B MN-major
// in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A in registers, B MN-major
// in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B MN-major
// in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers, B MN-major
// in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D[64 x 256] += A[64 x 16] . B[16 x 256], A in registers, B MN-major
// in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "S tile width");
  if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, scale_d);
  } else {
    wgmma_ss_n128(d, da, db, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 256,
                "head dim");
  if constexpr (N == 16) {
    wgmma_rs_n16(d, a, db, scale_d);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, db, scale_d);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db, scale_d);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db, scale_d);
  } else {
    wgmma_rs_n256(d, a, db, scale_d);
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int T_len, int kind,
                                        int window) {
  bool ok = kp <= qp && kp < T_len;
  if (kind == 1 && window > 0) ok = ok && (qp - kp < window);
  if (kind == 2 && window > 0) ok = ok && (qp / window == kp / window);
  return ok;
}

// the KV tiles the mask can reach from the query tile at q0
struct KvRange {
  int start;  // first key of the first tile
  int n;      // tiles
};

template <int BK>
__host__ __device__ __forceinline__ KvRange kv_range(int q0, int S, int T_len,
                                            int kind, int window) {
  // (ternaries, not min / max: this runs on the host too)
  const int q_last = (q0 + kRowsWG < S ? q0 + kRowsWG : S) - 1;
  int k_lo = 0;
  if (kind == 1 && window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
  if (kind == 2 && window > 0) k_lo = (q0 / window) * window;
  const int k_hi = T_len < q_last + 1 ? T_len : q_last + 1;
  const int start = (k_lo / BK) * BK;
  return {start, (k_hi - start + BK - 1) / BK};
}

template <int D, int kWG>
__global__ void __launch_bounds__(128 * (kWG + 1), 1)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              __nv_bfloat16* __restrict__ o, int B, int S,
                              int T_len, int HQ, int HKV, int kind,
                              int window, float scale_log2) {
  using Tl = Tile<D>;
  constexpr int BK = Tl::kBK;
  extern __shared__ uint8_t smem_raw[];
  // TMA's swizzle and the wgmma descriptors assume 1,024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;                             // [kWG][boxes][64][box]
  uint8_t* k_s = q_s + kWG * Tl::kQTile;           // [stage][boxes][BK][box]
  uint8_t* v_s = k_s + kStages * Tl::kKVTile;      // [stage][boxes][BK][box]
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kStages * Tl::kKVTile);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  // block -> (query tile, batch, KV head, head group), heaviest tile first
  const int groups = HQ / HKV / kWG;
  const int n_qt = (S + kRowsWG - 1) / kRowsWG;
  const int per_tile = B * HKV * groups;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / per_tile);
  int rest = static_cast<int>(blockIdx.x % per_tile);
  const int grp = rest % groups;
  rest /= groups;
  const int hk = rest % HKV;
  const int b = rest / HKV;
  const int q0 = qt * kRowsWG;
  const int h0 = hk * (HQ / HKV) + grp * kWG;
  const KvRange kv = kv_range<BK>(q0, S, T_len, kind, window);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(empty + st, 4 * kWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWG) {
    // the producer warpgroup: one thread issues every load
    if constexpr (kWG == 2) regs_dec<kProducerRegs>();
    if (threadIdx.x == kWG * 128) {
      mbar_expect_tx(q_full, kWG * Tl::kQTile);
      for (int w = 0; w < kWG; ++w)
        for (int c = 0; c < Tl::kBoxes; ++c)
          tma_load(q_s + w * Tl::kQTile + c * Tl::kQBox, &tm_q, q_full,
                   c * Tl::kBoxC, h0 + w, q0, b);
      for (int i = 0; i < kv.n; ++i) {
        const int st = i % kStages;
        const int k0 = kv.start + i * BK;
        // a stage is free once every consumer warp released it (the first
        // round passes at once)
        mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + st, Tl::kKVTile);
        for (int c = 0; c < Tl::kBoxes; ++c)
          tma_load(k_s + st * Tl::kKVTile + c * Tl::kKVBox, &tm_k,
                   k_full + st, c * Tl::kBoxC, hk, k0, b);
        mbar_expect_tx(v_full + st, Tl::kKVTile);
        for (int c = 0; c < Tl::kBoxes; ++c)
          tma_load(v_s + st * Tl::kKVTile + c * Tl::kKVBox, &tm_v,
                   v_full + st, c * Tl::kBoxC, hk, k0, b);
      }
    }
  } else {
    // a consumer warpgroup: query head h0 + wg, rows q0 .. q0 + 63
    if constexpr (kWG == 2) regs_inc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    // accumulator fragment: this thread holds rows row0 and row0 + 8, and
    // in each 8-column group the columns col and col + 1
    const int row0 = q0 + warp * 16 + lane / 4;
    const int col = 2 * (lane % 4);
    const int h = h0 + wg;
    const uint32_t q_addr = smem_u32(q_s + wg * Tl::kQTile);
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max (scores x log2 e)
    float l[2] = {0.f, 0.f};          // this thread's part of the row sum
    mbar_wait(q_full, 0);

    for (int i = 0; i < kv.n; ++i) {
      const int st = i % kStages;
      const int ph = (i / kStages) & 1;
      const int k0 = kv.start + i * BK;
      const uint32_t k_addr = smem_u32(k_s + st * Tl::kKVTile);
      const uint32_t v_addr = smem_u32(v_s + st * Tl::kKVTile);

      // S = Q . K^T: Q and K K-major; a k16 step moves 32 bytes along a
      // swizzled row, then on to the next box
      float s[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
      mbar_wait(k_full + st, ph);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk * 16 / Tl::kBoxC;
        const int off = (kk * 16 % Tl::kBoxC) * 2;
        wgmma_ss<BK>(s,
                     smem_desc(q_addr + box * Tl::kQBox + off, 16,
                               8 * Tl::kRowBytes, Tl::kLayout),
                     smem_desc(k_addr + box * Tl::kKVBox + off, 16,
                               8 * Tl::kRowBytes, Tl::kLayout),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // s[j]: row row0 + 8 * ((j >> 1) & 1), key k0 + 8 * (j / 4) + col +
      // (j & 1). The element mask only where the tile crosses an edge.
      const bool edge =
          k0 + BK - 1 > q0 || k0 + BK > T_len ||
          (kind == 1 && window > 0 && q0 + kRowsWG - 1 - k0 >= window) ||
          (kind == 2 && window > 0 &&
           k0 / window != (q0 + kRowsWG - 1) / window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int qp = row0 + ((j & 2) ? 8 : 0);
          const int kp = k0 + (j / 4) * 8 + col + (j & 1);
          s[j] = visible(qp, kp, T_len, kind, window) ? s[j] * scale_log2
                                                      : kNegInf;
        }
      } else {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) s[j] *= scale_log2;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the four threads of a quad hold one row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        s[j] = exp2f(s[j] - m[(j >> 1) & 1]);
        sum[(j >> 1) & 1] += s[j];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
      // P in bf16 as wgmma's A fragment: k16 step kk takes the S fragment
      // of keys 16 kk .. 16 kk + 15 as it stands
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P . V: V MN-major (d contiguous); a k16 step is 16 rows of
      // every box, LBO the step from one 64-column box to the next, SBO
      // from 8 rows to the next 8
      mbar_wait(v_full + st, ph);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(acc, p[kk],
                    smem_desc(v_addr + kk * 16 * Tl::kRowBytes, Tl::kKVBox,
                              8 * Tl::kRowBytes, Tl::kLayout),
                    1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + st);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qp = row0 + 8 * r;
      if (qp < S) {
        const float denom = fmaxf(l[r], 1e-30f);
        __nv_bfloat16* orow = o + ((static_cast<size_t>(b) * S + qp) * HQ + h) * D;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + col) =
              __floats2bfloat162_rn(acc[4 * c + 2 * r] / denom,
                                    acc[4 * c + 2 * r + 1] / denom);
      }
    }
  }
}

// ---- host side ----------------------------------------------------------

// error codes beside cudaError_t's (ops.py names them)
constexpr int kErrNoEncode = 1001;  // cuTensorMapEncodeTiled not found
constexpr int kErrTensorMap = 1002;  // a tensor map was refused

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, from the libcuda.so.1 that the CUDA
// runtime has loaded (no -lcuda at link time)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib == nullptr) return nullptr;
    return reinterpret_cast<EncodeTiled>(
        dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// a 4-D map over a contiguous bf16 [B, len, H, D] tensor (dims innermost
// first); a box is box_c columns x 1 head x rows positions x 1 batch
bool make_map(CUtensorMap* map, const void* base, int B, int len, int H,
              int D, int box_c, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(len) * H * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_c), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box_c * 2 == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_c * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int kWG>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T_len, int HQ, int HKV, int kind, int window,
           cudaStream_t stream) {
  using Tl = Tile<D>;
  constexpr int smem = smem_bytes<D, kWG>();
  // the dynamic shared-memory limit, once per (instantiation, device)
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(flash_attention_tc_kernel<D, kWG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  if (encode_tiled() == nullptr) return kErrNoEncode;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, S, HQ, D, Tl::kBoxC, kRowsWG) ||
      !make_map(&mk, k, B, T_len, HKV, D, Tl::kBoxC, Tl::kBK) ||
      !make_map(&mv, v, B, T_len, HKV, D, Tl::kBoxC, Tl::kBK))
    return kErrTensorMap;
  const long long blocks =
      static_cast<long long>((S + kRowsWG - 1) / kRowsWG) * B * HQ / kWG;
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  flash_attention_tc_kernel<D, kWG>
      <<<static_cast<unsigned>(blocks), 128 * (kWG + 1), smem, stream>>>(
          mq, mk, mv, static_cast<__nv_bfloat16*>(o), B, S, T_len, HQ, HKV,
          kind, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// query heads a block by default: two of one KV head where they pair up
// and the launch is bound by its total work rather than by its heaviest
// query tile, i.e. one-head blocks would keep every SM of the current
// device busy for longer than the heaviest tile takes; else one (pairing
// then only idles SMs)
template <int BK>
int auto_heads(int B, int S, int T_len, int HQ, int HKV, int kind,
               int window) {
  if ((HQ / HKV) % 2 != 0) return 1;
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 1;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 1;
  long long work = 0;  // KV tiles of one head's query tiles
  int heaviest = 0;
  for (int q0 = 0; q0 < S; q0 += kRowsWG) {
    const int n = kv_range<BK>(q0, S, T_len, kind, window).n;
    work += n;
    heaviest = n > heaviest ? n : heaviest;
  }
  return work * B * HQ > static_cast<long long>(heaviest) * sms[dev] ? 2 : 1;
}

template <int D>
int launch_g(const void* q, const void* k, const void* v, void* o, int B,
             int S, int T_len, int HQ, int HKV, int kind, int window,
             int heads_per_block, cudaStream_t stream) {
  if (heads_per_block == 0)
    heads_per_block = auto_heads<Tile<D>::kBK>(B, S, T_len, HQ, HKV, kind,
                                               window);
  if (heads_per_block == 2)
    return launch<D, 2>(q, k, v, o, B, S, T_len, HQ, HKV, kind, window,
                        stream);
  return launch<D, 1>(q, k, v, o, B, S, T_len, HQ, HKV, kind, window,
                      stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers
// to contiguous, 16-byte aligned bf16 tensors on the current device;
// `kind` 0 = full, 1 = swa, 2 = chunked; `heads_per_block` 0 (the
// default choice, auto_heads), 2 (query heads of one KV head paired in a
// block; Hq / Hkv even) or 1; `stream` is a cudaStream_t. Returns the launch's cudaGetLastError(),
// cudaErrorInvalidValue for arguments the kernel does not take, or
// kErrNoEncode / kErrTensorMap.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int S, int T_len, int HQ, int HKV,
                                         int D, int kind, int window,
                                         int heads_per_block, void* stream) {
  if (B <= 0 || S <= 0 || S > T_len || HKV <= 0 || HQ % HKV != 0 ||
      kind < 0 || kind > 2 || window < 0 ||
      !(heads_per_block == 0 || heads_per_block == 1 ||
        (heads_per_block == 2 && (HQ / HKV) % 2 == 0)) ||
      static_cast<long long>((S + kRowsWG - 1) / kRowsWG) * B * HQ >=
          (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_g<16>(q, k, v, o, B, S, T_len, HQ, HKV, kind, window,
                           heads_per_block, st);
    case 32:
      return launch_g<32>(q, k, v, o, B, S, T_len, HQ, HKV, kind, window,
                           heads_per_block, st);
    case 64:
      return launch_g<64>(q, k, v, o, B, S, T_len, HQ, HKV, kind, window,
                           heads_per_block, st);
    case 128:
      return launch_g<128>(q, k, v, o, B, S, T_len, HQ, HKV, kind, window,
                           heads_per_block, st);
    case 256:
      return launch_g<256>(q, k, v, o, B, S, T_len, HQ, HKV, kind, window,
                           heads_per_block, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
