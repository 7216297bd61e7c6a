// RWKV6 WKV recurrence over time: outputs and the final state (B5).
//
// Replaces the Pallas TPU kernel `rwkv6_scan_kernel` / `_kernel`
// (src/repro/kernels/rwkv6_scan/kernel.py:54, :21) and its layout
// wrapper (ops.py). Per batch b and head h, over the steps t = 0 .. S-1,
// with r, k, v, w [B, H, S, hd] (w the decay in (0, 1)), u [H, hd] and
// the state S [B, H, hd, hd] (key i x value j), all f32:
//   o_t[j]  = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
//   S[i,j] <- w_t[i] * S[i,j] + k_t[i] * v_t[j]
// The plain PyTorch version is `rwkv6_scan_ref` in ../ref.py.
//
// Layout. r, k, v, w and o are addressed through their (b, h, t)
// strides with the last dim contiguous, so the model hands in views of
// its [B, S, H, hd] projections without a copy and gets o back in that
// layout too. u [H, hd] and the states [B, H, hd, hd] are contiguous.
// hd = 16, 32, 64 or 128. Any S >= 1.
//
// Bound. The recurrence reads r, k, v and w once, writes o once and
// reads and writes the state once: 5 * B * H * S * hd * 4 bytes plus
// 2 * B * H * hd^2 * 4. At one 3,000-token prefill of rwkv6-1.6b (B = 1,
// H = 32, hd = 64) that is 124 MB, 0.037 ms at 3.35 TB/s; a decode step
// at 8 slots (S = 1) moves the state's 2 x 4.2 MB, 0.0026 ms. Both are
// bound by bytes. On the CUDA cores the recurrence needs 3 instructions
// per (step, i, j) (k v, the update's and the output's multiply-adds):
// 1.18 G at that prefill, about 0.04 ms on 132 SMs x 128 lanes. f32
// stays off the tensor cores: TF32 keeps three decimal digits and the
// scan is held to 2e-4.
//
// Design. The scan is sequential in time, so a prefill has only
// B * H * hd / 16 independent pieces of work (128 at B = 1): a block
// takes 16 value columns of one head (the columns of S move
// independently) and must keep its SM's four sub-partitions issuing one
// step after another.
//  - A register tile per thread: RT rows x CT adjacent columns of the
//    state, so that a thread's r, k and w loads serve CT columns and its
//    v load RT rows. A prefill takes 4 x 2 (at hd = 64, 128 threads: a
//    warp on each sub-partition), a decode step 4 x 4 (64 threads; 4 x 2
//    at hd = 16); both the fastest of the sweep that chip_smoke.py runs.
//  - Output sums off the chain: in the step loop each thread writes its
//    CT partial column sums to shared memory, [step][row group][column],
//    and talks to no other thread. After a chunk the block adds the
//    partials of all its steps in parallel (two accumulators, four
//    columns a thread) and stores o, 16 contiguous floats a step. The
//    only chain from step to step is the update's multiply-add.
//  - The bonus in the partials: r_t . (u (k_t v_t[j])) = v_t[j] *
//    sum_i r_t[i] u[i] k_t[i]; a thread adds v_t[j] times its rows' share
//    of that sum to its partial sums, from the r and k it already holds,
//    so the reduction over row groups completes it (a pass of its own,
//    kept in shared memory, was timed too: PERF.md).
//  - Operands ahead of use: r, k, w and v do not depend on the state, so
//    step t + 1's are read into registers while step t computes.
//  - Staging: a chunk of T steps of r, k, w (all hd rows) and this
//    block's 16 values of v is copied to shared memory with cp.async,
//    double-buffered: the next chunk loads while this one runs. A prefill
//    takes 32-step chunks (88 KB at hd = 64), a decode step (S <= 4) a
//    4-step one, so that eight 11 KB blocks share an SM.
//
// State in and out. The final state may be written over the initial one
// (the decode cache passes the same pointer): every thread reads its own
// RT x CT slice of the state before the scan and writes back exactly
// that slice after it, and no other thread touches those elements. The
// lanes of a warp cover neighbouring columns of a row (CT floats each,
// 64 contiguous bytes a row of the block).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W, in turns with
// the earlier design, real rwkv6-1.6b activations): 0.1500 ms at the
// 3,000-token prefill layer against 0.6113 (4.08x), 0.25 of the bound;
// 0.0033 ms at the decode step with the L2 cache warm against 0.0048,
// 0.0053 with it cold against 0.0066. What holds it back now: one warp
// per sub-partition issues about 45 instructions a step (37 of them
// floating point, with the bonus) and five shared-memory accesses, 50 ns
// a step in all; each chunk's copy burst and output reduction add about
// 200 ns a chunk. Spreading the copies over the steps (a ring of three
// chunks), bulk copies (TMA, by row or by tensor map), helper warps that
// copy and reduce beside the compute warps, and operands more than one
// step ahead behind per-step guards were each measured slower.
//
// Other tiles, chunks and block widths are built for the sweep that
// picked the defaults (rwkv6_scan_tile_launch); the earlier design, one
// column of hd / 4 rows a thread in two warps a block, is
// rwkv6_scan_chain.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 64;

// the default: 16 columns a block; a prefill 4 x 2 register tiles and a
// 32-step chunk, a decode (S <= kDecodeChunk) 4 x 4 tiles (4 x 2 at
// hd = 16) and a 4-step chunk
constexpr int kTileRows = 4, kTileCols = 2, kBlockCols = 16;
constexpr int kDecodeTileCols = 4;
constexpr int kChunk = 32, kDecodeChunk = 4;
constexpr int kUnroll = 4;  // steps a prefill's step loop unrolls

struct Strides {
  long long s[5][3];  // r, k, v, w, o: the (b, h, t) strides in floats
};

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;
  float* o;
  float* s_out;
  int B, H, S;
  Strides st;
  cudaStream_t stream;
};

// D head dim, RT x CT the register tile, C columns a block, T steps a
// chunk. Shared memory in floats: two chunk buffers, each r | k | w
// [3][T][D] and v [T][C], then the partial column sums [T][PS] (PS
// padded by C floats so that the steps a warp reduces at once fall on
// different banks).
template <int D, int RT, int CT, int C, int T>
struct Tile {
  static constexpr int kGroups = D / RT;          // row groups
  static constexpr int kLanesPerGroup = C / CT;   // threads a row group
  static constexpr int kThreads = kGroups * kLanesPerGroup;
  static constexpr int kPS = kGroups * C + C;
  static constexpr int kBuf = 3 * T * D + T * C;  // one chunk buffer
  static constexpr int kP = 2 * kBuf;
  static constexpr int kBytes = (kP + T * kPS) * 4;
  // a decode instance's blocks an SM (launch bounds): 512 threads an SM
  // at up to 128 registers each, so that a decode step's 1,024 blocks of
  // 64 threads (B 8, H 32, hd 64) run at once
  static constexpr int kDecodeBlocks = 512 / kThreads;
  static_assert(D % RT == 0 && C % CT == 0 && D % C == 0 && C % 4 == 0,
                "tile");
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
  static_assert(T % 4 == 0, "16-byte aligned regions");
  static_assert((kGroups * C) % 32 == 0, "bank padding of the partials");
  static_assert(kGroups % 2 == 0, "partials summed two row groups at once");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// N consecutive floats, 4 * N-byte aligned (N = 1, 2 or a multiple of 4)
template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + q);
      dst[q] = x.x;
      dst[q + 1] = x.y;
      dst[q + 2] = x.z;
      dst[q + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = src[q];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* dst, const float (&src)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      *reinterpret_cast<float4*>(dst + q) =
          make_float4(src[q], src[q + 1], src[q + 2], src[q + 3]);
    }
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = src[q];
  }
}

// one step's operands of a thread: its rows of r, k, w, its columns of v
template <int RT, int CT>
struct StepOps {
  float r[RT], k[RT], w[RT], v[CT];
};

template <int D, int RT, int CT, int C, int T>
__global__ void __launch_bounds__(Tile<D, RT, CT, C, T>::kThreads,
                                  T <= kDecodeChunk
                                      ? Tile<D, RT, CT, C, T>::kDecodeBlocks
                                      : 1)
    rwkv6_scan_tile_kernel(const float* __restrict__ r,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ w,
                           const float* __restrict__ u, const float* s0,
                           float* __restrict__ o, float* s_out, int H, int S,
                           Strides st) {
  using L = Tile<D, RT, CT, C, T>;
  constexpr int NT = L::kThreads;
  constexpr int G = L::kGroups;
  constexpr int PS = L::kPS;
  constexpr int Q = D / 4;  // 16-byte pieces of a row
  extern __shared__ __align__(16) float smem[];
  float* const p_s = smem + L::kP;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j0 = blockIdx.y * C;
  const int tid = threadIdx.x;
  const int g = tid / L::kLanesPerGroup;                 // row group
  const int cl = (tid - g * L::kLanesPerGroup) * CT;     // first column
  const int i0 = g * RT;                                 // first row

  const int which[4] = {0, 1, 3, 2};  // r, k, w, v's index in the strides
  const float* const srcs[4] = {r, k, w, v};
  const long long o_base = b * st.s[4][0] + h * st.s[4][1] + j0;
  const long long o_t = st.s[4][2];

  // all the copies of the chunk starting at step t0 into buffer buf,
  // 16 bytes a thread, rows coalesced
  auto load = [&](int buf, int t0) {
    const int n = min(T, S - t0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int per = a < 3 ? Q : C / 4;  // pieces a row
      const float* src = srcs[a] + b * st.s[which[a]][0] +
                         h * st.s[which[a]][1] + (a == 3 ? j0 : 0);
      float* dst = smem + buf * L::kBuf + a * T * D;
#pragma unroll
      for (int m = 0; m < (T * per + NT - 1) / NT; ++m) {
        const int idx = tid + m * NT;
        const int tt = idx / per;
        const int q = idx - tt * per;
        if (tt < n) {
          cp_async16(dst + tt * (a < 3 ? D : C) + q * 4,
                     src + (t0 + tt) * st.s[which[a]][2] + q * 4);
        }
      }
    }
    cp_async_commit();
  };
  load(0, 0);

  // this thread's RT x CT slice of the state, read before anything else
  // of the block is written, and u at its rows
  float s[RT][CT], ur[RT];
  const long long s_base =
      static_cast<long long>(bh) * D * D + static_cast<long long>(i0) * D +
      j0 + cl;
#pragma unroll
  for (int x = 0; x < RT; ++x) load_vec(s[x], s0 + s_base + x * D);
  load_vec(ur, u + h * D + i0);

  const int n_chunks = (S + T - 1) / T;
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    // chunk c has landed, and every thread is done with chunk c - 1
    // (its buffer, the partials)
    cp_async_wait_all();
    __syncthreads();
    const int t0 = c * T;
    const int n = min(T, S - t0);
    const float* rb = smem + buf * L::kBuf;  // r; k at +T*D, w at +2T*D
    const float* vb = rb + 3 * T * D;
    if (c + 1 < n_chunks) load(buf ^ 1, (c + 1) * T);

    // the steps: the state update and this thread's partial column sums,
    // with the next step's operands read into registers while one step
    // computes. The bonus r_t . (u k_t) v_t[j] joins the partial sums as
    // v_t[j] times this thread's rows' share of r_t . (u k_t). A whole
    // chunk runs groups of kUnroll steps unrolled, so that the scheduler
    // interleaves neighbouring steps; the ragged last chunk a plain loop.
    auto fetch = [&](StepOps<RT, CT>& op, int t) {
      load_vec(op.r, rb + t * D + i0);
      load_vec(op.k, rb + (T + t) * D + i0);
      load_vec(op.w, rb + (2 * T + t) * D + i0);
      load_vec(op.v, vb + t * C + cl);
    };
    float* const pp = p_s + g * C + cl;
    auto step = [&](const StepOps<RT, CT>& op, int tt) {
      float p0[CT], p1[CT], bx0 = 0.f, bx1 = 0.f;
#pragma unroll
      for (int y = 0; y < CT; ++y) p0[y] = p1[y] = 0.f;
#pragma unroll
      for (int x = 0; x < RT; ++x) {
        float& bx = (x & 1) ? bx1 : bx0;
        bx = fmaf(op.r[x] * ur[x], op.k[x], bx);
#pragma unroll
        for (int y = 0; y < CT; ++y) {
          float& p = (x & 1) ? p1[y] : p0[y];
          p = fmaf(op.r[x], s[x][y], p);
          s[x][y] = fmaf(op.w[x], s[x][y], op.k[x] * op.v[y]);
        }
      }
#pragma unroll
      for (int y = 0; y < CT; ++y) {
        p0[y] = fmaf(op.v[y], bx0 + bx1, p0[y] + p1[y]);
      }
      store_vec(pp + tt * PS, p0);
    };
    StepOps<RT, CT> cur, nxt;
    fetch(cur, 0);
    if (n == T) {
      for (int g0 = 0; g0 < T; g0 += kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int tt = g0 + u;
          fetch(nxt, min(tt + 1, T - 1));
          step(cur, tt);
          cur = nxt;
        }
      }
    } else {
#pragma unroll 1
      for (int tt = 0; tt < n; ++tt) {
        fetch(nxt, min(tt + 1, T - 1));
        step(cur, tt);
        cur = nxt;
      }
    }
    __syncthreads();

    // o_t[j] = the sum of the partials over the row groups, for the
    // chunk's steps, four columns a thread
#pragma unroll
    for (int m = 0; m < (T * C / 4 + NT - 1) / NT; ++m) {
      const int idx = tid + m * NT;
      const int t = idx / (C / 4);
      if (t < n) {
        const int col = (idx - t * (C / 4)) * 4;
        const float* part = p_s + t * PS + col;
        float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int gg = 0; gg < G; gg += 2) {
          float x0[4], x1[4];
          load_vec(x0, part + gg * C);
          load_vec(x1, part + (gg + 1) * C);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a0[e] += x0[e];
            a1[e] += x1[e];
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) a0[e] += a1[e];
        store_vec(o + o_base + (t0 + t) * o_t + col, a0);
      }
    }
  }

#pragma unroll
  for (int x = 0; x < RT; ++x) store_vec(s_out + s_base + x * D, s[x]);
}

template <int D, int RT, int CT, int C, int T>
int launch(const Args& a) {
  using L = Tile<D, RT, CT, C, T>;
  auto* kernel = rwkv6_scan_tile_kernel<D, RT, CT, C, T>;
  if (L::kBytes > 48 * 1024) {
    // the dynamic shared-memory limit, once per (instance, device)
    static bool configured[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= kMaxDevices)
      return static_cast<int>(cudaErrorInvalidDevice);
    if (!configured[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      configured[dev] = true;
    }
  }
  const dim3 grid(a.B * a.H, D / C);
  kernel<<<grid, L::kThreads, L::kBytes, a.stream>>>(
      a.r, a.k, a.v, a.w, a.u,
      a.s0, a.o, a.s_out, a.H, a.S, a.st);
  return static_cast<int>(cudaGetLastError());
}

// the built instances: the defaults at every head dim (4 x 2 tiles at a
// 32-step chunk; 4 x 4 tiles, 4 x 2 at hd = 16, at a 4-step chunk); and at
// hd = 64 the sweep's other tiles at both chunks (4 x 2, 8 x 1, 2 x 4,
// 8 x 2, 2 x 2, 4 x 1 and 4 x 4 of 16 columns a block; 4 x 2 of 8) and the
// default tile at 16- and 64-step chunks
#define RWKV6_TILES(X)                                                     \
  X(16, 4, 2, 16, 4) X(16, 4, 2, 16, 32) X(32, 4, 4, 16, 4)                \
  X(32, 4, 2, 16, 32) X(64, 4, 4, 16, 4) X(64, 4, 2, 16, 32)               \
  X(128, 4, 4, 16, 4) X(128, 4, 2, 16, 32) X(64, 4, 2, 16, 4)              \
  X(64, 4, 4, 16, 32) X(64, 8, 1, 16, 4) X(64, 8, 1, 16, 32)               \
  X(64, 2, 4, 16, 4) X(64, 2, 4, 16, 32) X(64, 8, 2, 16, 4)                \
  X(64, 8, 2, 16, 32) X(64, 2, 2, 16, 4) X(64, 2, 2, 16, 32)               \
  X(64, 4, 1, 16, 4) X(64, 4, 1, 16, 32) X(64, 4, 2, 8, 4)                 \
  X(64, 4, 2, 8, 32) X(64, 4, 2, 16, 16) X(64, 4, 2, 16, 64)

int dispatch(const Args& a, int D, int rt, int ct, int c, int t) {
#define RWKV6_CASE(d, rt_, ct_, c_, t_)                                    \
  if (D == d && rt == rt_ && ct == ct_ && c == c_ && t == t_)              \
    return launch<d, rt_, ct_, c_, t_>(a);
  RWKV6_TILES(RWKV6_CASE)
#undef RWKV6_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Args from the C entry points' arguments; false for ones the kernel
// does not take
bool make_args(Args* a, const void* r, const void* k, const void* v,
               const void* w, const void* u, const void* s0, void* o,
               void* s_out, int B, int H, int S, const long long* strides,
               void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 ||
      static_cast<long long>(B) * H > 0x7fffffffLL) {
    return false;
  }
  for (int x = 0; x < 5; ++x) {
    for (int d = 0; d < 3; ++d) {
      a->st.s[x][d] = strides[x * 3 + d];
      if (a->st.s[x][d] % 4 != 0) return false;
    }
  }
  a->r = static_cast<const float*>(r);
  a->k = static_cast<const float*>(k);
  a->v = static_cast<const float*>(v);
  a->w = static_cast<const float*>(w);
  a->u = static_cast<const float*>(u);
  a->s0 = static_cast<const float*>(s0);
  a->o = static_cast<float*>(o);
  a->s_out = static_cast<float*>(s_out);
  a->B = B;
  a->H = H;
  a->S = S;
  a->stream = static_cast<cudaStream_t>(stream);
  return true;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers
// to f32 data, 16-byte aligned; `strides` points to 15 int64 on the host:
// the (b, h, t) strides, in elements, of r, k, v, w and o, each a
// multiple of 4 (the last dim of each is contiguous). u, s0 and s_out
// are contiguous; s_out may equal s0. `stream` is a cudaStream_t.
// Returns the launch's cudaGetLastError() (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* o, void* s_out, int B, int H, int S,
                                 int D, const long long* strides,
                                 void* stream) {
  Args a;
  if (!make_args(&a, r, k, v, w, u, s0, o, s_out, B, H, S, strides,
                 stream)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S <= kDecodeChunk) {
    return dispatch(a, D, kTileRows, D >= 32 ? kDecodeTileCols : kTileCols,
                    kBlockCols, kDecodeChunk);
  }
  return dispatch(a, D, kTileRows, kTileCols, kBlockCols, kChunk);
}

// The same with a chosen instance: `rows` x `cols` register tiles,
// `block_cols` columns a block, `chunk` steps a chunk (one of
// RWKV6_TILES; cudaErrorInvalidValue for another).
extern "C" int rwkv6_scan_tile_launch(const void* r, const void* k,
                                      const void* v, const void* w,
                                      const void* u, const void* s0, void* o,
                                      void* s_out, int B, int H, int S, int D,
                                      int rows, int cols, int block_cols,
                                      int chunk, const long long* strides,
                                      void* stream) {
  Args a;
  if (!make_args(&a, r, k, v, w, u, s0, o, s_out, B, H, S, strides,
                 stream)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(a, D, rows, cols, block_cols, chunk);
}
