// RWKV6 WKV recurrence over time: the earlier design of kernel B5, kept
// beside rwkv6_scan.cu so that the two can be timed against each other
// on one card (ops._rwkv6_scan_chain). No path of the model calls it.
//
// Replaced the Pallas TPU kernel `rwkv6_scan_kernel` / `_kernel`
// (src/repro/kernels/rwkv6_scan/kernel.py) and its layout wrapper
// (ops.py). Per batch b and head h, over the steps t = 0 .. S-1, with
// r, k, v, w [B, H, S, hd] (w the decay in (0, 1)), u [H, hd] and the
// state S [B, H, hd, hd] (key i x value j), all f32:
//   o_t[j]  = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
//   S[i,j] <- w_t[i] * S[i,j] + k_t[i] * v_t[j]
// The plain PyTorch version is `rwkv6_scan_ref` in ../ref.py.
//
// Layout. r, k, v, w and o are addressed through their (b, h, t)
// strides with the last dim contiguous, so the model hands in views of
// its [B, S, H, hd] projections without a copy and gets o back in that
// layout too. u [H, hd] and the states [B, H, hd, hd] are contiguous.
// hd = 16, 32, 64 or 128 (template parameter). Any S >= 1.
//
// Design. The value columns of the state are independent: S[:, j] moves
// with k, w and v_t[j] alone. A block takes 16 columns of one head
// (grid: B * H blocks by hd / 16), and each column is held by 4 threads
// whose lanes are 8 apart, each keeping hd / 4 rows of it in registers
// for the whole scan. A thread sums r_t[i] * S[i,j] and
// r_t[i] * u[i] * k_t[i] over its rows, the 4 partial sums of a column
// meet by two warp shuffles, and
//   o_t[j] = sum_i r_t[i] S[i,j] + v_t[j] * sum_i r_t[i] u[i] k_t[i],
// a reassociation of the sum above (within the f32 tolerance). The
// TPU kernel's in-order time grid, with the state in VMEM scratch,
// becomes the loop over time inside the block. r_t, k_t and w_t (all hd
// rows) and this block's 16 values of v_t are staged in shared memory a
// chunk of steps at a time with cp.async (16 bytes per thread, coalesced
// rows), double-buffered so the next chunk loads while this one runs.
// A ragged last chunk loads and runs only the steps that exist.
//
// State in and out. The final state may be written over the initial one
// (the decode cache passes the same pointer): every thread reads its own
// hd / 4 x 1 slice of the state before the scan and writes back exactly
// that slice after it, and no other thread touches those elements.
//
// Bound. The recurrence reads r, k, v and w once, writes o once and
// reads and writes the state once: 5 * B * H * S * hd * 4 bytes plus
// 2 * B * H * hd^2 * 4. At one 3,000-token prefill of rwkv6-1.6b (B = 1,
// H = 32, hd = 64) that is 124 MB, 0.037 ms at 3.35 TB/s; its 5 flops per
// (step, i, j) (the output's and the update's multiply-adds and k v) are
// 2.0 GFLOP, 0.030 ms at 67 TFLOP/s in f32: bound by bytes. A decode
// step at 8 slots (S = 1) is bound by the state's 2 x 4.2 MB, about
// 2.6 us. The scan is sequential in time, so a prefill runs only
// B * H * hd / 16 blocks (128 at B = 1), each one step after another;
// splitting the columns over hd / 16 blocks is what spreads one head
// over 4 SMs, and the per-step chain is kept short (hd / 4 rows per
// thread, two shuffles). On an H100 (700 W) this takes 0.61 ms at that
// prefill, 6% of the bound, and 0.0046-0.0048 ms at that decode step,
// 55% of it: with two warps per SM nothing hides a step's shared-memory
// loads, multiply-add chain and shuffles. rwkv6_scan.cu is the design
// that took its place.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 4;                  // threads per column
constexpr int kCols = 16;                   // columns per block
constexpr int kThreads = kGroups * kCols;   // 64: 2 warps of 8 x 4
constexpr unsigned kFullMask = 0xffffffffu;

// steps per staged chunk: r, k and w take at most 24.6 KB (two buffers)
template <int D>
struct Chunk {
  static constexpr int kSteps = D >= 64 ? 1024 / D : 32;
};

struct Strides {
  long long s[5][3];  // r, k, v, w, o: the (b, h, t) strides in floats
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    rwkv6_scan_chain_kernel(const float* __restrict__ r,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ w,
                            const float* __restrict__ u, const float* s0,
                            float* __restrict__ o, float* s_out, int H, int S,
                            Strides st) {
  constexpr int T = Chunk<D>::kSteps;
  constexpr int R = D / kGroups;  // rows per thread
  constexpr int Q = D / 4;        // float4s per row
  // [buffer][r | k | w][step][row] and [buffer][step][column]
  __shared__ __align__(16) float rkw_s[2][3][T][D];
  __shared__ __align__(16) float v_s[2][T][kCols];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 3;                          // row group
  const int jl = ((tid >> 5) << 3) + (lane & 7);    // column in the block
  const int j = j0 + jl;
  const int i0 = g * R;

  // r, k, w (staged as rows 0, 1, 2) and v: base offsets and t strides
  const float* src[4] = {r, k, w, v};
  const int which[4] = {0, 1, 3, 2};  // their index in the strides
  long long base[4], t_stride[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    base[a] = b * st.s[which[a]][0] + h * st.s[which[a]][1];
    t_stride[a] = st.s[which[a]][2];
  }
  const long long o_base = b * st.s[4][0] + h * st.s[4][1] + j;
  const long long o_t = st.s[4][2];

  // issue the cp.async copies of the chunk starting at step t0
  auto load = [&](int buf, int t0) {
    const int n = min(T, S - t0);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      for (int idx = tid; idx < T * Q; idx += kThreads) {
        const int tt = idx / Q;
        const int q = idx - tt * Q;
        if (tt < n) {
          cp_async16(&rkw_s[buf][a][tt][q * 4],
                     src[a] + base[a] + (t0 + tt) * t_stride[a] + q * 4);
        }
      }
    }
    for (int idx = tid; idx < T * (kCols / 4); idx += kThreads) {
      const int tt = idx / (kCols / 4);
      const int q = idx - tt * (kCols / 4);
      if (tt < n) {
        cp_async16(&v_s[buf][tt][q * 4],
                   src[3] + base[3] + (t0 + tt) * t_stride[3] + j0 + q * 4);
      }
    }
    cp_async_commit();
  };

  load(0, 0);

  float s[R], ub[R];  // this thread's rows of S[:, j] and of u
  const long long s_base = static_cast<long long>(bh) * D * D + j;
#pragma unroll
  for (int x = 0; x < R; ++x) {
    s[x] = s0[s_base + static_cast<long long>(i0 + x) * D];
    ub[x] = u[h * D + i0 + x];
  }

  const int n_chunks = (S + T - 1) / T;
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) {
      load(buf ^ 1, (c + 1) * T);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = c * T;
    const int n = min(T, S - t0);
    for (int tt = 0; tt < n; ++tt) {
      const float* rr = &rkw_s[buf][0][tt][i0];
      const float* kk = &rkw_s[buf][1][tt][i0];
      const float* ww = &rkw_s[buf][2][tt][i0];
      const float vj = v_s[buf][tt][jl];
      float acc = 0.f;    // sum_i r[i] S[i,j]
      float bonus = 0.f;  // sum_i r[i] u[i] k[i]
#pragma unroll
      for (int x = 0; x < R; x += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rr + x);
        const float4 k4 = *reinterpret_cast<const float4*>(kk + x);
        const float4 w4 = *reinterpret_cast<const float4*>(ww + x);
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc = fmaf(rv[e], s[x + e], acc);
          bonus = fmaf(rv[e] * ub[x + e], kv[e], bonus);
          s[x + e] = fmaf(wv[e], s[x + e], kv[e] * vj);
        }
      }
      float p = fmaf(vj, bonus, acc);
      p += __shfl_xor_sync(kFullMask, p, 8);
      p += __shfl_xor_sync(kFullMask, p, 16);
      if (g == 0) o[o_base + (t0 + tt) * o_t] = p;
    }
    __syncthreads();  // every thread is done with buf before it reloads
  }

#pragma unroll
  for (int x = 0; x < R; ++x) {
    s_out[s_base + static_cast<long long>(i0 + x) * D] = s[x];
  }
}

template <int D>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* o,
                   float* s_out, int B, int H, int S, const Strides& st,
                   cudaStream_t stream) {
  const dim3 grid(B * H, D / kCols);
  rwkv6_scan_chain_kernel<D><<<grid, kThreads, 0, stream>>>(
      r, k, v, w, u, s0, o, s_out, H, S, st);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers
// to f32 data, 16-byte aligned; `strides` points to 15 int64 on the host:
// the (b, h, t) strides, in elements, of r, k, v, w and o, each a
// multiple of 4 (the last dim of each is contiguous). u, s0 and s_out
// are contiguous; s_out may equal s0. `stream` is a cudaStream_t.
// Returns the launch's cudaGetLastError() (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int rwkv6_scan_chain_launch(const void* r, const void* k,
                                       const void* v, const void* w,
                                       const void* u, const void* s0,
                                       void* o, void* s_out, int B, int H,
                                       int S, int D,
                                       const long long* strides,
                                       void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 ||
      static_cast<long long>(B) * H > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st;
  for (int a = 0; a < 5; ++a) {
    for (int d = 0; d < 3; ++d) {
      st.s[a][d] = strides[a * 3 + d];
      if (st.s[a][d] % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  float* of = static_cast<float*>(o);
  float* sof = static_cast<float*>(s_out);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return static_cast<int>(
          launch<16>(rf, kf, vf, wf, uf, sf, of, sof, B, H, S, st, cs));
    case 32:
      return static_cast<int>(
          launch<32>(rf, kf, vf, wf, uf, sf, of, sof, B, H, S, st, cs));
    case 64:
      return static_cast<int>(
          launch<64>(rf, kf, vf, wf, uf, sf, of, sof, B, H, S, st, cs));
    case 128:
      return static_cast<int>(
          launch<128>(rf, kf, vf, wf, uf, sf, of, sof, B, H, S, st, cs));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
