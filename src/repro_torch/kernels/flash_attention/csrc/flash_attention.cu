// Online-softmax (flash) attention forward on the CUDA cores: causal,
// sliding window, chunked. ops.py sends f32 inputs here (TF32 tensor
// cores cannot meet f32's 3e-5); bf16 goes to the tensor-core kernel of
// flash_attention_tc.cu, and this kernel's bf16 instance is reachable only
// through the private ops._flash_attention_simt, which chip_smoke.py times
// beside the tensor-core kernel as the earlier design.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` / `_kernel`
// (src/repro/kernels/flash_attention/kernel.py) and its GQA wrapper
// (ops.py). For query i and key j, both counted from position 0:
//   mask     j <= i;  kind swa: also i - j < window;
//            kind chunked: also i / window == j / window (window 0: causal)
//   s        (q_i . k_j) * (1 / sqrt(d)), f32, masked entries -1e30
//   out_i    sum_j p_ij v_j / sum_j p_ij, p = exp(s - running max),
//            p cast to the input type before P.V (kernel.py:58), the
//            output cast to the input type.
// The plain PyTorch version is `flash_attention_ref` in ../ref.py.
//
// Layout. q and o are [B, S, Hq, d], k and v [B, T, Hkv, d], contiguous:
// the model's own layout, read in place. Query head h reads KV head
// h / (Hq / Hkv), so GQA needs neither a repeat nor a transpose.
// Types: f32 or bf16; d = 16, 32, 64, 128 or 256 (template parameters).
//
// Design. One block of 256 threads per (b * Hq + h, tile of 64 queries).
// The TPU kernel's sequential KV grid axis, with its (acc, m, l) carry in
// VMEM scratch, becomes a loop inside the block over 64-key tiles, with
// the carry in registers. The Q tile and each K, V and P tile sit in
// shared memory as f32 (the shared memory is dynamic: 215 KB at d = 256,
// over the 48 KB static limit). Thread (ty, tx) of the 16 x 16 grid owns
// query rows ty + 16 i (i < 4): for the scores, keys tx + 16 j (j < 4);
// for the output, columns tx + 16 c (c < d / 16). Row maxima and sums
// are reduced over the 16 lanes of a half-warp with shuffles.
//
// Only the KV tiles the mask can reach are visited: keys up to the
// tile's last query, and from q0 - window + 1 (swa) or the chunk start
// (chunked). A skipped tile is fully masked for every row. In a fully
// masked tile the Pallas code adds exp(-1e30 - (-1e30)) = 1 per key until
// a real key sets the max and alpha = exp(-1e30 - m) = 0 wipes it; since
// every query row sees its own key (the wrapper requires S <= T), every
// row meets a real key, so skipping changes nothing. Visited tiles keep
// the Pallas arithmetic, partly masked rows included. Ragged S and T are
// masked here (keys past T are -1e30 with zero V rows, queries past S are
// not stored): the Pallas wrapper's S % q_block == 0 does not hold for
// prompts.
//
// Bound. At gemma3-1b's prefill (B = 1, Hq = 4, Hkv = 1, d = 256) the
// two products take 4 * Hq * d flops per visible (query, key) pair:
// S = 2,048, full causal, is 8.6 GFLOP, 8.7 us at the bf16 tensor-core
// peak, against 10 MB of q, k, v and o, 3.1 us at 3.35 TB/s: bound by
// operations. This kernel does its products with f32 FMAs on the CUDA
// cores (67 TFLOP/s peak), so in bf16 it cannot come near that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 16;
constexpr int kLdP = kBK + 16;  // P row stride: two rows of a warp on
                                // disjoint banks
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// p rounded to the input type (kernel.py:58 `p.astype(v.dtype)`)
__device__ __forceinline__ float to_input_type(float x, const float*) {
  return x;
}
__device__ __forceinline__ float to_input_type(float x,
                                               const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return ((size_t)(kBQ + 2 * kBK) * (D + 4) + (size_t)kBQ * kLdP) *
         sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int T_len, int HQ, int HKV, int kind, int window,
                           float scale) {
  constexpr int kLd = D + 4;  // Q/K/V row stride (floats): 16-byte rows,
                              // conflict-free float4 reads across rows
  constexpr int kDC = D / 16;
  constexpr int kD4 = D / 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][kLd]
  float* ks = qs + kBQ * kLd;                   // [kBK][kLd]
  float* vs = ks + kBK * kLd;                   // [kBK][kLd]
  float* ps = vs + kBK * kLd;                   // [kBQ][kLdP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x / HQ;
  const int h = blockIdx.x % HQ;
  const int hk = h / (HQ / HKV);
  const int q0 = blockIdx.y * kBQ;
  const size_t q_stride = (size_t)HQ * D;  // between positions
  const size_t k_stride = (size_t)HKV * D;
  const T* qb = q + ((size_t)b * S * HQ + h) * D;
  const T* kb = k + ((size_t)b * T_len * HKV + hk) * D;
  const T* vb = v + ((size_t)b * T_len * HKV + hk) * D;
  T* ob = o + ((size_t)b * S * HQ + h) * D;

  for (int idx = tid; idx < kBQ * kD4; idx += kThreads) {
    const int r = idx / kD4;
    const int c = (idx % kD4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) val = load4(qb + (size_t)(q0 + r) * q_stride + c);
    *reinterpret_cast<float4*>(qs + r * kLd + c) = val;
  }

  // the KV range the mask can reach from this query tile
  const int q_last = min(q0 + kBQ, S) - 1;
  int k_lo = 0;
  if (kind == 1 && window > 0) k_lo = max(0, q0 - window + 1);
  if (kind == 2 && window > 0) k_lo = (q0 / window) * window;
  const int k_hi = min(T_len, q_last + 1);

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the Q tile is stored; the last tile's readers done
    for (int idx = tid; idx < kBK * kD4; idx += kThreads) {
      const int r = idx / kD4;
      const int c = (idx % kD4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (k0 + r < T_len) {
        kv = load4(kb + (size_t)(k0 + r) * k_stride + c);
        vv = load4(vb + (size_t)(k0 + r) * k_stride + c);
      }
      *reinterpret_cast<float4*>(ks + r * kLd + c) = kv;
      *reinterpret_cast<float4*>(vs + r * kLd + c) = vv;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fma4(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty + 16 * i;
      const int qp = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = kp <= qp && kp < T_len;
        if (kind == 1 && window > 0) ok = ok && (qp - kp < window);
        if (kind == 2 && window > 0) ok = ok && (qp / window == kp / window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[row * kLdP + tx + 16 * j] = to_input_type(p, q);
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kLdP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vr[kDC];
#pragma unroll
        for (int c = 0; c < kDC; ++c) vr[c] = vs[(kk + u) * kLd + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < kDC; ++c) acc[i][c] = fmaf(p, vr[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDC; ++c)
      store(ob + (size_t)qp * q_stride + tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int T_len, int HQ, int HKV, int kind,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // the dynamic shared memory limit, once per (instantiation, device)
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid(B * HQ, (S + kBQ - 1) / kBQ);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, HQ, HKV, kind,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int T_len, int HQ, int HKV, int D,
                     int kind, int window, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, T_len, HQ, HKV, kind, window,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, T_len, HQ, HKV, kind, window,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, T_len, HQ, HKV, kind, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, T_len, HQ, HKV, kind, window,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, T_len, HQ, HKV, kind, window,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers
// to contiguous, 16-byte aligned tensors; `dtype` 0 = f32, 1 = bf16;
// `kind` 0 = full, 1 = swa, 2 = chunked; `stream` is a cudaStream_t.
// Returns the launch's cudaGetLastError() (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T_len, int HQ, int HKV, int D,
                                      int dtype, int kind, int window,
                                      void* stream) {
  if (B <= 0 || S <= 0 || S > T_len || HKV <= 0 || HQ % HKV != 0 ||
      kind < 0 || kind > 2 || window < 0 || (S + kBQ - 1) / kBQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_d<float>(q, k, v, o, B, S, T_len, HQ, HKV,
                                            D, kind, window, st));
  if (dtype == 1)
    return static_cast<int>(launch_d<__nv_bfloat16>(
        q, k, v, o, B, S, T_len, HQ, HKV, D, kind, window, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
