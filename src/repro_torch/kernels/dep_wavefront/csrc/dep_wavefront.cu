// B2: segmented dependency-miss counts, in two forms.
//
// Replaces the Pallas TPU kernel `dep_wavefront_kernel`
// (src/repro/kernels/dep_wavefront/kernel.py). Plain PyTorch versions in
// ../ref.py; wrappers in ../ops.py.
//
// 1. `dep_wavefront_kernel`, the kernel's own contract: over edges
//    grouped by dst (a dependent unit), a segmented inclusive prefix scan
//    gives each edge
//      miss  edges so far in its segment whose source has not committed,
//      pos   edges so far in its segment.
//    A segment opens at entry 0, wherever dst changes, and at every
//    padding entry (dst == KEY_SENTINEL), which gets miss = pos = 0. Any
//    E; the wrappers `dep_wavefront_ready` and the fragment variant
//    sort, broadcast segment totals and scatter to units around it.
//
// 2. `dep_wavefront_rows_kernel`, the batch engine's stage 4 (the
//    wavefront check of src/repro_torch/core/engine.py) in one launch:
//    from the slots' units row_unit [T], their predecessor rows preds
//    [T, P] (-1 = none) and the committed flags `done`, dep_ok [T] = no
//    edge of row t misses, where the edges are the T*P entries in row
//    order with dst = row_unit[t] (KEY_SENTINEL for -1) and src_ok =
//    done[pred] — the same scan as form 1, so a segment still joins
//    consecutive rows of one unit. It takes the place of the eager
//    `where`, the `done[preds]` gather, the scan, the per-row `amax` and
//    the compare, and stores no `pos`.
//
// Design, both forms: one block (the scan is a chain; CUDA blocks run in
// no order). A thread owns consecutive edges (kItems of them in form 1,
// one row's P in form 2) and scans them serially in registers; then one
// warp-shuffle scan of the per-thread aggregates and one pass over the
// warp totals in shared memory: two __syncthreads a tile. In form 1 a
// thread's four edges load and store as one vector access an array (a
// strided store an edge cost as much time as all the rest, by
// measurement). A scan element's counts travel packed in one 32-bit
// word with the segment flag in its top bit, so a shuffle step moves
// one word. The dst before
// a thread's first edge comes from the neighbouring lane by shuffle, or
// across a warp boundary through shared memory after the first barrier
// (`tile_scan`); no edge is read twice. A tile holds up to 4,096 edges in
// form 1 and 1,024 rows in form 2 (every main-path shape, E = 40 to
// 2,048, is one tile); above that a loop over tiles carries the open
// segment in shared memory, double-buffered so no barrier closes a tile.
// Form 2 needs no per-edge output: a row's verdict is "no live edge of
// the row misses, and, where its first edge continues the segment of the
// row before, that segment has no miss so far".
//
// Bound. Form 1 moves 13 bytes an edge (27 KB at E = 2,048, 8 ns at
// 3.35 TB/s); form 2 reads 4 bytes an edge and 1 a gathered flag and
// writes 1 byte a row. Both are latency-bound: the launch, the barriers
// and the dependent shuffle steps set the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kItems = 4;  // consecutive edges a thread owns in form 1
constexpr int kRowChunk = 8;  // a row's preds loaded together in form 2
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kKeySentinel = 0x7fffffff;

// ---------------------------------------------------------------- the scan
// A scan element packs its counts in the low bits of V and the segment
// flag ("a segment opens at or before this element") in the top bit.
// combine(acc, left), `left` preceding `acc`: the counts add unless acc
// opened a segment, and the flags OR. No field overflows within a tile.
template <typename V>
__device__ __forceinline__ V flag_bit() {
  return V(1) << (sizeof(V) * 8 - 1);
}

template <typename V>
__device__ __forceinline__ V combine(V acc, V left) {
  return (acc & flag_bit<V>()) ? acc : acc + left;
}

template <typename V>
struct TileScan {
  V tot[2][kMaxWarps];  // warp totals (lane 0's key test left out)
  V pre[2][kMaxWarps];  // exclusive prefix of each warp within the tile
  int first_key[2][kMaxWarps];
  int last_key[2][kMaxWarps];
  uint8_t first_forced[2][kMaxWarps];
  uint8_t f0[2][kMaxWarps];  // the warp's first element opens a segment
  int carry_key[2];          // last dst of the tile before
  int carry[2][2];           // counts of its open segment
};

// The block-wide part of one tile's segmented scan (as in lock_grant.cu).
// Each thread passes `agg`, the serial scan of its own elements in which
// the first element's flag holds only its forced part; the first
// element's key test against the element before it is resolved here (by
// shuffle within a warp, through shared memory across a warp boundary,
// against `carry_key` at the tile's start). Returns the thread's
// exclusive prefix within the tile (its flag: a segment opens in the tile
// before the thread's first element) and sets `f0`, whether the first
// element opens a segment. Two __syncthreads; `par` alternates between
// tiles.
template <typename V>
__device__ __forceinline__ V tile_scan(TileScan<V>& sm, int par, V agg,
                                       int first_key, bool first_forced,
                                       int last_key, bool& f0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const V kFlag = flag_bit<V>();
  const int prev_key = __shfl_up_sync(kFullMask, last_key, 1);
  const bool own_f0 = first_forced || (lane > 0 && first_key != prev_key);
  if (own_f0) agg |= kFlag;
  V inc = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const V o = __shfl_up_sync(kFullMask, inc, d);
    if (lane >= d) inc = combine(inc, o);
  }
  const V ex = __shfl_up_sync(kFullMask, inc, 1);
  if (lane == 31) {
    sm.tot[par][warp] = inc;
    sm.last_key[par][warp] = last_key;
  }
  if (lane == 0) {
    sm.first_key[par][warp] = first_key;
    sm.first_forced[par][warp] = first_forced;
  }
  __syncthreads();
  if (warp == 0) {
    V t = 0;
    bool fw = true;
    if (lane < nwarps) {
      const int pk =
          lane == 0 ? sm.carry_key[par] : sm.last_key[par][lane - 1];
      fw = sm.first_forced[par][lane] || sm.first_key[par][lane] != pk;
      t = sm.tot[par][lane] | (fw ? kFlag : V(0));
    }
    V wi = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const V o = __shfl_up_sync(kFullMask, wi, d);
      if (lane >= d) wi = combine(wi, o);
    }
    const V wex = __shfl_up_sync(kFullMask, wi, 1);
    if (lane < nwarps) {
      sm.pre[par][lane] = lane == 0 ? V(0) : wex;
      sm.f0[par][lane] = fw;
    }
  }
  __syncthreads();
  const bool fw = sm.f0[par][warp];
  const V pw = sm.pre[par][warp];
  if (lane == 0) {
    f0 = fw;
    return pw;
  }
  f0 = own_f0;
  return combine(ex | (fw ? kFlag : V(0)), pw);
}

using V32 = unsigned int;
constexpr V32 kFlag32 = 0x80000000u;

// ------------------------------------------------ 1. the grouped edges
constexpr int kBits = 15;  // one count field: miss, then pos
constexpr V32 kField = (V32(1) << kBits) - 1;

__global__ void __launch_bounds__(kMaxThreads, 1)
dep_wavefront_kernel(const int* __restrict__ dst,
                     const uint8_t* __restrict__ src_ok,
                     int* __restrict__ miss, int* __restrict__ pos, int n) {
  __shared__ TileScan<V32> sm;
  const int tid = threadIdx.x;
  const int tile = blockDim.x * kItems;
  if (tid == 0) {
    sm.carry_key[0] = kKeySentinel;
    sm.carry[0][0] = sm.carry[0][1] = 0;
  }
  int par = 0;
  for (int base = 0; base < n; base += tile, par ^= 1) {
    const int i0 = base + tid * kItems;
    int d[kItems];
    V32 v[kItems];
    bool flag[kItems];
    if (i0 + kItems <= n &&
        (reinterpret_cast<uintptr_t>(dst + i0) & 15) == 0) {
      const int4 q = *reinterpret_cast<const int4*>(dst + i0);
      d[0] = q.x;
      d[1] = q.y;
      d[2] = q.z;
      d[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        d[j] = i0 + j < n ? dst[i0 + j] : kKeySentinel;
    }
    uint8_t ok[kItems];
    if (i0 + kItems <= n &&
        (reinterpret_cast<uintptr_t>(src_ok + i0) & 3) == 0) {
      const uchar4 q = *reinterpret_cast<const uchar4*>(src_ok + i0);
      ok[0] = q.x;
      ok[1] = q.y;
      ok[2] = q.z;
      ok[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) ok[j] = i0 + j < n ? src_ok[i0 + j] : 1;
    }
    V32 agg = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = i0 + j;
      const bool active = d[j] != kKeySentinel;  // past n: padding
      const bool missing = active && ok[j] == 0;
      v[j] = V32(missing) | (V32(active) << kBits);
      const bool forced = i == 0 || !active;
      flag[j] = forced || (j > 0 && d[j] != d[j - 1]);
      agg = flag[j] ? (v[j] | kFlag32) : agg + v[j];
    }
    bool f0;
    V32 run = tile_scan(sm, par, agg, d[0], flag[0], d[kItems - 1], f0);
    flag[0] = f0;

    const int* c = sm.carry[par];
    int m[kItems], p[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      run = flag[j] ? (v[j] | kFlag32) : run + v[j];
      const bool open = !(run & kFlag32);
      m[j] = int(run & kField) + (open ? c[0] : 0);
      p[j] = int((run >> kBits) & kField) + (open ? c[1] : 0);
      if (j == kItems - 1 && tid == blockDim.x - 1) {
        sm.carry[par ^ 1][0] = m[j];
        sm.carry[par ^ 1][1] = p[j];
        sm.carry_key[par ^ 1] = d[j];
      }
    }
    // a thread's edges are consecutive: one vector store an output
    if (i0 + kItems <= n &&
        ((reinterpret_cast<uintptr_t>(miss + i0) |
          reinterpret_cast<uintptr_t>(pos + i0)) & 15) == 0) {
      *reinterpret_cast<int4*>(miss + i0) = make_int4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<int4*>(pos + i0) = make_int4(p[0], p[1], p[2], p[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (i0 + j < n) {
          miss[i0 + j] = m[j];
          pos[i0 + j] = p[j];
        }
      }
    }
  }
}

// ------------------------------------------------ 2. the engine's rows
__global__ void __launch_bounds__(kMaxThreads, 1)
dep_wavefront_rows_kernel(const int* __restrict__ row_unit,
                          const int* __restrict__ preds,
                          const uint8_t* __restrict__ done,
                          uint8_t* __restrict__ dep_ok, int T, int P,
                          int n_done) {
  __shared__ TileScan<V32> sm;
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm.carry_key[0] = kKeySentinel;
    sm.carry[0][0] = 0;
  }
  int par = 0;
  for (int base = 0; base < T; base += blockDim.x, par ^= 1) {
    const int t = base + tid;
    const bool valid = t < T;
    const int unit = valid ? row_unit[t] : kKeySentinel;
    const int* row = preds + static_cast<long long>(t) * P;
    // the row's edges in order: dst = unit where pred >= 0, else padding;
    // kRowChunk preds are loaded together, then their flags
    V32 agg = 0;  // misses since the row's last segment start
    bool any_miss = false, first_live = false, prev_live = false;
    for (int j0 = 0; j0 < P; j0 += kRowChunk) {
      int pr[kRowChunk];
      bool missing[kRowChunk];
#pragma unroll
      for (int q = 0; q < kRowChunk; ++q)
        pr[q] = valid && j0 + q < P ? row[j0 + q] : -1;
#pragma unroll
      for (int q = 0; q < kRowChunk; ++q) {
        missing[q] = false;
        if (pr[q] >= 0 && unit != kKeySentinel)
          missing[q] = done[pr[q] < n_done ? pr[q] : n_done - 1] == 0;
      }
#pragma unroll
      for (int q = 0; q < kRowChunk; ++q) {
        const int j = j0 + q;
        if (j >= P) break;
        const bool live = pr[q] >= 0 && unit != kKeySentinel;
        // within a row every live edge has the row's dst: a live edge
        // opens a segment only after a padding entry; the first edge's
        // test against the row before waits for tile_scan
        const bool start =
            j == 0 ? (t == 0 || !live) : (!live || !prev_live);
        agg = start ? (V32(missing[q]) | kFlag32) : agg + V32(missing[q]);
        any_miss |= missing[q];
        if (j == 0) first_live = live;
        prev_live = live;
      }
    }
    const int first_key = first_live ? unit : kKeySentinel;
    const int last_key = prev_live ? unit : kKeySentinel;
    const bool first_forced = t == 0 || !first_live;
    bool f0;
    const V32 e = tile_scan(sm, par, agg, first_key, first_forced, last_key,
                            f0);
    // misses of the segment that the row's first edge continues
    const int carried =
        int(e & ~kFlag32) + ((e & kFlag32) ? 0 : sm.carry[par][0]);
    if (valid) dep_ok[t] = (!any_miss && (f0 || carried == 0)) ? 1 : 0;
    if (tid == blockDim.x - 1) {
      // the open segment at the tile's end, for the next tile
      const V32 whole = combine(f0 ? (agg | kFlag32) : agg, e);
      sm.carry[par ^ 1][0] = int(whole & ~kFlag32) +
                             ((whole & kFlag32) ? 0 : sm.carry[par][0]);
      sm.carry_key[par ^ 1] = last_key;
    }
  }
}

__global__ void empty_kernel() {}

int block_threads(int work, int per_thread) {
  int t = (work + per_thread - 1) / per_thread;
  t = (t + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

}  // namespace

// Plain C entry points (loaded with ctypes). All pointers are device
// pointers; `stream` is a cudaStream_t. Each returns cudaGetLastError()
// and launches nothing for an empty input.

// Form 1, any n >= 0.
extern "C" int dep_wavefront_launch(const void* dst, const void* src_ok,
                                    void* miss, void* pos, int n,
                                    void* stream) {
  if (n > 0) {
    dep_wavefront_kernel<<<1, block_threads(n, kItems), 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(dst), static_cast<const uint8_t*>(src_ok),
        static_cast<int*>(miss), static_cast<int*>(pos), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Form 2: row_unit [T], preds [T, P] (int32, P >= 1), done [n_done]
// (bool, n_done >= 1; a pred past it reads its last flag), dep_ok [T].
extern "C" int dep_wavefront_rows_launch(const void* row_unit,
                                         const void* preds, const void* done,
                                         void* dep_ok, int T, int P,
                                         int n_done, void* stream) {
  if (T > 0) {
    if (P < 1 || n_done < 1) return static_cast<int>(cudaErrorInvalidValue);
    dep_wavefront_rows_kernel<<<1, block_threads(T, 1), 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(row_unit), static_cast<const int*>(preds),
        static_cast<const uint8_t*>(done), static_cast<uint8_t*>(dep_ok), T,
        P, n_done);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty one-block launch of `threads` threads: the launch floor,
// timed beside the kernels.
extern "C" int dep_wavefront_empty_launch(int threads, void* stream) {
  empty_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
