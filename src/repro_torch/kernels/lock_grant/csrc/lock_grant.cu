// B1: the ORTHRUS lock grant, in two forms.
//
// Replaces the Pallas TPU kernel `lock_grant_kernel`
// (src/repro/kernels/lock_grant/kernel.py). Plain PyTorch versions in
// ../ref.py; wrappers in ../ops.py.
//
// 1. `lock_grant_kernel`, the kernel's own contract: over entries sorted
//    by (record, enqueue stamp), a segmented inclusive prefix scan over
//    each record's run gives
//      req_pos  1-based position among the read/write requests,
//      wbefore  write requests before it,
//      op_pos   1-based position among all active entries (contenders),
//    and the grant: a read is granted when the record is write-free and
//    no write precedes it in its run; a write when the record is
//    write-free, has no read holders and the write is the first request.
//    A segment opens at entry 0, at a new key and at every inactive
//    (REQ_NONE) entry. Any N; the engine calls it only above the fused
//    form's capacity.
//
//    Design. One block (the scan is a chain; CUDA blocks run in no
//    order). Each thread owns kItems consecutive entries and scans them
//    serially in registers; then one warp-shuffle scan of the per-thread
//    aggregates and one pass over the warp totals in shared memory: two
//    __syncthreads a tile. A thread's four entries' inputs and outputs
//    move as one vector load or store each (a strided store an entry
//    cost as much time as all the rest, by measurement). The counts of
//    one scan element travel packed in one 64-bit word (three 21-bit
//    fields and the segment flag in the top bit), so a shuffle step
//    moves one word and the combine is one select and one add. Each key
//    is loaded once: the key before a
//    thread's first entry comes from the neighbouring lane by shuffle,
//    and across a warp boundary through shared memory after the first
//    barrier (`tile_scan`). A tile holds blockDim * kItems <= 4,096
//    entries; above that a loop over tiles carries the open segment in
//    shared memory, double-buffered so no barrier closes a tile.
//
// 2. `lock_grant_step_kernel`, the engine's whole grant decision of one
//    ORTHRUS round (src/repro_torch/core/engine.py, stage 7) in one
//    launch, for T*K <= kStepCap entries: from the round's [T, K] keys,
//    modes, pending mask and enqueue stamps and the lock table, the grant
//    of every entry in entry order, the re-entrant grant (the record's
//    write holder is the entry's slot) included. It takes the place of
//    about 40 eager kernels: the entry kinds and keys, the lock-table
//    gathers, the packed sort, four gathers into sorted order, the
//    segmented grant, the unsort and the self-grant.
//
//    Design. The grant of an entry depends only on the entries of its own
//    record and their (stamp, index) order, and only through two minima:
//    a read is granted iff the record is write-free and no write of the
//    record precedes it (it is below the record's least write), a write
//    iff the record is write-free with no readers and it is the record's
//    least request. Only pending entries of records in the table
//    (key < R) can be granted, and every entry of such a record is
//    active (inactive entries carry KEY_SENTINEL, which is >= R), so no
//    inactive entry splits its run; release entries count in neither
//    minimum. So one block finds, per record, the least request and the
//    least write by (stamp, index) in an open-addressed hash table in
//    shared memory (native 32-bit atomicMin: the stamp, then the index
//    among the entries at the least stamp) and decides every entry from
//    them. That equals the sort-and-scan of the plain version entry for
//    entry; a one-block sort of 4,096 packed 96-bit entries would cost
//    78 bitonic stages on one SM, most of the launch. Entries that cannot
//    be granted take no part beyond their loads.
//
// Bound. Both are latency-bound: the sorted form moves 26 bytes an entry
// (67 KB at N = 2,560, 20 ns at 3.35 TB/s), the fused form about 15
// bytes an entry plus 8 per gathered table entry. The time is the
// launch, the barriers and the dependent shuffle steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kItems = 4;  // consecutive entries a thread owns
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kReqRead = 0;
constexpr int kReqWrite = 1;
constexpr int kReqNone = 3;
constexpr int kModeWrite = 1;
constexpr int kKeySentinel = 0x7fffffff;
constexpr int kI32Max = 0x7fffffff;
constexpr int kStepCap = 4096;         // entries of the fused form
constexpr int kStepSlots = 2 * kStepCap;  // its largest hash table
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------- the scan
// A scan element packs its counts in the low bits of V and the segment
// flag ("a segment opens at or before this element") in the top bit.
// combine(acc, left), `left` preceding `acc`: the counts add unless acc
// opened a segment, and the flags OR. No field overflows: a tile holds
// at most 4,096 elements.
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
  int carry_key[2];          // last key of the tile before
  int carry[2][3];           // counts of its open segment
};

// The block-wide part of one tile's segmented scan. Each thread passes
// `agg`, the serial scan of its own elements in which the first element's
// flag holds only its forced part (`first_forced`: entry 0, an inactive
// or an invalid entry). The first element's key test against the element
// before it is resolved here: by shuffle within a warp, through shared
// memory across a warp boundary (the total's counts do not depend on it,
// only its flag does), against `carry_key` at the tile's start. Returns
// the thread's exclusive prefix within the tile (its flag: a segment
// opens in the tile before the thread's first element) and sets `f0`,
// whether the first element opens a segment. Two __syncthreads; `par`
// alternates between tiles, so nothing is overwritten while read.
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

// Up to four consecutive int32 values from p[i..], one 16-byte load
// where aligned and whole; entries at or past n read as `fill`.
__device__ __forceinline__ void load4(const int* __restrict__ p, int i, int n,
                                      int fill, int (&out)[kItems]) {
  if (i + kItems <= n && (reinterpret_cast<uintptr_t>(p + i) & 15) == 0) {
    const int4 v = *reinterpret_cast<const int4*>(p + i);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) out[j] = i + j < n ? p[i + j] : fill;
  }
}

// Four consecutive bytes of p[i..] as one 4-byte load where aligned and
// whole; bytes at or past n read as 0.
__device__ __forceinline__ void load4(const uint8_t* __restrict__ p, int i,
                                      int n, uint8_t (&out)[kItems]) {
  if (i + kItems <= n && (reinterpret_cast<uintptr_t>(p + i) & 3) == 0) {
    const uchar4 v = *reinterpret_cast<const uchar4*>(p + i);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) out[j] = i + j < n ? p[i + j] : 0;
  }
}

// Stores of four consecutive values to p[i..], one vector store where
// aligned and whole (a thread's entries are consecutive, so a warp's
// stores are too); nothing at or past n.
__device__ __forceinline__ void store4(int* __restrict__ p, int i, int n,
                                       const int (&v)[kItems]) {
  if (i + kItems <= n && (reinterpret_cast<uintptr_t>(p + i) & 15) == 0) {
    *reinterpret_cast<int4*>(p + i) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (i + j < n) p[i + j] = v[j];
  }
}

__device__ __forceinline__ void store4(uint8_t* __restrict__ p, int i, int n,
                                       const uint8_t (&v)[kItems]) {
  if (i + kItems <= n && (reinterpret_cast<uintptr_t>(p + i) & 3) == 0) {
    *reinterpret_cast<uchar4*>(p + i) = make_uchar4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (i + j < n) p[i + j] = v[j];
  }
}

// ------------------------------------------------ 1. the sorted form
using V64 = unsigned long long;
constexpr int kBits = 21;  // one count field of the packed scan element
constexpr V64 kField = (V64(1) << kBits) - 1;

__device__ __forceinline__ V64 pack_entry(int k) {
  const bool active = k != kReqNone;
  const bool is_w = k == kReqWrite;
  const bool is_req = is_w || k == kReqRead;
  return V64(is_req) | (V64(is_w) << kBits) | (V64(active) << (2 * kBits));
}

__global__ void __launch_bounds__(kMaxThreads, 1)
lock_grant_kernel(const int* __restrict__ keys, const int* __restrict__ kind,
                  const uint8_t* __restrict__ wh_free,
                  const int* __restrict__ rc, uint8_t* __restrict__ grant,
                  int* __restrict__ req_pos, int* __restrict__ wbefore,
                  int* __restrict__ op_pos, int n) {
  __shared__ TileScan<V64> sm;
  const int tid = threadIdx.x;
  const int tile = blockDim.x * kItems;
  const V64 kFlag = flag_bit<V64>();
  if (tid == 0) {
    sm.carry_key[0] = 0;
    sm.carry[0][0] = sm.carry[0][1] = sm.carry[0][2] = 0;
  }
  int par = 0;
  for (int base = 0; base < n; base += tile, par ^= 1) {
    const int i0 = base + tid * kItems;
    int key[kItems], k[kItems], rcv[kItems];
    uint8_t free[kItems];
    load4(keys, i0, n, 0, key);
    load4(kind, i0, n, kReqNone, k);
    load4(rc, i0, n, 0, rcv);
    load4(wh_free, i0, n, free);

    // serial scan of the thread's entries; the first one's key test waits
    V64 agg = 0;
    bool flag[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = i0 + j;
      const bool forced = i == 0 || i >= n || k[j] == kReqNone;
      flag[j] = forced || (j > 0 && key[j] != key[j - 1]);
      const V64 v = pack_entry(k[j]);
      agg = flag[j] ? (v | kFlag) : agg + v;
    }
    bool f0;
    V64 run = tile_scan(sm, par, agg, key[0], flag[0], key[kItems - 1], f0);
    flag[0] = f0;

    const int* c = sm.carry[par];
    uint8_t g[kItems];
    int req[kItems], wb[kItems], op[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const V64 v = pack_entry(k[j]);
      run = flag[j] ? (v | kFlag) : run + v;
      const bool open = !(run & kFlag);  // the tile before's segment goes on
      req[j] = int(run & kField) + (open ? c[0] : 0);
      const int wr = int((run >> kBits) & kField) + (open ? c[1] : 0);
      op[j] = int((run >> (2 * kBits)) & kField) + (open ? c[2] : 0);
      const bool is_w = k[j] == kReqWrite;
      wb[j] = wr - (is_w ? 1 : 0);
      g[j] = ((k[j] == kReqRead && free[j] && wb[j] == 0) ||
              (is_w && free[j] && rcv[j] == 0 && req[j] == 1))
                 ? 1
                 : 0;
      if (j == kItems - 1 && tid == blockDim.x - 1) {
        // the open segment at the tile's end, for the next tile
        sm.carry[par ^ 1][0] = req[j];
        sm.carry[par ^ 1][1] = wr;
        sm.carry[par ^ 1][2] = op[j];
        sm.carry_key[par ^ 1] = key[j];
      }
    }
    store4(grant, i0, n, g);
    store4(req_pos, i0, n, req);
    store4(wbefore, i0, n, wb);
    store4(op_pos, i0, n, op);
  }
}

// ------------------------------------------------ 2. the fused form
__device__ __forceinline__ unsigned hash_slot(int key, int shift) {
  return (static_cast<unsigned>(key) * 2654435769u) >> shift;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
lock_grant_step_kernel(const int* __restrict__ keys,
                       const int* __restrict__ modes,
                       const uint8_t* __restrict__ pend,
                       const int* __restrict__ enq,
                       const int* __restrict__ wh, const int* __restrict__ rc,
                       uint8_t* __restrict__ grant, int n, int K, int R,
                       int slots) {
  // per hash slot: the record, and the least (stamp, index) of its
  // requests and of its writes
  extern __shared__ int table[];
  int* slot_key = table;
  int* req_enq = table + slots;
  int* req_idx = table + 2 * slots;
  int* wr_enq = table + 3 * slots;
  int* wr_idx = table + 4 * slots;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int shift = __clz(slots) + 1;  // slots = 2^(32 - shift)

  for (int h = tid; h < slots; h += nt) slot_key[h] = kKeySentinel;

  // entry tid + r * nt: can it be granted (pending, in the table)? The
  // dense loads go out together, then the table's gathers: two latencies
  bool cand[kItems], is_w[kItems], rc_zero[kItems];
  int key[kItems], stamp[kItems], holder[kItems], slot[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = tid + r * nt;
    const bool valid = i < n;
    key[r] = valid ? keys[i] : kKeySentinel;
    stamp[r] = valid ? enq[i] : 0;
    is_w[r] = valid && modes[i] == kModeWrite;
    // keys past the table read as write-held: never granted
    cand[r] = valid && pend[i] != 0 && key[r] < R;
    holder[r] = slot[r] = 0;
    rc_zero[r] = false;
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (cand[r]) {
      const int safe = key[r] > 0 ? key[r] : 0;
      holder[r] = wh[safe];
      rc_zero[r] = rc[safe] == 0;
    }
  }
  __syncthreads();  // the table is empty

  // claim a slot per record (the claimant resets its minima)
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (!cand[r]) continue;
    unsigned h = hash_slot(key[r], shift);
    while (true) {
      const int old = atomicCAS(&slot_key[h], kKeySentinel, key[r]);
      if (old == kKeySentinel) {
        req_enq[h] = req_idx[h] = wr_enq[h] = wr_idx[h] = kI32Max;
        break;
      }
      if (old == key[r]) break;
      h = (h + 1) & (slots - 1);
    }
    slot[r] = h;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (!cand[r]) continue;
    atomicMin(&req_enq[slot[r]], stamp[r]);
    if (is_w[r]) atomicMin(&wr_enq[slot[r]], stamp[r]);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (!cand[r]) continue;
    const int i = tid + r * nt;
    if (req_enq[slot[r]] == stamp[r]) atomicMin(&req_idx[slot[r]], i);
    if (is_w[r] && wr_enq[slot[r]] == stamp[r])
      atomicMin(&wr_idx[slot[r]], i);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = tid + r * nt;
    if (i >= n) continue;
    bool g = false;
    if (cand[r]) {
      const int h = slot[r];
      const bool free = holder[r] == -1;
      bool fifo;
      if (is_w[r]) {
        fifo = free && rc_zero[r] && req_enq[h] == stamp[r] &&
               req_idx[h] == i;
      } else {
        const int we = wr_enq[h];
        fifo = free && (stamp[r] < we || (stamp[r] == we && i < wr_idx[h]));
      }
      g = fifo || holder[r] == i / K;  // re-entrant: the slot holds it
    }
    grant[i] = g ? 1 : 0;
  }
}

__global__ void empty_kernel() {}

// the thread count of a one-block launch over `work` units, kItems a thread
int block_threads(int work, int per_thread) {
  int t = (work + per_thread - 1) / per_thread;
  t = (t + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

}  // namespace

// Plain C entry points (loaded with ctypes). All pointers are device
// pointers; `stream` is a cudaStream_t. Each returns cudaGetLastError()
// (or another CUDA error code) and launches nothing for n == 0.

// The sorted form, any n >= 0.
extern "C" int lock_grant_launch(const void* keys, const void* kind,
                                 const void* wh_free, const void* rc,
                                 void* grant, void* req_pos, void* wbefore,
                                 void* op_pos, int n, void* stream) {
  if (n > 0) {
    lock_grant_kernel<<<1, block_threads(n, kItems), 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(keys), static_cast<const int*>(kind),
        static_cast<const uint8_t*>(wh_free), static_cast<const int*>(rc),
        static_cast<uint8_t*>(grant), static_cast<int*>(req_pos),
        static_cast<int*>(wbefore), static_cast<int*>(op_pos), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fused form: n = T * K entries of [T, K] keys, modes, pend (bool)
// and enq, the lock table wh and rc (at least R entries), grant (bool,
// n). 0 < n <= lock_grant_step_capacity(), K >= 1, R >= 1.
extern "C" int lock_grant_step_capacity() { return kStepCap; }

extern "C" int lock_grant_step_launch(const void* keys, const void* modes,
                                      const void* pend, const void* enq,
                                      const void* wh, const void* rc,
                                      void* grant, int n, int K, int R,
                                      void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (n > kStepCap || K < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int slots = 64;  // a power of two, at least twice the entries
  while (slots < 2 * n) slots *= 2;
  const int smem = 5 * slots * static_cast<int>(sizeof(int));
  // the dynamic shared-memory limit, once per device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(lock_grant_step_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               5 * kStepSlots * static_cast<int>(sizeof(int)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  lock_grant_step_kernel<<<1, block_threads(n, kItems), smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const int*>(modes),
      static_cast<const uint8_t*>(pend), static_cast<const int*>(enq),
      static_cast<const int*>(wh), static_cast<const int*>(rc),
      static_cast<uint8_t*>(grant), n, K, R, slots);
  return static_cast<int>(cudaGetLastError());
}

// An empty one-block launch of `threads` threads: the launch floor,
// timed beside the kernels.
extern "C" int lock_grant_empty_launch(int threads, void* stream) {
  empty_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
