// B1's earlier design (PRs 11-17), kept built only to be timed beside
// the kernel of lock_grant.cu; no path of the port launches it.
//
// Segmented FIFO lock grant over entries sorted by (record, enqueue stamp),
// in the place of the Pallas TPU kernel `lock_grant_kernel`
// (src/repro/kernels/lock_grant/kernel.py). For each entry, a segmented
// inclusive prefix scan over its record's run gives
//   req_pos  1-based position among the read/write requests,
//   wbefore  write requests before it,
//   op_pos   1-based position among all active entries (contenders),
// and the grant decision: a read is granted when the record is write-free
// and no write precedes it in its run; a write when the record is
// write-free, has no read holders and the write is the first request.
// The plain PyTorch version is `lock_grant_ref` in ../ref.py; the
// wrapper (../ops.py) sorts, gathers the lock table and unsorts.
//
// Design. The TPU kernel walks its grid in order and carries the open
// segment from block to block in SMEM. CUDA blocks run in no order, so
// here ONE thread block of 1024 threads walks the tiles of 1024 entries
// itself: per tile a block-wide segmented scan of (flag, req, wr, op) —
// warp __shfl_up_sync, then a scan of the 32 warp totals in shared
// memory — and the carry (last key, three running counts) is handed to
// the next tile in shared memory. Adding the carry to exactly the
// entries with no segment start before them in the tile reproduces the
// TPU kernel's `base = max(base, 0)`.
//
// Bound. The kernel reads 13 bytes per entry (key, kind, rc: 4 each,
// wh_free: 1) and writes 13 (grant: 1, three counters: 4 each): about
// 26 bytes per entry, 67 KB at the main path's N = 2,560 (T*K entries of
// a full-width ORTHRUS round), which is about 20 ns at the H100's
// 3.35 TB/s. Its time is therefore set by launch latency and by the
// serial tile loop, not by memory. The one-block design spends exactly
// one launch and no second pass or grid-wide synchronisation; at
// N = 2,560 the loop runs three tiles, the last one half full. A multi-block
// decoupled look-back only pays off at N far above the main path's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kReqRead = 0;
constexpr int kReqWrite = 1;
constexpr int kReqNone = 3;

// One scan element: `flag` = a segment starts at or before this element
// (within the scanned range); the counts are inclusive within the segment.
struct Scan {
  int flag;
  int req;
  int wr;
  int op;
};

// acc <- left (+) acc, where `left` precedes `acc` in the order.
__device__ __forceinline__ void combine(Scan& acc, const Scan& left) {
  if (!acc.flag) {
    acc.req += left.req;
    acc.wr += left.wr;
    acc.op += left.op;
  }
  acc.flag |= left.flag;
}

__device__ __forceinline__ Scan warp_scan(Scan v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Scan o;
    o.flag = __shfl_up_sync(kFullMask, v.flag, d);
    o.req = __shfl_up_sync(kFullMask, v.req, d);
    o.wr = __shfl_up_sync(kFullMask, v.wr, d);
    o.op = __shfl_up_sync(kFullMask, v.op, d);
    if (lane >= d) combine(v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
lock_grant_tile_kernel(const int* __restrict__ keys,
                       const int* __restrict__ kind,
                       const uint8_t* __restrict__ wh_free,
                       const int* __restrict__ rc, uint8_t* __restrict__ grant,
                       int* __restrict__ req_pos, int* __restrict__ wbefore,
                       int* __restrict__ op_pos, int n) {
  __shared__ Scan warp_tot[kWarps];
  __shared__ Scan carry;  // counts of the open segment after the last tile
  __shared__ int carry_key;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    carry = Scan{0, 0, 0, 0};
    carry_key = 0;
  }
  __syncthreads();

  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const bool valid = i < n;
    const int key = valid ? keys[i] : 0;
    const int k = valid ? kind[i] : kReqNone;
    const bool active = k != kReqNone;
    const bool is_w = active && k == kReqWrite;
    const bool is_r = active && k == kReqRead;
    const int prev = tid == 0 ? carry_key : (valid ? keys[i - 1] : 0);
    // entry 0, an inactive entry and a new key each open a segment;
    // entries past n are isolated and never stored
    const bool start = i == 0 || !active || key != prev;

    Scan v{start ? 1 : 0, (is_r || is_w) ? 1 : 0, is_w ? 1 : 0,
           active ? 1 : 0};
    v = warp_scan(v, lane);
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) warp_tot[lane] = warp_scan(warp_tot[lane], lane);
    __syncthreads();
    if (warp > 0) combine(v, warp_tot[warp - 1]);
    combine(v, carry);

    if (valid) {
      const int wb = v.wr - (is_w ? 1 : 0);
      const bool free = wh_free[i] != 0;
      const bool g = (is_r && free && wb == 0) ||
                     (is_w && free && rc[i] == 0 && v.req == 1);
      grant[i] = g ? 1 : 0;
      req_pos[i] = v.req;
      wbefore[i] = wb;
      op_pos[i] = v.op;
    }
    __syncthreads();  // every thread has read `carry` and `warp_tot`
    if (tid == kThreads - 1) {
      carry = Scan{0, v.req, v.wr, v.op};
      carry_key = key;
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). All pointers are device
// pointers; `stream` is a cudaStream_t. Returns cudaGetLastError().
extern "C" int lock_grant_tile_launch(const void* keys, const void* kind,
                                      const void* wh_free, const void* rc,
                                      void* grant, void* req_pos,
                                      void* wbefore, void* op_pos, int n,
                                      void* stream) {
  if (n > 0) {
    lock_grant_tile_kernel<<<1, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(keys), static_cast<const int*>(kind),
        static_cast<const uint8_t*>(wh_free), static_cast<const int*>(rc),
        static_cast<uint8_t*>(grant), static_cast<int*>(req_pos),
        static_cast<int*>(wbefore), static_cast<int*>(op_pos), n);
  }
  return static_cast<int>(cudaGetLastError());
}
