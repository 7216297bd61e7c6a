// B2's earlier design (PRs 12-17), kept built only to be timed beside
// the kernels of dep_wavefront.cu; no path of the port launches it.
//
// Segmented dependency-miss counts over edges grouped by dependent unit,
// in the place of the Pallas TPU kernel `dep_wavefront_kernel`
// (src/repro/kernels/dep_wavefront/kernel.py). For each edge, a
// segmented inclusive prefix scan over its dst segment gives
//   miss  edges so far in the segment whose source has not committed,
//   pos   edges so far in the segment.
// A segment opens at entry 0, wherever dst changes, and at every padding
// entry (dst == KEY_SENTINEL), which gets miss = pos = 0. The plain
// PyTorch version is `dep_wavefront_ref` in ../ref.py; the wrappers
// (../ops.py) sort, broadcast segment totals and scatter to units.
//
// Design. The TPU kernel walks its grid in order and carries the open
// segment (last dst, miss, pos) from block to block in SMEM. CUDA blocks
// run in no order, so, as for lock_grant, ONE thread block of 1024
// threads walks the tiles of 1024 edges itself: per tile a block-wide
// segmented scan of (flag, miss, pos) — warp __shfl_up_sync, then a
// scan of the 32 warp totals in shared memory — and the carry (last
// dst, two running counts) goes to the next tile in shared memory.
// Adding the carry to exactly the entries with no segment start before
// them in the tile reproduces the TPU kernel's `base = max(base, 0)`.
// Entries past n are isolated by the `valid` guard and never stored, so
// any n works (the TPU wrapper's padding to the block size served only
// the Pallas grid).
//
// Bound. The kernel reads 5 bytes per edge (dst: 4, src_ok: 1) and
// writes 8 (miss, pos): 13 bytes per edge, 27 KB at the main path's
// largest E = T*P = 2,048 (a full-width quecc round), about 8 ns at the
// H100's 3.35 TB/s. Its time is set by launch latency and the serial
// tile loop (two tiles at E = 2,048), not by memory; one launch, no
// second pass and no grid-wide synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kKeySentinel = 0x7fffffff;

// One scan element: `flag` = a segment starts at or before this element
// (within the scanned range); the counts are inclusive within the segment.
struct Scan {
  int flag;
  int miss;
  int pos;
};

// acc <- left (+) acc, where `left` precedes `acc` in the order.
__device__ __forceinline__ void combine(Scan& acc, const Scan& left) {
  if (!acc.flag) {
    acc.miss += left.miss;
    acc.pos += left.pos;
  }
  acc.flag |= left.flag;
}

__device__ __forceinline__ Scan warp_scan(Scan v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Scan o;
    o.flag = __shfl_up_sync(kFullMask, v.flag, d);
    o.miss = __shfl_up_sync(kFullMask, v.miss, d);
    o.pos = __shfl_up_sync(kFullMask, v.pos, d);
    if (lane >= d) combine(v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
dep_wavefront_tile_kernel(const int* __restrict__ dst,
                          const uint8_t* __restrict__ src_ok,
                          int* __restrict__ miss, int* __restrict__ pos,
                          int n) {
  __shared__ Scan warp_tot[kWarps];
  __shared__ Scan carry;  // counts of the open segment after the last tile
  __shared__ int carry_dst;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    carry = Scan{0, 0, 0};
    carry_dst = kKeySentinel;
  }
  __syncthreads();

  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const bool valid = i < n;
    const int d = valid ? dst[i] : kKeySentinel;
    const bool active = d != kKeySentinel;
    const bool missing = active && src_ok[i] == 0;
    const int prev = tid == 0 ? carry_dst : (valid ? dst[i - 1] : 0);
    // entry 0, a padding entry and a new dst each open a segment
    const bool start = i == 0 || !active || d != prev;

    Scan v{start ? 1 : 0, missing ? 1 : 0, active ? 1 : 0};
    v = warp_scan(v, lane);
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) warp_tot[lane] = warp_scan(warp_tot[lane], lane);
    __syncthreads();
    if (warp > 0) combine(v, warp_tot[warp - 1]);
    combine(v, carry);

    if (valid) {
      miss[i] = v.miss;
      pos[i] = v.pos;
    }
    __syncthreads();  // every thread has read `carry` and `warp_tot`
    if (tid == kThreads - 1) {
      carry = Scan{0, v.miss, v.pos};
      carry_dst = d;
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). All pointers are device
// pointers; `stream` is a cudaStream_t. Returns cudaGetLastError().
extern "C" int dep_wavefront_tile_launch(const void* dst,
                                         const void* src_ok, void* miss,
                                         void* pos, int n, void* stream) {
  if (n > 0) {
    dep_wavefront_tile_kernel<<<1, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(dst), static_cast<const uint8_t*>(src_ok),
        static_cast<int*>(miss), static_cast<int*>(pos), n);
  }
  return static_cast<int>(cudaGetLastError());
}
