// Capacity positions of the planned MoE dispatch, over expert ids sorted
// by (expert, arrival).
//
// Replaces the Pallas TPU kernel `dispatch_positions_kernel`
// (src/repro/kernels/moe_dispatch/kernel.py). For each entry: its 0-based
// position within its run of equal expert ids (-1 for a padding entry,
// any id < 0), the keep-mask `(e >= 0) & (pos < capacity)` and its slot
// in the [experts, capacity] dispatch table (`e * capacity + pos` if
// kept, `drop_slot` if not). Positions count
// runs, not ids, so the result is the TPU kernel's on any input, sorted
// or not. The plain PyTorch version is `dispatch_positions_ref` in
// ../ref.py; the wrapper (../ops.py) routes, sorts and scatters.
//
// Design. The TPU kernel walks its grid in order and carries the open run
// (last id, running count) from block to block in SMEM. CUDA blocks run
// in no order, so here ONE thread block of 1024 threads walks the tiles
// of 1024 entries itself, as lock_grant.cu does. An active entry that
// does not open a run has only active entries of its own id between it
// and its run's start, so its position is its distance to the last run
// start at or before it: per tile, each warp finds that start from a
// ballot of the run-start flags, the 32 warps' last starts are max-scanned
// in shared memory, and the last start of the earlier tiles is the carry.
// The ragged last tile is masked; nothing is padded.
//
// Bound. The function reads 4 bytes per entry (the id) and writes 5 (pos:
// 4, keep: 1): 9 bytes per entry, 54 KB at the main path's largest N =
// 2 * S = 6,000 (a 3,000-token mixtral prefill), about 16 ns at the
// H100's 3.35 TB/s. This kernel writes each slot as well (4 more bytes
// per entry, so the wrapper needs no glue for it). Its time is set by
// launch latency and by the serial tile loop (six tiles there; one at a
// decode step's 16 entries), not by memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kThreads, 1)
moe_dispatch_kernel(const int* __restrict__ experts, int* __restrict__ pos,
                    uint8_t* __restrict__ keep, int* __restrict__ slot,
                    int n, int capacity, int drop_slot) {
  __shared__ int warp_last[kWarps];  // max-scan of each warp's last start
  __shared__ int carry;              // last run start in earlier tiles

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_le = kFullMask >> (31 - lane);  // lanes 0..lane
  if (tid == 0) carry = -1;
  __syncthreads();

  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const bool valid = i < n;
    const int e = valid ? experts[i] : -1;
    const bool active = e >= 0;
    // entry 0, a padding entry and a new id each open a run; entries
    // past n open none and are never stored
    const bool start =
        valid && (i == 0 || !active || e != experts[i - 1]);

    const unsigned below = __ballot_sync(kFullMask, start) & lanes_le;
    // the last run start at or before i within this warp (-1: none)
    int last = below ? base + (warp << 5) + 31 - __clz(static_cast<int>(below))
                     : -1;
    if (lane == 31) warp_last[warp] = last;
    __syncthreads();
    if (warp == 0) {
      int v = warp_last[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFullMask, v, d);
        if (lane >= d) v = max(v, o);
      }
      warp_last[lane] = v;
    }
    __syncthreads();
    // every start of this tile lies past the carry
    if (!below) last = max(carry, warp > 0 ? warp_last[warp - 1] : -1);

    if (valid) {
      const int p = active ? i - last : -1;
      const bool k = active && p < capacity;
      pos[i] = p;
      keep[i] = k ? 1 : 0;
      slot[i] = k ? e * capacity + p : drop_slot;
    }
    __syncthreads();  // every thread has read `carry` and `warp_last`
    if (tid == 0) carry = max(carry, warp_last[kWarps - 1]);
    __syncthreads();
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). All pointers are device
// pointers; `stream` is a cudaStream_t. Returns cudaGetLastError().
extern "C" int moe_dispatch_launch(const void* experts, void* pos, void* keep,
                                   void* slot, int n, int capacity,
                                   int drop_slot, void* stream) {
  if (n > 0) {
    moe_dispatch_kernel<<<1, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(experts), static_cast<int*>(pos),
        static_cast<uint8_t*>(keep), static_cast<int*>(slot), n, capacity,
        drop_slot);
  }
  return static_cast<int>(cudaGetLastError());
}
