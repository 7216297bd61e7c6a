// The planned MoE dispatch (kernel B3): the whole dispatch plan in one
// launch, and the sorted form of the TPU kernel.
//
// Replaces the Pallas TPU kernel `dispatch_positions_kernel`
// (src/repro/kernels/moe_dispatch/kernel.py) and the plan around it
// (`repro.models.moe.plan_dispatch`: top-k, renormalisation, a stable
// sort by expert, the positions, two scatters and the load histogram).
// The plain PyTorch versions are in ../ref.py; the wrappers in ../ops.py.
//
// The fused plan, `moe_dispatch_plan_kernel` (the main path). From the
// router probabilities f32[N, E] it writes the [E * C] table of slot
// tokens (-1 empty) and slot weights (0 empty) and the f32[E] load:
//   - each token's top-k by jax.lax.top_k's rule: larger value first,
//     equal values in ascending expert index (an insertion with a strict
//     `>`, the experts in ascending order); the weights renormalised as
//     w / max(sum in choice order, 1e-9) with IEEE division;
//   - each routed entry's position within its expert: the number of
//     earlier tokens whose top-k holds that expert. A stable sort of the
//     (token, choice) entries by expert leaves each expert's entries in
//     token order (a token's k experts are distinct), so this is the
//     position after JAX's sort, and no sort is needed;
//   - slot e * C + p gets the entry at position p < C; every other slot
//     -1 and 0.0 (the kernel writes all E * C slots);
//   - load[e] = count_e / (N * k).
// The grouped form (per-shard dispatch, `moe_dispatch_shards` G > 1) is
// the same kernel over G independent plans in one launch: probabilities
// f32[G, n, E] in, G tables of [E * C] (group-local token indices), G
// loads and, where asked, G rows of integer counts out. The grid is G
// clusters of the one-plan launch's blocks; cluster g reads blockIdx.x /
// blocks as its group and offsets its input and outputs by it. The carry
// between blocks never leaves a cluster (distributed shared memory), so
// the groups exchange nothing. One plan (G = 1) is the same launch as
// before the grouped form.
// Design. A token a thread. Each thread keeps its token's top-k in
// registers. Per expert, one ballot of "my token routes to e" gives each
// token its rank within the warp (popc of the lanes below) and the warp's
// count; an exclusive scan down each expert's column of the [warps][E]
// counts gives each warp's base in its block. The blocks of one thread
// block cluster (Hopper: up to 8, each up to 1,024 tokens a pass) then
// read each other's per-expert totals from distributed shared memory, so
// a block's base is the running count of the earlier passes (the carry)
// plus the totals of the lower-ranked blocks; a plan of over 8 tiles
// walks them in passes of 8. This is the TPU grid's in-order carry, in
// one launch, with one cluster barrier a pass. No sort, no global
// atomics; deterministic. A block takes as few threads as cover its
// share of the tokens (at least 128), so a 3,000-token prefill runs on
// 8 SMs of 384 threads and a decode step on one block of 128.
// Routing probabilities are finite (a softmax): the order of NaN and of
// -0.0 against 0.0 is outside the contract.
//
// Bound. The plan reads the probabilities once (N * E * 4 bytes) and
// writes the table and the load once (E * C * 8 + E * 4): 160 KB at a
// 3,000-token mixtral-8x22b prefill (N 3,000, E 8, C 1,024), about
// 0.048 us at the H100's 3.35 TB/s; 8.5 KB at a decode step (N 8, C
// 128). Its time is set by launch latency and by each tile's chain of
// loads, ballots, barriers and scattered stores, not by memory. The
// grouped form's G plans run side by side on G clusters, so G plans
// cost about one launch, not G.
//
// The sorted form, `moe_dispatch_kernel`: the TPU kernel's own contract,
// over expert ids sorted by (expert, arrival). For each entry: its
// 0-based position within its run of equal expert ids (-1 for a padding
// entry, any id < 0), the keep-mask `(e >= 0) & (pos < capacity)` and its
// slot in the dispatch table (`e * capacity + pos` if kept, `drop_slot`
// if not). Positions count runs, not ids, so the result is the TPU
// kernel's on any input, sorted or not. It is off the main path;
// chip_smoke.py holds and times it.
//
// Its design. The TPU kernel walks its grid in order and carries the
// open run (last id, running count) from block to block in SMEM. Here
// ONE thread block of 1024 threads walks the tiles of 1024 entries
// itself. An active entry that does not open a run has only active
// entries of its own id between it and its run's start, so its position
// is its distance to the last run start at or before it: per tile, each
// warp finds that start from a ballot of the run-start flags, the 32
// warps' last starts are max-scanned in shared memory, and the last start
// of the earlier tiles is the carry. The ragged last tile is masked;
// nothing is padded. Its function reads 4 bytes per entry (the id) and
// writes 5 (pos: 4, keep: 1); the kernel writes each slot as well.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
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

constexpr int kMaxExperts = 256;  // MAX_EXPERTS in ../ops.py
constexpr int kMaxTopK = 8;       // MAX_TOP_K in ../ops.py
constexpr int kMaxCluster = 8;    // blocks of a cluster (the portable most)
constexpr int kMinThreads = 128;  // a block's least threads

// A token's top-k so far, in registers: values descending, equal values
// by ascending expert (the experts are offered in ascending order).
template <int K>
struct TopK {
  float v[K];
  int e[K];  // -1 until filled (a token past n keeps -1)

  __device__ void clear() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = -INFINITY;
      e[j] = -1;
    }
  }

  // Offers expert `x`'s value `val`. It goes before the first entry that
  // is strictly smaller (an equal value of a lower expert stays first;
  // any finite value beats an empty entry's -inf); every entry from
  // there on moves down one place.
  __device__ void offer(float val, int x) {
    bool moving = false;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      moving = moving || val > v[j];
      if (moving) {
        const float tv = v[j];
        const int te = e[j];
        v[j] = val;
        e[j] = x;
        val = tv;
        x = te;
      }
    }
  }
};

// One cluster of `blocks` blocks walks one group's tokens in passes of
// blocks * blockDim.x, a token a thread; each block keeps every expert's
// count over the earlier passes (`carry`, the same in every block). The
// cluster's group is blockIdx.x / blocks; `counts` may be null.
template <int K>
__global__ void __launch_bounds__(kThreads, 1)
moe_dispatch_plan_kernel(const float* __restrict__ probs,
                         int* __restrict__ slot_token,
                         float* __restrict__ slot_weight,
                         float* __restrict__ load, int* __restrict__ counts,
                         int n, int num_experts, int capacity, bool vec4) {
  // per pass: each warp's count of each expert, then its exclusive base
  // within the block (the row stride of kMaxExperts + 1 keeps a column's
  // 32 reads on 32 banks)
  __shared__ int warp_count[kWarps][kMaxExperts + 1];
  // this block's count of each expert in the pass, read by the cluster's
  // other blocks; two buffers, so one cluster barrier a pass suffices
  __shared__ int block_total[2][kMaxExperts];
  __shared__ int gathered[kMaxCluster][kMaxExperts];  // all blocks' totals
  __shared__ int carry[kMaxExperts];   // each expert's entries so far
  __shared__ int offset[kMaxExperts];  // this block's base in the pass

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  // this cluster's group: its probabilities, table, load and counts
  const size_t group = blockIdx.x / blocks;
  probs += group * n * num_experts;
  slot_token += group * num_experts * capacity;
  slot_weight += group * num_experts * capacity;
  load += group * num_experts;
  if (counts != nullptr) counts += group * num_experts;
  for (int x = tid; x < num_experts; x += threads) carry[x] = 0;
  __syncthreads();

  const int pass = blocks * threads;
  int buf = 0;
  for (int first = 0; first < n; first += pass, buf ^= 1) {
    const int t = first + rank * threads + tid;
    TopK<K> top;
    top.clear();
    if (t < n) {
      const float* row = probs + static_cast<size_t>(t) * num_experts;
      if (vec4) {
        for (int x = 0; x < num_experts; x += 4) {
          const float4 q = *reinterpret_cast<const float4*>(row + x);
          top.offer(q.x, x);
          top.offer(q.y, x + 1);
          top.offer(q.z, x + 2);
          top.offer(q.w, x + 3);
        }
      } else {
        for (int x = 0; x < num_experts; ++x) top.offer(row[x], x);
      }
    }

    // each choice's rank among the warp's tokens routed to its expert
    int rank_in_warp[K];
#pragma unroll
    for (int j = 0; j < K; ++j) rank_in_warp[j] = 0;
    for (int x = 0; x < num_experts; ++x) {
      bool mine = false;
#pragma unroll
      for (int j = 0; j < K; ++j) mine = mine || top.e[j] == x;
      const unsigned m = __ballot_sync(kFullMask, mine);
      const int r = __popc(m & lanes_below);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (top.e[j] == x) rank_in_warp[j] = r;
      }
      if (lane == 0) warp_count[warp][x] = __popc(m);
    }
    __syncthreads();

    // down each expert's column: the warps' exclusive bases in the block
    // and the block's total
    for (int x = warp; x < num_experts; x += warps) {
      const int c = lane < warps ? warp_count[lane][x] : 0;
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFullMask, incl, d);
        if (lane >= d) incl += o;
      }
      if (lane < warps) warp_count[lane][x] = incl - c;
      if (lane == 31) block_total[buf][x] = incl;
    }
    if (blocks > 1) {
      cluster.sync();  // every block's totals of this pass are visible
      // one remote read a thread, all in flight together
      for (int i = tid; i < blocks * num_experts; i += threads) {
        const int r = i / num_experts;
        const int x = i - r * num_experts;
        gathered[r][x] = cluster.map_shared_rank(&block_total[buf][0], r)[x];
      }
    }
    __syncthreads();

    // this block's base: the carry and the lower blocks' totals; the
    // carry moves past the whole pass
    for (int x = tid; x < num_experts; x += threads) {
      int below = 0;
      int all = 0;
      for (int r = 0; r < blocks; ++r) {
        const int v = blocks > 1 ? gathered[r][x] : block_total[buf][x];
        below += r < rank ? v : 0;
        all += v;
      }
      offset[x] = carry[x] + below;
      carry[x] += all;
    }
    __syncthreads();

    if (t < n) {
      float sum = top.v[0];
#pragma unroll
      for (int j = 1; j < K; ++j) sum += top.v[j];
      const float den = fmaxf(sum, 1e-9f);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int x = top.e[j];
        const int p = offset[x] + warp_count[warp][x] + rank_in_warp[j];
        if (p < capacity) {
          const int s = x * capacity + p;
          slot_token[s] = t;
          slot_weight[s] = top.v[j] / den;
        }
      }
    }
    __syncthreads();  // the next pass rewrites warp_count and offset
  }
  // no block leaves while another may still read its block_total
  if (blocks > 1) cluster.sync();

  // carry[x] is now expert x's count, in every block
  if (rank == 0) {
    const float total = static_cast<float>(n * K);
    for (int x = tid; x < num_experts; x += threads) {
      load[x] = static_cast<float>(carry[x]) / total;
      if (counts != nullptr) counts[x] = carry[x];
    }
  }
  for (int x = 0; x < num_experts; ++x) {
    const unsigned from = static_cast<unsigned>(min(carry[x], capacity));
    int* tok = slot_token + static_cast<size_t>(x) * capacity;
    float* wt = slot_weight + static_cast<size_t>(x) * capacity;
    for (unsigned p = from + rank * threads + tid;
         p < static_cast<unsigned>(capacity); p += pass) {
      tok[p] = -1;
      wt[p] = 0.0f;
    }
  }
}

// A plan's cluster: up to kMaxCluster blocks, as many as give each block
// at least kMinThreads tokens, each block as few threads (a multiple of
// 32, at most 1,024) as cover its share of one pass: the SMs split the
// work of a pass, and a plan of over 8,192 tokens takes passes of 8 x
// 1,024. `groups` such clusters, one a plan.
template <int K>
int launch_plan(const void* probs, void* slot_token, void* slot_weight,
                void* load, void* counts, int groups, int n,
                int num_experts, int capacity, bool vec4,
                cudaStream_t stream) {
  const int blocks = max(1, min(kMaxCluster, n / kMinThreads));
  const int share = (n + blocks - 1) / blocks;
  const int threads =
      min(kThreads, max(kMinThreads, (share + 31) / 32 * 32));
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(groups * blocks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = blocks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, moe_dispatch_plan_kernel<K>, static_cast<const float*>(probs),
      static_cast<int*>(slot_token), static_cast<float*>(slot_weight),
      static_cast<float*>(load), static_cast<int*>(counts), n, num_experts,
      capacity, vec4);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). All pointers are device
// pointers; `stream` is a cudaStream_t.

// The sorted form. Returns cudaGetLastError().
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

// The fused plan (see the top of the file), `groups` of them. `probs` is
// f32[groups, n, num_experts] in rows; the outputs are [groups, E * C]
// (`slot_token`, `slot_weight`) and [groups, E] (`load`, and `counts`
// where not null). `vec4` says the rows may be read as float4
// (num_experts % 4 == 0 and `probs` 16-byte aligned, so every group's
// rows are too). Returns cudaErrorInvalidValue for a top_k, num_experts
// or group count the kernel does not take, else the launch's error.
extern "C" int moe_dispatch_plan_launch(const void* probs, void* slot_token,
                                        void* slot_weight, void* load,
                                        void* counts, int groups, int n,
                                        int num_experts, int top_k,
                                        int capacity, int vec4,
                                        void* stream) {
  if (top_k < 1 || top_k > kMaxTopK || num_experts < top_k ||
      num_experts > kMaxExperts || groups < 1 ||
      groups > 0x7fffffff / kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec4 != 0;
  switch (top_k) {
#define MOE_PLAN_CASE(K)                                                  \
  case K:                                                                 \
    return launch_plan<K>(probs, slot_token, slot_weight, load, counts,   \
                          groups, n, num_experts, capacity, v, s);
    MOE_PLAN_CASE(1)
    MOE_PLAN_CASE(2)
    MOE_PLAN_CASE(3)
    MOE_PLAN_CASE(4)
    MOE_PLAN_CASE(5)
    MOE_PLAN_CASE(6)
    MOE_PLAN_CASE(7)
    MOE_PLAN_CASE(8)
#undef MOE_PLAN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
