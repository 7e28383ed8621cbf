// Batched incremental sum-tree write, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sumtree_update/kernel.py
// (sumtree_update_pallas). That kernel turns every gather and scatter into
// a (block_b, 2C) one-hot masked row-sum, because the TPU's vector unit has
// no gather, and relies on its grid running in order for cross-block
// last-writer-wins. A GPU gathers natively and runs blocks in no order, so
// this kernel keeps the function and drops the formulation:
//
//   1. election_clear / election_vote: the last writer of each leaf is the
//      highest lane id, elected across the whole batch with atomicMax into
//      a (C,) int32 scratch that the caller allocates;
//   2. write_leaves: only the winner writes its leaf;
//   3. repair_ancestors: one block walks the log2(C) levels in order with
//      __syncthreads between them, recomputing each touched node as
//      left + right (no delta patch), so the tree is bit-identical to the
//      plain version whenever the leaves are.
//
// What bounds it on the H100: neither bytes nor operations. It moves a few
// KiB (B ids and values, B * log2(C) nodes) and does B * log2(C) adds, so
// it is bound by latency: four dependent launches, and in the repair 21
// levels of dependent L2 round trips inside one block. The design keeps
// every step a plain gather/store on the L2-resident tree (16 MiB at 2^21
// leaves, under the 50 MB L2) and skips duplicate ancestors of neighbouring
// lanes, so the repair's work shrinks towards the root.

#include "sumtree_common.cuh"

using namespace repro_torch;

__global__ void write_leaves(float* __restrict__ tree,
                             const int* __restrict__ idx,
                             const float* __restrict__ values, int B, int cap,
                             const int* __restrict__ winner) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B && is_winner(idx, b, cap, winner))
    tree[cap + clipped_slot(idx[b], cap)] = values[b];
}

// tree (2C,) f32 updated in place; idx (B,) i32; values (B,) f32;
// winner (C,) i32 scratch. Returns cudaGetLastError() after the launches.
extern "C" int sumtree_update_launch(float* tree, int depth, const int* idx,
                                     const float* values, int B, int* winner,
                                     void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int cap = 1 << depth;
  int grid = grid_for(B, kThreads);
  election_clear<<<grid, kThreads, 0, s>>>(idx, B, cap, winner);
  election_vote<<<grid, kThreads, 0, s>>>(idx, B, cap, winner);
  write_leaves<<<grid, kThreads, 0, s>>>(tree, idx, values, B, cap, winner);
  repair_ancestors<<<1, kRepairThreads, 0, s>>>(tree, idx, B, cap, depth);
  return static_cast<int>(cudaGetLastError());
}
