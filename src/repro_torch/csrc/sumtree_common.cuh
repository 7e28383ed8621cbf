// Shared device code of the sum-tree kernels (sumtree_update.cu,
// replay_ingest.cu): index rules, last-writer election and the
// level-ordered ancestor repair.
//
// Tree layout: a flat (2C,) float32 array, node 1 is the root, node i has
// children 2i and 2i+1, leaf k lives at C + k, index 0 is unused.
//
// Index rules (numpy-style scatter, as the reference sum tree applies them):
// ids in [-C, -1] wrap to id + C; any other id outside [0, C) is dropped
// from the leaf write. The ancestor repair still walks from every lane's
// clipped node, dropped lanes included, so the repaired tree equals the
// reference's bit for bit whenever the leaves do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kThreads = 256;
constexpr int kRepairThreads = 1024;

__device__ __forceinline__ int wrap_index(int id, int cap) {
  return id < 0 ? id + cap : id;
}

__device__ __forceinline__ bool in_range(int id, int cap) {
  int n = wrap_index(id, cap);
  return n >= 0 && n < cap;
}

__device__ __forceinline__ int clipped_slot(int id, int cap) {
  int n = wrap_index(id, cap);
  return n < 0 ? 0 : (n >= cap ? cap - 1 : n);
}

// Pass 1 of the election: every in-range lane clears its slot's entry in
// the (C,) scratch, so the scratch needs no clearing of its own. A kernel
// boundary separates this pass from the next.
__global__ void election_clear(const int* __restrict__ idx, int B, int cap,
                               int* __restrict__ winner) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B && in_range(idx[b], cap)) winner[clipped_slot(idx[b], cap)] = -1;
}

// Pass 2: the highest lane id of each slot wins (last-writer-wins, as the
// reference scatter resolves duplicates). Blocks run in no order, so the
// winner is elected across the whole batch with an atomic max.
__global__ void election_vote(const int* __restrict__ idx, int B, int cap,
                              int* __restrict__ winner) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B && in_range(idx[b], cap))
    atomicMax(&winner[clipped_slot(idx[b], cap)], b);
}

__device__ __forceinline__ bool is_winner(const int* __restrict__ idx, int b,
                                          int cap,
                                          const int* __restrict__ winner) {
  return in_range(idx[b], cap) && winner[clipped_slot(idx[b], cap)] == b;
}

// Ancestor repair in level order: level l recomputes every touched node
// at depth (depth - l) as tree[2p] + tree[2p + 1], reading the children
// that level l - 1 wrote. One block, with __syncthreads between levels as
// the barrier. A lane whose node equals the previous lane's node at this
// level skips it: the previous lane writes the same value (contiguous
// FIFO slots share most ancestors, so this removes almost all redundant
// writes); any other duplicate writes the identical value, a benign race.
__global__ void __launch_bounds__(kRepairThreads)
repair_ancestors(float* tree, const int* __restrict__ idx, int B,
                 int cap, int depth) {
  for (int level = 1; level <= depth; ++level) {
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      int node = (clipped_slot(idx[b], cap) + cap) >> level;
      if (b > 0 && ((clipped_slot(idx[b - 1], cap) + cap) >> level) == node)
        continue;
      tree[node] = tree[2 * node] + tree[2 * node + 1];
    }
    __syncthreads();
  }
}

inline int grid_for(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace repro_torch
