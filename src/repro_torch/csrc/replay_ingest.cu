// Fused replay ingest of one transition block, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/replay_ingest/kernel.py
// (replay_ingest_pallas). Given packed slot ids, raw priorities, an
// `applied` lane mask and one row per lane for every storage buffer:
//
//   leaf[slot] = applied ? (max(|p|, 1e-4))^alpha : old leaf
//   row[slot]  = applied ? item row : old row
//
// with duplicate slots resolved last-writer-wins over the whole batch, ids
// in [-C, -1] wrapped and any other id outside [0, C) dropped, then the
// ancestors of every lane's clipped slot repaired as left + right.
//
// The TPU kernel walks the lanes serially so that in-order stores give
// last-writer-wins, and gets cross-block order from its sequential grid.
// Here the winner of each slot is elected first (atomicMax of the lane id,
// sumtree_common.cuh), including masked lanes: a masked winner would write
// the old row and leaf, which is no write at all, and it still shadows an
// earlier applied lane on the same slot. Only applied winners write, so no
// "old" value ever needs to be gathered.
//
// What bounds it on the H100: the storage scatter is the bulk of the bytes
// (22,320 rows x 144 B, about 3.2 MB in and 3.2 MB out on the main path),
// so the write pass gives each lane one warp and copies every buffer as
// (C, row_bytes) uint8 rows, one code path for every dtype; many warps in
// flight keep the scattered row writes overlapped. The tree step is the
// latency-bound level-ordered repair shared with sumtree_update.

#include "sumtree_common.cuh"

using namespace repro_torch;

namespace {

constexpr int kMaxBufs = 8;

struct BufTable {
  unsigned char* dst[kMaxBufs];        // (C, row_bytes) storage buffers
  const unsigned char* src[kMaxBufs];  // (B, row_bytes) item rows
  long long row_bytes[kMaxBufs];
  int n;
};

__device__ __forceinline__ float to_leaf(float p, float alpha) {
  float a = fabsf(p);
  // max(|p|, 1e-4) with NaN propagated, as the plain version's maximum does
  float m = (a > 1e-4f || a != a) ? a : 1e-4f;
  return powf(m, alpha);
}

__global__ void ingest_write(float* __restrict__ tree,
                             const int* __restrict__ idx,
                             const float* __restrict__ prio,
                             const unsigned char* __restrict__ applied, int B,
                             int cap, float alpha,
                             const int* __restrict__ winner, BufTable t) {
  int lane = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  int l = threadIdx.x % 32;
  if (lane >= B || !applied[lane] || !is_winner(idx, lane, cap, winner)) return;
  long long slot = clipped_slot(idx[lane], cap);
  for (int k = 0; k < t.n; ++k) {
    long long rb = t.row_bytes[k];
    unsigned char* d = t.dst[k] + slot * rb;
    const unsigned char* s = t.src[k] + lane * rb;
    for (long long j = l; j < rb; j += 32) d[j] = s[j];
  }
  if (l == 0) tree[cap + slot] = to_leaf(prio[lane], alpha);
}

}  // namespace

// tree (2C,) f32 and the n_bufs storage buffers are updated in place;
// idx (B,) i32, prio (B,) f32, applied (B,) u8; bufs[k] (C, row_bytes[k])
// and items[k] (B, row_bytes[k]) as raw bytes; winner (C,) i32 scratch.
// Returns cudaGetLastError() after the launches (-1 for too many buffers).
extern "C" int replay_ingest_launch(float* tree, int depth, const int* idx,
                                    const float* prio,
                                    const unsigned char* applied, int B,
                                    float alpha, int n_bufs, void** bufs,
                                    void** items, const long long* row_bytes,
                                    int* winner, void* stream) {
  if (n_bufs > kMaxBufs || n_bufs < 0) return -1;
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int cap = 1 << depth;
  BufTable t;
  t.n = n_bufs;
  for (int k = 0; k < n_bufs; ++k) {
    t.dst[k] = static_cast<unsigned char*>(bufs[k]);
    t.src[k] = static_cast<const unsigned char*>(items[k]);
    t.row_bytes[k] = row_bytes[k];
  }
  int grid = grid_for(B, kThreads);
  election_clear<<<grid, kThreads, 0, s>>>(idx, B, cap, winner);
  election_vote<<<grid, kThreads, 0, s>>>(idx, B, cap, winner);
  ingest_write<<<grid_for(B, kThreads / 32), kThreads, 0, s>>>(
      tree, idx, prio, applied, B, cap, alpha, winner, t);
  repair_ancestors<<<1, kRepairThreads, 0, s>>>(tree, idx, B, cap, depth);
  return static_cast<int>(cudaGetLastError());
}
