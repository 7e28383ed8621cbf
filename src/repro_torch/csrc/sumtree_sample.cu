// Batched inverse-CDF descent of the sum tree, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sumtree_sample/kernel.py
// (sumtree_sample_pallas), which reads each level's left-child masses with
// a (block_b, 2C) one-hot masked row-sum because the TPU's vector unit has
// no gather. Here one thread walks one offset down the tree with native
// gathers: at each of the log2(C) levels it goes left iff u < tree[2n] and
// else subtracts the left mass (u - left, the same fp32 operation in the
// same order as the plain version), clips the final leaf to [0, C) and
// emits the leaf's mass, which is bitwise tree[C + idx].
//
// What bounds it on the H100: latency. B offsets need B * log2(C) dependent
// 4-byte loads (512 x 21 on the main path), a few KiB in all, so neither
// bandwidth nor arithmetic comes close to its limit. The whole tree
// (16 MiB at 2^21 leaves) stays in the 50 MB L2 between calls, so each
// level is one L2 round trip; the upper levels are shared by every thread
// and hit L1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void descend(const float* __restrict__ tree, int depth,
                        const float* __restrict__ u_in, int B,
                        int* __restrict__ idx_out, float* __restrict__ mass_out) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int cap = 1 << depth;
  float u = u_in[b];
  int node = 1;
  for (int level = 0; level < depth; ++level) {
    int left = 2 * node;
    float left_mass = tree[left];
    if (u < left_mass) {
      node = left;
    } else {
      node = left + 1;
      u = __fsub_rn(u, left_mass);
    }
  }
  int leaf = node - cap;
  leaf = leaf < 0 ? 0 : (leaf >= cap ? cap - 1 : leaf);
  idx_out[b] = leaf;
  mass_out[b] = tree[cap + leaf];
}

}  // namespace

// tree (2C,) f32; u (B,) f32 -> idx (B,) i32, mass (B,) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int sumtree_sample_launch(const float* tree, int depth,
                                     const float* u, int B, int* idx,
                                     float* mass, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  descend<<<(B + kThreads - 1) / kThreads, kThreads, 0, s>>>(tree, depth, u, B,
                                                            idx, mass);
  return static_cast<int>(cudaGetLastError());
}
