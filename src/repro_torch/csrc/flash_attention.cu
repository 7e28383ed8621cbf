// Flash-attention forward, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_bhsd): online-softmax attention, causal and/or sliding
// window, a query offset q_offset (query row i sits at position
// q_offset + i, keys at 0..Sk-1), GQA by reading KV head h / group without
// materialising repeated KV, KV tiles with no visible pair skipped, ragged
// Sq and Sk masked per element. f32 softmax state inside; the output is in
// the input's type. A row with no visible key gives 0: masked scores are
// -1e30 (not -inf), their probabilities are 0, and the denominator is
// floored at 1e-30, as in kernel.py:71-82.
//
// The TPU grid (b, h, q block, kv block) runs in order, carrying m, l and
// the accumulator in VMEM scratch across its sequential kv dimension. Here
// one thread block of 4 warps owns one (b, h, 64-row q tile), and that kv
// dimension becomes a loop inside the block over 64-key tiles:
//
//   1. the Q tile is staged once in shared memory; each K and V tile is
//      staged in turn (16-byte loads, rows past Sk zero-filled);
//   2. each warp owns 16 query rows: S = Q K^T into shared memory, through
//      nvcuda::wmma 16x16x16 bf16 fragments with f32 accumulators (for
//      f32 inputs, plain FMA loops in the same template);
//   3. two lanes per row mask, take the running max, rescale, exponentiate
//      and write P (bf16 for the tensor cores, f32 on the FMA path);
//   4. the warp rescales its O rows (f32, shared memory) and adds P V.
//
// The loop starts at the first tile the window reaches and, under
// causality, ends at the diagonal, the kernel.py:44-53 visibility test.
//
// What bounds it on the H100: bf16 tensor-core operations. At the main
// path's shape (one llama3.2-1b layer's prefill, B=4, Hq=32, Hkv=8,
// S=2048, D=Dv=64, causal) the visible pairs need 2 * 268.6M * 128 =
// 68.7 GFLOP, 69 us at 989 TFLOP/s; its bytes (q, k, v, o once: 84 MB)
// take 25 us at 3.35 TB/s. What this simple design leaves on the table:
// wgmma and TMA (mma.sync-class wmma reaches a fraction of the tensor-core
// rate), S, P and O round-trip through shared memory every tile instead of
// staying in registers, K/V loads are not pipelined with the products
// (no cp.async or TMA ring), and every launch sets its shared-memory size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int WARPS = 4;          // each warp owns 16 query rows
constexpr int NT = WARPS * 32;
constexpr float NEG_INF = -1e30f;

// Shared-memory row padding: 16 bytes, which keeps every wmma pointer
// 32-byte aligned and spreads rows over the banks.
template <typename T> struct Pad;
template <> struct Pad<bf16> { static constexpr int v = 8; };
template <> struct Pad<float> { static constexpr int v = 4; };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, group, Sq, Sk, D, Dv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale;
  int causal, window, q_offset;   // window <= 0: none
};

constexpr int LDS = BK + 4;       // f32 score rows

template <typename T>
__host__ __device__ size_t smem_bytes(int D, int Dv) {
  constexpr int P = Pad<T>::v;
  return sizeof(T) * (size_t(BQ + BK) * (D + P) + size_t(BK) * (Dv + P) +
                      size_t(BQ) * (BK + P)) +
         sizeof(float) * (size_t(BQ) * LDS + size_t(BQ) * (Dv + 4) + 3 * BQ);
}

__device__ __forceinline__ void store_val(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store_val(float* p, float x) { *p = x; }

// rows x width tile from global (row stride in elements) into shared memory
// (row stride ld), 16 bytes per thread per step; rows >= valid are zeroed.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, long long stride,
                          int rows, int valid, int width) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = width / E;
  for (int i = threadIdx.x; i < rows * cpr; i += NT) {
    const int r = i / cpr, c = (i - r * cpr) * E;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// S[16 rows of this warp][0..BK) = Q K^T (unscaled).
__device__ void scores(const bf16* Qs, const bf16* Ks, int ld, float* Ss, int D,
                       int warp, int lane) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(a, Qs + warp * 16 * ld + kk * 16, ld);
      wmma::load_matrix_sync(b, Ks + n * 16 * ld + kk * 16, ld);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Ss + warp * 16 * LDS + n * 16, acc, LDS, wmma::mem_row_major);
  }
}

__device__ void scores(const float* Qs, const float* Ks, int ld, float* Ss, int D,
                       int warp, int lane) {
  const int r = warp * 16 + lane / 2;
  const float* qrow = Qs + r * ld;
  for (int c = lane & 1; c < BK; c += 2) {
    const float* krow = Ks + c * ld;
    float acc = 0.0f;
    for (int d = 0; d < D; ++d) acc = fmaf(qrow[d], krow[d], acc);
    Ss[r * LDS + c] = acc;
  }
}

// O[16 rows of this warp] += P V.
__device__ void add_pv(const bf16* Ps, int ldp, const bf16* Vs, int ldv, float* Os,
                       int ldo, int Dv, int warp, int lane) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  for (int n = 0; n < Dv / 16; ++n) {
    float* o = Os + warp * 16 * ldo + n * 16;
    wmma::load_matrix_sync(acc, o, ldo, wmma::mem_row_major);
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::load_matrix_sync(a, Ps + warp * 16 * ldp + kk * 16, ldp);
      wmma::load_matrix_sync(b, Vs + kk * 16 * ldv + n * 16, ldv);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o, acc, ldo, wmma::mem_row_major);
  }
}

__device__ void add_pv(const float* Ps, int ldp, const float* Vs, int ldv, float* Os,
                       int ldo, int Dv, int warp, int lane) {
  const int r = warp * 16 + lane / 2;
  const float* prow = Ps + r * ldp;
  for (int c = lane & 1; c < Dv; c += 2) {
    float acc = Os[r * ldo + c];
    for (int kk = 0; kk < BK; ++kk) acc = fmaf(prow[kk], Vs[kk * ldv + c], acc);
    Os[r * ldo + c] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_fwd(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int PAD = Pad<T>::v;
  const int D = p.D, Dv = p.Dv;
  const int ldq = D + PAD, ldv = Dv + PAD, ldp = BK + PAD, ldo = Dv + 4;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * ldq;
  T* Vs = Ks + BK * ldq;
  T* Ps = Vs + BK * ldv;
  float* Ss = reinterpret_cast<float*>(Ps + BQ * ldp);
  float* Os = Ss + BQ * LDS;
  float* m_s = Os + BQ * ldo;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int row0 = qt * BQ;
  const int q_rows = min(BQ, p.Sq - row0);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + row0 * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + row0 * p.o_ss;

  load_tile(Qs, ldq, qg, p.q_ss, BQ, q_rows, D);
  for (int i = threadIdx.x; i < BQ * Dv; i += NT) Os[(i / Dv) * ldo + i % Dv] = 0.0f;
  if (threadIdx.x < BQ) {
    m_s[threadIdx.x] = NEG_INF;
    l_s[threadIdx.x] = 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 2;       // this lane's row for the softmax
  const int q_first = p.q_offset + row0;
  const int q_last = q_first + q_rows - 1;
  const int q_pos = q_first + r;
  const bool has_window = p.window > 0;

  // tiles holding a visible pair: k_first < Sk; causal: k_first <= q_last;
  // window: k_last > q_first - window
  int kt_end = (p.Sk + BK - 1) / BK;
  if (p.causal) kt_end = min(kt_end, q_last < 0 ? 0 : q_last / BK + 1);
  int kt_begin = 0;
  if (has_window) {
    const int lo = q_first - p.window - BK + 2;   // least k_first visible
    kt_begin = lo <= 0 ? 0 : (lo + BK - 1) / BK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const int k_rows = min(BK, p.Sk - k0);
    __syncthreads();                        // every warp is done with the last tile
    load_tile(Ks, ldq, kg + k0 * p.k_ss, p.k_ss, BK, k_rows, D);
    load_tile(Vs, ldv, vg + k0 * p.v_ss, p.v_ss, BK, k_rows, Dv);
    __syncthreads();

    scores(Qs, Ks, ldq, Ss, D, warp, lane);
    __syncwarp();

    // online softmax over this tile, two lanes per row (columns of one parity)
    float sv[BK / 2];
    unsigned ok_bits = 0u;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = (lane & 1) + 2 * j;
      const int k_pos = k0 + c;
      bool ok = c < k_rows;
      if (p.causal) ok = ok && q_pos >= k_pos;
      if (has_window) ok = ok && q_pos - k_pos < p.window;
      const float s = ok ? Ss[r * LDS + c] * p.scale : NEG_INF;
      ok_bits |= unsigned(ok) << j;
      sv[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, mx);
    const float corr = expf(m_old - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float pj = (ok_bits >> j) & 1u ? expf(sv[j] - m_new) : 0.0f;
      sum += pj;
      store_val(Ps + r * ldp + (lane & 1) + 2 * j, pj);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    __syncwarp();
    if ((lane & 1) == 0) {
      m_s[r] = m_new;
      l_s[r] = l_s[r] * corr + sum;
      c_s[r] = corr;
    }
    __syncwarp();
    for (int i = lane; i < 16 * Dv; i += 32) {
      const int rr = warp * 16 + i / Dv;
      Os[rr * ldo + i % Dv] *= c_s[rr];
    }
    __syncwarp();
    add_pv(Ps, ldp, Vs, ldv, Os, ldo, Dv, warp, lane);
  }
  __syncwarp();

  for (int i = lane; i < 16 * Dv; i += 32) {
    const int rr = warp * 16 + i / Dv, c = i % Dv;
    if (rr < q_rows) store_val(og + rr * p.o_ss + c, Os[rr * ldo + c] / fmaxf(l_s[rr], 1e-30f));
  }
}

bool supported(int D, int Dv) {
  auto in_set = [](int x) { return x == 32 || x == 64 || x == 80 || x == 128; };
  return (in_set(D) && in_set(Dv)) || (D == 192 && Dv == 128);
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(p.D, p.Dv);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B);
  flash_fwd<T><<<grid, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,Hq,Sq,D), k (B,Hkv,Sk,D), v (B,Hkv,Sk,Dv) -> o (B,Hq,Sq,Dv), each
// given by its batch, head and sequence strides in elements (the last
// stride is 1); bf16 when is_bf16, else f32. window <= 0: no window.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head size the kernel does not take).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, int Dv, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, int window, int q_offset, void* stream) {
  if (!supported(D, Dv) || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  Params p{q, k, v, o, Hq, Hq / Hkv, Sq, Sk, D, Dv,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           scale, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(p, B, s) : launch<float>(p, B, s);
}
