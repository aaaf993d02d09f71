// K1: flash attention forward, bf16 in / bf16 out, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gyre_tpu/ops/attention.py::_flash_kernel
// (launched by _flash_forward). Same math: softmax(Q K^T * scale) V with an
// online softmax over KV tiles, running max and sum in f32, bf16 products
// with f32 accumulation, exp2 in the log2 domain. The TPU's tricks are
// dropped: no 128-lane head padding in device memory (head dims pad to the
// 16-wide tensor-core step inside shared memory only) and no ones-column
// denominator in V.
//
// What bounds it on the H100: at SD1.5 shapes (T=4096, d=40..160) the two
// products are ~4*T*T*d FLOP per (batch, head) against ~4*T*d bytes of
// Q/K/V/O, so the kernel is compute-bound in principle; this first version
// is bound by its own shared-memory round trips (scores, probabilities and
// the output accumulator live in shared memory, WMMA 16x16x16 products, no
// cp.async pipelining). What the design does about the memory side: the
// [T, T] score matrix never reaches device memory, and each K/V tile is
// read once per 64-row query tile.
//
// Layout: one block of 4 warps per (batch*head, query tile). The output
// accumulator O[BQ, DP] is kept in shared memory in f32 so that rows can be
// rescaled by the online-softmax factor regardless of how WMMA lays out its
// fragments; this also lets d=512 (the VAE's single-head attention) run with
// a 32-row query tile instead of needing 64 rows of accumulator registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) & ~static_cast<size_t>(127);
}

// Shared-memory bytes for one block: Q, K, V tiles (bf16, head dim padded
// to dp), O accumulator (f32), scores S (f32), probabilities P (bf16),
// running max m and sum l (f32).
__host__ __device__ constexpr size_t smem_bytes(int bq, int bk, int dp) {
  return align128(size_t(bq) * dp * 2) + 2 * align128(size_t(bk) * dp * 2) +
         align128(size_t(bq) * dp * 4) + align128(size_t(bq) * bk * 4) +
         align128(size_t(bq) * bk * 2) + 2 * align128(size_t(bq) * 4);
}

template <int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int tq, int tk, int d,
                     int dp, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off = 0;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + off);
  off += align128(size_t(BQ) * dp * 2);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + off);
  off += align128(size_t(BK) * dp * 2);
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem + off);
  off += align128(size_t(BK) * dp * 2);
  float* so = reinterpret_cast<float*>(smem + off);
  off += align128(size_t(BQ) * dp * 4);
  float* ss = reinterpret_cast<float*>(smem + off);
  off += align128(size_t(BQ) * BK * 4);
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem + off);
  off += align128(size_t(BQ) * BK * 2);
  float* sm = reinterpret_cast<float*>(smem + off);
  off += align128(size_t(BQ) * 4);
  float* sl = reinterpret_cast<float*>(smem + off);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const size_t q_base = size_t(blockIdx.y) * tq * d;
  const size_t k_base = size_t(blockIdx.y) * tk * d;
  const int vecs = dp / 8;  // 16-byte vectors per padded row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Q tile, zero-padded in rows (past tq) and head dim (past d)
  for (int i = tid; i < BQ * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i % vecs) * 8;
    uint4 val = zero;
    if (q0 + r < tq && c < d)
      val = *reinterpret_cast<const uint4*>(q + q_base + size_t(q0 + r) * d + c);
    *reinterpret_cast<uint4*>(sq + r * dp + c) = val;
  }
  for (int i = tid; i < BQ * dp; i += kThreads) so[i] = 0.f;
  for (int i = tid; i < BQ; i += kThreads) {
    sm[i] = -INFINITY;
    sl[i] = 0.f;
  }
  __syncthreads();

  constexpr int kSTilesN = BK / 16;
  constexpr int kSTiles = (BQ / 16) * kSTilesN;
  const int o_tiles_n = dp / 16;
  const int o_tiles = (BQ / 16) * o_tiles_n;

  for (int k0 = 0; k0 < tk; k0 += BK) {
    // K and V tiles; rows past tk are zero so that 0 * p stays 0
    for (int i = tid; i < BK * vecs; i += kThreads) {
      const int r = i / vecs;
      const int c = (i % vecs) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < tk && c < d) {
        const size_t g = k_base + size_t(k0 + r) * d + c;
        kv = *reinterpret_cast<const uint4*>(k + g);
        vv = *reinterpret_cast<const uint4*>(v + g);
      }
      *reinterpret_cast<uint4*>(sk + r * dp + c) = kv;
      *reinterpret_cast<uint4*>(sv + r * dp + c) = vv;
    }
    __syncthreads();

    // S = Q K^T (f32)
    for (int t = warp; t < kSTiles; t += kWarps) {
      const int tm = t / kSTilesN;
      const int tn = t % kSTilesN;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < dp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sq + tm * 16 * dp + kk, dp);
        wmma::load_matrix_sync(fb, sk + tn * 16 * dp + kk, dp);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(ss + tm * 16 * BK + tn * 16, acc, BK,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax, one warp per row: P = exp2(S*scale - m_new),
    // O *= exp2(m_old - m_new), l = l*alpha + sum(P)
    for (int r = warp; r < BQ; r += kWarps) {
      float vals[BK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + j * 32;
        const float s = (k0 + c < tk) ? ss[r * BK + c] * scale_log2 : -INFINITY;
        vals[j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = sm[r];
      // every tile holds at least one valid column, so m_new is finite
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float p = exp2f(vals[j] - m_new);
        sp[r * BK + lane + j * 32] = __float2bfloat16(p);
        sum += p;
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      const float alpha = exp2f(m_old - m_new);
      for (int c = lane; c < dp; c += 32) so[r * dp + c] *= alpha;
      if (lane == 0) {
        sm[r] = m_new;
        sl[r] = sl[r] * alpha + sum;
      }
    }
    __syncthreads();

    // O += P V
    for (int t = warp; t < o_tiles; t += kWarps) {
      const int tm = t / o_tiles_n;
      const int tn = t % o_tiles_n;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* op = so + tm * 16 * dp + tn * 16;
      wmma::load_matrix_sync(acc, op, dp, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sp + tm * 16 * BK + kk, BK);
        wmma::load_matrix_sync(fb, sv + kk * dp + tn * 16, dp);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(op, acc, dp, wmma::mem_row_major);
    }
    __syncthreads();
  }

  // O / l -> bf16, only real rows and head-dim columns
  for (int i = tid; i < BQ * d; i += kThreads) {
    const int r = i / d;
    const int c = i % d;
    if (q0 + r < tq)
      o[q_base + size_t(q0 + r) * d + c] =
          __float2bfloat16(so[r * dp + c] / fmaxf(sl[r], 1e-20f));
  }
}

template <int BQ, int BK>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* o, int bh, int tq,
                   int tk, int d, int dp, float scale_log2,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(BQ, BK, dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<BQ, BK><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, tq, tk, d, dp, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q [bh, tq, d], k and v [bh, tk, d], o [bh, tq, d]; all bf16, contiguous,
// d a multiple of 8 and at most 512. Returns a cudaError_t as int.
extern "C" int gyre_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int bh, int tq,
                                    int tk, int d, float scale,
                                    void* stream) {
  // batch*heads is the grid's y dimension (at most 65535)
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0 || d <= 0 || d % 8 ||
      d > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (d + 15) / 16 * 16;
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // 64x64 tiles keep shared memory under 227 KB up to dp=256; wider heads
  // (the VAE's d=512) take 32x32 tiles
  if (dp <= 256)
    err = launch<64, 64>(qp, kp, vp, op, bh, tq, tk, d, dp, scale_log2, s);
  else
    err = launch<32, 32>(qp, kp, vp, op, bh, tq, tk, d, dp, scale_log2, s);
  return static_cast<int>(err);
}
