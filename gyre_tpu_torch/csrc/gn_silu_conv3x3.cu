// K2b: fused (GroupNorm affine -> SiLU -> 3x3 SAME conv) over NHWC, for
// Hopper (sm_90a).
//
// Replaces pass 2 of the TPU fusion, the Pallas kernel
// gyre_tpu/ops/fused_norm_conv.py::_make_kernel (launched by
// _gn_silu_conv3x3_impl). Same math: y = silu(x*a + b) in f32, rounded to
// bf16, zero padding of the H and W borders applied AFTER the activation,
// a 3x3 stride-1 conv with f32 accumulation, + bias, bf16 out. The
// per-(batch, channel) affine a, b comes from K2a (gn_stats.cu).
//
// Design: an implicit GEMM. M = B*H*W output pixels, N = Co, K = 9*C with
// k = (tap, ci). The A operand is never materialised: each block gathers
// its [BM pixels x BK channels] slice of x for one tap, applies the affine
// and SiLU in registers and stores bf16 to shared memory; out-of-image
// pixels are written as zeros. The B operand is the HWIO weight read as a
// [9*C, Co] row-major matrix. WMMA 16x16x16 bf16 products, f32
// accumulators, bias added in the epilogue.
//
// What bounds it on the H100: 2*M*N*K FLOP against one read of x per tap
// and output tile plus one write of the output; the UNet shapes are
// compute-bound, the VAE's wide 256^2 and 512^2 levels nearly balanced.
// What the design does: the normalised activation never reaches device
// memory (the unfused chain writes and re-reads it), and the 9 taps re-read
// x from L2 rather than from a padded copy. This first version does not
// pipeline its loads (no cp.async / TMA) and uses WMMA rather than wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // input channels per k step
constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along N, 32x32 each
constexpr int LDA = BK + 8;    // shared-memory row strides, skewed
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int kTileBytes = BM * LDA * 2 + BK * LDB * 2;
constexpr int kEpilogueBytes = BM * LDC * 4;
constexpr int kSmemBytes =
    kTileBytes > kEpilogueBytes ? kTileBytes : kEpilogueBytes;

__global__ void __launch_bounds__(kThreads)
    gn_silu_conv3x3_kernel(const __nv_bfloat16* __restrict__ xin,
                           const float* __restrict__ aff_a,
                           const float* __restrict__ aff_b,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, int batch, int h,
                           int wd, int c, int co) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem + BM * LDA * 2);
  float* sc = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;  // 0..3
  const int wn = warp % 2;  // 0..1
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int hw = h * wd;
  const int m_total = batch * hw;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // A-tile assignment: BM rows x BK/8 vectors = 512 vectors, 2 per thread
  int a_row[2], a_vec[2], a_b[2], a_y[2], a_x[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    a_row[i] = idx / (BK / 8);
    a_vec[i] = idx % (BK / 8);
    const int m = m0 + a_row[i];
    a_ok[i] = m < m_total;
    const int mm = a_ok[i] ? m : 0;
    a_b[i] = mm / hw;
    const int rem = mm % hw;
    a_y[i] = rem / wd;
    a_x[i] = rem % wd;
  }
  // B-tile assignment: BK rows x BN/8 vectors = 256 vectors, 1 per thread
  const int b_row = tid / (BN / 8);
  const int b_vec = tid % (BN / 8);
  const int b_n = n0 + b_vec * 8;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    for (int c0 = 0; c0 < c; c0 += BK) {
      // A: silu(x*a+b) of the tap-shifted pixel, zero outside the image
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint4 val = zero;
        const int ci = c0 + a_vec[i] * 8;
        const int yy = a_y[i] + dy;
        const int xx = a_x[i] + dx;
        if (a_ok[i] && ci < c && yy >= 0 && yy < h && xx >= 0 && xx < wd) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              xin + ((size_t(a_b[i]) * h + yy) * wd + xx) * c + ci);
          const __nv_bfloat16* rv =
              reinterpret_cast<const __nv_bfloat16*>(&raw);
          const float* ap = aff_a + size_t(a_b[i]) * c + ci;
          const float* bp = aff_b + size_t(a_b[i]) * c + ci;
          __align__(16) __nv_bfloat16 act[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float t = __bfloat162float(rv[j]) * ap[j] + bp[j];
            act[j] = __float2bfloat16(t / (1.f + __expf(-t)));
          }
          val = *reinterpret_cast<const uint4*>(act);
        }
        *reinterpret_cast<uint4*>(sa + a_row[i] * LDA + a_vec[i] * 8) = val;
      }
      // B: weight rows (tap, ci) x output channels n0..n0+BN
      {
        uint4 val = zero;
        const int ci = c0 + b_row;
        if (ci < c && b_n < co)
          val = *reinterpret_cast<const uint4*>(
              w + (size_t(tap) * c + ci) * co + b_n);
        *reinterpret_cast<uint4*>(sb + b_row * LDB + b_vec * 8) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], sa + (wm * 32 + i * 16) * LDA + kk,
                                 LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], sb + kk * LDB + wn * 32 + j * 16,
                                 LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: accumulators -> shared memory -> + bias -> bf16
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          sc + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
          wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN;
    const int cc = idx % BN;
    const int m = m0 + r;
    const int n = n0 + cc;
    if (m < m_total && n < co)
      out[size_t(m) * co + n] = __float2bfloat16(sc[r * LDC + cc] + bias[n]);
  }
}

}  // namespace

// x [batch, h, wd, c] bf16; a, b [batch, c] f32; w [3, 3, c, co] bf16
// (HWIO); bias [co] f32; out [batch, h, wd, co] bf16. c and co multiples of
// 8, all pointers 16-byte aligned. Returns a cudaError_t as int.
extern "C" int gyre_gn_silu_conv3x3(const void* x, const void* a,
                                    const void* b, const void* w,
                                    const void* bias, void* out, int batch,
                                    int h, int wd, int c, int co,
                                    void* stream) {
  if (batch <= 0 || h <= 0 || wd <= 0 || c <= 0 || co <= 0 || c % 8 ||
      co % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m_total = 1LL * batch * h * wd;
  dim3 grid(static_cast<unsigned>((m_total + BM - 1) / BM),
            static_cast<unsigned>((co + BN - 1) / BN));
  gn_silu_conv3x3_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
      batch, h, wd, c, co);
  return static_cast<int>(cudaGetLastError());
}
