// K2a: GroupNorm statistics folded into a per-(batch, channel) affine, for
// Hopper (sm_90a).
//
// Replaces pass 1 of the TPU fusion, gyre_tpu/ops/fused_norm_conv.py::
// gn_affine (the XLA reduction feeding the Pallas kernel _make_kernel):
// per-(batch, group) mean and variance of x [B, HW, C] (NHWC, bf16), folded
// with the GroupNorm scale and bias into a, b [B, C] f32 such that
// x*a + b == GroupNorm(x)*scale + bias. K2b applies that affine while it
// loads its conv input.
//
// What bounds it on the H100: one read of x (bytes), nothing else; at VAE
// 512^2 x 128 that is 64 MiB. What the design does about that: pass 1 splits
// the pixels of each image across many blocks so the card's bandwidth is
// used even at batch 1 (a block per (batch, group) would give 32 blocks),
// and reads x coalesced along channels. Pass 2 touches only B*C*splits
// partial sums.
//
// Cancellation: E[x^2] - E[x]^2 in f32 loses the variance when |mean| is
// large against the spread. Pass 1 therefore sums x - K_c, where K_c is the
// channel's value at pixel 0 (a sample of the data, so |mean - K_c| is of
// the order of the spread), and pass 2 recombines the shifted per-channel
// sums of each group exactly, in double:
//   sum_p (x - mu)^2 = S2_c + 2 (K_c - mu) S1_c + N (K_c - mu)^2.
// Both passes sum in a fixed order, so the result is the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

// part[b, s, c] = (sum_p (x - K_c), sum_p (x - K_c)^2) over the pixels of
// split s. grid (splits, batch).
__global__ void __launch_bounds__(kThreads)
    gn_partial_kernel(const __nv_bfloat16* __restrict__ x,
                      float2* __restrict__ part, int hw, int c,
                      int pix_per_split) {
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int p0 = s * pix_per_split;
  const int p1 = min(p0 + pix_per_split, hw);
  const __nv_bfloat16* xb = x + size_t(b) * hw * c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    const float shift = __bfloat162float(xb[ch]);
    float s1 = 0.f, s2 = 0.f;
    for (int p = p0; p < p1; ++p) {
      const float dv = __bfloat162float(xb[size_t(p) * c + ch]) - shift;
      s1 += dv;
      s2 += dv * dv;
    }
    part[(size_t(b) * gridDim.x + s) * c + ch] = make_float2(s1, s2);
  }
}

// One block per (group, batch): group mean and variance in double, then
// a = rsqrt(var + eps) * gamma, b = beta - mean * a. grid (groups, batch).
__global__ void __launch_bounds__(kThreads)
    gn_finalize_kernel(const __nv_bfloat16* __restrict__ x,
                       const float2* __restrict__ part,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       float* __restrict__ a_out, float* __restrict__ b_out,
                       int hw, int c, int groups, int splits, float eps) {
  extern __shared__ double sh[];  // [cpg] S1, [cpg] S2, [cpg] K
  __shared__ double mean_s, inv_s;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int cpg = c / groups;
  const __nv_bfloat16* xb = x + size_t(b) * hw * c;
  for (int i = threadIdx.x; i < cpg; i += kThreads) {
    const int ch = g * cpg + i;
    double t1 = 0.0, t2 = 0.0;
    for (int s = 0; s < splits; ++s) {
      const float2 pv = part[(size_t(b) * splits + s) * c + ch];
      t1 += pv.x;
      t2 += pv.y;
    }
    sh[i] = t1;
    sh[cpg + i] = t2;
    sh[2 * cpg + i] = __bfloat162float(xb[ch]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const double n = double(hw) * cpg;
    double tot = 0.0;
    for (int i = 0; i < cpg; ++i) tot += sh[i] + double(hw) * sh[2 * cpg + i];
    const double mean = tot / n;
    double m2 = 0.0;
    for (int i = 0; i < cpg; ++i) {
      const double dk = sh[2 * cpg + i] - mean;
      m2 += sh[cpg + i] + 2.0 * dk * sh[i] + double(hw) * dk * dk;
    }
    const double var = fmax(m2 / n, 0.0);
    mean_s = mean;
    inv_s = 1.0 / sqrt(var + double(eps));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cpg; i += kThreads) {
    const int ch = g * cpg + i;
    const float av = float(inv_s) * gamma[ch];
    a_out[size_t(b) * c + ch] = av;
    b_out[size_t(b) * c + ch] = beta[ch] - float(mean_s) * av;
  }
}

}  // namespace

// x [batch, hw, c] bf16; gamma, beta [c] f32; a, b [batch, c] f32;
// part: scratch of batch*splits*c float2, splits = ceil(hw / pix_per_split).
// Returns a cudaError_t as int.
extern "C" int gyre_gn_stats(const void* x, const void* gamma,
                             const void* beta, void* a, void* b, void* part,
                             int batch, int hw, int c, int groups,
                             int pix_per_split, float eps, void* stream) {
  if (batch <= 0 || hw <= 0 || c <= 0 || groups <= 0 || c % groups ||
      pix_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (hw + pix_per_split - 1) / pix_per_split;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* pp = static_cast<float2*>(part);
  gn_partial_kernel<<<dim3(splits, batch), kThreads, 0, s>>>(xp, pp, hw, c,
                                                             pix_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cpg = c / groups;
  gn_finalize_kernel<<<dim3(groups, batch), kThreads,
                       size_t(3) * cpg * sizeof(double), s>>>(
      xp, pp, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(a),
      static_cast<float*>(b), hw, c, groups, splits, eps);
  return static_cast<int>(cudaGetLastError());
}
