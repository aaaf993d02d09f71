// K2a: GroupNorm statistics folded into a per-(batch, channel) affine, for
// Hopper (sm_90a).
//
// Pairs with pass 1 of the TPU fusion, gyre_tpu/ops/fused_norm_conv.py:42
// gn_affine, the XLA reduction that feeds the Pallas kernel _make_kernel
// (:63): per-(batch, group) mean and variance of x [B, HW, C] (NHWC, bf16),
// folded with the GroupNorm scale and bias into a, b [B, C] f32 such that
// x*a + b == GroupNorm(x)*scale + bias. K2b applies that affine while it
// loads its conv input.
//
// What bounds it on the H100: one read of x, 2*B*HW*C bytes. At the VAE's
// 256^2 and 512^2 shapes that is 32-128 MiB, 10-40 us at 3.35 TB/s: there
// the whole card's bandwidth decides. At the UNet's shapes the bytes take
// 0.1-4.7 us, and the floor of one launch decides.
//
// Design, one launch per call, no workspace, no atomics:
//  * A thread-block cluster owns one batch row's slab of whole groups (grid
//    (cluster, slabs, batch)); its blocks split the image's pixels into
//    contiguous ranges. Narrow slabs and large blocks give the large shapes
//    enough loads in flight to fill the card; at the small ones a short
//    cluster keeps the launch to a few microseconds. The wrapper
//    (ops/fused_norm_conv.py) picks slabs, cluster size and block size per
//    shape, as measured (kernel_sweep.py).
//  * Each thread reads 8 channels (16 bytes) per load, neighbouring threads
//    neighbouring vectors of a pixel's slab, then the next pixel rows, with
//    kUnroll independent loads in flight. Default caching: K2b reads the
//    same x next, and at most shapes it fits in the 50 MB L2.
//  * Sums are taken per channel (a vector straddles two groups when a group
//    has 10 or 30 channels) and combined per group only at the end.
//  * Reduction: per thread in f32 registers; over the block's threads in
//    shared memory, in double. Group g of the slab belongs to rank
//    g % cluster: every block pushes its sums of g's channels into that
//    rank's shared memory (distributed shared memory stores), and after one
//    cluster barrier the owner adds them in rank order and finishes the
//    group, a warp per group, lanes over its channels, combined by a fixed
//    shuffle tree. No block reads another's shared memory, so none waits
//    for the others before it exits, and the barrier's first half (every
//    block has started, so its shared memory may be written) is signalled
//    at the kernel's start and waited for only before the first push.
//    Every order is fixed: the same input gives the same bits on every run.
//
// Cancellation: E[x^2] - E[x]^2 in f32 loses the variance when |mean| is
// large against the spread. Each thread therefore sums x - K_c, where K_c
// is the channel's value at pixel 0 of the image (a sample of the data, so
// |mean - K_c| is of the order of the spread; every block reads it
// itself), and the group's statistics are recombined exactly, in double:
//   sum_p (x - mu)^2 = S2_c + 2 (K_c - mu) S1_c + N (K_c - mu)^2.
// Only the last step, rsqrt(var + eps), is in f32, as in the plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <atomic>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Applies ``set`` (a kernel's function attributes) once per device, from
// any thread: one atomic flag a device. Threads that race on a device's
// first launch each apply the same attributes, which cudaFuncSetAttribute
// allows (a device pool launches from a host thread a device).
constexpr int kMaxDevices = 64;

template <typename Set>
cudaError_t once_per_device(std::atomic<bool>* done, Set set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = set();
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

constexpr int kMaxSlab = 512;     // channels of a slab (64 vectors)
constexpr int kMaxCluster = 16;   // non-portable above 8
constexpr int kMaxInbox = 2048;   // (rank, owned channel) sums a block holds

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the 8 bf16 channels of a 16-byte vector as f32 (a bf16 is the top half
// of an f32; the lower address is the lower half of each word)
__device__ __forceinline__ void unpack(const uint4& raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// s1 += x - k, s2 += (x - k)^2 for the 8 channels of one vector
__device__ __forceinline__ void accumulate(const uint4& raw, const float* k,
                                           float* s1, float* s2) {
  float f[8];
  unpack(raw, f);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float d = f[e] - k[e];
    s1[e] += d;
    s2[e] = fmaf(d, d, s2[e]);
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (cluster, slabs, batch), cluster (cluster, 1, 1). slab: channels per
// slab, a multiple of 8 and of cpg, at most kMaxSlab. Dynamic shared
// memory: red, kThreads * 8 float2, then the inbox, cluster * owned
// double2, owned = ceil(groups of a slab / cluster) * cpg.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const uint4* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ a_out,
                    float* __restrict__ b_out, int hw, int c, int cpg,
                    int slab, double inv_n, float eps) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kUnroll = kThreads >= 1024 ? 4 : 8;  // 64 registers at 1024
  constexpr int kPart = kThreads > kMaxSlab ? kThreads : kMaxSlab;
  extern __shared__ __align__(16) unsigned char smem[];
  // (S1, S2) per row r of threads and slot e * nvec + vi (channel 8 vi + e:
  // neighbouring threads store to neighbouring words)
  float2* red = reinterpret_cast<float2*>(smem);
  double2* inbox = reinterpret_cast<double2*>(smem + kThreads * 8 *
                                              sizeof(float2));
  __shared__ double2 part[kPart];  // the block's sums in two stages (by
                                   // slot), then the cluster's sums of
                                   // owned channels (by channel)
  __shared__ float shift[kMaxSlab];  // K_c
  __shared__ float2 affine[kMaxSlab];  // (gamma, beta), loaded early

  // every block has started once all have arrived: only then may a block
  // write another's shared memory
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int ncl = int(cluster.num_blocks());
  const int c0 = int(blockIdx.y) * slab;
  const int bi = int(blockIdx.z);
  const int tid = int(threadIdx.x);
  const int nvec = slab / 8;         // vectors of a pixel's slab
  const int rows = kThreads / nvec;  // pixel rows a block reads at once
  const int vi = tid % nvec;
  const int r = tid / nvec;
  const int cv = c / 8;              // vectors of a pixel
  for (int ch = tid; ch < slab; ch += kThreads)
    affine[ch] = make_float2(__ldg(gamma + c0 + ch), __ldg(beta + c0 + ch));

  if (r < rows) {
    const uint4* xv = x + size_t(bi) * hw * cv + c0 / 8 + vi;
    float k[8], s1[8], s2[8];
    unpack(__ldg(xv), k);
#pragma unroll
    for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.f;
    if (r == 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) shift[vi * 8 + e] = k[e];
    }
    // this rank's pixels [p0, p1), row r of every pass; the loads of a
    // pass are issued together, the last pass's under a predicate (at the
    // small shapes a thread has only a few)
    const int p0 = int(unsigned(rank) * unsigned(hw) / unsigned(ncl));
    const int p1 = int(unsigned(rank + 1) * unsigned(hw) / unsigned(ncl));
    for (int p = p0 + r; p < p1; p += kUnroll * rows) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p + u * rows < p1) v[u] = __ldg(xv + size_t(p + u * rows) * cv);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p + u * rows < p1) accumulate(v[u], k, s1, s2);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      red[r * slab + e * nvec + vi] = make_float2(s1[e], s2[e]);
  }
  __syncthreads();

  // over the block's rows: lanes l < lanes of a slot sum rows l,
  // l + lanes, ... in double, then one thread per slot sums the lanes
  const int lanes = slab < kThreads ? kThreads / slab : 1;
  for (int i = tid; i < lanes * slab; i += kThreads) {
    const int s = i % slab;
    double t1 = 0.0, t2 = 0.0;
#pragma unroll 4
    for (int rr = i / slab; rr < rows; rr += lanes) {
      const float2 v = red[rr * slab + s];
      t1 += v.x;
      t2 += v.y;
    }
    part[i] = make_double2(t1, t2);
  }
  __syncthreads();
  // push the block's sums of channel ch (group g) to g's owner, rank
  // g % ncl, at its place for (this rank, g / ncl)
  const int groups = slab / cpg;
  const int owned = (groups + ncl - 1) / ncl * cpg;
  cluster_wait();
  for (int s = tid; s < slab; s += kThreads) {
    double t1 = 0.0, t2 = 0.0;
    for (int l = 0; l < lanes; ++l) {
      const double2 v = part[l * slab + s];
      t1 += v.x;
      t2 += v.y;
    }
    const int ch = s % nvec * 8 + s / nvec;
    const int g = ch / cpg;
    double2* dst = cluster.map_shared_rank(inbox, g % ncl);
    dst[rank * owned + (g / ncl) * cpg + ch % cpg] = make_double2(t1, t2);
  }
  cluster_arrive_release();
  cluster_wait();

  // finish the owned groups g = rank + ncl j: the sums of every rank in
  // rank order, then the group's mean and M2 over its channels
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const double n_pix = double(hw);
  for (int j = warp; rank + ncl * j < groups; j += kWarps) {
    const int g = rank + ncl * j;
    double tot = 0.0;
    for (int i = lane; i < cpg; i += 32) {
      double t1 = 0.0, t2 = 0.0;
      for (int q = 0; q < ncl; ++q) {
        const double2 v = inbox[q * owned + j * cpg + i];
        t1 += v.x;
        t2 += v.y;
      }
      part[g * cpg + i] = make_double2(t1, t2);
      tot += t1 + n_pix * shift[g * cpg + i];
    }
    const double mean = warp_sum(tot) * inv_n;
    double m2 = 0.0;
    for (int i = lane; i < cpg; i += 32) {
      const double2 v = part[g * cpg + i];
      const double dk = double(shift[g * cpg + i]) - mean;
      m2 += v.y + 2.0 * dk * v.x + n_pix * dk * dk;
    }
    const float var = float(fmax(warp_sum(m2) * inv_n, 0.0));
    const float inv = rsqrtf(var + eps);
    for (int i = lane; i < cpg; i += 32) {
      const float2 gb = affine[g * cpg + i];
      const size_t o = size_t(bi) * c + c0 + g * cpg + i;
      const float av = inv * gb.x;
      a_out[o] = av;
      b_out[o] = gb.y - float(mean) * av;
    }
  }
}

template <int kThreads>
cudaError_t launch(const uint4* x, const float* gamma, const float* beta,
                   float* a, float* b, int batch, int hw, int c, int cpg,
                   int slabs, int cluster, float eps, cudaStream_t stream) {
  constexpr size_t kRed = size_t(kThreads) * 8 * sizeof(float2);
  auto kernel = gn_stats_kernel<kThreads>;
  // the function's attributes, once per device (host time counts here: most
  // launches take a few microseconds on the card)
  static std::atomic<bool> configured[kMaxDevices];
  cudaError_t err = once_per_device(configured, [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(kRed + kMaxInbox * sizeof(double2)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  });
  if (err != cudaSuccess) return err;
  const int slab = c / slabs;
  const int owned = (slab / cpg + cluster - 1) / cluster * cpg;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(cluster), unsigned(slabs), unsigned(batch));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kRed + size_t(cluster) * owned * sizeof(double2);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, gamma, beta, a, b, hw, c, cpg,
                           slab, 1.0 / (double(hw) * cpg), eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x [batch, hw, c] bf16; gamma, beta [c] f32; ab [2, batch, c] f32 (a, then
// b). The channels split into `slabs` slabs of whole groups, c / slabs
// channels each (a multiple of 8, at most 512); each slab of each batch row
// is one cluster of `cluster` blocks (1-16) of `threads` threads (256, 512
// or 1024), and a cluster may own at most 2048 (rank, channel) sums; hw is
// at most 2^26. All pointers 16-byte aligned. Returns a cudaError_t as int.
extern "C" int gyre_gn_stats(const void* x, const void* gamma,
                             const void* beta, void* ab, int batch, int hw,
                             int c, int groups, int slabs, int cluster,
                             int threads, float eps, void* stream) {
  if (batch <= 0 || batch > 65535 || hw <= 0 || hw > (1 << 26) || c <= 0 ||
      groups <= 0 || c % groups || slabs <= 0 || slabs > 65535 ||
      groups % slabs || cluster <= 0 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slab = c / slabs;
  const int cpg = c / groups;
  if (slab % 8 || slab > kMaxSlab ||
      cluster * ((slab / cpg + cluster - 1) / cluster) * cpg > kMaxInbox)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const uint4*>(x);
  const auto* gp = static_cast<const float*>(gamma);
  const auto* bp = static_cast<const float*>(beta);
  auto* a = static_cast<float*>(ab);
  auto* b = a + size_t(batch) * c;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (threads) {
    case 256:
      err = launch<256>(xp, gp, bp, a, b, batch, hw, c, cpg, slabs, cluster,
                        eps, s);
      break;
    case 512:
      err = launch<512>(xp, gp, bp, a, b, batch, hw, c, cpg, slabs, cluster,
                        eps, s);
      break;
    case 1024:
      err = launch<1024>(xp, gp, bp, a, b, batch, hw, c, cpg, slabs, cluster,
                         eps, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
