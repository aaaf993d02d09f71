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
// What bounds it on the H100: an implicit GEMM of M = B*H*W pixels, N = Co
// and K = 9*C, 2*M*N*K FLOP against the bytes of x, the [9C, Co] weight
// and the output. The UNet's 64..16 levels and the VAE are FLOP-bound; at
// the UNet's 8x8 level (M = 128) the 30-60 MB weight read bounds it, and
// the problem is having enough blocks to stream it.
//
// Design:
//  * A block computes a 128 pixel x 128 channel tile (masked past Co). Its
//    pixels are a spatial tile, 8 rows x 16 columns of one image (W >= 16)
//    or 8 x 8 of two images (W < 16, the 8x8 level), so that the 9 taps
//    read shifted windows of one halo'd tile.
//  * K runs over 64-channel chunks of C and, inside each, the 9 taps. Per
//    chunk the block loads the raw halo tile ((8+2) x (TW+2) pixels x 64
//    channels) once, applies the affine + SiLU once per element in place
//    (zeros outside the image, after the activation), and the 9 taps are
//    ldmatrix reads of that tile at shifted rows: the activation runs once
//    per input element per block, not once per tap.
//  * Operand loads are asynchronous (cp.async): a ring of 3-4 stages of
//    [64 x 128] weight tiles, and two halo buffers, so the next chunk's halo
//    and the next taps' weights load while the tensor cores work.
//  * The weight tile sits in shared memory in the layout wgmma reads
//    directly (N-major, 128-byte swizzle); the activated halo tile is
//    XOR-swizzled in 16-byte units and each warp ldmatrix-es its 16 rows
//    of a tap's shifted window into registers. Products are wgmma
//    m64n128k16 (sm_90a) with A from registers and B from shared memory,
//    two warpgroups of 64 rows each, f32 accumulators in registers. (A
//    from shared memory would need a uniform row stride, which the shifted
//    tap windows do not have: a tile row jumps by TW+2 halo pixels.)
//  * Split-K for small M: when the output tiles alone leave SMs idle, K is
//    split over up to 13 blocks of one thread-block cluster (grid z). Each
//    block leaves its f32 partial tile in its own shared memory; after a
//    cluster barrier, block r sums row slice r of the tile over all the
//    cluster's blocks through distributed shared memory, in rank order
//    (the same result every run), adds the bias and writes bf16. One
//    launch, no workspace.
//  Next steps: TMA for the weight tile with a producer warp and mbarrier
//  stage handoff in place of the per-tap block barrier.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <atomic>
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

constexpr int BM = 128;        // output pixels per block
constexpr int BKC = 64;        // input channels per chunk (128 B a pixel)
constexpr int TH = 8;          // tile rows
constexpr int kThreads = 256;  // 8 warps

template <int TW>
struct Tile {
  static constexpr int TB = BM / (TH * TW);  // images per tile (1 or 2)
  static constexpr int HW = TW + 2;          // halo row length
  static constexpr int HPI = (TH + 2) * HW;  // halo pixels per image
  static constexpr int HROWS = TB * HPI;     // halo pixels
  // the halo tile, then the chunk's affine a, b (64 f32 each) per image
  static constexpr int kAffOff = HROWS * BKC * 2;
  static constexpr int kHaloBytes = kAffOff + TB * 2 * BKC * 4;
};

constexpr int BN = 128;     // output channels per block
constexpr int NSTAGE = 3;   // weight stages in the ring
// one weight stage: 2 atoms of 64 k-rows x 128 bytes (64 columns each)
constexpr int kBBytes = BKC * BN * 2;
constexpr int kAtomBytes = BKC * 128;
constexpr int LDP = BN + 4;  // f32 partial-tile stride

template <int TW>
constexpr size_t smem_bytes() {
  constexpr size_t main_loop =
      size_t(NSTAGE) * kBBytes + 2 * size_t(Tile<TW>::kHaloBytes);
  constexpr size_t epilogue = size_t(BM) * LDP * 4;
  return main_loop > epilogue ? main_loop : epilogue;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// wgmma shared-memory descriptor of an N-major, 128-byte-swizzled B tile
// at `addr` (1024-byte aligned): 8-row k groups `sbo` bytes apart, 64-column
// atoms `lbo` bytes apart
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(lbo >> 4) << 16 |
         uint64_t(sbo >> 4) << 32 | uint64_t(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}


// d (64 x 128 per warpgroup, f32) += a (64 x 16 bf16 in registers, each
// warp its 16 rows in the mma.m16n8k16 A layout) * b (16 x 128 bf16 in
// shared memory, N-major, 128-byte swizzle, described by desc)
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// byte offset of 16-byte unit `chunk` of row `row` in a swizzled tile whose
// rows are `row_bytes` long: the unit index is XORed with the row's low 3
// bits, so 8 consecutive rows read at one logical unit hit 8 bank groups
__device__ __forceinline__ int swz(int row, int chunk, int row_bytes) {
  return row * row_bytes + ((chunk ^ (row & 7)) << 4);
}

template <int TW>
__global__ void __launch_bounds__(kThreads, 2)
    gn_silu_conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ aff_a,
                           const float* __restrict__ aff_b,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, int batch, int h,
                           int wd, int c, int co, int tiles_x, int tiles_y) {
  using T = Tile<TW>;
  extern __shared__ __align__(1024) unsigned char smem[];
  // weight stages first: the swizzle needs 1024-byte aligned tiles
  unsigned char* b_buf = smem;
  unsigned char* halo_buf[2] = {smem + NSTAGE * kBBytes,
                                smem + NSTAGE * kBBytes +
                                    T::kHaloBytes};

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // rows 16 warp .. 16 warp + 15 of the tile
  const int n0 = blockIdx.x * BN;
  int mt = blockIdx.y;
  const int x0 = (mt % tiles_x) * TW;
  mt /= tiles_x;
  const int y0 = (mt % tiles_y) * TH;
  const int b0 = (mt / tiles_y) * T::TB;

  // this block's share of K: 64-channel chunks [j0, j1), each with 9 taps
  const int chunks = (c + BKC - 1) / BKC;
  const int j0 = int(blockIdx.z) * chunks / int(gridDim.z);
  const int j1 = (int(blockIdx.z) + 1) * chunks / int(gridDim.z);
  const int n_it = (j1 - j0) * 9;

  // image coordinates of halo pixel hr; false outside the image
  auto halo_pixel = [&](int hr, int& bb, int& yy, int& xx) {
    const int ib = hr / T::HPI;
    const int rem = hr % T::HPI;
    bb = b0 + ib;
    yy = y0 + rem / T::HW - 1;
    xx = x0 + rem % T::HW - 1;
    return bb < batch && yy >= 0 && yy < h && xx >= 0 && xx < wd;
  };

  // raw x of chunk j's halo tile, and the chunk's a, b beside it; pixels
  // outside the image are not loaded (the activation writes their zeros).
  // A thread's 16-byte units all sit at channel group tid % 8, on halo
  // rows tid / 8 + 32 i.
  auto load_halo = [&](int j, unsigned char* buf) {
    if (tid < T::TB * 32) {  // image tid / 32: 16 units of a, then of b
      const int bb = b0 + tid / 32;
      const int u = tid % 32;
      const int ca = j * BKC + (u % 16) * 4;
      const bool ok = bb < batch && ca < c;
      const float* src = (u < 16 ? aff_a : aff_b) + size_t(bb) * c + ca;
      cp_async16(smem_u32(buf + T::kAffOff + tid * 16), ok ? src : aff_a,
                 ok);
    }
    const int ch = j * BKC + (tid & 7) * 8;
    if (ch >= c) return;
    for (int hr = tid >> 3; hr < T::HROWS; hr += kThreads / 8) {
      int bb, yy, xx;
      if (halo_pixel(hr, bb, yy, xx))
        cp_async16(smem_u32(buf + swz(hr, tid & 7, BKC * 2)),
                   x + ((size_t(bb) * h + yy) * wd + xx) * c + ch, true);
    }
  };

  // silu(x*a+b) in place, once per element, on part `part` of `parts` of
  // the tile (rows tid / 8 + 32 (part + parts i)); zeros outside the image
  // and past C (silu(b) != 0, so the SAME padding comes after the
  // activation)
  auto activate = [&](int j, unsigned char* buf, int part, int parts) {
    const int pk = tid & 7;  // this thread's physical 16-byte unit
    for (int hr = (tid >> 3) + part * (kThreads / 8); hr < T::HROWS;
         hr += parts * (kThreads / 8)) {
      const int ch = j * BKC + (pk ^ (hr & 7)) * 8;
      uint4* p = reinterpret_cast<uint4*>(buf + hr * (BKC * 2) + (pk << 4));
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      int bb, yy, xx;
      if (halo_pixel(hr, bb, yy, xx) && ch < c) {
        const uint4 raw = *p;
        const __nv_bfloat162* rv = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float4* ap = reinterpret_cast<const float4*>(
            buf + T::kAffOff + (bb - b0) * (2 * BKC * 4) + (ch - j * BKC) * 4);
        const float4* bp = ap + BKC / 4;
        const float4 a_lo = ap[0], a_hi = ap[1];
        const float4 b_lo = bp[0], b_hi = bp[1];
        const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                             a_hi.x, a_hi.y, a_hi.z, a_hi.w};
        const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                             b_hi.x, b_hi.y, b_hi.z, b_hi.w};
        __nv_bfloat162* act = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(rv[e]);
          const float t0 = fmaf(xf.x, av[2 * e], bv[2 * e]);
          const float t1 = fmaf(xf.y, av[2 * e + 1], bv[2 * e + 1]);
          act[e] = __floats2bfloat162_rn(__fdividef(t0, 1.f + __expf(-t0)),
                                         __fdividef(t1, 1.f + __expf(-t1)));
        }
      }
      *p = val;
    }
  };

  // weight rows (tap, chunk j) x columns n0..n0+BN; zeros past C and Co.
  // Column group u of row kr goes to atom u / 8, unit (u % 8) ^ (kr % 8). A
  // thread's units sit in one column group, on rows w_kr0 + kRowStep i,
  // which share their swizzle (kRowStep is a multiple of 8).
  constexpr int kUnits = BN / 8;
  constexpr int kRowStep = kThreads / kUnits;
  const int w_unit = tid % kUnits;
  const int w_kr0 = tid / kUnits;
  const bool w_col_ok = n0 + w_unit * 8 < co;
  const __nv_bfloat16* w_col = w + n0 + w_unit * 8;
  const int w_dst =
      (w_unit / 8) * kAtomBytes + swz(w_kr0, w_unit % 8, 128);
  auto load_w = [&](int j, int tap, unsigned char* buf) {
    const int cb = j * BKC;
#pragma unroll
    for (int i = 0; i < BKC / kRowStep; ++i) {
      const int ci = cb + w_kr0 + i * kRowStep;
      const bool ok = w_col_ok && ci < c;
      cp_async16(smem_u32(buf + w_dst + i * kRowStep * 128),
                 ok ? w_col + (size_t(tap) * c + ci) * co : w, ok);
    }
  };

  // Iteration it is (chunk q = it / 9, tap it % 9); issue(x) runs at
  // iteration x - (NSTAGE - 1) and commits one group. Chunk 0's halo goes
  // with x = 0; chunk q+1's with x = 9q + NSTAGE - 1, i.e. at the start of
  // chunk q, so its raw tile is in place from tap NSTAGE - 1 of chunk q on
  // and is activated in slices over the remaining taps of chunk q.
  const int n_chunks = j1 - j0;
  auto issue = [&](int x) {
    if (x < n_it) {
      const int q = x / 9;
      const int tap = x % 9;
      if (x == 0) load_halo(j0, halo_buf[0]);
      if (tap == NSTAGE - 1 && q + 1 < n_chunks)
        load_halo(j0 + q + 1, halo_buf[(q + 1) & 1]);
      load_w(j0 + q, tap, b_buf + (x % NSTAGE) * kBBytes);
    }
    cp_async_commit();
  };
  constexpr int kParts = 9 - (NSTAGE - 1);  // activation slices

  // ldmatrix row address: this lane's pixel row as a halo row at the
  // centre tap, and its k offset
  int a_row;
  {
    const int m = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int ib = m / (TH * TW);
    const int r = m % (TH * TW);
    a_row = ib * T::HPI + (r / TW + 1) * T::HW + r % TW + 1;
  }
  const int a_unit = lane >> 4;  // k 0-7 or 8-15

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) issue(s);

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<NSTAGE - 2>();
    // the weight tile is read by wgmma through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int q = it / 9;
    const int tap = it % 9;
    unsigned char* hb = halo_buf[q & 1];
    if (it == 0) {
      activate(j0, hb, 0, 1);
      __syncthreads();
    }
    issue(it + NSTAGE - 1);

    // this warp's 16 rows of the tap's shifted window, 4 k16 steps
    const int hr = a_row + (tap / 3 - 1) * T::HW + (tap % 3 - 1);
    const uint32_t hbase = smem_u32(hb);
    uint32_t af[BKC / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKC / 16; ++kk)
      ldsm_x4(hbase + swz(hr, kk * 2 + a_unit, BKC * 2), af[kk]);
    const uint32_t bbase = smem_u32(b_buf + (it % NSTAGE) * kBBytes);
    fence_regs<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKC / 16; ++kk)
      wgmma_n128(acc, af[kk],
                wgmma_desc(bbase + kk * 16 * 128, kAtomBytes, 8 * 128));
    wgmma_commit_and_wait();
    fence_regs<BN / 2>(acc);

    // a slice of the next chunk's activation, behind this tap's products:
    // its buffer is read only after the barrier that opens the next chunk
    if (tap >= NSTAGE - 1 && q + 1 < n_chunks)
      activate(j0 + q + 1, halo_buf[(q + 1) & 1], tap - (NSTAGE - 1),
               kParts);
  }
  // epilogue: f32 partial tile -> own shared memory; after the cluster
  // barrier block r reduces row slice r over the cluster in rank order
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  {
    // accumulator layout: n8 block jn holds rows lane/4 and lane/4 + 8 of
    // the warp's 16, columns 8 jn + 2 (lane % 4) + {0, 1}
    const int row = warp * 16 + (lane >> 2);
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int col = jn * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(part + row * LDP + col) =
          make_float2(acc[4 * jn], acc[4 * jn + 1]);
      *reinterpret_cast<float2*>(part + (row + 8) * LDP + col) =
          make_float2(acc[4 * jn + 2], acc[4 * jn + 3]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int split = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int row0 = rank * BM / split;  // this rank's rows [row0, row1)
  const int row1 = (rank + 1) * BM / split;
  for (int idx = tid; idx < (row1 - row0) * (BN / 4); idx += kThreads) {
    const int row = row0 + idx / (BN / 4);
    const int col = (idx % (BN / 4)) * 4;
    const int n = n0 + col;
    const int ib = row / (TH * TW);
    const int r = row % (TH * TW);
    const int bb = b0 + ib;
    const int yy = y0 + r / TW;
    const int xx = x0 + r % TW;
    if (bb >= batch || yy >= h || xx >= wd || n >= co) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < split; ++q) {
      const float* pq = cluster.map_shared_rank(part, q);
      const float4 v = *reinterpret_cast<const float4*>(pq + row * LDP + col);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float4 bv = *reinterpret_cast<const float4*>(bias + n);
    __align__(8) __nv_bfloat162 o[2] = {
        __floats2bfloat162_rn(s.x + bv.x, s.y + bv.y),
        __floats2bfloat162_rn(s.z + bv.z, s.w + bv.w)};
    *reinterpret_cast<uint2*>(out + ((size_t(bb) * h + yy) * wd + xx) * co +
                              n) = *reinterpret_cast<const uint2*>(o);
  }
  // no block may leave while another still reads its shared memory
  cluster.sync();
}

template <int TW>
cudaError_t launch(const __nv_bfloat16* x, const float* a, const float* b,
                   const __nv_bfloat16* w, const float* bias,
                   __nv_bfloat16* out, int batch, int h, int wd, int c,
                   int co, int m_tiles, int split, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<TW>();
  auto kernel = gn_silu_conv3x3_kernel<TW>;
  // the function's attributes, once per device (host time counts at the
  // small levels, where a launch takes tens of microseconds)
  static std::atomic<bool> configured[kMaxDevices];
  cudaError_t err = once_per_device(configured, [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e == cudaSuccess)  // clusters of more than 8 blocks
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  });
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned((co + BN - 1) / BN), unsigned(m_tiles),
                     unsigned(split));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = unsigned(split);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int tiles_x = (wd + TW - 1) / TW;
  const int tiles_y = (h + TH - 1) / TH;
  err = cudaLaunchKernelEx(&cfg, kernel, x, a, b, w, bias, out, batch, h, wd,
                           c, co, tiles_x, tiles_y);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
  // 8 x 16 pixel tiles of one image, or 8 x 8 of two below 16 columns
  const bool narrow = wd < 16;
  const int tw = narrow ? 8 : 16;
  const int tb = BM / (TH * tw);
  const long long m_tiles = 1LL * ((batch + tb - 1) / tb) *
                            ((h + TH - 1) / TH) * ((wd + tw - 1) / tw);
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // Split K over the cluster as measured best by kernel_sweep.py at
  // SD1.5's shapes on the H100 (PERF.md): cluster sizes of 5, 8 and 13
  // schedule well, other sizes (3, 6, 7, 9, 11, 12) up to 1.5x slower at
  // the same block count. Many tiles (the VAE's 128x128 and up): 1, or 2
  // for long K; 100-255 tiles (the UNet's 64x64, Co = 320 in 3 tiles of
  // 128): 2; 32-99 tiles (16x16, 32x32): 5; fewer (8x8): 8, or 13 for K of
  // more than 20 chunks.
  const int chunks = (c + BKC - 1) / BKC;
  const long long tiles = m_tiles * ((co + BN - 1) / BN);
  int split;
  if (tiles >= 256)
    split = chunks > 8 ? 2 : 1;
  else if (tiles >= 100)
    split = 2;
  else if (tiles >= 32)
    split = 5;
  else
    split = chunks > 20 ? 13 : 8;
  if (split > chunks) split = chunks;

  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* biasp = static_cast<const float*>(bias);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int mt = static_cast<int>(m_tiles);
  cudaError_t err;
  if (narrow)
    err = launch<8>(xp, ap, bp, wp, biasp, op, batch, h, wd, c, co, mt, split,
                    s);
  else
    err = launch<16>(xp, ap, bp, wp, biasp, op, batch, h, wd, c, co, mt,
                     split, s);
  return static_cast<int>(err);
}
