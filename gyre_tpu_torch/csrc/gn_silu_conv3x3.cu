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
// and the output. Every shape of the UNet and the VAE at their loaded
// batches is FLOP-bound; a batch-1 8x8 level is near the weight read.
//
// Design: a warp-specialised pipeline, one block of four warpgroups an SM.
//  * Tiles. A tile is 128 output pixels x BN output channels: 16 rows x 8
//    columns of one image, or 8 x 8 of two images, whichever overhangs the
//    image less (fewer tiles; ties go to 16 x 8). BN is 128, or 192 where
//    Co is 64 past a multiple of 128 (320 = 192 + 128). A tile runs
//    products only as wide as its 64-column atoms before Co (64, 128 or
//    192), so that no tensor-core time goes to whole atoms past Co.
//  * K runs over 64-channel chunks of C and, inside each, the 9 taps.
//  * Producers (warpgroups 0-1):
//    - warp 0, one lane: keeps TMA loads of the [64 x BN] weight tiles of
//      each (chunk, tap) in flight in a ring of NS stages. A 3-D tensor map
//      over the HWIO weight ([9][C][Co]) zero-fills rows past C and columns
//      past Co; its 128-byte swizzle is the layout wgmma reads (N-major,
//      64-column atoms).
//    - warps 1-7: load the raw halo tile of the next chunk ((TH+2) x 10
//      pixels x 64 channels an image) from device memory into registers,
//      apply the affine + SiLU once per element, zero the pixels outside
//      the image and the channels past C after the activation, and store
//      it in wgmma's K-major layout without swizzle (kPitch below), where
//      every tap's shifted window is one descriptor: no copies, no
//      ldmatrix. The tile is double-buffered: a chunk's loads go out before
//      the wait for its buffer, and it is written while the consumers run
//      the chunk before.
//  * Consumers (warpgroups 2-3): 64 output pixels each. They only wait on
//    barriers and issue wgmma (A and B from shared memory, f32
//    accumulators in registers). A tap is 4 products of k16; after
//    committing a tap the warpgroup waits until at most that tap and the
//    one before are in flight (wgmma.wait_group kInFlight = 2), so the
//    tensor cores never drain inside the K loop, and then releases the
//    stage of the tap two back.
//  * Barriers. Each weight stage has a full barrier (the TMA's bytes) and
//    an empty one (one arrival per consumer warpgroup once its products of
//    that stage retired); each halo buffer likewise (an arrival from every
//    halo thread after fence.proxy.async, which hands their generic stores
//    to wgmma's async proxy; one a consumer warpgroup once the chunk's last
//    products retired, kInFlight - 1 taps into the next chunk). Phases are
//    tracked by parity on both sides; nothing else synchronises the block
//    inside the loop.
//  * Persistent blocks: with split 1 the grid is min(tiles, SMs) and each
//    block walks tiles t, t + grid, ...; the producers run ahead into the
//    next tile while the consumers store this one's from registers (+ bias,
//    bf16), so one tile's epilogue overlaps the next one's loads.
//  * Split-K for few tiles: K is split over the blocks of a thread-block
//    cluster (grid z). Each leaves its f32 partial tile in its own shared
//    memory; after a cluster barrier, block r sums row slice r of the tile
//    over the cluster through distributed shared memory, in rank order (the
//    same result every run), adds the bias and writes bf16. One launch, no
//    workspace.
//  * The launch rule (choose_plan) depends only on (batch, h, w, c, co)
//    and the card's SM count: the tile shape and width, and the split that
//    prices best in rounds of blocks (kernel_sweep.py, PERF.md).
// What bounds each shape (kernel_sweep.py's ablations, PERF.md): the
// consumers' products, 60-75 % of the tensor cores' peak on their own; the
// producers' loads and activation add 10-25 % on top where a tile's chunks
// are few (the VAE's C = 128); wave quantization where tiles are few.

#include <cooperative_groups.h>
#include <cuda.h>
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

constexpr int BM = 128;  // output pixels per tile
constexpr int BKC = 64;  // input channels per chunk (128 B a pixel)
constexpr int NS = 6;    // weight stages
// tap groups a consumer warpgroup leaves in flight after each commit
constexpr int kInFlight = 2;
constexpr int kAtomBytes = BKC * 128;  // 64 k-rows x 64 columns of weight
// warpgroups: the producers (warp 0 the weights, the rest the halo), then
// the two consumers
constexpr int kProducerWGs = 2;
constexpr int kProducerWarps = 4 * kProducerWGs;
constexpr int kThreads = 128 * (kProducerWGs + 2);
constexpr int kHaloThreads = 32 * (kProducerWarps - 1);

// The activated halo tile, in the K-major layout of wgmma's A operand
// without swizzle: 8 x 16-byte core matrices (8 pixels of a halo row, one
// 8-channel unit) run along the row, a row's 10 pixels of unit k, then
// unit k + 1 kPitch bytes on (10 x 16 bytes, padded by one 16-byte slot so
// that a warp's stores of 4 pixels x 8 units hit 8 distinct bank quads),
// then the next halo row 8 kPitch bytes on. A tap's window for 8 output
// rows of 8 pixels is then a descriptor: 8-row groups 8 kPitch apart
// (SBO), k halves kPitch apart (LBO), starting at (row + dy, pixel dx).
constexpr int kPitch = 176;

template <int TH, int TW, int TB>
struct Tile {
  static_assert(TH * TW * TB == BM && TW == 8, "a tile is 128 pixels");
  static constexpr int HW = TW + 2;                // halo row length
  static constexpr int HPI = (TH + 2) * HW;        // halo pixels per image
  static constexpr int HP = TB * HPI;              // halo pixels
  static constexpr int kABytes = TB * (TH + 2) * 8 * kPitch;
  // a warpgroup's 64 pixels are 8 whole rows of one image: the second
  // consumer warpgroup's first halo row (the first's is 0)
  static constexpr int kRow1 = 64 / (TH * TW) * (TH + 2) + 64 % (TH * TW) / TW;
};

// shared memory of BN-channel tiles: the weight stages, two A buffers, the
// barriers; the split-K epilogue's f32 partial tile overlays the start
template <int TH, int TW, int TB, int BN>
struct Smem {
  using T = Tile<TH, TW, TB>;
  static constexpr int kStageBytes = BKC * BN * 2;
  static constexpr int kLDP = BN + 4;  // f32 partial-tile stride
  static constexpr int kA = NS * kStageBytes;
  static constexpr int kBar = kA + 2 * T::kABytes;
  static constexpr int kBytes = kBar + 8 * (2 * NS + 4);
  static_assert(BM * kLDP * 4 <= kBar, "the partial tile fits the buffers");
  static_assert(kBytes <= 232448, "at most 227 KB of shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// waits for the completion of the barrier's phase of parity ``parity``
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the weight tile (n, k, tap) of ``map`` into shared memory at ``dst``;
// its bytes complete a transaction on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int n, int k,
                                         int tap) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(n), "r"(k),
      "r"(tap)
      : "memory");
}

// the generic proxy's shared-memory stores, made visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a K-major A tile without swizzle at ``addr``: core
// matrices kPitch bytes apart along K, 8-row groups 8 kPitch apart
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(kPitch >> 4) << 16 |
         uint64_t((8 * kPitch) >> 4) << 32;
}

// wgmma descriptor of an N-major, 128-byte-swizzled B tile at ``addr``:
// 8-row k groups 1024 bytes apart, 64-column atoms kAtomBytes apart
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(kAtomBytes >> 4) << 16 |
         uint64_t(1024 >> 4) << 32 | uint64_t(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x N per warpgroup, f32) = a (64 x 16 bf16, K-major in shared
// memory, descriptor da) * b (16 x N bf16, N-major, db) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n192(float* d, uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// a tap's products: 4 k16 steps of the tile's width before Co (atoms of
// 64 columns), the A window from ``a``, the weight stage at ``b``
template <int BN>
__device__ __forceinline__ void tap_products(float* acc, uint32_t a,
                                             uint32_t b, int atoms,
                                             int first) {
  if constexpr (BN == 192) {
    if (atoms == 3) {
#pragma unroll
      for (int kk = 0; kk < BKC / 16; ++kk)
        wgmma_n192(acc, desc_a(a + kk * 2 * kPitch), desc_b(b + kk * 2048),
                   kk > 0 || !first);
      return;
    }
  }
  if (atoms == 2) {
#pragma unroll
    for (int kk = 0; kk < BKC / 16; ++kk)
      wgmma_n128(acc, desc_a(a + kk * 2 * kPitch), desc_b(b + kk * 2048),
                 kk > 0 || !first);
  } else {
#pragma unroll
    for (int kk = 0; kk < BKC / 16; ++kk)
      wgmma_n64(acc, desc_a(a + kk * 2 * kPitch), desc_b(b + kk * 2048),
                kk > 0 || !first);
  }
}

// 2^x and 1/x on the special-function unit, denormals flushed (no
// fix-up code around them): silu's e^-t and 1/(1 + e^-t) differ from the
// unflushed forms only where e^-t is denormal, and there 1 + e^-t rounds
// to 1 in f32 either way
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_ftz(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// silu(x * a + b) of 8 bf16 channels, in f32, rounded to bf16
__device__ __forceinline__ uint4 silu8(uint4 raw, const float* a,
                                       const float* b) {
  uint4 val;
  const __nv_bfloat162* rv = reinterpret_cast<const __nv_bfloat162*>(&raw);
  __nv_bfloat162* act = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 xf = __bfloat1622float2(rv[e]);
    const float t0 = fmaf(xf.x, a[2 * e], b[2 * e]);
    const float t1 = fmaf(xf.y, a[2 * e + 1], b[2 * e + 1]);
    act[e] = __floats2bfloat162_rn(t0 * rcp_ftz(1.f + exp2_ftz(-kLog2e * t0)),
                                   t1 * rcp_ftz(1.f + exp2_ftz(-kLog2e * t1)));
  }
  return val;
}

template <int TH, int TW, int TB, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    gn_silu_conv3x3_kernel(const __grid_constant__ CUtensorMap wmap,
                           const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ aff_a,
                           const float* __restrict__ aff_b,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, int batch, int h,
                           int wd, int c, int co, int tiles_x, int tiles_y,
                           int n_tiles, int tiles) {
  using T = Tile<TH, TW, TB>;
  using S = Smem<TH, TW, TB, BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t w_full = s0 + S::kBar;
  const uint32_t w_empty = w_full + 8 * NS;
  const uint32_t h_full = w_empty + 8 * NS;
  const uint32_t h_empty = h_full + 16;

  const int tid = threadIdx.x;
  // the warp index from lane 0: the compiler then knows it is uniform in a
  // warp, and takes the role branches as uniform (wgmma in a divergent
  // path is serialised)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, 2);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(h_full + 8 * b, kHaloThreads);
      mbar_init(h_empty + 8 * b, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's share of K: 64-channel chunks [j0, j1), each with 9 taps
  const int chunks = (c + BKC - 1) / BKC;
  const int split = int(gridDim.z);
  const int j0 = int(blockIdx.z) * chunks / split;
  const int j1 = (int(blockIdx.z) + 1) * chunks / split;

  // tile t: output channels from n0, pixels from (image b0, row y0, col x0)
  auto tile_at = [&](int t, int& n0, int& b0, int& y0, int& x0) {
    n0 = (t % n_tiles) * BN;
    int mt = t / n_tiles;
    x0 = (mt % tiles_x) * TW;
    mt /= tiles_x;
    y0 = (mt % tiles_y) * TH;
    b0 = (mt / tiles_y) * TB;
  };

  // one branch a role to the end of the kernel
  if (warp < kProducerWarps) {
    if (warp == 0) {
      // ---- weight producer: TMA loads of the (chunk, tap) tiles ----
      if (lane == 0) {
        int s = 0, ph = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          int n0, b0, y0, x0;
          tile_at(t, n0, b0, y0, x0);
          // atoms wholly past Co are neither loaded nor read
          const int boxes = min(BN, co - n0 + 63) / 64;
          for (int j = j0; j < j1; ++j) {
            for (int tap = 0; tap < 9; ++tap) {
              mbar_wait(w_empty + 8 * s, ph ^ 1);
              const uint32_t full = w_full + 8 * s;
              const uint32_t dst = s0 + s * S::kStageBytes;
              mbar_expect_tx(full, boxes * kAtomBytes);
              for (int bx = 0; bx < boxes; ++bx)
                tma_load(dst + bx * kAtomBytes, &wmap, full, n0 + 64 * bx,
                         j * BKC, tap);
              if (++s == NS) {
                s = 0;
                ph ^= 1;
              }
            }
          }
        }
      }
      __syncwarp();
    } else {
      // ---- halo producer: the activated halo tile of each chunk ----
      // This thread's units all sit at unit k, on halo pixels ht / 8 +
      // kStep i. Each chunk's loads go out before the wait for its A buffer,
      // straight into registers.
      const int ht = tid - 32;
      const int k = ht & 7;
      constexpr int kStep = kHaloThreads / 8;
      constexpr int kIters = (T::HP + kStep - 1) / kStep;
      int hq = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int n0, b0, y0, x0;
        tile_at(t, n0, b0, y0, x0);
        // per pixel of this thread: its index in x (-1 outside the image)
        // and its unit's offset in an A buffer
        int src[kIters], dst[kIters];
#pragma unroll
        for (int i = 0; i < kIters; ++i) {
          const int p = min((ht >> 3) + kStep * i, T::HP - 1);
          const int ib = TB == 1 ? 0 : p / T::HPI;
          const int rem = p - ib * T::HPI;
          const int hr = rem / T::HW;
          const int hc = rem % T::HW;
          const int bb = b0 + ib;
          const int yy = y0 + hr - 1;
          const int xx = x0 + hc - 1;
          src[i] = bb < batch && yy >= 0 && yy < h && xx >= 0 && xx < wd
                       ? (bb * h + yy) * wd + xx
                       : -1;
          dst[i] = ((ib * (TH + 2) + hr) * 8 + k) * kPitch + hc * 16;
        }
        for (int j = j0; j < j1; ++j, ++hq) {
          const int ch = j * BKC + k * 8;
          const bool ch_ok = ch < c;
          uint4 raw[kIters];
#pragma unroll
          for (int i = 0; i < kIters; ++i) {
            raw[i] = make_uint4(0u, 0u, 0u, 0u);
            if (ch_ok && src[i] >= 0)
              raw[i] = __ldg(reinterpret_cast<const uint4*>(
                  x + size_t(src[i]) * c + ch));
          }
          float av[TB][8], bv[TB][8];
#pragma unroll
          for (int ib = 0; ib < TB; ++ib) {
            float4 v[4] = {};
            if (ch_ok && b0 + ib < batch) {
              const size_t o = size_t(b0 + ib) * c + ch;
              const float4* ap = reinterpret_cast<const float4*>(aff_a + o);
              const float4* bp = reinterpret_cast<const float4*>(aff_b + o);
              v[0] = __ldg(ap);
              v[1] = __ldg(ap + 1);
              v[2] = __ldg(bp);
              v[3] = __ldg(bp + 1);
            }
            const float* f = reinterpret_cast<const float*>(v);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              av[ib][e] = f[e];
              bv[ib][e] = f[8 + e];
            }
          }
          mbar_wait(h_empty + 8 * (hq & 1), ((hq >> 1) & 1) ^ 1);
          unsigned char* abuf = smem + S::kA + (hq & 1) * T::kABytes;
          // silu(x * a + b) once per element, zeros outside the image and
          // past C (silu(b) != 0, so the SAME padding comes after the
          // activation)
#pragma unroll
          for (int i = 0; i < kIters; ++i) {
            if ((ht >> 3) + kStep * i >= T::HP) continue;
            const bool second = TB > 1 && (ht >> 3) + kStep * i >= T::HPI;
            float a8[8], b8[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              a8[e] = second ? av[TB - 1][e] : av[0][e];
              b8[e] = second ? bv[TB - 1][e] : bv[0][e];
            }
            const uint4 act = silu8(raw[i], a8, b8);
            *reinterpret_cast<uint4*>(abuf + dst[i]) =
                ch_ok && src[i] >= 0 ? act : make_uint4(0u, 0u, 0u, 0u);
          }
          fence_proxy_async();
          mbar_arrive(h_full + 8 * (hq & 1));
        }
      }
    }
    if (split > 1) {  // the consumers' two cluster barriers
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
  } else {
    // ---- consumers: wgmma only ----
    const int wg = (warp >> 2) - kProducerWGs;  // 64 output pixels from 64 wg
    const int wq = warp & 3;             // 16 of them from 16 wq
    const bool lead = (tid & 127) == 0;
    const uint32_t a_row = (wg == 0 ? 0 : T::kRow1) * 8 * kPitch;
    float acc[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
    int s = 0, ph = 0, hq = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int n0, b0, y0, x0;
      tile_at(t, n0, b0, y0, x0);
      // 64-column atoms of this tile before Co: the products' width
      const int atoms = min(BN, co - n0 + 63) / 64;
      int issued = 0;  // taps of this tile issued
      for (int j = j0; j < j1; ++j, ++hq) {
        const int hb = hq & 1;
        mbar_wait(h_full + 8 * hb, (hq >> 1) & 1);
        const uint32_t a_buf = s0 + S::kA + hb * T::kABytes + a_row;
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait(w_full + 8 * s, ph);
          // the tap's window: halo rows from dy, pixels from dx
          const uint32_t a = a_buf + (tap / 3) * 8 * kPitch + (tap % 3) * 16;
          const uint32_t b = s0 + s * S::kStageBytes;
          // the tile's first product overwrites the accumulators
          const int first = issued == 0;
          wgmma_fence();
          tap_products<BN>(acc, a, b, atoms, first);
          wgmma_commit();
          wgmma_wait<kInFlight>();
          // the tap kInFlight back has retired: its stage, and kInFlight - 1
          // taps into a chunk the chunk before's halo, go back to the
          // producers
          if (lead) {
            if (issued >= kInFlight)
              mbar_arrive(w_empty + 8 * ((s + NS - kInFlight) % NS));
            if (tap == kInFlight - 1 && j > j0)
              mbar_arrive(h_empty + 8 * (hb ^ 1));
          }
          ++issued;
          if (++s == NS) {
            s = 0;
            ph ^= 1;
          }
        }
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      if (lead) {
        for (int i = 1; i <= kInFlight; ++i)
          mbar_arrive(w_empty + 8 * ((s + NS - i) % NS));
        mbar_arrive(h_empty + 8 * ((hq - 1) & 1));
      }
      // accumulator layout: n8 block jn holds rows lane/4 and lane/4 + 8 of
      // the warp's 16, columns 8 jn + 2 (lane % 4) + {0, 1}
      if (split == 1) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = wg * 64 + wq * 16 + (lane >> 2) + 8 * half;
          const int ib = m / (TH * TW);
          const int r = m % (TH * TW);
          const int bb = b0 + ib;
          const int yy = y0 + r / TW;
          const int xx = x0 + r % TW;
          if (bb >= batch || yy >= h || xx >= wd) continue;
          __nv_bfloat16* row = out + ((size_t(bb) * h + yy) * wd + xx) * co;
#pragma unroll
          for (int jn = 0; jn < BN / 8; ++jn) {
            const int n = n0 + jn * 8 + (lane & 3) * 2;
            if (n < co) {
              const float2 bv = *reinterpret_cast<const float2*>(bias + n);
              *reinterpret_cast<__nv_bfloat162*>(row + n) =
                  __floats2bfloat162_rn(acc[4 * jn + 2 * half] + bv.x,
                                        acc[4 * jn + 2 * half + 1] + bv.y);
            }
          }
        }
      } else {
        // f32 partial tile -> own shared memory, once both consumer
        // warpgroups are done reading it
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        float* part = reinterpret_cast<float*>(smem);
        const int row = wg * 64 + wq * 16 + (lane >> 2);
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
          const int col = jn * 8 + (lane & 3) * 2;
          *reinterpret_cast<float2*>(part + row * S::kLDP + col) =
              make_float2(acc[4 * jn], acc[4 * jn + 1]);
          *reinterpret_cast<float2*>(part + (row + 8) * S::kLDP + col) =
              make_float2(acc[4 * jn + 2], acc[4 * jn + 3]);
        }
      }
    }
    if (split == 1) return;

    // split-K: after the cluster barrier block r reduces row slice r of the
    // tile over the cluster in rank order
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    int n0, b0, y0, x0;
    tile_at(blockIdx.x, n0, b0, y0, x0);
    const float* part = reinterpret_cast<const float*>(smem);
    const int rank = int(cluster.block_rank());
    const int row0 = rank * BM / split;  // this rank's rows [row0, row1)
    const int row1 = (rank + 1) * BM / split;
    const int first_thread = 32 * kProducerWarps;
    for (int idx = tid - first_thread; idx < (row1 - row0) * (BN / 4);
         idx += 256) {
      const int row = row0 + idx / (BN / 4);
      const int col = (idx % (BN / 4)) * 4;
      const int n = n0 + col;
      const int ib = row / (TH * TW);
      const int r = row % (TH * TW);
      const int bb = b0 + ib;
      const int yy = y0 + r / TW;
      const int xx = x0 + r % TW;
      if (bb >= batch || yy >= h || xx >= wd || n >= co) continue;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < split; ++q) {
        const float* pq = cluster.map_shared_rank(part, q);
        const float4 v =
            *reinterpret_cast<const float4*>(pq + row * S::kLDP + col);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      const float4 bv = *reinterpret_cast<const float4*>(bias + n);
      __align__(8) __nv_bfloat162 o[2] = {
          __floats2bfloat162_rn(sum.x + bv.x, sum.y + bv.y),
          __floats2bfloat162_rn(sum.z + bv.z, sum.w + bv.w)};
      *reinterpret_cast<uint2*>(out + ((size_t(bb) * h + yy) * wd + xx) * co +
                                n) = *reinterpret_cast<const uint2*>(o);
    }
    // no block may leave while another still reads its shared memory
    cluster.sync();
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda); null where the driver lacks it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the card's SM count, once per device
int sm_count() {
  static std::atomic<int> counts[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n == 0 &&
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
          cudaSuccess)
    counts[dev].store(n, std::memory_order_relaxed);
  return n;
}

// a launch: the tile shape (0: 16 rows x 8 pixels of one image, 1: 8 x 8
// of two), the tile's output channels and the blocks of a cluster that
// split K
struct Plan {
  int shape;
  int bn;
  int split;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

long long m_tiles(int shape, int batch, int h, int wd) {
  return shape == 0 ? batch * cdiv(h, 16) * cdiv(wd, 8)
                    : cdiv(batch, 2) * cdiv(h, 8) * cdiv(wd, 8);
}

// The launch rule. The tile shape that overhangs the image less (fewer
// tiles; ties go to 16 x 8). 192-channel tiles where Co is 64 past a
// multiple of 128 (320 = 192 + 128, 960 = 5 x 192), so that no tile runs
// 64-column products, else 128. The split: a block's cost, in taps of 64
// output columns, is its chunks' taps at a tile's average width plus
// kTapFixed each, plus kTileFixed taps a tile (the first chunk's loads,
// the epilogue) and kReduce taps for a split's reduction; blocks run in
// rounds of one an SM. Splits are powers of two (clusters of 3, 5, 6 or 7
// blocks of a whole SM each pack badly); 8 and 16 only in one round.
constexpr double kTapFixed = 0.5;
constexpr double kTileFixed = 9;
constexpr double kReduce = 6;

Plan choose_plan(int batch, int h, int wd, int c, int co, int sms) {
  const long long mt0 = m_tiles(0, batch, h, wd);
  const long long mt1 = m_tiles(1, batch, h, wd);
  const int shape = mt1 < mt0 ? 1 : 0;
  const int bn = co % 128 == 64 && co > 128 ? 192 : 128;
  const long long n_tiles = cdiv(co, bn);
  const long long tiles = (shape ? mt1 : mt0) * n_tiles;
  const long long chunks = cdiv(c, BKC);
  const double tap = double(cdiv(co, 64)) / n_tiles + kTapFixed;
  Plan best = {shape, bn, 1};
  double best_cost = 0;
  for (int split = 1; split <= 16 && split <= chunks; split *= 2) {
    if (split >= 8 && tiles * split > sms) break;
    const double per_block = (cdiv(chunks, split) * 9 + kTileFixed) * tap +
                             (split > 1 ? kReduce * tap : 0);
    const double cost = double(cdiv(tiles * split, sms)) * per_block;
    if (best_cost == 0 || cost < best_cost) {
      best = {shape, bn, split};
      best_cost = cost;
    }
  }
  return best;
}

template <int TH, int TW, int TB, int BN>
cudaError_t launch(const CUtensorMap& wmap, const __nv_bfloat16* x,
                   const float* a, const float* b, const float* bias,
                   __nv_bfloat16* out, int batch, int h, int wd, int c,
                   int co, int split, int sms, cudaStream_t stream) {
  constexpr int smem = Smem<TH, TW, TB, BN>::kBytes;
  auto kernel = gn_silu_conv3x3_kernel<TH, TW, TB, BN>;
  // the function's attributes, once per device (host time counts at the
  // small levels, where a launch takes tens of microseconds)
  static std::atomic<bool> configured[kMaxDevices];
  cudaError_t err = once_per_device(configured, [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)  // clusters of more than 8 blocks
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  });
  if (err != cudaSuccess) return err;
  const int tiles_x = int(cdiv(wd, TW));
  const int tiles_y = int(cdiv(h, TH));
  const int n_tiles = int(cdiv(co, BN));
  const long long tiles =
      cdiv(batch, TB) * tiles_y * tiles_x * (long long)n_tiles;
  if (tiles > (1LL << 30)) return cudaErrorInvalidValue;
  // split 1: persistent blocks, at most one an SM; else one a tile and
  // slice of K
  const long long grid = split > 1 ? tiles : (tiles < sms ? tiles : sms);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(grid), 1, unsigned(split));
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
  err = cudaLaunchKernelEx(&cfg, kernel, wmap, x, a, b, bias, out, batch, h,
                           wd, c, co, tiles_x, tiles_y, n_tiles, int(tiles));
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
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  // the weight as [9][C][Co]: one (tap, 64 channels, 64 columns) box a
  // load, rows past C and columns past Co read as zeros
  CUtensorMap wmap;
  const cuuint64_t dims[3] = {cuuint64_t(co), cuuint64_t(c), 9};
  const cuuint64_t strides[2] = {cuuint64_t(co) * 2, cuuint64_t(c) * co * 2};
  const cuuint32_t box[3] = {64, BKC, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  Plan plan = choose_plan(batch, h, wd, c, co, sms);
  const int chunks = int(cdiv(c, BKC));
  if (plan.split > chunks) plan.split = chunks;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  const auto* biasp = static_cast<const float*>(bias);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (plan.shape == 0)
    err = plan.bn == 192
              ? launch<16, 8, 1, 192>(wmap, xp, ap, bp, biasp, op, batch, h,
                                      wd, c, co, plan.split, sms, s)
              : launch<16, 8, 1, 128>(wmap, xp, ap, bp, biasp, op, batch, h,
                                      wd, c, co, plan.split, sms, s);
  else
    err = plan.bn == 192
              ? launch<8, 8, 2, 192>(wmap, xp, ap, bp, biasp, op, batch, h,
                                     wd, c, co, plan.split, sms, s)
              : launch<8, 8, 2, 128>(wmap, xp, ap, bp, biasp, op, batch, h,
                                     wd, c, co, plan.split, sms, s);
  return static_cast<int>(err);
}
