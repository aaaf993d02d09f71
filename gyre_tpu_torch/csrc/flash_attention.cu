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
// What bounds it on the H100: at SD1.5's self-attention shapes (T = 4096
// ... 256, d = 40..160) the two products are 4*T*T*d FLOP per (batch,
// head) against 8*T*d bytes of Q, K, V and O: compute-bound, with the
// softmax's exp2 (T*T per head) a second limit at d = 40. Cross-attention
// (Tk = 77) and the 8x8 level are small enough to be bound by launch and
// memory latency.
//
// Design (FlashAttention-2 on mma.sync):
//  * A block of 4 or 8 warps takes 64 or 128 query rows of one (batch,
//    head); each warp owns 16 rows. For head dims up to 160 the warp's Q
//    fragments are loaded once into registers for the whole KV loop.
//  * S = Q K^T goes to register accumulators (mma.sync m16n8k16 bf16, K
//    read with ldmatrix); the online softmax runs on those registers, with
//    quad shuffles for the row max; P is rounded to bf16 in registers and
//    is the A operand of P V directly (the accumulator layout of two n8
//    tiles is the A layout of one k16 step); V is read with ldmatrix.trans;
//    O is rescaled and accumulated in registers. Nothing but the K and V
//    tiles passes through shared memory.
//  * K and V tiles are double-buffered with cp.async: tile j+1 loads while
//    tile j is computed.
//  * Q, K, V and O are addressed through (batch, token, head) strides, so
//    the [B,T,H,D] tensors the models hold are read and written in place.
//  * Head dims pad to a multiple of 16 in shared memory only (zero-filled
//    by cp.async); rows past Tk (Tk = 77 at cross-attention) are zero and
//    their scores are masked to -inf before the running max.
//  * Head dims above 160 (the VAE's single-head d = 512): a 16 x 512 f32
//    accumulator per warp does not fit registers, so the head dim of O is
//    split over blocks (grid z, 128 columns each). Each block computes the
//    full S (Q read from shared memory with ldmatrix at every k step, K
//    tiles of 32 keys) and only its 128-column slice of P V.
//  mma.sync rather than wgmma: wgmma needs 64-row warpgroup tiles and its
//  B operand in shared memory in its own layout; moving to it (with TMA
//  producer warps) is the next step for this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <atomic>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
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

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit, one instruction (exp2f adds range
// handling the softmax does not need: its arguments are <= 0 or -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Strides {  // elements, per (batch, token, head)
  long long b, t, h;
};

// DP: head dim padded to 16 (the S product's depth); DV: columns of O this
// block computes (DP, or a 128-wide slice of it); BK: keys per KV tile;
// QREGS: Q fragments held in registers for the whole KV loop; NW: warps,
// 16 query rows each
template <int DP, int DV, int BK, bool QREGS, int NW>
struct Flash {
  static constexpr int kThreads = NW * 32;
  static constexpr int BQ = 16 * NW;  // query rows per block
  // shared-memory row strides in bytes: 16 bytes over the row, so that
  // stride / 16 is odd and 8 rows read by one ldmatrix hit 8 bank groups
  static constexpr int LDQ = DP * 2 + 16;
  static constexpr int LDV = DV * 2 + 16;
  static constexpr int kQBytes = BQ * LDQ;
  static constexpr int kKBytes = BK * LDQ;
  static constexpr int kVBytes = BK * LDV;
  static constexpr size_t kSmem = size_t(kQBytes) + 2 * (kKBytes + kVBytes);
  static constexpr int KD = DP / 16;  // k16 steps of Q K^T
  static constexpr int SN = BK / 8;   // n8 tiles of S
  static constexpr int ON = DV / 8;   // n8 tiles of O
};

template <int DP, int DV, int BK, bool QREGS, int NW>
__global__ void __launch_bounds__(NW * 32)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int heads, int tq,
                     int tk, int d, Strides qs, Strides ks, Strides vs,
                     Strides os, float scale_log2) {
  using F = Flash<DP, DV, BK, QREGS, NW>;
  constexpr int kThreads = F::kThreads;
  constexpr int BQ = F::BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sq = smem;
  unsigned char* sk[2] = {smem + F::kQBytes,
                          smem + F::kQBytes + F::kKBytes};
  unsigned char* sv[2] = {smem + F::kQBytes + 2 * F::kKBytes,
                          smem + F::kQBytes + 2 * F::kKBytes + F::kVBytes};

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int bi = blockIdx.y / heads;
  const int hi = blockIdx.y % heads;
  const int v0 = blockIdx.z * DV;  // first column of this block's O slice
  const __nv_bfloat16* qb = q + bi * qs.b + hi * qs.h;
  const __nv_bfloat16* kb = k + bi * ks.b + hi * ks.h;
  const __nv_bfloat16* vb = v + bi * vs.b + hi * vs.h;

  // Q tile: rows past tq and columns past d are zero
  for (int i = tid; i < BQ * (DP / 8); i += kThreads) {
    const int r = i / (DP / 8);
    const int c = (i % (DP / 8)) * 8;
    const bool ok = q0 + r < tq && c < d;
    cp_async16(smem_u32(sq + r * F::LDQ + c * 2),
               ok ? qb + (q0 + r) * qs.t + c : q, ok);
  }
  auto load_kv = [&](int k0, int stage) {
    for (int i = tid; i < BK * (DP / 8); i += kThreads) {
      const int r = i / (DP / 8);
      const int c = (i % (DP / 8)) * 8;
      const bool ok = k0 + r < tk && c < d;
      cp_async16(smem_u32(sk[stage] + r * F::LDQ + c * 2),
                 ok ? kb + (k0 + r) * ks.t + c : k, ok);
    }
    for (int i = tid; i < BK * (DV / 8); i += kThreads) {
      const int r = i / (DV / 8);
      const int c = (i % (DV / 8)) * 8;
      const bool ok = k0 + r < tk && v0 + c < d;
      cp_async16(smem_u32(sv[stage] + r * F::LDV + c * 2),
                 ok ? vb + (k0 + r) * vs.t + v0 + c : v, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // ldmatrix lane roles: A rows (Q), B rows (K keys, V keys)
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;
  const uint32_t sq_a = smem_u32(sq) + a_row * F::LDQ + a_col * 2;

  uint32_t qf[QREGS ? F::KD : 1][4];
  float acc_o[F::ON][4];
#pragma unroll
  for (int j = 0; j < F::ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_o[j][e] = 0.f;
  // running max (log2 domain) and this thread's partial sums, rows g, g+8
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = (tk + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_kv((j + 1) * BK, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (QREGS) {
      if (j == 0) {
#pragma unroll
        for (int kd = 0; kd < F::KD; ++kd) ldsm_x4(sq_a + kd * 32, qf[kd]);
      }
    }

    // S = Q K^T, 16 x BK per warp
    float s[F::SN][4];
#pragma unroll
    for (int n = 0; n < F::SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const uint32_t sk_b = smem_u32(sk[stage]) + k_row * F::LDQ + k_col * 2;
#pragma unroll
    for (int kd = 0; kd < F::KD; ++kd) {
      uint32_t a_tmp[4];
      const uint32_t* a = qf[QREGS ? kd : 0];
      if constexpr (!QREGS) {
        ldsm_x4(sq_a + kd * 32, a_tmp);
        a = a_tmp;
      }
#pragma unroll
      for (int n16 = 0; n16 < BK / 16; ++n16) {
        uint32_t r[4];
        ldsm_x4(sk_b + n16 * 16 * F::LDQ + kd * 32, r);
        mma_bf16(s[2 * n16], a, r[0], r[1]);
        mma_bf16(s[2 * n16 + 1], a, r[2], r[3]);
      }
    }

    // online softmax on the accumulators: thread holds rows g (e = 0, 1)
    // and g + 8 (e = 2, 3), columns 8n + 2(lane%4) + (e%2)
    const int k0 = j * BK;
    if (k0 + BK > tk) {
#pragma unroll
      for (int n = 0; n < F::SN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + n * 8 + (lane & 3) * 2 + (e & 1) >= tk) s[n][e] = -INFINITY;
    }
    float alpha[2];
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < F::SN; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * hrow], s[n][2 * hrow + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // every tile holds at least one key < tk, so m_new is finite
      const float m_new = fmaxf(m_run[hrow], mx * scale_log2);
      alpha[hrow] = ex2(m_run[hrow] - m_new);
      m_run[hrow] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < F::SN; ++n)
#pragma unroll
        for (int e = 2 * hrow; e < 2 * hrow + 2; ++e) {
          s[n][e] = ex2(fmaf(s[n][e], scale_log2, -m_new));
          sum += s[n][e];
        }
      l_run[hrow] = l_run[hrow] * alpha[hrow] + sum;
    }
#pragma unroll
    for (int n = 0; n < F::ON; ++n) {
      acc_o[n][0] *= alpha[0];
      acc_o[n][1] *= alpha[0];
      acc_o[n][2] *= alpha[1];
      acc_o[n][3] *= alpha[1];
    }

    // O += P V: two n8 tiles of P in bf16 are one k16 A fragment
    const uint32_t sv_b = smem_u32(sv[stage]) + v_row * F::LDV + v_col * 2;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n16 = 0; n16 < DV / 16; ++n16) {
        uint32_t r[4];
        ldsm_x4_t(sv_b + kk * 16 * F::LDV + n16 * 32, r);
        mma_bf16(acc_o[2 * n16], pa, r[0], r[1]);
        mma_bf16(acc_o[2 * n16 + 1], pa, r[2], r[3]);
      }
    }
    // the next iteration's loads overwrite this stage
    __syncthreads();
  }

  // O / l -> bf16, real rows and head-dim columns only, through o's strides
#pragma unroll
  for (int hrow = 0; hrow < 2; ++hrow) {
    float l = l_run[hrow];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-20f);
    const int row = q0 + warp * 16 + (lane >> 2) + hrow * 8;
    if (row >= tq) continue;
    __nv_bfloat16* orow = o + bi * os.b + row * os.t + hi * os.h;
#pragma unroll
    for (int n = 0; n < F::ON; ++n) {
      const int c = v0 + n * 8 + (lane & 3) * 2;
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            acc_o[n][2 * hrow] * inv, acc_o[n][2 * hrow + 1] * inv);
    }
  }
}

template <int DP, int DV, int BK, bool QREGS, int NW>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* o, int batch,
                   int heads, int tq, int tk, int d, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale_log2,
                   cudaStream_t stream) {
  using F = Flash<DP, DV, BK, QREGS, NW>;
  auto kernel = flash_fwd_kernel<DP, DV, BK, QREGS, NW>;
  // the shared-memory limit, once per device
  static std::atomic<bool> configured[kMaxDevices];
  cudaError_t err = once_per_device(configured, [&] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(F::kSmem));
  });
  if (err != cudaSuccess) return err;
  dim3 grid((tq + F::BQ - 1) / F::BQ, batch * heads, DP / DV);
  kernel<<<grid, F::kThreads, F::kSmem, stream>>>(q, k, v, o, heads, tq, tk, d,
                                                 qs, ks, vs, os, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q [batch, tq, heads, d], k and v [batch, tk, heads, d], o like q, each
// addressed through its (batch, token, head) strides in elements; the head
// dim is unit-stride. bf16, d a multiple of 8 and at most 512, pointers and
// strides 16-byte aligned. Returns a cudaError_t as int.
extern "C" int gyre_flash_attention(
    const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int tq, int tk, int d, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, float scale, void* stream) {
  // batch*heads is the grid's y dimension (at most 65535)
  if (batch <= 0 || heads <= 0 || 1LL * batch * heads > 65535 || tq <= 0 ||
      tk <= 0 || d <= 0 || d % 8 || d > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_st, o_sh};
  const float sl2 = scale * 1.4426950408889634f;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto s = static_cast<cudaStream_t>(stream);
#define GYRE_FLASH(DP, DV, BK, QREGS, NW)                                    \
  launch<DP, DV, BK, QREGS, NW>(qp, kp, vp, op, batch, heads, tq, tk, d, qs, \
                                ks, vs, os, sl2, s)
  // warps and KV tile per head dim: from a sweep of (4 | 8 warps) x
  // (two tile lengths) at the SD1.5 shapes on the H100 (PERF.md)
  cudaError_t err;
  if (d <= 16)
    err = GYRE_FLASH(16, 16, 64, true, 8);
  else if (d <= 32)
    err = GYRE_FLASH(32, 32, 64, true, 8);
  else if (d <= 48)
    err = GYRE_FLASH(48, 48, 64, true, 8);
  else if (d <= 64)
    err = GYRE_FLASH(64, 64, 64, true, 8);
  else if (d <= 80)
    err = GYRE_FLASH(80, 80, 128, true, 8);
  else if (d <= 128)
    err = GYRE_FLASH(128, 128, 64, true, 4);
  else if (d <= 160)
    err = GYRE_FLASH(160, 160, 64, true, 4);
  else if (d <= 256)
    err = GYRE_FLASH(256, 128, 32, false, 4);
  else
    err = GYRE_FLASH(512, 128, 32, false, 4);
#undef GYRE_FLASH
  return static_cast<int>(err);
}
