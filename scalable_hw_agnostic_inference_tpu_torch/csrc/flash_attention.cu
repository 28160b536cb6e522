// Flash attention for Hopper (kernel B1): softmax(q k^T * scale) v with an
// online softmax, GQA by kv head h / (H / Hkv), optional causal masking and
// per-row key lengths.
//
// Replaces: scalable_hw_agnostic_inference_tpu/ops/pallas/flash_attention.py
// flash_attention (kernel _flash_kernel, pallas_call at :196).
//
// Contract (the same as the TPU kernel's):
//   q [B, T, H, D] bf16, k/v [B, S, Hkv, D] bf16, lengths [B] int32 or null
//   -> out [B, T, H, D] bf16. Query i sits at key position S - T + i (the
//   causal offset); keys at or past lengths[b] are masked and their tiles
//   skipped; a row with no live key returns zeros.
//
// What bounds it on the H100: at prefill shapes (T = S >= 512, D = 128) the
// work is about T / 2 multiply-adds per byte read, far above the card's ~295
// operations per byte, so the tensor cores bound it, and only wgmma reaches
// their full rate. The design (one CTA per query tile of one (b, h)):
//   - a producer warp starts TMA loads: the query tile once, then K and V
//     tiles of BK keys into a ring of STAGES shared-memory stages, each
//     stage guarded by a "full" mbarrier (TMA bytes landed) and an "empty"
//     one (every consumer thread done reading it);
//   - NC consumer warpgroups, 64 query rows each, run S = Q K^T as wgmma
//     with both operands in shared memory and S in registers; the online
//     softmax runs in registers, a row's max across the 4 threads that hold
//     it; P is rounded to bf16 in registers and fed as wgmma's register A
//     operand for O += P V, V read MN-major from shared memory; O stays in
//     registers until the epilogue writes it straight to global memory;
//   - the tensor maps are rank 4, [B, T, H, D] for Q and [B, S, Hkv, D] for
//     K/V, so a box past T or S is zero-filled by the hardware and never
//     reads the next batch row; 128-byte swizzled boxes of 64 values;
//   - the key walk stops at min(length, S - T + q0 + BQ), and a warpgroup
//     skips the products of a tile wholly above its own diagonal; only a
//     tile that crosses the diagonal or the length applies the mask, which
//     is per element (the diagonal may fall anywhere: the static
//     continuation calls with S - T a multiple of 16, not of a tile);
//   - masked scores are -inf and a row whose running max is still -inf
//     exponentiates against 0, so no exp(-inf - -inf) forms, and a row with
//     no live key ends with l = 0 and writes zeros.
// Numerics: 64-key tiles and p = exp(s * scale - m) in fp32 (__expf), the
// choices of the WMMA kernel this one replaced, so the softmax rescales at
// the same keys and P is rounded to bf16 from the same values: the redesign
// changes the order of the products' fp32 sums, not where the kernel rounds.
// Registers: O is D / 2 floats a thread; D >= 192 runs one consumer
// warpgroup (64 query rows), so a thread may hold up to 255 registers, and
// no instantiation spills without setmaxnreg. The tensor maps are encoded
// on the host at every call (three cuTensorMapEncodeTiled calls, some
// microseconds, not cached).
// Left for later work: K and V on separate barriers, so S = Q K^T starts
// before V lands; overlapping one tile's softmax with the next tile's
// products (ping-pong between the two warpgroups); a TMA store epilogue.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

using namespace shai_sm90;

namespace {

constexpr int WG = 128;       // threads in a warpgroup
constexpr int WG_ROWS = 64;   // query rows per consumer warpgroup
constexpr int STAGES = 2;     // K/V ring depth
constexpr int CHUNK = 64;     // bf16 values per 128-byte swizzled row

template <int D>
struct Cfg {
  static constexpr int NC = D <= 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int BQ = NC * WG_ROWS;      // query rows per CTA
  static constexpr int BK = 64;                 // keys per K/V tile
  static constexpr int CH = D / CHUNK;         // 64-wide column chunks
  static constexpr int THREADS = NC * WG + 32; // + one producer warp
  static constexpr uint32_t Q_CHUNK = WG_ROWS * CHUNK * 2;  // bytes
  static constexpr uint32_t KV_CHUNK = BK * CHUNK * 2;
  static constexpr uint32_t Q_BYTES = NC * CH * Q_CHUNK;
  static constexpr uint32_t KV_BYTES = CH * KV_CHUNK;  // one K or V tile
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + Q_BYTES;
  static constexpr size_t v_off = k_off + size_t(STAGES) * KV_BYTES;
  static constexpr size_t bar_off = v_off + size_t(STAGES) * KV_BYTES;
  // barriers: q_full, full[STAGES], empty[STAGES]; 1024 bytes of slack to
  // align the base to a swizzle atom
  static constexpr size_t bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_kernel(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const int* __restrict__ lengths,
             __nv_bfloat16* __restrict__ out, int T, int S, int H, int Hkv,
             float scale, int causal) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem + C::q_off;
  unsigned char* ks = smem + C::k_off;
  unsigned char* vs = smem + C::v_off;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = blockIdx.x * C::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int q_offset = S - T;

  int kv_len = S;
  if (lengths != nullptr) kv_len = min(kv_len, max(lengths[b], 0));
  int bound = kv_len;
  if (causal) bound = min(bound, q_offset + q0 + C::BQ);
  const int n_tiles = bound > 0 ? (bound + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NC * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == C::NC) {
    // producer warp: one lane starts every TMA load
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int g = 0; g < C::NC; ++g) {
        for (int c = 0; c < C::CH; ++c) {
          tma_load_4d(qs + (g * C::CH + c) * C::Q_CHUNK, &tm_q, q_full,
                      c * CHUNK, h, q0 + g * WG_ROWS, b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        for (int c = 0; c < C::CH; ++c) {
          tma_load_4d(ks + s * C::KV_BYTES + c * C::KV_CHUNK, &tm_k,
                      &full[s], c * CHUNK, kvh, j * BK, b);
          tma_load_4d(vs + s * C::KV_BYTES + c * C::KV_CHUNK, &tm_v,
                      &full[s], c * CHUNK, kvh, j * BK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg ... + 63; this thread
  // holds rows r0 and r0 + 8 of them, columns 8 i + 2 (lane % 4) + {0, 1}
  const int tid = threadIdx.x % WG;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;
  const int row_base = q0 + wg * WG_ROWS;
  const int first_pos = q_offset + row_base;  // this warpgroup's diagonal
  const int qpos0 = first_pos + r0;
  const int qpos1 = qpos0 + 8;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const unsigned char* qw = qs + wg * C::CH * C::Q_CHUNK;
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const int k0 = j * BK;
    if (!causal || k0 <= first_pos + WG_ROWS - 1) {
      const unsigned char* kt = ks + s * C::KV_BYTES;
      const unsigned char* vt = vs + s * C::KV_BYTES;
      float sc[BK / 2];
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;  // 16 values = 32 bytes
        Ss<BK>::mma(sc,
                    desc_sw128(qw + (kk / 4) * C::Q_CHUNK + off, 16),
                    desc_sw128(kt + (kk / 4) * C::KV_CHUNK + off, 16),
                    kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale, mask where the tile crosses the length or
      // this warpgroup's diagonal, row max over the 4 threads of a row
      const bool masked = k0 + BK > kv_len ||
                          (causal && k0 + BK - 1 > first_pos);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = sc[4 * i + e] * scale;
          float x1 = sc[4 * i + 2 + e] * scale;
          if (masked) {
            const int kpos = k0 + 8 * i + 2 * (lane % 4) + e;
            const bool in = kpos < kv_len;
            if (!in || (causal && kpos > qpos0)) x0 = -INFINITY;
            if (!in || (causal && kpos > qpos1)) x1 = -INFINITY;
          }
          sc[4 * i + e] = x0;
          sc[4 * i + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
      }
      const float n0 = fmaxf(m0, mx0);
      const float n1 = fmaxf(m1, mx1);
      // a row with no live key so far exponentiates against 0: every term
      // is exp(-inf) = 0, and no -inf - -inf is formed
      const float u0 = n0 == -INFINITY ? 0.f : n0;
      const float u1 = n1 == -INFINITY ? 0.f : n1;
      const float c0 = __expf(m0 - u0);
      const float c1 = __expf(m1 - u1);
      m0 = n0;
      m1 = n1;
      float s0 = 0.f, s1 = 0.f;
      uint32_t pf[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const float p00 = __expf(sc[4 * i] - u0);
        const float p01 = __expf(sc[4 * i + 1] - u0);
        const float p10 = __expf(sc[4 * i + 2] - u1);
        const float p11 = __expf(sc[4 * i + 3] - u1);
        s0 += p00 + p01;
        s1 += p10 + p11;
        // accumulator columns 16 kk .. 16 kk + 15 are wgmma's A fragment
        pf[i / 2][(i % 2) * 2] = pack_bf16(p00, p01);
        pf[i / 2][(i % 2) * 2 + 1] = pack_bf16(p10, p11);
      }
      // l stays a per-thread partial sum: the row's 4 threads add theirs
      // in the epilogue
      l0 = l0 * c0 + s0;
      l1 = l1 * c1 + s1;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= c0;
        o[4 * i + 1] *= c0;
        o[4 * i + 2] *= c1;
        o[4 * i + 3] *= c1;
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        Rs<D>::mma(o, pf[kk], desc_sw128(vt + kk * 16 * 128, C::KV_CHUNK),
                   1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int t0 = row_base + r0;
  const int t1 = t0 + 8;
  const int col = 2 * (lane % 4);
  __nv_bfloat16* dst0 = out + ((size_t(b) * T + t0) * H + h) * D + col;
  __nv_bfloat16* dst1 = out + ((size_t(b) * T + t1) * H + h) * D + col;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (t0 < T) {
      *reinterpret_cast<__nv_bfloat162*>(dst0 + 8 * i) =
          __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    }
    if (t1 < T) {
      *reinterpret_cast<__nv_bfloat162*>(dst1 + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    }
  }
}

// A rank-4 map over a contiguous bf16 [n3, n2, n1, 64 * k] tensor with a
// box of [1, rows, 1, 64] values, 128-byte swizzled; out-of-range
// elements of a box read as zero.
bool encode_4d(CUtensorMap* map, const void* base, int n3, int n2, int n1,
               int n0, int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(n0), cuuint64_t(n1),
                              cuuint64_t(n2), cuuint64_t(n3)};
  const cuuint64_t strides[3] = {cuuint64_t(n0) * 2,
                                 cuuint64_t(n0) * n1 * 2,
                                 cuuint64_t(n0) * n1 * n2 * 2};
  const cuuint32_t box[4] = {CHUNK, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int B, int T, int S,
                   int H, int Hkv, float scale, int causal,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_4d(&tm_q, q, B, T, H, D, WG_ROWS) ||
      !encode_4d(&tm_k, k, B, S, Hkv, D, C::BK) ||
      !encode_4d(&tm_v, v, B, S, Hkv, D, C::BK)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + C::BQ - 1) / C::BQ, H, B);
  flash_kernel<D><<<grid, C::THREADS, C::bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), T, S, H, Hkv, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int shai_flash_attention(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int B, int T, int S, int H,
                                    int Hkv, int D, float scale, int causal,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || T < 1 || S < 1 || Hkv < 1 || H % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, lengths, out, B, T, S, H,
                                         Hkv, scale, causal, st));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, lengths, out, B, T, S, H,
                                          Hkv, scale, causal, st));
    case 192:
      return static_cast<int>(launch<192>(q, k, v, lengths, out, B, T, S, H,
                                          Hkv, scale, causal, st));
    case 256:
      return static_cast<int>(launch<256>(q, k, v, lengths, out, B, T, S, H,
                                          Hkv, scale, causal, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* shai_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
