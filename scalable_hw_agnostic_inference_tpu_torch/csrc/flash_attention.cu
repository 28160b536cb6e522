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
// operations per byte, so the tensor cores bound it. This first version
// issues bf16 tensor-core products through WMMA (16x16x16 tiles, fp32
// accumulation) and stages everything through shared memory:
//   - one block owns a [64, D] query tile of one head; a loop over [64, D]
//     K/V tiles replaces the TPU kernel's sequential grid axis, and stops at
//     min(length, S - T + (tile + 1) * 64) so dead tiles are never read;
//   - each of the 4 warps owns 16 query rows end to end (scores, softmax,
//     its strip of the fp32 output accumulator), so only the K/V tile loads
//     need block-wide barriers;
//   - masked probabilities are zeroed explicitly (not through exp(-inf)), so
//     a row whose first live tile is all masked is not poisoned by
//     exp(NEG_INF - NEG_INF) = 1; key rows past the live bound are
//     zero-filled, so garbage there cannot reach the output as 0 * inf.
// Not yet done, and left for later work: wgmma, TMA loads, a producer warp
// and register-resident accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per tile
constexpr int WARPS = BQ / 16;      // one warp per 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

// Shared-memory layout. Row strides are padded against bank conflicts and
// keep every WMMA tile pointer 32-byte aligned.
template <int D>
struct Layout {
  static constexpr int LDB = D + 8;   // bf16 Q, K, V tiles
  static constexpr int LDS = BK + 4;  // fp32 scores
  static constexpr int LDP = BK + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;   // fp32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(BQ) * LDB * 2;
  static constexpr size_t v_off = k_off + size_t(BK) * LDB * 2;
  static constexpr size_t s_off = v_off + size_t(BK) * LDB * 2;
  static constexpr size_t p_off = s_off + size_t(BQ) * LDS * 4;
  static constexpr size_t o_off = p_off + size_t(BQ) * LDP * 2;
  static constexpr size_t bytes = o_off + size_t(BQ) * LDO * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const int* __restrict__ lengths,
             __nv_bfloat16* __restrict__ out,
             int T, int S, int H, int Hkv, float scale, int causal) {
  using L = Layout<D>;
  constexpr int VEC = 8;         // bf16 values per 16-byte load
  constexpr int VPR = D / VEC;   // 16-byte vectors per row
  constexpr int HALF = BK / 2;   // score columns per lane
  constexpr int DHALF = D / 2;   // output columns per lane

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* os = reinterpret_cast<float*>(smem + L::o_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int q_offset = S - T;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // keys at or past kv_len are masked; with causal masking the tile loop
  // also stops at the last key the block's last query may see
  int kv_len = S;
  if (lengths != nullptr) kv_len = min(kv_len, max(lengths[b], 0));
  int bound = kv_len;
  if (causal) bound = min(bound, q_offset + q0 + BQ);
  const int n_tiles = bound > 0 ? (bound + BK - 1) / BK : 0;

  for (int idx = tid; idx < BQ * VPR; idx += THREADS) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * VEC;
    const int t = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) {
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t(b) * T + t) * H + h) * D + c);
    }
    *reinterpret_cast<uint4*>(qs + r * L::LDB + c) = val;
  }
  float* ostrip = os + warp * 16 * L::LDO;
  for (int idx = lane; idx < 16 * D; idx += 32) {
    ostrip[(idx / D) * L::LDO + idx % D] = 0.f;
  }

  // each lane pair owns one query row: lane / 2 picks the row, lane % 2
  // the half of the score and output columns
  const int lrow = lane >> 1;
  const int half = lane & 1;
  const int row = warp * 16 + lrow;
  const int qpos = q_offset + q0 + row;
  float m_i = NEG_INF;
  float l_i = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int idx = tid; idx < BK * VPR; idx += THREADS) {
      const int r = idx / VPR;
      const int c = (idx % VPR) * VEC;
      const int s = k0 + r;
      uint4 kval = make_uint4(0u, 0u, 0u, 0u);
      uint4 vval = make_uint4(0u, 0u, 0u, 0u);
      if (s < kv_len) {
        const size_t off = ((size_t(b) * S + s) * Hkv + kvh) * D + c;
        kval = *reinterpret_cast<const uint4*>(k + off);
        vval = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + r * L::LDB + c) = kval;
      *reinterpret_cast<uint4*>(vs + r * L::LDB + c) = vval;
    }
    __syncthreads();

    // scores for this warp's 16 rows: [16, D] x [D, BK]
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BK / 16];
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(sacc[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, qs + warp * 16 * L::LDB + kk, L::LDB);
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        // K^T as a column-major [D, BK] operand read straight from K rows
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bt;
        wmma::load_matrix_sync(bt, ks + n * 16 * L::LDB + kk, L::LDB);
        wmma::mma_sync(sacc[n], a, bt, sacc[n]);
      }
    }
    float* sstrip = ss + warp * 16 * L::LDS;
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::store_matrix_sync(sstrip + n * 16, sacc[n], L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this row's half of the tile
    const float* srow = sstrip + lrow * L::LDS + half * HALF;
    const int kbase = k0 + half * HALF;
    float sv[HALF];
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      const int kpos = kbase + c;
      const bool live = kpos < kv_len && (!causal || qpos >= kpos);
      sv[c] = live ? srow[c] * scale : NEG_INF;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float corr = __expf(m_i - m_new);
    __nv_bfloat16* prow = ps + row * L::LDP + half * HALF;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      const int kpos = kbase + c;
      const bool live = kpos < kv_len && (!causal || qpos >= kpos);
      const float p = live ? __expf(sv[c] - m_new) : 0.f;
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * corr + sum;
    m_i = m_new;
    float* orow = ostrip + lrow * L::LDO + half * DHALF;
#pragma unroll 8
    for (int c = 0; c < DHALF; ++c) orow[c] *= corr;
    __syncwarp();

    // output strip += P [16, BK] x V [BK, D]
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> pa[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::load_matrix_sync(pa[kk], ps + warp * 16 * L::LDP + kk * 16,
                             L::LDP);
    }
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, ostrip + n * 16, L::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> vb;
        wmma::load_matrix_sync(vb, vs + kk * 16 * L::LDB + n * 16, L::LDB);
        wmma::mma_sync(oacc, pa[kk], vb, oacc);
      }
      wmma::store_matrix_sync(ostrip + n * 16, oacc, L::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncwarp();

  const int t = q0 + row;
  if (t < T) {
    const float inv = 1.f / fmaxf(l_i, 1e-20f);
    const float* orow = ostrip + lrow * L::LDO + half * DHALF;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        out + ((size_t(b) * T + t) * H + h) * D + half * DHALF);
#pragma unroll 8
    for (int c = 0; c < DHALF; c += 2) {
      dst[c / 2] = __floats2bfloat162_rn(orow[c] * inv, orow[c + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int B, int T, int S,
                   int H, int Hkv, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), T,
      S, H, Hkv, scale, causal);
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
