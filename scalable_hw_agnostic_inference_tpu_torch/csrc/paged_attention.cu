// Paged decode attention for Hopper (kernel B2): one query token per row
// attends that row's context straight out of the paged KV pool through its
// block table.
//
// Replaces: scalable_hw_agnostic_inference_tpu/ops/pallas/paged_attention.py
// paged_decode_attention (kernel _paged_kernel, pallas_call at :160).
//
// Contract (the same as the TPU kernel's bf16 branch):
//   q [B, H, D] bf16, k/v pool [N, bs, Hkv, D] bf16, tables [B, M] int32
//   (physical block ids, any order, M = the caller's context bucket),
//   lengths [B] int32 -> out [B, H, D] bf16. Keys at or past lengths[b] are
//   masked; a row of length 0 returns zeros.
//
// What bounds it on the H100: one multiply-add per K or V element read, so
// device-memory bytes bound it (about 2 operations per byte against the
// card's ~295). The design therefore reads each live byte once and nothing
// else:
//   - one block per (row, kv head) holds all G = H / Hkv query heads of the
//     GQA group (one warp each), so a K/V block is fetched once for the
//     group, never once per query head;
//   - the walk stops at min(M, cdiv(length, bs)) table entries: a dead block
//     is never read (the TPU kernel's revisit elision, done by not looping);
//   - each token's [D] slice of the head is one contiguous 2*D-byte run at
//     stride Hkv * D in the pool, loaded with 16-byte vectors;
//   - the online softmax (m, l, acc) is fp32 in registers, one D/32 slice of
//     acc per lane.
// Known limit, left for later work: at B = 8 and Hkv = 8 the grid has only
// 64 blocks for 132 SMs and each block walks its blocks one after another,
// so the kernel cannot fill the card; splitting the walk across blocks
// (split-K) with a second reduction pass is the fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

template <int D>
__global__ void paged_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k_pool,
                             const __nv_bfloat16* __restrict__ v_pool,
                             const int* __restrict__ tables,
                             const int* __restrict__ lengths,
                             __nv_bfloat16* __restrict__ out, int H, int Hkv,
                             int bs, int M, float scale) {
  constexpr int VEC = 8;        // bf16 values per 16-byte load
  constexpr int VPR = D / VEC;  // 16-byte vectors per token slice
  constexpr int PER_LANE = D / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + bs * D;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = kvh * G + warp;  // this warp's query head

  const int len = max(lengths[b], 0);
  const int n_live = min(M, (len + bs - 1) / bs);

  float qv[PER_LANE];
  float acc[PER_LANE];
  const __nv_bfloat16* qrow = q + (size_t(b) * H + h) * D;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    qv[i] = __bfloat162float(qrow[lane + 32 * i]) * scale;
    acc[i] = 0.f;
  }
  float m_i = NEG_INF;
  float l_i = 0.f;

  const int* trow = tables + size_t(b) * M;
  for (int j = 0; j < n_live; ++j) {
    const size_t blk = static_cast<size_t>(trow[j]);
    __syncthreads();  // every warp is done with the previous block
    for (int idx = threadIdx.x; idx < bs * VPR; idx += blockDim.x) {
      const int t = idx / VPR;
      const int c = (idx % VPR) * VEC;
      const size_t off = ((blk * bs + t) * Hkv + kvh) * D + c;
      *reinterpret_cast<uint4*>(ks + t * D + c) =
          *reinterpret_cast<const uint4*>(k_pool + off);
      *reinterpret_cast<uint4*>(vs + t * D + c) =
          *reinterpret_cast<const uint4*>(v_pool + off);
    }
    __syncthreads();

    const int n_tok = min(bs, len - j * bs);  // live tokens of this block
    for (int t = 0; t < n_tok; ++t) {
      const __nv_bfloat16* krow = ks + t * D;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        s += qv[i] * __bfloat162float(krow[lane + 32 * i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      const float m_new = fmaxf(m_i, s);
      const float corr = __expf(m_i - m_new);
      const float p = __expf(s - m_new);
      l_i = l_i * corr + p;
      const __nv_bfloat16* vrow = vs + t * D;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        acc[i] = acc[i] * corr + p * __bfloat162float(vrow[lane + 32 * i]);
      }
      m_i = m_new;
    }
  }

  const float inv = 1.f / fmaxf(l_i, 1e-20f);
  __nv_bfloat16* orow = out + (size_t(b) * H + h) * D;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    orow[lane + 32 * i] = __float2bfloat16(acc[i] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* lengths, void* out, int B,
                   int H, int Hkv, int bs, int M, float scale,
                   cudaStream_t stream) {
  const size_t smem = size_t(2) * bs * D * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(Hkv, B);
  const dim3 block(32 * (H / Hkv));
  paged_kernel<D><<<grid, block, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), H, Hkv, bs, M, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int shai_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, int B, int H, int Hkv, int D, int bs,
    int M, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || H / Hkv > 32 || bs < 1 || M < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(launch<64>(q, k_pool, v_pool, tables, lengths,
                                         out, B, H, Hkv, bs, M, scale, st));
    case 128:
      return static_cast<int>(launch<128>(q, k_pool, v_pool, tables, lengths,
                                          out, B, H, Hkv, bs, M, scale, st));
    case 192:
      return static_cast<int>(launch<192>(q, k_pool, v_pool, tables, lengths,
                                          out, B, H, Hkv, bs, M, scale, st));
    case 256:
      return static_cast<int>(launch<256>(q, k_pool, v_pool, tables, lengths,
                                          out, B, H, Hkv, bs, M, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
