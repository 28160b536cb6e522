// B2's device core (paged_attention.cu, bf16 pools): the walk over one
// row's paged context. It is B2's alone: B3 (ragged_paged_attention.cu)
// shared it until B3 moved to tensor-core query tiles with split-K decode,
// and B2 is next to move onto that walk.
//
// One CUDA block attends one (row, kv head): its G = H / Hkv warps each own
// one query head of the GQA group, so a K/V block is fetched once for the
// whole group. The walk covers min(M, cdiv(length, bs)) table entries, so a
// dead block is neither read nor computed, and inside the last live block
// only the live tokens are visited (a masked probability is never formed,
// which is the same as zeroing it). Each token's [D] slice of the head is
// one contiguous run at stride Hkv * D in the pool, loaded into shared
// memory with 16-byte vectors (8 bf16 or 16 int8 values a thread). An int8
// block is dequantized in registers, value times its (block, kv head) f32
// scale, as it is read back from shared memory. The online softmax
// (m, l, acc) is fp32, one D / 32 slice of acc per lane. A row of length 0
// writes zeros (acc / max(l, 1e-20) with acc = 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace shai_paged {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

// Shared memory one block needs: a K and a V block of bs tokens x D values.
template <int D, typename T>
inline size_t smem_bytes(int bs) {
  return size_t(2) * bs * D * sizeof(T);
}

// Attend query row b, kv head kvh. T is the pool's element type; an int8
// pool (T = int8_t) reads k_scale / v_scale [N, Hkv], a bf16 pool ignores
// them (B2 instantiates only the bf16 walk). smem holds
// smem_bytes<D, T>(bs) bytes, 16-byte aligned. Needs
// blockDim.x == 32 * (H / Hkv).
template <int D, typename T>
__device__ __forceinline__ void attend_row(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    int b, int kvh, int H, int Hkv, int bs, int M, float scale,
    unsigned char* smem) {
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int VEC = 16 / sizeof(T);  // values per 16-byte load
  constexpr int VPR = D / VEC;         // 16-byte vectors per token slice
  constexpr int PER_LANE = D / 32;

  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + bs * D;

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
    float k_sc = 1.f;
    float v_sc = 1.f;
    if constexpr (QUANT) {
      k_sc = k_scale[blk * Hkv + kvh];
      v_sc = v_scale[blk * Hkv + kvh];
    }
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
      const T* krow = ks + t * D;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        s += qv[i] * (to_float(krow[lane + 32 * i]) * k_sc);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      const float m_new = fmaxf(m_i, s);
      const float corr = __expf(m_i - m_new);
      const float p = __expf(s - m_new);
      l_i = l_i * corr + p;
      const T* vrow = vs + t * D;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        acc[i] = acc[i] * corr + p * (to_float(vrow[lane + 32 * i]) * v_sc);
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

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace shai_paged
