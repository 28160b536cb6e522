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
// else. The walk is this kernel's device core (paged_attention_core.cuh,
// no longer shared with B3); int8 pools never come here, the wrapper sends
// them to B3 as the TPU kernel's int8 branch does:
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

#include "paged_attention_core.cuh"

namespace {

template <int D>
__global__ void paged_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k_pool,
                             const __nv_bfloat16* __restrict__ v_pool,
                             const int* __restrict__ tables,
                             const int* __restrict__ lengths,
                             __nv_bfloat16* __restrict__ out, int H, int Hkv,
                             int bs, int M, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  shai_paged::attend_row<D, __nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, tables, lengths, out, blockIdx.y,
      blockIdx.x, H, Hkv, bs, M, scale, smem);
}

template <int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* lengths, void* out, int B,
                   int H, int Hkv, int bs, int M, float scale,
                   cudaStream_t stream) {
  const size_t smem = shai_paged::smem_bytes<D, __nv_bfloat16>(bs);
  cudaError_t err = shai_paged::allow_smem(paged_kernel<D>, smem);
  if (err != cudaSuccess) return err;
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
