// Ragged paged attention for Hopper (kernel B3): every row's query attends
// exactly its own live blocks of the paged KV pool, over the full table
// window, with an optional in-kernel int8 dequant.
//
// Replaces: scalable_hw_agnostic_inference_tpu/ops/pallas/
// ragged_paged_attention.py ragged_paged_attention (kernel _ragged_kernel,
// pallas_call at :188).
//
// Contract (the same as the TPU kernel's):
//   q [rows, H, D] bf16, k/v pool [N, bs, Hkv, D] bf16 or int8, with an int8
//   pool k_scale / v_scale [N, Hkv] f32 (one scale per block and kv head),
//   tables [rows, M] int32 (M = blocks_per_seq, the full window), lengths
//   [rows] int32 -> out [rows, H, D] bf16. Keys at or past lengths[r] are
//   masked; the work of a row follows cdiv(lengths[r], bs), not M; an int8
//   value counts as value * scale[block, kv head], all math in fp32; a row
//   of length 0 returns zeros. Callers with several queries per sequence
//   (the chunked-prefill continuation) flatten them one per row, each row
//   with its own length and a copy of the sequence's table.
//
// What bounds it on the H100: one multiply-add per K or V element read, so
// device-memory bytes bound it, and an int8 pool halves those bytes. The
// walk is the device core B3 shares with B2 (paged_attention_core.cuh):
//   - one block per (row, kv head) holds the whole GQA group (one warp per
//     query head), so a K/V block is fetched once for the group;
//   - the walk stops at min(M, cdiv(length, bs)) table entries: dead blocks
//     are neither read nor computed, which is what the TPU kernel's
//     compute skip plus revisit elision do over its (rows, M) grid;
//   - an int8 block streams as int8 (16 values per 16-byte load) with its
//     two f32 scales, and is dequantized in registers;
//   - the online softmax is fp32 in registers.
// Known limits, left for later work: at decode (8 rows, 8 kv heads) the grid
// has 64 blocks for 132 SMs and each walks its context alone, the same
// occupancy limit as B2, fixed by split-K with a second reduction pass; the
// continuation layout (512 rows x 8 kv heads) fills the card but reads the
// sequence's prior context once per query row, from L2 at best, where one
// block per query tile would read it once.

#include "paged_attention_core.cuh"

namespace {

template <int D, typename T>
__global__ void ragged_kernel(const __nv_bfloat16* __restrict__ q,
                              const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ tables,
                              const int* __restrict__ lengths,
                              __nv_bfloat16* __restrict__ out, int H, int Hkv,
                              int bs, int M, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  shai_paged::attend_row<D, T>(q, k_pool, v_pool, k_scale, v_scale, tables,
                               lengths, out, blockIdx.x, blockIdx.y, H, Hkv,
                               bs, M, scale, smem);
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* k_scale;
  const void* v_scale;
  const void* tables;
  const void* lengths;
  void* out;
  int rows, H, Hkv, bs, M;
  float scale;
};

template <int D, typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = shai_paged::smem_bytes<D, T>(a.bs);
  cudaError_t err = shai_paged::allow_smem(ragged_kernel<D, T>, smem);
  if (err != cudaSuccess) return err;
  // rows on x (up to 2^31 - 1): neighbouring blocks are neighbouring rows
  // of one kv head, which in the continuation layout read the same blocks
  const dim3 grid(a.rows, a.Hkv);
  const dim3 block(32 * (a.H / a.Hkv));
  ragged_kernel<D, T><<<grid, block, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const T*>(a.k_pool), static_cast<const T*>(a.v_pool),
      static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.lengths),
      static_cast<__nv_bfloat16*>(a.out), a.H, a.Hkv, a.bs, a.M, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_pool(const Args& a, bool quantized, cudaStream_t stream) {
  return quantized ? launch<D, int8_t>(a, stream)
                   : launch<D, __nv_bfloat16>(a, stream);
}

}  // namespace

// Returns a cudaError_t as int: 0 when the launch was accepted. quantized:
// the pool is int8 and k_scale / v_scale point at its [N, Hkv] f32 scales;
// otherwise the pool is bf16 and the scale pointers are not read.
extern "C" int shai_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, int rows, int H, int Hkv, int D, int bs,
    int M, int quantized, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 1 || Hkv < 1 || Hkv > 65535 || H % Hkv != 0 || H / Hkv > 32 ||
      bs < 1 || M < 1 || (quantized && (!k_scale || !v_scale))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,       k_pool, v_pool, k_scale, v_scale, tables, lengths,
               out,     rows,   H,      Hkv,     bs,      M,      scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(launch_pool<64>(a, quantized, st));
    case 128:
      return static_cast<int>(launch_pool<128>(a, quantized, st));
    case 192:
      return static_cast<int>(launch_pool<192>(a, quantized, st));
    case 256:
      return static_cast<int>(launch_pool<256>(a, quantized, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
