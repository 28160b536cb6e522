// W8A16 projection for Hopper: bf16 activations times int8 weights with a
// per-output-channel f32 scale, for the decode-width calls of the serving
// path (every projection of a decode step and the lm_head on sampled rows).
//
// Replaces: no Pallas kernel. The JAX package leaves the int8 product to
// XLA (scalable_hw_agnostic_inference_tpu/ops/quant.py quant_matmul, :142:
// "(x @ kernel_q.astype(bf16)) * scale.astype(bf16)"), which loads the
// int8 tiles from device memory and converts them in registers. On the
// card that fusion has to be written by hand: the plain PyTorch expression
// writes a dequantized bf16 copy of every weight and reads it back on every
// call, 5 bytes per weight against bf16's 2, so int8 would make decode
// slower than bf16.
//
// Contract: x [M, K] bf16 contiguous, wq [N, K] int8 contiguous (the
//   nn.Linear layout, [out, in]), scale [N] f32 -> y [M, N] bf16 with
//   y[m, n] = bf16(bf16(sum_k x[m, k] * wq[n, k]) * bf16(scale[n])):
//   the sum in fp32, rounded to bf16, then multiplied by the bf16-rounded
//   scale and rounded again (the reference's order). 1 <= M <= 64,
//   N % 8 == 0, K % 64 == 0.
//
// What bounds it on the H100: at M <= 64 every weight byte feeds at most
//   64 multiply-adds, far under the ~295 operations per byte where the
//   tensor cores would bound it, so the N K bytes of int8 weights over the
//   3.35 TB/s of device memory do (Llama-3-8B's decode step: 7.5 GB of
//   projections and lm_head, 2.24 ms, against 4.48 ms in bf16).
//
// Design (simple first; no wgmma, no TMA):
//   - each weight byte is read from device memory exactly once and
//     converted to bf16 in registers (exact: every int8 is a bf16); no
//     dequantized copy is ever written;
//   - products on tensor cores with mma.sync m16n8k16 (bf16 in, fp32
//     accumulate). The [N, K] row-major weight is already the "col" B
//     operand. A thread's 16-byte read holds 16 consecutive k of one
//     output row; the k order inside each 64-wide chunk is permuted (the
//     same permutation for A and B, which a sum does not see) so that the
//     four 32-bit words of that read are exactly the thread's B fragments
//     of the chunk's four k16 steps, and its A fragments are 32 contiguous
//     bytes of each x row it holds;
//   - a decode call is a stream of bytes with a short latency budget (at
//     M = 8 the gate projection is 17.5 us of device-memory time), so the
//     design keeps as many bytes in flight as an SM holds: K runs in
//     stages, each stage's weight tile [R, KS] int8 and x slice [M, KS]
//     bf16 copied by cp.async into a ring of 3 stage buffers, two stages
//     in flight while one is computed, one __syncthreads a stage; two
//     CTAs an SM up to M = 32, so one computes while the other waits. KS
//     is picked per shape so that a stage holds about 16 KB of weights
//     (256 k at 64 rows, 2048 at 8) within the shared-memory budget (a
//     4-deep ring and one CTA of an 8-deep ring measured slower: a CTA's
//     conversion and products do not overlap its own barrier waits);
//   - x leaves L2 once per CTA and stage; rows past M are zeros (with M <=
//     8 only the 8 live rows are staged and an m16 tile's upper half is
//     skipped);
//   - a CTA of 8 warps owns R = 8 * WN output rows: WN warps side by side
//     in n (one n8 tile each), WK = 8 / WN warps taking the 64-wide chunks
//     round-robin. The host picks R per shape (ops/cuda/int8_matmul.py
//     int8_plan): N = 1024 (k, v) runs 128 CTAs of 8 rows, N = 4096 (q, o,
//     down) 256 CTAs of 16, N = 14336 (gate, up) 224 CTAs of 64;
//   - shared-memory rows are padded by 16 bytes, so the 16-byte fragment
//     reads of a warp's eight rows hit eight different bank groups;
//   - the WK partial sums of a tile are added through shared memory in a
//     fixed order, so the result is deterministic (a CUDA graph replay is
//     bit-equal to an eager call); no split-K across CTAs, no atomics;
//   - the epilogue rounds, scales and rounds as the reference does and
//     writes bf16 pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 64;      // k of one 16-byte weight read per row
constexpr int STAGES = 3;      // the cp.async ring
constexpr int WPAD = 16;       // bytes of pad per staged weight row
constexpr int XPAD = 8;        // bf16 of pad per staged x row
constexpr int STAGE_W_BYTES = 16384;   // weight bytes a stage aims for
constexpr int SMEM_TWO_CTAS = 113 * 1024;   // budget for two CTAs an SM
constexpr int SMEM_ONE_CTA = 227 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four int8 (one 32-bit word, k ascending from the low byte) -> two bf16
// pairs, exactly: each byte biased to unsigned is placed in the mantissa
// of 2^23 and 2^23 + 128 taken off in fp32, which leaves the integer with
// its low 16 bits zero, so its bf16 is its top half (a byte permute, not
// a conversion: 6 permutes and 4 adds per word).
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float magic = 8388736.0f;   // 2^23 + 128
  const float f0 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - magic;
  const float f1 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - magic;
  const float f2 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - magic;
  const float f3 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - magic;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// 16 bf16 of one staged x row as 8 words.
__device__ __forceinline__ void load_xs(uint32_t (&r)[8],
                                       const __nv_bfloat16* p) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint4 b = *reinterpret_cast<const uint4*>(p + 8);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

// One 64-wide chunk of k for every m16 tile: the thread's weight word s
// (k = c*64 + q*16 + 4s .. + 3 of output row n0 + g) is its B fragment of
// step s, and x[row, c*64 + q*16 + 4s .. + 3] its A fragment. xs points at
// the staged x row g, column (chunk in the stage)*64 + q*16.
template <int MT>
__device__ __forceinline__ void chunk_mma(float (&acc)[MT][4], uint4 w,
                                          const __nv_bfloat16* xs, int xld,
                                          int M) {
  uint32_t b[4][2];
  i8x4_to_bf16(w.x, b[0][0], b[0][1]);
  i8x4_to_bf16(w.y, b[1][0], b[1][1]);
  i8x4_to_bf16(w.z, b[2][0], b[2][1]);
  i8x4_to_bf16(w.w, b[3][0], b[3][1]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    uint32_t xa[8], xb[8];
    load_xs(xa, xs + mt * 16 * xld);
    if (mt * 16 + 8 < M) {
      load_xs(xb, xs + (mt * 16 + 8) * xld);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) xb[i] = 0u;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      mma_bf16(acc[mt], xa[2 * s], xb[2 * s], xa[2 * s + 1],
               xb[2 * s + 1], b[s][0], b[s][1]);
    }
  }
}

// The shape of one call's stages (the host computes the same): k per
// stage (a power of two), staged x rows, the row strides and the bytes of
// one stage.
struct Plan {
  int ks, ks_log2, xrows, wld, xld, w_bytes, stage_bytes;
};

__host__ __device__ inline Plan make_plan(int M, int K, int rows, int ks) {
  Plan p;
  p.ks = ks;
  p.ks_log2 = 0;
  while ((1 << p.ks_log2) < ks) ++p.ks_log2;
  p.xrows = M <= 8 ? 8 : ((M + 15) / 16) * 16;
  p.wld = ks + WPAD;
  p.xld = ks + XPAD;
  p.w_bytes = rows * p.wld;
  p.stage_bytes = p.w_bytes + p.xrows * p.xld * 2;
  return p;
}

// Copy stage st (k0 = st * ks) of the CTA's weight rows and of x (rows
// < M, k < K) into its ring slot, as one cp.async group. Piece i of the
// weight tile is row i / (ks / 16), 16 bytes at column i % (ks / 16): a
// warp copies whole rows, ks bytes each, contiguous.
__device__ __forceinline__ void stage_copy(unsigned char* slot,
                                           const __nv_bfloat16* x,
                                           const int8_t* wq, int M, int N,
                                           int K, int row0, int rows,
                                           const Plan& p, int k0) {
  const int wsh = p.ks_log2 - 4, xsh = p.ks_log2 - 3;
  const int live_rows = N - row0 < rows ? N - row0 : rows;
  for (int i = threadIdx.x; i < live_rows << wsh; i += THREADS) {
    const int r = i >> wsh, col = (i & ((1 << wsh) - 1)) << 4;
    if (k0 + col < K) {
      cp_async16(slot + r * p.wld + col,
                 wq + static_cast<size_t>(row0 + r) * K + k0 + col);
    }
  }
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(slot + p.w_bytes);
  for (int i = threadIdx.x; i < M << xsh; i += THREADS) {
    const int r = i >> xsh, col = (i & ((1 << xsh) - 1)) << 3;
    if (k0 + col < K) {
      cp_async16(xs + r * p.xld + col,
                 x + static_cast<size_t>(r) * K + k0 + col);
    }
  }
}

// Up to two m16 tiles two CTAs share an SM (at most 113 KB of ring each,
// 128 registers a thread); three and four tiles take one.
template <int MT>
__global__ void __launch_bounds__(THREADS, MT <= 2 ? 2 : 1)
    int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                       const int8_t* __restrict__ wq,
                       const float* __restrict__ scale,
                       __nv_bfloat16* __restrict__ y, int M, int N, int K,
                       int WN, int ks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = 8 * WN;
  const Plan p = make_plan(M, K, rows, ks);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % WN, wk = warp / WN, WK = WARPS / WN;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = blockIdx.x * rows;
  const int n0 = row0 + wn * 8;
  const bool live = n0 < N;
  const int chunks = K / CHUNK;
  const int stage_chunks = ks / CHUNK;
  const int stages = (K + ks - 1) / ks;

  // x rows M .. xrows of every slot stay zero (cp.async writes rows < M)
  for (int st = 0; st < STAGES; ++st) {
    __nv_bfloat16* xs =
        reinterpret_cast<__nv_bfloat16*>(smem + st * p.stage_bytes +
                                         p.w_bytes);
    for (int i = threadIdx.x; i < (p.xrows - M) * p.xld; i += THREADS) {
      xs[M * p.xld + i] = __float2bfloat16_rn(0.0f);
    }
  }

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.0f;
  }

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < stages) {
      stage_copy(smem + st * p.stage_bytes, x, wq, M, N, K, row0, rows, p,
                 st * ks);
    }
    cp_async_commit();
  }
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<STAGES - 2>();   // stage st has landed
    __syncthreads();               // and every warp is done with st - 1
    const int next = st + STAGES - 1;
    if (next < stages) {
      stage_copy(smem + (next % STAGES) * p.stage_bytes, x, wq, M, N, K,
                 row0, rows, p, next * ks);
    }
    cp_async_commit();
    if (live) {
      const unsigned char* slot = smem + (st % STAGES) * p.stage_bytes;
      const unsigned char* ws = slot + (wn * 8 + g) * p.wld + q * 16;
      const __nv_bfloat16* xs =
          reinterpret_cast<const __nv_bfloat16*>(slot + p.w_bytes) +
          g * p.xld + q * 16;
      // this warp's chunks of the stage: global chunk index = wk mod WK
      const int c0 = st * stage_chunks;
      int j = ((wk - c0) % WK + WK) % WK;
#pragma unroll 2
      for (; j < stage_chunks && c0 + j < chunks; j += WK) {
        const uint4 w = *reinterpret_cast<const uint4*>(ws + j * CHUNK);
        chunk_mma<MT>(acc, w, xs + j * CHUNK, p.xld, M);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the reduction reuses it

  // the WK partial tiles of each n8 tile, added in a fixed order
  if (WK > 1) {
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        red[((warp * MT + mt) * 4 + i) * 32 + lane] = acc[mt][i];
      }
    }
    __syncthreads();
    if (wk != 0) return;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = acc[mt][i];
        for (int j = 1; j < WK; ++j) {
          s += red[(((wn + j * WN) * MT + mt) * 4 + i) * 32 + lane];
        }
        acc[mt][i] = s;
      }
    }
  }
  if (!live) return;

  // y = bf16(bf16(acc) * bf16(scale)), as (x @ Wq^T in bf16) * scale.bf16
  const int n = n0 + 2 * q;
  const float s0 = __bfloat162float(__float2bfloat16_rn(scale[n]));
  const float s1 = __bfloat162float(__float2bfloat16_rn(scale[n + 1]));
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + g + 8 * h;
      if (row >= M) continue;
      const float v0 =
          __bfloat162float(__float2bfloat16_rn(acc[mt][2 * h])) * s0;
      const float v1 =
          __bfloat162float(__float2bfloat16_rn(acc[mt][2 * h + 1])) * s1;
      *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(row) * N + n) =
          pack_bf16(v0, v1);
    }
  }
}

template <int MT>
cudaError_t launch(const void* x, const void* wq, const void* scale,
                   void* y, int M, int N, int K, int wn,
                   cudaStream_t stream) {
  const int rows = 8 * wn;
  const int budget = MT <= 2 ? SMEM_TWO_CTAS : SMEM_ONE_CTA;
  // k per stage: a power of two from the chunk up, about STAGE_W_BYTES
  // of weights, no more than K needs, and the ring within the budget
  int ks = CHUNK;
  while (ks * 2 * rows <= STAGE_W_BYTES && ks < K) ks *= 2;
  while (ks > CHUNK &&
         STAGES * make_plan(M, K, rows, ks).stage_bytes > budget) {
    ks /= 2;
  }
  const int reduction = WARPS * MT * 4 * 32 * 4;
  int bytes = STAGES * make_plan(M, K, rows, ks).stage_bytes;
  bytes = bytes < reduction ? reduction : bytes;
  if (bytes > SMEM_ONE_CTA) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + rows - 1) / rows);
  int8_matmul_kernel<MT><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), M,
      N, K, wn, ks);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 when the launch was accepted. rows_per_cta
// is 8, 16, 32 or 64 (the host's plan, ops/cuda/int8_matmul.py).
extern "C" int shai_int8_matmul(const void* x, const void* wq,
                                const void* scale, void* y, int M, int N,
                                int K, int rows_per_cta, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int wn = rows_per_cta / 8;
  if (M < 1 || M > 64 || N < 8 || N % 8 != 0 || K < CHUNK ||
      K % CHUNK != 0 || rows_per_cta % 8 != 0 ||
      (wn != 1 && wn != 2 && wn != 4 && wn != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((M + 15) / 16) {
    case 1:
      return static_cast<int>(launch<1>(x, wq, scale, y, M, N, K, wn, st));
    case 2:
      return static_cast<int>(launch<2>(x, wq, scale, y, M, N, K, wn, st));
    case 3:
      return static_cast<int>(launch<3>(x, wq, scale, y, M, N, K, wn, st));
    default:
      return static_cast<int>(launch<4>(x, wq, scale, y, M, N, K, wn, st));
  }
}
