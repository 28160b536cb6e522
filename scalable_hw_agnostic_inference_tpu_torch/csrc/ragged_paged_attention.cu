// Ragged paged attention for Hopper (kernel B3): every row's query attends
// exactly its own live keys of the paged KV pool, over the full table
// window, with an optional int8 pool. Its decode CTA is also B2's kernel.
//
// Replaces: scalable_hw_agnostic_inference_tpu/ops/pallas/
// ragged_paged_attention.py ragged_paged_attention (kernel _ragged_kernel,
// pallas_call at :188), and, through decode_kernel,
// scalable_hw_agnostic_inference_tpu/ops/pallas/paged_attention.py
// paged_decode_attention (kernel _paged_kernel, pallas_call at :160): B2's
// contract is this one with R = 1 on the caller's truncated [B, M] tables.
//
// Contract (the TPU kernel's, plus a stated sharing of tables):
//   q [rows, H, D] bf16, k/v pool [N, bs, Hkv, D] bf16 or int8, with an int8
//   pool k_scale / v_scale [N, Hkv] f32 (one scale per block and kv head),
//   tables [rows / R, M] int32 (M = blocks_per_seq, the full window; each
//   run of R = rows_per_table consecutive rows shares one table row; R = 1
//   is the TPU kernel's contract), lengths [rows] int32 -> out [rows, H, D]
//   bf16. Keys at or past lengths[r] are masked; a row's work follows its
//   length, not M; an int8 value counts as value * scale[block, kv head];
//   Q K^T and P V run on bf16 operands with fp32 accumulation and an fp32
//   softmax (Q and P are rounded to bf16, as in B1); a row of length 0
//   returns zeros. The chunked-prefill continuation passes R = its chunk
//   length, each row's length start + t + 1 (a causal edge).
//
// Row groups (groups_kernel, the fused mixed-phase step's layout): the same
//   attention over rows cut into groups, each a first row, a row count and
//   the table row all its rows attend through. The fused step's B decode
//   rows are B groups of one, its C-token chunk one group of C rows: one
//   launch, its grid segmented by group, the decode CTA for a group of one
//   and the tile CTA for a larger one, so the chunk's queries share each
//   K/V tile they load and the kernel never learns which phase a row is
//   in (the TPU kernel's mixed layout: every row its own table and length).
//
// What bounds it on the H100: at decode, one multiply-add per K or V
// element read, so device-memory bytes bound it and an int8 pool halves
// them; at the continuation (512 rows sharing one context), rows x keys
// products over one read of the context, so the tensor cores do.
//
// The decode CTA (decode_kernel: R = 1 and G = H / Hkv <= 32, so every
// B2 call, B3's ragged decode and every int8 decode). A decode row is a
// stream of bytes with G query heads of work per key, so the design keeps
// as many bytes in flight as the SM holds and spends few instructions per
// byte:
//   - one CTA of 4 warps per (row, kv head, split), all 128 threads
//     issuing the gather, so a tile's copies go out four times as fast as
//     from one warp;
//   - a key tile's table entries are read once: two warps map the tile's
//     64 keys to pool rows (one divide by bs per key, a shift when bs is
//     a power of two; the entry read by one lane and shuffled to the keys
//     in it) into a small ring of offsets, a tile ahead of its copies, so
//     the copies themselves are contiguous 2 D-byte (D-byte int8) rows at
//     stride Hkv D with no divide; any bs >= 1;
//   - a cp.async ring of S tiles of 64 keys (3 for bf16, 4 for int8),
//     S - 1 of them in flight while one is computed; at D = 128 two CTAs
//     fit an SM, some 140 KB of K/V in flight, and one CTA's start and
//     merge overlap the other's stream; one __syncthreads per tile;
//   - each warp takes its own 16-key quarter of every tile (G <= 16; for
//     G <= 32 two warps share a quarter-pair, one m16 tile of heads each)
//     on mma.sync m16n8k16 with the G heads as product rows, with its own
//     (m, l, acc); the four warps merge through shared memory at the end
//     by log-sum-exp, a warp with l = 0 skipped. With one or two warps per
//     scheduler every latency of a tile's chain shows, so the chain is
//     kept short: Q's fragments stay in registers (D <= 128) and Q K^T
//     runs as two independent accumulator chains;
//   - int8 on the same path: each warp converts its own quarter to bf16 in
//     shared memory, k_scale folds into the scores and v_scale into P;
//   - split-K when rows x kv heads would not fill the card, the splits
//     taking key tiles round-robin (so a split's first table entries load
//     beside the row's length, not after it); the last split CTA of a
//     (row, kv head) to finish (a counter per pair, reset by that CTA)
//     merges the splits' partials, or, without counters, merge_kernel does
//     in a second launch. A CTA's fixed cost is a chain of device-memory
//     round trips (length and entries, first tile, partials, fence and
//     count, merge): the split plan trades it against each CTA's stream;
//   - not TMA: a decode tile is a gather of [bs, D] boxes through the table.
//
// The continuation CTA (ragged_kernel: R > 1, or G > 32):
//   - one CTA per (tile of RT consecutive rows of one table, kv head,
//     split); its product rows are the tile's rows times the G = H / Hkv
//     query heads of the kv head (16 rows x 4 heads = 64 at the
//     continuation, one warp of 16 product rows per 16), so a K/V key tile
//     is read once per tile, not once per query row;
//   - the CTA walks its table's live keys in tiles of 64, up to the tile's
//     largest length; each product row masks by its own length;
//   - products run on tensor cores with mma.sync m16n8k16 (bf16 in, fp32
//     out), fragments through ldmatrix from padded shared-memory rows, K/V
//     key tiles double-buffered by cp.async. Not wgmma and TMA: a key tile
//     is gathered token by token through the table (a [bs, D] box per
//     entry at stride Hkv D), an int8 tile must become bf16 in shared
//     memory before any tensor-core read, and a decode tile has 4 useful
//     product rows, a quarter of one m16 tile, let alone a 64-row wgmma;
//   - int8 without a dequant pass: each int8 tile is converted to bf16 in
//     shared memory (exact: every value in -128..127 is a bf16), the block's
//     k_scale multiplies the fp32 scores of its keys, and its v_scale
//     multiplies P's columns before P is rounded to bf16 for P V; the row
//     sum l takes the unscaled P. bf16 and int8 pools then share one
//     tensor-core path;
//   - split-K for decode: when the grid alone would not fill the card,
//     `splits` CTAs share each row's key tiles evenly; each writes fp32
//     partials (m, l, acc) to scratch, and merge_kernel combines them by
//     log-sum-exp, skipping a split with l = 0 (no live key), so no
//     exp(-inf - -inf) forms;
//   - keys past the tile's largest length are zero-filled, never read, so
//     no stale pool value reaches P V; masked scores are -inf and a row
//     whose running max is still -inf exponentiates against 0 (both CTAs).
// Left for later work: wgmma with a TMA gather of table entries for the
// continuation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KT = 64;         // keys per tile
constexpr int MAX_PROWS = 64;  // product rows per CTA (4 warps)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when `bytes` is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory of one CTA with `warps` warps (16 product rows each):
//   q    [warps * 16][LD] bf16 (rows padded by 8 values against ldmatrix
//        bank conflicts);
//   k, v [2 stages][KT][SLD] of the pool type (SLD = LD for bf16, read in
//        place; D for int8, a staging copy);
//   int8 only: kc, vc [KT][LD] bf16 (the converted tile) and the per-key
//        scales ks, vs [2 stages][KT] f32.
template <int D, typename T>
struct Smem {
  static constexpr bool QUANT = sizeof(T) == 1;
  static constexpr int LD = D + 8;
  static constexpr int SLD = QUANT ? D : LD;
  static constexpr size_t stage = size_t(KT) * SLD * sizeof(T);
  static __host__ __device__ size_t q_bytes(int warps) {
    return size_t(warps) * 16 * LD * 2;
  }
  static __host__ __device__ size_t bytes(int warps) {
    size_t n = q_bytes(warps) + 4 * stage;
    if (QUANT) n += 2 * size_t(KT) * LD * 2 + 4 * KT * sizeof(float);
    return n;
  }
};

// One tile CTA: rows [row0, row0 + nr) of the table row `trow`, times the
// G query heads of kv head `kvh`, over split `split` of `splits` of their
// keys. `rows` sizes the split partials ([splits, rows, H]).
template <int D, typename T>
__device__ __forceinline__ void tile_cta(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ trow,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ part_ml, int rows,
    int row0, int nr, int G, int H, int Hkv, int bs, int M, float sl2,
    int kvh, int split, int splits) {
  using SM = Smem<D, T>;
  constexpr bool QUANT = SM::QUANT;
  constexpr int LD = SM::LD;
  constexpr int SLD = SM::SLD;
  constexpr int EPC = 16 / int(sizeof(T));  // pool values per 16 bytes
  constexpr int CPK = D / EPC;              // 16-byte chunks per key
  const int warps = blockDim.x / 32;
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  T* kst = reinterpret_cast<T*>(smem + SM::q_bytes(warps));
  T* vst = reinterpret_cast<T*>(smem + SM::q_bytes(warps) + 2 * SM::stage);
  unsigned char* tail = smem + SM::q_bytes(warps) + 4 * SM::stage;
  __nv_bfloat16* kc = reinterpret_cast<__nv_bfloat16*>(tail);
  __nv_bfloat16* vc = kc + KT * LD;
  float* kss = reinterpret_cast<float*>(vc + KT * LD);
  float* vss = kss + 2 * KT;

  const int window = M * bs;

  // the two product rows this thread holds: warp * 16 + lane / 4 (+ 8)
  int prow[2], phead[2], plen[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int p = warp * 16 + lane / 4 + 8 * e;
    const int rt = p / G;
    prow[e] = rt < nr ? row0 + rt : -1;
    phead[e] = kvh * G + p % G;
    plen[e] = prow[e] >= 0 ? min(max(lengths[prow[e]], 0), window) : 0;
  }
  int maxlen = 0;
  for (int r = 0; r < nr; ++r) {
    maxlen = max(maxlen, min(max(lengths[row0 + r], 0), window));
  }
  const int nkt = (maxlen + KT - 1) / KT;
  const int per = (nkt + splits - 1) / splits;
  const int kt_begin = split * per;
  const int kt_end = min(nkt, kt_begin + per);

  // queries of the product rows, zeros past the tile
  for (int i = tid; i < warps * 16 * (D / 8); i += nthr) {
    const int p = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const int rt = p / G;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rt < nr) {
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t(row0 + rt) * H + kvh * G + p % G) * D + c));
    }
    *reinterpret_cast<uint4*>(qs + p * LD + c) = val;
  }

  auto load_tile = [&](int kt, int st) {
    const int kbase = kt * KT;
    for (int i = tid; i < KT * CPK; i += nthr) {
      const int key = i / CPK;
      const int c = (i % CPK) * EPC;
      const int kpos = kbase + key;
      const T* srck = kp;
      const T* srcv = vp;
      int bytes = 0;
      if (kpos < maxlen) {
        const size_t blk = static_cast<size_t>(trow[kpos / bs]);
        const size_t off = ((blk * bs + kpos % bs) * Hkv + kvh) * D + c;
        srck = kp + off;
        srcv = vp + off;
        bytes = 16;
      }
      cp_async16(kst + (size_t(st) * KT + key) * SLD + c, srck, bytes);
      cp_async16(vst + (size_t(st) * KT + key) * SLD + c, srcv, bytes);
    }
    if constexpr (QUANT) {
      for (int i = tid; i < KT; i += nthr) {
        const int kpos = kbase + i;
        float ks = 0.f, vs = 0.f;
        if (kpos < maxlen) {
          const size_t blk = static_cast<size_t>(trow[kpos / bs]);
          ks = k_scale[blk * Hkv + kvh];
          vs = v_scale[blk * Hkv + kvh];
        }
        kss[st * KT + i] = ks;
        vss[st * KT + i] = vs;
      }
    }
  };

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if (kt_begin < kt_end) load_tile(kt_begin, 0);
  cp_async_commit();
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_tile(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* kt_s;
    const __nv_bfloat16* vt_s;
    if constexpr (QUANT) {
      // int8 -> bf16 in shared memory, exact; the scales stay apart
      for (int i = tid; i < KT * (D / 16); i += nthr) {
        const int key = i / (D / 16);
        const int c = (i % (D / 16)) * 16;
        const int8_t* sk = kst + (size_t(st) * KT + key) * SLD + c;
        const int8_t* sv = vst + (size_t(st) * KT + key) * SLD + c;
        const int4 rk = *reinterpret_cast<const int4*>(sk);
        const int4 rv = *reinterpret_cast<const int4*>(sv);
        const int8_t* bk = reinterpret_cast<const int8_t*>(&rk);
        const int8_t* bv = reinterpret_cast<const int8_t*>(&rv);
        uint32_t wk[8], wv[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          wk[x] = pack_bf16(float(bk[2 * x]), float(bk[2 * x + 1]));
          wv[x] = pack_bf16(float(bv[2 * x]), float(bv[2 * x + 1]));
        }
        uint4* dk = reinterpret_cast<uint4*>(kc + key * LD + c);
        uint4* dv = reinterpret_cast<uint4*>(vc + key * LD + c);
        dk[0] = make_uint4(wk[0], wk[1], wk[2], wk[3]);
        dk[1] = make_uint4(wk[4], wk[5], wk[6], wk[7]);
        dv[0] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
        dv[1] = make_uint4(wv[4], wv[5], wv[6], wv[7]);
      }
      __syncthreads();
      kt_s = kc;
      vt_s = vc;
    } else {
      kt_s = reinterpret_cast<const __nv_bfloat16*>(kst) +
             size_t(st) * KT * LD;
      vt_s = reinterpret_cast<const __nv_bfloat16*>(vst) +
             size_t(st) * KT * LD;
    }

    // S = Q K^T for this warp's 16 product rows x 64 keys
    float sc[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qs + (warp * 16 + lane % 16) * LD + kk * 16 +
                         (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < KT / 16; ++j) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kt_s + (j * 16 + lane % 8 + (lane / 16) * 8) * LD +
                            kk * 16 + ((lane / 8) % 2) * 8);
        mma16816(sc[2 * j], a, bf[0], bf[1]);
        mma16816(sc[2 * j + 1], a, bf[2], bf[3]);
      }
    }

    // mask by each row's length, fold k_scale and the softmax scale in
    const int kbase = kt * KT;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = 8 * n + 2 * (lane % 4) + e;
        float mul = sl2;
        if constexpr (QUANT) mul *= kss[st * KT + kl];
        const int kpos = kbase + kl;
        const float x0 = kpos < plen[0] ? sc[n][e] * mul : -INFINITY;
        const float x1 = kpos < plen[1] ? sc[n][2 + e] * mul : -INFINITY;
        sc[n][e] = x0;
        sc[n][2 + e] = x1;
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
    const float u0 = n0 == -INFINITY ? 0.f : n0;
    const float u1 = n1 == -INFINITY ? 0.f : n1;
    const float c0 = exp2f(m0 - u0);
    const float c1 = exp2f(m1 - u1);
    m0 = n0;
    m1 = n1;
    float s0 = 0.f, s1 = 0.f;
    uint32_t pa[KT / 16][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(sc[n][e] - (e < 2 ? u0 : u1));
      }
      s0 += p[0] + p[1];
      s1 += p[2] + p[3];
      if constexpr (QUANT) {
        // v_scale folds into P's columns before the bf16 rounding
        const int kl = 8 * n + 2 * (lane % 4);
        const float v0 = vss[st * KT + kl];
        const float v1 = vss[st * KT + kl + 1];
        p[0] *= v0;
        p[1] *= v1;
        p[2] *= v0;
        p[3] *= v1;
      }
      pa[n / 2][(n % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }
    // O += P V
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vt_s + (kk * 16 + lane % 8 +
                                      ((lane / 8) % 2) * 8) * LD +
                                  j * 16 + (lane / 16) * 8);
        mma16816(o[2 * j], pa[kk], bf[0], bf[1]);
        mma16816(o[2 * j + 1], pa[kk], bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage (and the int8 copy) may be overwritten
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const int col = 2 * (lane % 4);
  if (splits == 1) {
    const float inv[2] = {l0 > 0.f ? 1.f / l0 : 0.f,
                          l1 > 0.f ? 1.f / l1 : 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (prow[e] < 0) continue;
      __nv_bfloat16* dst =
          out + (size_t(prow[e]) * H + phead[e]) * D + col;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(o[n][2 * e] * inv[e],
                                  o[n][2 * e + 1] * inv[e]);
      }
    }
    return;
  }
  // split-K partials: unnormalized acc, m in log2 units, l
  const float mm[2] = {m0, m1};
  const float ll[2] = {l0, l1};
  const size_t n_out = size_t(rows) * H;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (prow[e] < 0) continue;
    const size_t idx = size_t(split) * n_out + size_t(prow[e]) * H +
                       phead[e];
    float* dst = part_o + idx * D + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[n][2 * e], o[n][2 * e + 1]);
    }
    if (lane % 4 == 0) {
      part_ml[2 * idx] = mm[e];
      part_ml[2 * idx + 1] = ll[e];
    }
  }
}

// The continuation kernel: tile `sub` of table row `tg` for each CTA, the
// R rows of each table row in tiles of RT.
template <int D, typename T>
__global__ void __launch_bounds__(128)
ragged_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ tables,
              const int* __restrict__ lengths,
              __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
              float* __restrict__ part_ml, int rows, int R, int RT, int G,
              int H, int Hkv, int bs, int M, float sl2) {
  const int tpt = (R + RT - 1) / RT;
  const int tg = blockIdx.x / tpt;
  const int sub = blockIdx.x % tpt;
  tile_cta<D, T>(q, kp, vp, k_scale, v_scale, tables + size_t(tg) * M,
                 lengths, out, part_o, part_ml, rows, tg * R + sub * RT,
                 min(RT, R - sub * RT), G, H, Hkv, bs, M, sl2, blockIdx.y,
                 blockIdx.z, gridDim.z);
}

// Output vector i (of n_out per split), columns d and d + 1, merged from
// `splits` partials by log-sum-exp and normalized, in one pass with a
// running max. A split with l = 0 saw no live key and is skipped; if all
// are, the output is zeros. Loads bypass L1 (the partials may come from
// other CTAs of the same launch) and go out 8 splits at a time, since a
// loop that waits on each split's load in turn pays a round trip to the
// L2 per split.
__device__ __forceinline__ __nv_bfloat162 merged_pair(
    const float* part_o, const float* part_ml, size_t n_out, size_t i,
    int D, int d, int splits) {
  constexpr int BATCH = 8;
  float mx = -INFINITY, a0 = 0.f, a1 = 0.f, l = 0.f;
  for (int s0 = 0; s0 < splits; s0 += BATCH) {
    float2 ml[BATCH], v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const size_t idx = size_t(min(s0 + k, splits - 1)) * n_out + i;
      ml[k] = __ldcg(reinterpret_cast<const float2*>(part_ml + 2 * idx));
      v[k] = __ldcg(reinterpret_cast<const float2*>(part_o + idx * D + d));
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (s0 + k >= splits || !(ml[k].y > 0.f)) continue;
      const float nm = fmaxf(mx, ml[k].x);
      const float c = exp2f(mx - nm);  // 0 while mx is -inf
      const float w = exp2f(ml[k].x - nm);
      l = l * c + w * ml[k].y;
      a0 = a0 * c + w * v[k].x;
      a1 = a1 * c + w * v[k].y;
      mx = nm;
    }
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  return __floats2bfloat162_rn(a0 * inv, a1 * inv);
}

// Merge `splits` partials of each (row, head): one warp per output vector.
template <int D>
__global__ void merge_kernel(const float* __restrict__ part_o,
                             const float* __restrict__ part_ml,
                             __nv_bfloat16* __restrict__ out, int n_out,
                             int splits) {
  const int i = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= n_out) return;
  for (int d = 2 * lane; d < D; d += 64) {
    *reinterpret_cast<__nv_bfloat162*>(out + size_t(i) * D + d) =
        merged_pair(part_o, part_ml, n_out, i, D, d, splits);
  }
}

// -- the decode CTA -----------------------------------------------------------

constexpr int DEC_WARPS = 4;
constexpr int DEC_MAX_G = 32;  // query heads per kv head: two m16 tiles

// Shared memory of the decode CTA:
//   q    [32][LD] bf16, the G product rows (zeros past G; rows padded by 8
//        values against ldmatrix bank conflicts);
//   k, v [S stages][KT][SLD] of the pool type (SLD = LD for bf16, read in
//        place; D for int8, a staging copy);
//   int8 only: kc, vc [KT][LD] bf16, the converted tile;
//   koff [S + 1][KT] int, each key's pool row (-1: past the length), and,
//        int8 only, ks, vs [S + 1][KT] f32, each key's block scales.
// After the walk the ring holds the warps' partials o [4][16][D] and
// (m, l) [4][16][2] f32 for their merge.
template <int D, typename T>
struct DecodeSmem {
  static constexpr bool QUANT = sizeof(T) == 1;
  static constexpr int LD = D + 8;
  static constexpr int SLD = QUANT ? D : LD;
  static constexpr int S = QUANT ? 4 : 3;
  static constexpr size_t stage = size_t(KT) * SLD * sizeof(T);
  static constexpr size_t q_bytes = size_t(DEC_MAX_G) * LD * 2;
  static constexpr size_t ring = 2 * S * stage;
  static constexpr size_t conv = QUANT ? 2 * size_t(KT) * LD * 2 : 0;
  static constexpr size_t meta = size_t(S + 1) * KT * 4 * (QUANT ? 3 : 1);
  static constexpr size_t bytes = q_bytes + ring + conv + meta;
  static_assert(size_t(DEC_WARPS) * 16 * (D + 2) * 4 <= ring,
                "the warps' partials fit in the ring");
  static_assert(bytes <= 232448, "227 KB of shared memory per block");
};

// One decode CTA: query row `row` over the table row `trow`, kv head
// `kvh`, split `split` of `splits`. `slot` (of `n_slots`) indexes its split
// partials ([splits, n_slots, H]) and its merge counter ([n_slots, Hkv]).
template <int D, typename T>
__device__ __forceinline__ void decode_cta(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ trow,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ part_ml,
    int* __restrict__ counters, int row, int slot, int n_slots, int G, int H,
    int Hkv, int bs, int M, float sl2, int kvh, int split, int splits) {
  using SM = DecodeSmem<D, T>;
  constexpr bool QUANT = SM::QUANT;
  constexpr int LD = SM::LD;
  constexpr int SLD = SM::SLD;
  constexpr int S = SM::S;
  constexpr int NT = DEC_WARPS * 32;
  constexpr int EPC = 16 / int(sizeof(T));  // pool values per 16 bytes
  constexpr int CPK = D / EPC;              // 16-byte chunks per key
  constexpr unsigned FULL = 0xffffffffu;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  T* kst = reinterpret_cast<T*>(smem + SM::q_bytes);
  T* vst = kst + size_t(S) * KT * SLD;
  __nv_bfloat16* kc =
      reinterpret_cast<__nv_bfloat16*>(smem + SM::q_bytes + SM::ring);
  __nv_bfloat16* vc = kc + KT * LD;
  int* koff = reinterpret_cast<int*>(smem + SM::q_bytes + SM::ring +
                                     SM::conv);
  float* kss = reinterpret_cast<float*>(koff + (S + 1) * KT);
  float* vss = kss + (S + 1) * KT;

  const int len = min(max(lengths[row], 0), M * bs);
  const int nkt = (len + KT - 1) / KT;
  // split s takes key tiles s, s + splits, ...: its tile j is
  // split + j * splits, known before the length is
  const int n = split < nkt ? (nkt - split + splits - 1) / splits : 0;

  // one m16 tile of heads when G <= 16, else two; warp w takes tile w % MT
  // and the MT 16-key chunks from (w / MT) * MT of every key tile
  const int MT = G > 16 ? 2 : 1;
  const int mt = warp % MT;
  const int chunk0 = (warp / MT) * MT;

  for (int i = tid; i < MT * 16 * (D / 8); i += NT) {
    const int p = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (p < G) {
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t(row) * H + kvh * G + p) * D + c));
    }
    *reinterpret_cast<uint4*>(qs + p * LD + c) = val;
  }

  // Warps 0 and 1 map keys [32 w, 32 w + 32) of tile j to pool rows. Lane
  // l loads table entry e0 + l of those keys (each entry read once), a
  // tile ahead of its use, whatever the length (an entry past it is in
  // the table row all the same, and goes unused); write_meta shuffles
  // each key its entry.
  auto first_key = [&](int j) {
    return (split + j * splits) * KT + warp * 32;
  };
  const bool bs_pow2 = (bs & (bs - 1)) == 0;
  const int bs_log2 = __ffs(bs) - 1;
  auto div_bs = [&](int x) { return bs_pow2 ? x >> bs_log2 : x / bs; };
  auto load_entry = [&](int j) -> int {
    const int kf = first_key(j);
    const int e = div_bs(kf) + lane;
    return e < M && e <= div_bs(kf + 31) ? trow[e] : 0;
  };
  auto write_meta = [&](int j, int ent) {
    const int kf = first_key(j);
    const int kpos = kf + lane;
    const bool live = j < n && kpos < len;
    const int e0 = div_bs(kf);
    const int e = div_bs(kpos);
    const int src = live ? e - e0 : 0;
    const int blk = __shfl_sync(FULL, ent, src);
    const int at = (j % (S + 1)) * KT + warp * 32 + lane;
    koff[at] = live ? (blk * bs + kpos - e * bs) * Hkv + kvh : -1;
    if constexpr (QUANT) {
      float ks = 0.f, vs = 0.f;
      if (j < n && kf < len && e0 + lane <= div_bs(min(kf + 31, len - 1))) {
        ks = k_scale[size_t(ent) * Hkv + kvh];
        vs = v_scale[size_t(ent) * Hkv + kvh];
      }
      ks = __shfl_sync(FULL, ks, src);
      vs = __shfl_sync(FULL, vs, src);
      kss[at] = live ? ks : 0.f;
      vss[at] = live ? vs : 0.f;
    }
  };
  // every thread copies its 16-byte chunks of tile j's live keys (zeros
  // past the length) into stage j % S; one commit group per tile
  auto issue = [&](int j) {
    if (j < n) {
      const int* ko = koff + (j % (S + 1)) * KT;
      T* dk = kst + size_t(j % S) * KT * SLD;
      T* dv = vst + size_t(j % S) * KT * SLD;
#pragma unroll
      for (int it = 0; it < KT * CPK / NT; ++it) {
        const int i = tid + it * NT;
        const int key = i / CPK;
        const int c = (i % CPK) * EPC;
        const int r = ko[key];
        const size_t off = r >= 0 ? size_t(r) * D + c : 0;
        const int nb = r >= 0 ? 16 : 0;
        cp_async16(dk + key * SLD + c, kp + off, nb);
        cp_async16(dv + key * SLD + c, vp + off, nb);
      }
    }
    cp_async_commit();
  };

  int ent = 0;
  if (warp < 2) {
    int first[S];  // the first S tiles' entries, loaded all at once
#pragma unroll
    for (int j = 0; j < S; ++j) first[j] = load_entry(j);
#pragma unroll
    for (int j = 0; j < S - 1; ++j) write_meta(j, first[j]);
    ent = first[S - 1];
  }
  __syncthreads();
  for (int j = 0; j < S - 1; ++j) issue(j);
  // up to D = 128 the warp's Q fragments stay in registers for the walk
  constexpr bool QREG = D <= 128;
  uint32_t qa[QREG ? D / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ldmatrix_x4(qa[kk], qs + (mt * 16 + lane % 16) * LD + kk * 16 +
                              (lane / 16) * 8);
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int x = 0; x < D / 8; ++x) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[x][e] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n; ++i) {
    if (warp < 2) {
      write_meta(i + S - 1, ent);
      ent = load_entry(i + S);
    }
    cp_async_wait<S - 2>();  // tile i's copies (this thread's) are in
    __syncthreads();         // ...everyone's; tile i - 1 is done with
    issue(i + S - 1);        // into tile i - 1's stage
    const int st = i % S;
    const int at = (i % (S + 1)) * KT;
    const __nv_bfloat16* kt_s;
    const __nv_bfloat16* vt_s;
    if constexpr (QUANT) {
      // warp w converts keys [16 w, 16 w + 16) to bf16, exact; the scales
      // stay apart
      for (int x = lane; x < 16 * (D / 16); x += 32) {
        const int key = 16 * warp + x / (D / 16);
        const int c = (x % (D / 16)) * 16;
        const int4 rk = *reinterpret_cast<const int4*>(
            kst + (size_t(st) * KT + key) * SLD + c);
        const int4 rv = *reinterpret_cast<const int4*>(
            vst + (size_t(st) * KT + key) * SLD + c);
        const int8_t* bk = reinterpret_cast<const int8_t*>(&rk);
        const int8_t* bv = reinterpret_cast<const int8_t*>(&rv);
        uint32_t wk[8], wv[8];
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          wk[y] = pack_bf16(float(bk[2 * y]), float(bk[2 * y + 1]));
          wv[y] = pack_bf16(float(bv[2 * y]), float(bv[2 * y + 1]));
        }
        uint4* dk = reinterpret_cast<uint4*>(kc + key * LD + c);
        uint4* dv = reinterpret_cast<uint4*>(vc + key * LD + c);
        dk[0] = make_uint4(wk[0], wk[1], wk[2], wk[3]);
        dk[1] = make_uint4(wk[4], wk[5], wk[6], wk[7]);
        dv[0] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
        dv[1] = make_uint4(wv[4], wv[5], wv[6], wv[7]);
      }
      if (MT > 1) {
        __syncthreads();  // two warps read each converted quarter
      } else {
        __syncwarp();
      }
      kt_s = kc;
      vt_s = vc;
    } else {
      kt_s = reinterpret_cast<const __nv_bfloat16*>(kst) +
             size_t(st) * KT * LD;
      vt_s = reinterpret_cast<const __nv_bfloat16*>(vst) +
             size_t(st) * KT * LD;
    }
    const int kbase = (split + i * splits) * KT;
    for (int cc = 0; cc < MT; ++cc) {
      const int ch = chunk0 + cc;  // this warp's 16 keys of the tile
      // S = Q K^T: 16 product rows x 16 keys, the D/16 steps in two
      // independent accumulator chains (even and odd steps) summed after
      float sc[2][4], sd[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[x][e] = sd[x][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], bf[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
        } else {
          ldmatrix_x4(a, qs + (mt * 16 + lane % 16) * LD + kk * 16 +
                             (lane / 16) * 8);
        }
        ldmatrix_x4(bf, kt_s + (ch * 16 + lane % 8 + (lane / 16) * 8) * LD +
                            kk * 16 + ((lane / 8) % 2) * 8);
        float (&acc0)[4] = kk % 2 ? sd[0] : sc[0];
        float (&acc1)[4] = kk % 2 ? sd[1] : sc[1];
        mma16816(acc0, a, bf[0], bf[1]);
        mma16816(acc1, a, bf[2], bf[3]);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[x][e] += sd[x][e];
      }
      // mask by the row's length, fold k_scale and the softmax scale in
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kl = ch * 16 + 8 * x + 2 * (lane % 4) + e;
          float mul = sl2;
          if constexpr (QUANT) mul *= kss[at + kl];
          const bool live = kbase + kl < len;
          const float x0 = live ? sc[x][e] * mul : -INFINITY;
          const float x1 = live ? sc[x][2 + e] * mul : -INFINITY;
          sc[x][e] = x0;
          sc[x][2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, w));
      }
      const float n0 = fmaxf(m0, mx0);
      const float n1 = fmaxf(m1, mx1);
      const float u0 = n0 == -INFINITY ? 0.f : n0;
      const float u1 = n1 == -INFINITY ? 0.f : n1;
      const float c0 = exp2f(m0 - u0);
      const float c1 = exp2f(m1 - u1);
      m0 = n0;
      m1 = n1;
      float s0 = 0.f, s1 = 0.f;
      uint32_t pa[4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(sc[x][e] - (e < 2 ? u0 : u1));
        }
        s0 += p[0] + p[1];
        s1 += p[2] + p[3];
        if constexpr (QUANT) {
          // v_scale folds into P's columns before the bf16 rounding
          const int kl = ch * 16 + 8 * x + 2 * (lane % 4);
          const float v0 = vss[at + kl];
          const float v1 = vss[at + kl + 1];
          p[0] *= v0;
          p[1] *= v1;
          p[2] *= v0;
          p[3] *= v1;
        }
        pa[2 * x] = pack_bf16(p[0], p[1]);
        pa[2 * x + 1] = pack_bf16(p[2], p[3]);
      }
      l0 = l0 * c0 + s0;
      l1 = l1 * c1 + s1;
#pragma unroll
      for (int x = 0; x < D / 8; ++x) {
        o[x][0] *= c0;
        o[x][1] *= c0;
        o[x][2] *= c1;
        o[x][3] *= c1;
      }
      // O += P V over the chunk's 16 keys
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vt_s + (ch * 16 + lane % 8 +
                                      ((lane / 8) % 2) * 8) * LD +
                                  j * 16 + (lane / 16) * 8);
        mma16816(o[2 * j], pa, bf[0], bf[1]);
        mma16816(o[2 * j + 1], pa, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, w);
    l1 += __shfl_xor_sync(FULL, l1, w);
  }
  // the warps' partials into the ring, which no copy targets any more
  cp_async_wait<0>();
  __syncthreads();
  float* wo = reinterpret_cast<float*>(smem + SM::q_bytes);  // [4][16][D]
  float* wml = wo + DEC_WARPS * 16 * D;                        // [4][16][2]
  {
    const int g = lane / 4;
    const int col = 2 * (lane % 4);
    float* base = wo + warp * 16 * D;
#pragma unroll
    for (int x = 0; x < D / 8; ++x) {
      *reinterpret_cast<float2*>(base + g * D + 8 * x + col) =
          make_float2(o[x][0], o[x][1]);
      *reinterpret_cast<float2*>(base + (g + 8) * D + 8 * x + col) =
          make_float2(o[x][2], o[x][3]);
    }
    if (lane % 4 == 0) {
      wml[(warp * 16 + g) * 2] = m0;
      wml[(warp * 16 + g) * 2 + 1] = l0;
      wml[(warp * 16 + g + 8) * 2] = m1;
      wml[(warp * 16 + g + 8) * 2 + 1] = l1;
    }
  }
  __syncthreads();
  // merge the DEC_WARPS / MT warps that share each head's m16 tile: head p
  // lives in row p % 16 of tile p / 16, in warps k * MT + p / 16
  const int nkg = DEC_WARPS / MT;
  const size_t n_out = size_t(n_slots) * H;
  for (int x = tid; x < G * (D / 2); x += NT) {
    const int p = x / (D / 2);
    const int d = (x % (D / 2)) * 2;
    const int r = p % 16;
    float mx = -INFINITY;
    for (int k = 0; k < nkg; ++k) {
      const int w = k * MT + p / 16;
      if (wml[(w * 16 + r) * 2 + 1] > 0.f) {
        mx = fmaxf(mx, wml[(w * 16 + r) * 2]);
      }
    }
    float a0 = 0.f, a1 = 0.f, l = 0.f;
    for (int k = 0; k < nkg; ++k) {
      const int w = k * MT + p / 16;
      const float lw = wml[(w * 16 + r) * 2 + 1];
      if (!(lw > 0.f)) continue;
      const float wt = exp2f(wml[(w * 16 + r) * 2] - mx);
      l += wt * lw;
      const float2 v =
          *reinterpret_cast<const float2*>(wo + (w * 16 + r) * D + d);
      a0 += wt * v.x;
      a1 += wt * v.y;
    }
    if (splits == 1) {
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const size_t head = size_t(row) * H + kvh * G + p;
      *reinterpret_cast<__nv_bfloat162*>(out + head * D + d) =
          __floats2bfloat162_rn(a0 * inv, a1 * inv);
    } else {
      // split-K partials: unnormalized acc, m in log2 units, l
      const size_t idx =
          size_t(split) * n_out + size_t(slot) * H + kvh * G + p;
      *reinterpret_cast<float2*>(part_o + idx * D + d) = make_float2(a0, a1);
      if (d == 0) {
        part_ml[2 * idx] = mx;
        part_ml[2 * idx + 1] = l;
      }
    }
  }
  if (splits == 1 || counters == nullptr) return;

  // the last split CTA of this (row, kv head) to finish merges them all
  __shared__ int last;
  __threadfence();  // this CTA's partials are visible before its count
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(counters + size_t(slot) * Hkv + kvh, 1) == splits - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int x = tid; x < G * (D / 2); x += NT) {
    const int p = x / (D / 2);
    const int d = (x % (D / 2)) * 2;
    const size_t head = size_t(row) * H + kvh * G + p;
    *reinterpret_cast<__nv_bfloat162*>(out + head * D + d) = merged_pair(
        part_o, part_ml, n_out, size_t(slot) * H + kvh * G + p, D, d,
        splits);
  }
  if (tid == 0) counters[size_t(slot) * Hkv + kvh] = 0;  // for the next call
}

// The decode kernel: one row, its own table row, per CTA x.
template <int D, typename T>
__global__ void __launch_bounds__(DEC_WARPS * 32)
decode_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ tables,
              const int* __restrict__ lengths,
              __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
              float* __restrict__ part_ml, int* __restrict__ counters,
              int rows, int G, int H, int Hkv, int bs, int M, float sl2) {
  const int row = blockIdx.x;
  decode_cta<D, T>(q, kp, vp, k_scale, v_scale, tables + size_t(row) * M,
                   lengths, out, part_o, part_ml, counters, row, row, rows, G,
                   H, Hkv, bs, M, sl2, blockIdx.y, blockIdx.z, gridDim.z);
}

// -- row groups ---------------------------------------------------------------

// A launch over row groups (the fused step's mixed rows): entry i is rows
// [first[i], first[i] + count[i]), every one of them attending through
// table row trow[i], and owns CTAs [begin[i], begin[i + 1]) of the grid's
// y (its x is the kv head). A group of one row takes the decode CTA
// (dec_splits CTAs; slot i of the split partials and counters); a larger
// group takes tile CTAs of RT rows, unsplit, so its rows share each K/V
// tile they load. The entries list the tile groups first: blocks are
// dispatched in order, so the chunk's long CTAs take the first wave and
// the short decode CTAs fill the slots around and after them (in row
// order the chunk's CTAs queued behind the decode ones and ended last).
// Passed by value: a captured graph keeps it with the launch.
constexpr int MAX_GROUPS = 128;
struct Groups {
  int n;
  int dec_splits;
  int first[MAX_GROUPS];
  int count[MAX_GROUPS];
  int trow[MAX_GROUPS];
  int begin[MAX_GROUPS + 1];
};

template <int D, typename T>
__global__ void __launch_bounds__(DEC_WARPS * 32)
groups_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ tables,
              const int* __restrict__ lengths,
              __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
              float* __restrict__ part_ml, int* __restrict__ counters,
              const __grid_constant__ Groups g, int rows, int RT, int G,
              int H, int Hkv, int bs, int M, float sl2) {
  // the group whose CTAs hold this one: begin[i] <= x < begin[i + 1]
  const int x = blockIdx.y;
  int lo = 0, hi = g.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (g.begin[mid] <= x) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int local = x - g.begin[lo];
  const int first = g.first[lo];
  const int count = g.count[lo];
  const int* trow = tables + size_t(g.trow[lo]) * M;
  if (count == 1 && G <= DEC_MAX_G) {
    decode_cta<D, T>(q, kp, vp, k_scale, v_scale, trow, lengths, out,
                     part_o, part_ml, counters, first, lo, g.n, G, H, Hkv,
                     bs, M, sl2, blockIdx.x, local, g.dec_splits);
  } else {
    tile_cta<D, T>(q, kp, vp, k_scale, v_scale, trow, lengths, out, part_o,
                   part_ml, rows, first + local * RT,
                   min(RT, count - local * RT), G, H, Hkv, bs, M, sl2,
                   blockIdx.x, 0, 1);
  }
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
  void* part_o;
  void* part_ml;
  void* counters;
  int rows, R, RT, H, Hkv, bs, M, splits;
  float scale;
};

template <int D>
cudaError_t launch_merge(const Args& a, cudaStream_t stream) {
  const int n_out = a.rows * a.H;
  merge_kernel<D><<<(n_out + 3) / 4, 128, 0, stream>>>(
      static_cast<const float*>(a.part_o),
      static_cast<const float*>(a.part_ml),
      static_cast<__nv_bfloat16*>(a.out), n_out, a.splits);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_decode(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = DecodeSmem<D, T>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.rows, a.Hkv, a.splits);
  decode_kernel<D, T><<<grid, DEC_WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const T*>(a.k_pool), static_cast<const T*>(a.v_pool),
      static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.lengths),
      static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.part_o),
      static_cast<float*>(a.part_ml), static_cast<int*>(a.counters), a.rows,
      a.H / a.Hkv, a.H, a.Hkv, a.bs, a.M, a.scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1 || a.counters) return err;
  return launch_merge<D>(a, stream);
}

template <int D, typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  if (a.R == 1 && G <= DEC_MAX_G) return launch_decode<D, T>(a, stream);
  const int warps = (a.RT * G + 15) / 16;
  const size_t smem = Smem<D, T>::bytes(warps);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (a.rows / a.R) * ((a.R + a.RT - 1) / a.RT);
  const dim3 grid(tiles, a.Hkv, a.splits);
  ragged_kernel<D, T><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const T*>(a.k_pool), static_cast<const T*>(a.v_pool),
      static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.lengths),
      static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.part_o),
      static_cast<float*>(a.part_ml), a.rows, a.R, a.RT, G, a.H, a.Hkv,
      a.bs, a.M, a.scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return launch_merge<D>(a, stream);
}

template <int D>
cudaError_t launch_pool(const Args& a, bool quantized, cudaStream_t stream) {
  return quantized ? launch<D, int8_t>(a, stream)
                   : launch<D, __nv_bfloat16>(a, stream);
}

// One launch of groups_kernel: 128 threads, the shared memory of the larger
// of the two CTAs.
template <int D, typename T>
cudaError_t launch_groups(const Args& a, const Groups& g,
                          cudaStream_t stream) {
  constexpr size_t dsm = DecodeSmem<D, T>::bytes;
  const size_t tsm = Smem<D, T>::bytes(DEC_WARPS);
  const size_t smem = dsm > tsm ? dsm : tsm;
  cudaError_t err = cudaFuncSetAttribute(
      groups_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hkv, g.begin[g.n], 1);
  groups_kernel<D, T><<<grid, DEC_WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const T*>(a.k_pool), static_cast<const T*>(a.v_pool),
      static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.lengths),
      static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.part_o),
      static_cast<float*>(a.part_ml), static_cast<int*>(a.counters), g,
      a.rows, a.RT, a.H / a.Hkv, a.H, a.Hkv, a.bs, a.M, a.scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_groups_pool(const Args& a, const Groups& g,
                               bool quantized, cudaStream_t stream) {
  return quantized ? launch_groups<D, int8_t>(a, g, stream)
                   : launch_groups<D, __nv_bfloat16>(a, g, stream);
}

}  // namespace

// Returns a cudaError_t as int: 0 when the launch was accepted.
//   quantized: the pool is int8 and k_scale / v_scale point at its [N, Hkv]
//     f32 scales; otherwise the pool is bf16 and they are not read;
//   rows_per_table (R): tables is [rows / R, M]; R = 1 with at most 32
//     query heads per kv head takes the decode CTA (rows_per_tile 1);
//   rows_per_tile (RT): rows of one table per CTA, RT * (H / Hkv) <= 64;
//   splits: CTAs sharing each tile's keys; above 1, part_o [splits, rows,
//     H, D] and part_ml [splits, rows, H, 2] f32 scratch hold the partials;
//   counters: null, or [rows, Hkv] int32 zeros (and left zero) with which
//     the decode CTA's last split merges the partials; otherwise a second
//     kernel merges them.
extern "C" int shai_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, void* part_o, void* part_ml,
    void* counters, int rows, int rows_per_table, int rows_per_tile, int H,
    int Hkv, int D, int bs, int M, int quantized, int splits, float scale,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = rows_per_table;
  const int RT = rows_per_tile;
  if (rows < 1 || R < 1 || rows % R != 0 || RT < 1 || RT > R ||
      Hkv < 1 || Hkv > 65535 || H % Hkv != 0 ||
      RT * (H / Hkv) > MAX_PROWS || bs < 1 || M < 1 || splits < 1 ||
      splits > 65535 || (quantized && (!k_scale || !v_scale)) ||
      (splits > 1 && (!part_o || !part_ml))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,       k_pool, v_pool, k_scale, v_scale, tables,
               lengths, out,    part_o, part_ml, counters, rows,
               R,       RT,     H,      Hkv,     bs,       M,
               splits,  scale};
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

// Returns a cudaError_t as int: 0 when the launch was accepted. The row-group
// form of the same attention (see groups_kernel):
//   groups: host int32 [n_groups, 3] (first row, row count, table row), in
//     row order, covering rows 0 .. rows - 1 exactly; n_groups <= 128;
//     tables is [n_tables, M];
//   rows_per_tile (RT): rows per tile CTA of a group of more than one row,
//     RT * (H / Hkv) <= 64; those groups are not split;
//   dec_splits: CTAs sharing each decode group's keys; above 1, part_o
//     [dec_splits, n_groups, H, D] and part_ml [dec_splits, n_groups, H, 2]
//     f32 scratch and counters [n_groups, Hkv] int32 zeros (left zero): the
//     last split of each (group, kv head) merges the partials.
extern "C" int shai_ragged_paged_attention_groups(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, void* part_o, void* part_ml,
    void* counters, const void* groups, int n_groups, int rows,
    int rows_per_tile, int dec_splits, int H, int Hkv, int D, int bs, int M,
    int n_tables, int quantized, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int RT = rows_per_tile;
  if (n_groups < 1 || n_groups > MAX_GROUPS || !groups || rows < 1 ||
      RT < 1 || Hkv < 1 || Hkv > 65535 || H % Hkv != 0 ||
      RT * (H / Hkv) > MAX_PROWS || bs < 1 || M < 1 || n_tables < 1 ||
      dec_splits < 1 || dec_splits > 65535 ||
      (quantized && (!k_scale || !v_scale))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = H / Hkv;
  const int* desc = static_cast<const int*>(groups);
  int next_row = 0;
  bool split_decode = false;
  for (int i = 0; i < n_groups; ++i) {
    const int first = desc[3 * i], count = desc[3 * i + 1];
    const int trow = desc[3 * i + 2];
    if (first != next_row || count < 1 || trow < 0 || trow >= n_tables) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    next_row = first + count;
    split_decode |= count == 1 && G <= DEC_MAX_G && dec_splits > 1;
  }
  if (next_row != rows ||
      (split_decode && (!part_o || !part_ml || !counters))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the entries in dispatch order: the tile groups, then the decode groups
  Groups g{};
  g.n = n_groups;
  g.dec_splits = dec_splits;
  long long ctas = 0;
  int at = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < n_groups; ++i) {
      const int count = desc[3 * i + 1];
      const bool decode = count == 1 && G <= DEC_MAX_G;
      if (decode != (pass == 1)) continue;
      g.first[at] = desc[3 * i];
      g.count[at] = count;
      g.trow[at] = desc[3 * i + 2];
      g.begin[at] = static_cast<int>(ctas);
      ctas += decode ? dec_splits : (count + RT - 1) / RT;
      ++at;
    }
  }
  if (ctas > 65535) return static_cast<int>(cudaErrorInvalidValue);
  g.begin[n_groups] = static_cast<int>(ctas);
  const Args a{q,       k_pool, v_pool, k_scale,    v_scale, tables,
               lengths, out,    part_o, part_ml,    counters, rows,
               1,       RT,     H,      Hkv,        bs,       M,
               dec_splits, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(launch_groups_pool<64>(a, g, quantized, st));
    case 128:
      return static_cast<int>(launch_groups_pool<128>(a, g, quantized, st));
    case 192:
      return static_cast<int>(launch_groups_pool<192>(a, g, quantized, st));
    case 256:
      return static_cast<int>(launch_groups_pool<256>(a, g, quantized, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
