// W8A16 projection for Hopper (kernel B4): bf16 activations times int8
// weights with a per-output-channel f32 scale, at every width of the
// serving path: the decode instantiation (M <= 64 rows: every projection
// of a decode step, the lm_head on sampled rows) and the wide one (M > 64:
// prefill, continuation chunks, the fused step's window).
//
// Replaces: no Pallas kernel. The JAX package leaves the int8 product to
// XLA (scalable_hw_agnostic_inference_tpu/ops/quant.py quant_matmul, :142:
// "(x @ kernel_q.astype(bf16)) * scale.astype(bf16)"), which loads the
// int8 tiles from device memory and converts them in registers, at every
// width. On the card that fusion is written by hand: the plain PyTorch
// expression writes a dequantized bf16 copy of every weight and reads it
// back on every call, 5 bytes per weight against bf16's 2.
//
// Contract: x [M, K] bf16 contiguous, wq [N, K] int8 contiguous (the
//   nn.Linear layout, [out, in]), scale [N] f32 -> y [M, N] bf16 with
//   y[m, n] = bf16(bf16(sum_k x[m, k] * wq[n, k]) * bf16(scale[n])):
//   the sum in fp32, rounded to bf16, then multiplied by the bf16-rounded
//   scale and rounded again (the reference's order). M >= 1, N % 8 == 0,
//   K % 16 == 0 (the tensor maps' row strides); x, wq 16-byte aligned.
//
// What bounds it on the H100: at M <= 64 each weight byte feeds at most 64
//   multiply-adds, far under the card's ~295 operations per byte, so the
//   N K weight bytes over 3.35 TB/s do (an SM has to take in some 25 GB/s).
//   From about 300 rows up the tensor cores do (2 M N K at 989 TFLOP/s).
//
// Design (one source, one kernel, int8_matmul_kernel<NX, RW>: NX x rows, 8,
// 16, 32 or 64 for decode and 128 for wide; RW 64-row weight tiles a
// consumer warpgroup, 1, or 2 for wide calls with a tile for every SM):
//   - the product is computed transposed, y^T = Wq x^T: a 64-row weight
//     tile is wgmma's A operand, taken from registers, and x is its B
//     operand, K-major in shared memory, with wgmma's N = NX;
//   - a producer warpgroup (its registers given to the consumers by
//     setmaxnreg): one thread issues TMA loads of 128 k x (128 RW) rows of
//     int8 weights (128-byte swizzled) and the matching [NX, 128] x slice
//     (two boxes of 64 bf16) into a ring of mbarrier-guarded stages, 4
//     deep (3 for 256-row wide tiles); more stages measured slower at
//     decode widths. The TMA's zero fill gives the x rows past M and any
//     ragged N or K edge, with no masking code;
//   - two consumer warpgroups: each thread reads its A fragment of a k16
//     step (rows r and r + 8, k 2q, 2q + 1, 2q + 8, 2q + 9) as four 16-bit
//     shared-memory reads, conflict-free under the swizzle, and converts
//     it to bf16 exactly, 4 instructions a pair (spread the two bytes into
//     16-bit lanes; bf16 128 + (s & 127) less 128 or 256 by s's sign, one
//     bf16x2 fma); then issues the group's wgmmas and waits for them. The
//     conversion overlaps the copies in flight and the other warpgroup's
//     products, not barrier waits;
//   - a persistent CTA per SM walks its units (Walk below; the host plans
//     the same, ops/cuda/int8_matmul.py int8_plan): whole output tiles
//     round-robin for the full waves, so a wave's tiles share their weight
//     and x rows in L2, then a contiguous run of the (tile, k tile)
//     elements of the tiles left over, so every SM's load is within one k
//     tile of every other's and there is no ragged last wave;
//   - a tile whose k tiles fall to several CTAs is split: each piece writes
//     its fp32 partial to scratch (slot 2c + 1 for the piece that starts
//     the tile, 2c for the others: a CTA holds at most two pieces) and
//     bumps the tile's counter (an arrival count, never data); the last to
//     arrive adds the pieces in the order of their k ranges, a pure
//     function of the shape and the CTA count, so a CUDA graph replay is
//     bit-equal to an eager call, writes y and resets the counter to 0;
//   - the epilogue rounds, scales and rounds as the reference does and
//     writes bf16;
//   - the weight's tensor map is encoded once per (pointer, N, K, box rows)
//     and cached (a map is a pure function of those and the kernel's fixed
//     box width and swizzle, so the cache cannot go stale); x's is encoded
//     per call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "hopper_sm90.cuh"

using namespace shai_sm90;

namespace {

constexpr int WG = 128;                 // threads in a warpgroup
constexpr int CW = 2;                   // consumer warpgroups
constexpr int THREADS = (CW + 1) * WG;  // + one producer warpgroup
constexpr int TILE_K = 128;             // k a stage: one swizzled row
constexpr int SMEM_LIMIT = 232448;      // an H100 block's dynamic max
constexpr int MAX_STAGES = 4;

// NX x rows (wgmma's N); each consumer warpgroup owns RW tiles of 64 weight
// rows: one in the decode instantiations, two in the wide one (its x tile
// then feeds 256 weight rows, so the x bytes it takes in from L2 a
// multiply-add are two thirds of what 128 rows take).
template <int NX, int RW>
struct Cfg {
  static constexpr int TILE_N = CW * RW * 64;    // weight rows a tile
  static constexpr uint32_t W_BYTES = TILE_N * TILE_K;
  static constexpr uint32_t X_CHUNK = NX * 128;  // [NX, 64] bf16, swizzled
  static constexpr uint32_t STAGE = W_BYTES + 2 * X_CHUNK;
  // k16 steps a wgmma group: the wide instantiation converts and issues
  // half a stage at a time, so its A fragments and its two 64 x 128
  // accumulators fit a thread's registers
  static constexpr int GROUP = RW > 1 ? 4 : 8;
  // barriers (full and empty a stage), CW flags, 1024 bytes of slack to
  // align the base to a swizzle atom
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 256) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr size_t bar_off = size_t(STAGES) * STAGE;
  static constexpr size_t bytes = bar_off + 16 * STAGES + 4 * CW + 1024;
  static_assert(bytes <= SMEM_LIMIT, "stage ring over the shared memory");
};

// Two int8 (the low 16 bits of v, k ascending) -> a bf16 pair, exactly:
// each byte s in a 16-bit lane; bf16 0x4300 | (s & 127) is 128 + (s & 127)
// and bf16 0x4300 | (s & 128) is 128 or 256 by s's sign, so their
// difference is s (one fma, exact: the result is an integer in [-128,
// 127]).
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t v) {
  const uint32_t t = __byte_perm(v, 0u, 0x4140);
  const uint32_t a = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (t & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(b), "r"(0xBF80BF80u), "r"(a));
  return d;
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// atomicAdd with acquire-release order at device scope.
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// The CTA whose run holds element e: the largest c with c E / G <= e.
__device__ __forceinline__ int cta_of(int e, int E, int G) {
  return ((e + 1) * G - 1) / E;
}

// A CTA's walk over the output tiles (numbered n tile first, then m tile):
// whole tiles round-robin, tile u G + c at step u, for the full waves; then
// its run [c Er / G, (c + 1) Er / G) of the Er elements (tile, k tile) of
// the R < G tiles left, numbered from tile full G. Each step yields a unit:
// a tile and a k range of it. (The host keeps tiles times k tiles under
// 2^31, so Er G fits an int.)
struct Walk {
  int full, Er, r_hi, e, u;

  __device__ Walk(int tiles, int k_tiles, int G, int c) {
    full = tiles / G;
    Er = (tiles - full * G) * k_tiles;
    e = c * Er / G;
    r_hi = (c + 1) * Er / G;
    u = 0;
  }

  // The next unit of CTA c of G: its tile, k range and remainder tile index
  // (-1 for a whole tile of a full wave); false past the last.
  __device__ bool next(int G, int c, int k_tiles, int& tile, int& k0,
                       int& k1, int& rt) {
    if (u < full) {
      tile = u * G + c;
      k0 = 0;
      k1 = k_tiles;
      rt = -1;
      ++u;
      return true;
    }
    if (e >= r_hi) return false;
    rt = e / k_tiles;
    k0 = e - rt * k_tiles;
    k1 = min(k_tiles, r_hi - rt * k_tiles);
    tile = full * G + rt;
    e = rt * k_tiles + k1;
    return true;
  }
};

// The CTA's index and count, read afresh at each use: a copy held in a
// register across the main loop is what the wide instantiation would spill.
__device__ __forceinline__ int cta_index() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(v));
  return v;
}
__device__ __forceinline__ int cta_count() {
  int v;
  asm volatile("mov.u32 %0, %%nctaid.x;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int NX, int RW>
__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_kernel(const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_x,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                   int* __restrict__ counters, int M, int N, int m_tiles,
                   int n_tiles, int k_tiles) {
  using C = Cfg<NX, RW>;
  constexpr int STAGES = C::STAGES;
  constexpr int TILE_N = C::TILE_N;
  constexpr int ACC = NX / 2;   // accumulator floats a thread and row tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* empty = full + STAGES;
  volatile int* last = reinterpret_cast<volatile int*>(empty + STAGES);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CW * 4);   // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CW) {
    // producer warpgroup: it gives its registers up to the consumers, and
    // one thread starts every TMA load of the CTA's run
    setmaxnreg_dec<40>();
    if (threadIdx.x == CW * WG) {
      prefetch_tmap(&tm_w);
      prefetch_tmap(&tm_x);
      int it = 0;
      Walk walk(m_tiles * n_tiles, k_tiles, cta_count(), cta_index());
      int tile, rt, k0, k1;
      while (walk.next(cta_count(), cta_index(), k_tiles, tile, k0, k1,
                       rt)) {
        const int nt = tile / m_tiles;
        const int mt = tile - nt * m_tiles;
        for (int kt = k0; kt < k1; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], C::STAGE);
          unsigned char* st = smem + size_t(s) * C::STAGE;
          tma_load_2d(st, &tm_w, &full[s], kt * TILE_K, nt * TILE_N);
          tma_load_2d(st + C::W_BYTES, &tm_x, &full[s], kt * TILE_K,
                      mt * NX);
          tma_load_2d(st + C::W_BYTES + C::X_CHUNK, &tm_x, &full[s],
                      kt * TILE_K + 64, mt * NX);
        }
      }
    }
  } else {
    // consumer warpgroup wg: weight rows wg * 64 RW .. + 64 RW - 1 of the
    // tile, in RW row tiles; this thread's A rows of row tile t are
    // wrow + 64 t and + 8, its accumulator columns (x rows) 8 i + 2 q + {0, 1}
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % WG;
    const int lane = tid % 32;
    const int g8 = lane >> 2, q = lane & 3;
    const int wrow = wg * 64 * RW + (tid / 32) * 16 + g8;
    int it = 0;
    Walk walk(m_tiles * n_tiles, k_tiles, cta_count(), cta_index());
    int tile, rt, k0, k1;
    while (walk.next(cta_count(), cta_index(), k_tiles, tile, k0, k1,
                       rt)) {
      const int nt = tile / m_tiles;
      const int mt = tile - nt * m_tiles;

      float acc[RW][ACC];
#pragma unroll
      for (int t = 0; t < RW; ++t) {
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[t][i] = 0.f;
      }
      for (int kt = k0; kt < k1; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* st = smem + size_t(s) * C::STAGE;
        const uint64_t dx = desc_sw128(st + C::W_BYTES, 16);
        // row wrow's k16 step ks is the 16-byte chunk ks ^ (wrow % 8) of its
        // 128-byte row (TMA's 128-byte swizzle); row wrow + 8 is 1024 on
        const uint32_t ws = smem_u32(st + wrow * TILE_K + 2 * q);
#pragma unroll
        for (int g = 0; g < 8; g += C::GROUP) {
          uint32_t a[RW][C::GROUP][4];
#pragma unroll
          for (int t = 0; t < RW; ++t) {
#pragma unroll
            for (int j = 0; j < C::GROUP; ++j) {
              const uint32_t w = ws + t * 64 * TILE_K + (((g + j) ^ g8) << 4);
              a[t][j][0] = i8x2_to_bf16x2(lds_u16(w));
              a[t][j][1] = i8x2_to_bf16x2(lds_u16(w + 1024));
              a[t][j][2] = i8x2_to_bf16x2(lds_u16(w + 8));
              a[t][j][3] = i8x2_to_bf16x2(lds_u16(w + 1024 + 8));
            }
          }
#pragma unroll
          for (int t = 0; t < RW; ++t) fence_regs(acc[t]);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < C::GROUP; ++j) {
            // k16 step ks of x: 32 bytes on in a 64-wide chunk (the
            // descriptor's address field counts 16-byte units)
            const int ks = g + j;
            const uint64_t db =
                dx + ((ks / 4) * C::X_CHUNK + (ks % 4) * 32) / 16;
#pragma unroll
            for (int t = 0; t < RW; ++t) RsK<NX>::mma(acc[t], a[t][j], db, 1);
          }
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int t = 0; t < RW; ++t) fence_regs(acc[t]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }

      if (k0 > 0 || k1 < k_tiles) {
        // a split tile: this piece's partial to its slot, then the last
        // piece to arrive adds all of them in k order
        const int first = rt * k_tiles;
        const int c = cta_index(), G = cta_count();
        const int c_lo = cta_of(first, walk.Er, G);
        const int c_hi = cta_of(first + k_tiles - 1, walk.Er, G);
        constexpr int PER = RW * ACC;          // partial floats a thread
        constexpr int SLOT = CW * WG * PER;
        float* mine = part + size_t(k0 == 0 ? 2 * c + 1 : 2 * c) * SLOT +
                      wg * WG * PER + tid;
#pragma unroll
        for (int t = 0; t < RW; ++t) {
#pragma unroll
          for (int i = 0; i < ACC; ++i) {
            __stcg(mine + (t * ACC + i) * WG, acc[t][i]);
          }
        }
        // the warpgroup's stores, then one acquire-release arrival at
        // device scope: the last piece's threads read every other piece's
        // stores after it (the barrier carries the order to them)
        int* counter = &counters[CW * c_lo + wg];
        bar_sync(1 + wg, WG);
        if (tid == 0) last[wg] = atom_add_acq_rel(counter, 1) == c_hi - c_lo;
        bar_sync(1 + wg, WG);
        if (!last[wg]) continue;
        // the pieces in k order: a pass loads BATCH of a thread's values
        // from each of NB pieces at once (predicated, all in flight), then
        // adds them in order; INFLIGHT values a pass (16 beside 128
        // accumulators: more would spill them)
        constexpr int INFLIGHT = PER >= 128 ? 16 : PER >= 16 ? 64 : 128;
        constexpr int BATCH = PER < INFLIGHT ? PER : INFLIGHT;
        constexpr int NB = INFLIGHT / BATCH;
#pragma unroll
        for (int b = 0; b < PER; b += BATCH) {
          for (int c0 = c_lo; c0 <= c_hi; c0 += NB) {
            float v[NB][BATCH];
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              const int cc = c0 + j;
              if (cc > c_hi) break;
              const float* p =
                  part + size_t(cc == c_lo ? 2 * cc + 1 : 2 * cc) * SLOT +
                  (wg * WG * PER + tid) + b * WG;
#pragma unroll
              for (int i = 0; i < BATCH; ++i) v[j][i] = __ldcg(p + i * WG);
            }
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              const int cc = c0 + j;
              if (cc > c_hi) break;
#pragma unroll
              for (int i = 0; i < BATCH; ++i) {
                float& a = acc[(b + i) / ACC][(b + i) % ACC];
                a = cc == c_lo ? v[j][i] : a + v[j][i];
              }
            }
          }
        }
        if (tid == 0) *counter = 0;
      }

      // y[m, n] = bf16(bf16(acc) * bf16(scale[n])) for this thread's weight
      // rows n (two a row tile) and its x rows m
#pragma unroll
      for (int t = 0; t < RW; ++t) {
        const int n_a = nt * TILE_N + wrow + 64 * t;
        const int n_b = n_a + 8;
        const float s_a = n_a < N ? round_bf16(scale[n_a]) : 0.f;
        const float s_b = n_b < N ? round_bf16(scale[n_b]) : 0.f;
#pragma unroll
        for (int i = 0; i < NX / 8; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = mt * NX + 8 * i + 2 * q + h;
            if (m >= M) continue;
            __nv_bfloat16* row = y + static_cast<size_t>(m) * N;
            if (n_a < N) {
              row[n_a] =
                  __float2bfloat16_rn(round_bf16(acc[t][4 * i + h]) * s_a);
            }
            if (n_b < N) {
              row[n_b] =
                  __float2bfloat16_rn(round_bf16(acc[t][4 * i + 2 + h]) * s_b);
            }
          }
        }
      }
    }
  }
}

// A 2-D map over a contiguous row-major [outer, inner] tensor with a box of
// [box_outer, box_inner] elements, 128-byte swizzled; out-of-range elements
// of a box read as zero.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
               const void* base, int inner, int outer, int box_inner,
               int box_outer) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(inner), cuuint64_t(outer)};
  const cuuint64_t strides[1] = {cuuint64_t(inner) * elem_bytes};
  const cuuint32_t box[2] = {cuuint32_t(box_inner), cuuint32_t(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weight's map, [N, K] int8 in boxes of [rows, TILE_K], from a
// direct-mapped cache keyed on (pointer, N, K, rows).
struct WeightMap {
  const void* ptr;
  int n, k, rows;
  CUtensorMap map;
};
constexpr int MAP_SLOTS = 1024;
WeightMap g_maps[MAP_SLOTS];
std::mutex g_maps_mu;

bool weight_map(const void* wq, int N, int K, int rows, CUtensorMap* out) {
  uint64_t h = reinterpret_cast<uintptr_t>(wq) ^
               (uint64_t(uint32_t(N)) << 32) ^ (uint64_t(rows) << 20) ^
               uint32_t(K);
  h *= 0x9E3779B97F4A7C15ull;
  WeightMap& slot = g_maps[h >> 54];   // the top 10 bits
  std::lock_guard<std::mutex> lock(g_maps_mu);
  if (slot.ptr != wq || slot.n != N || slot.k != K || slot.rows != rows) {
    if (!encode_2d(&slot.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, K, N,
                   TILE_K, rows)) {
      slot.ptr = nullptr;
      return false;
    }
    slot.ptr = wq;
    slot.n = N;
    slot.k = K;
    slot.rows = rows;
  }
  *out = slot.map;
  return true;
}

template <int NX, int RW>
cudaError_t launch(const void* x, const void* wq, const void* scale,
                   void* y, void* part, void* counters, int M, int N, int K,
                   int ctas, int device, cudaStream_t stream) {
  using C = Cfg<NX, RW>;
  CUtensorMap tm_w, tm_x;
  if (!weight_map(wq, N, K, C::TILE_N, &tm_w) ||
      !encode_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, 64,
                 NX)) {
    return cudaErrorInvalidValue;
  }
  const int m_tiles = (M + NX - 1) / NX;
  const int n_tiles = (N + C::TILE_N - 1) / C::TILE_N;
  const int k_tiles = (K + TILE_K - 1) / TILE_K;
  const long long E = static_cast<long long>(m_tiles) * n_tiles * k_tiles;
  if (ctas < 1 || ctas > E || ctas > 65535 || E * ctas >= (1ll << 31)) {
    return cudaErrorInvalidValue;
  }
  static unsigned attributed = 0;   // devices whose attribute is set
  if (device < 32 && !(attributed & (1u << device))) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_kernel<NX, RW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::bytes));
    if (err != cudaSuccess) return err;
    attributed |= 1u << device;
  }
  int8_matmul_kernel<NX, RW><<<ctas, THREADS, C::bytes, stream>>>(
      tm_w, tm_x, static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(part),
      static_cast<int*>(counters), M, N, m_tiles, n_tiles, k_tiles);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 when the launch was accepted. ctas and
// row_tiles (64-row weight tiles a consumer warpgroup: 1, or 2 past 64 x
// rows) are the host plan's (ops/cuda/int8_matmul.py int8_plan); part holds
// 2 ctas x (tile rows) x NX fp32 when the plan splits a tile (else it may
// be null), counters 2 ctas int32 zeros, which every launch leaves at zero.
extern "C" int shai_int8_matmul(const void* x, const void* wq,
                                const void* scale, void* y, void* part,
                                void* counters, int M, int N, int K,
                                int ctas, int row_tiles, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 1 || N < 8 || N % 8 != 0 || K < 16 || K % 16 != 0 ||
      row_tiles < 1 || row_tiles > (M > 64 ? 2 : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) {
    err = launch<8, 1>(x, wq, scale, y, part, counters, M, N, K, ctas,
                       device, st);
  } else if (M <= 16) {
    err = launch<16, 1>(x, wq, scale, y, part, counters, M, N, K, ctas,
                        device, st);
  } else if (M <= 32) {
    err = launch<32, 1>(x, wq, scale, y, part, counters, M, N, K, ctas,
                        device, st);
  } else if (M <= 64) {
    err = launch<64, 1>(x, wq, scale, y, part, counters, M, N, K, ctas,
                        device, st);
  } else if (row_tiles == 1) {
    err = launch<128, 1>(x, wq, scale, y, part, counters, M, N, K, ctas,
                         device, st);
  } else {
    err = launch<128, 2>(x, wq, scale, y, part, counters, M, N, K, ctas,
                         device, st);
  }
  return static_cast<int>(err);
}
