// Fused attention forward with the in-kernel rel-pos term, for sm_90a.
//
// Replaces liteasr_tpu/ops/flash_attention.py:_attn_kernel (the Pallas TPU
// kernel), with its training options: the per-row lse and the
// attention-probability dropout (K1'). liteasr_tpu_torch/ops/
// flash_attention.py holds the function it computes, its plain PyTorch
// version and the ctypes wrapper.
//
// The file holds two bodies. The bf16 one (rel_attn_fwd_tc_kernel) is the
// main path, decoding and training, and runs on the tensor cores. The fp32
// one (rel_attn_fwd_kernel) serves only the parity checks, which hold the
// card against the CPU at 1e-4: tensor cores in fp32 would mean TF32 (about
// three decimal digits), so it stays on scalar fp32 FMAs.
//
// Both give one block 64 query rows of one (batch x head) row `bh` and walk
// the keys in tiles of 64 with an online softmax, so the scores never reach
// device memory. The rel-pos term of score (t, j) depends only on the
// diagonal delta = t - j: delta >= 0 reads table row Tk - 1 - delta with q_v
// row t, delta <= -2 reads row -delta - 2 with q_v row t + 1 (which may lie
// in the next query tile: the crossover row), delta == -1 gives 0. The 127
// diagonals of a (query tile, key tile) pair are one "position window" of
// table rows (tc::window_row).
//
// The bf16 body, one warpgroup (128 threads) a block, warp w owning query
// rows 16 w .. 16 w + 15:
//   - tiles: Q and q_v (65 rows) once, then per key tile K, V, the window
//     (128 rows) and the bool-mask tile, copied by cp.async into shared
//     memory in the core-matrix layout of tc_tile.cuh, zero-filled past the
//     ragged edges and past D (a bf16 row of D = 100 is 200 bytes, not
//     16-byte pieces, so it loads element by element). K, V and the mask
//     tile are double-buffered: the next tile's copy overlaps this tile's
//     products and softmax. The window has one buffer: the next one is
//     copied once B has read it, overlapping the softmax and P V.
//   - products, all wgmma (m64nNk16, fp32 accumulate): S = Q K^T (both
//     operands in shared memory); the window scores B = q_v . window^T
//     (two m64n64, kept in shared memory in fp32, 33 KB), whose row 64 (the
//     crossover q_v row) is 128 dot products on the CUDA cores while the
//     tensor cores run; out += P V with P from registers (the accumulator
//     layout is the A fragment layout) and V as the N-major operand. Each
//     score adds B[r][slot] or B[r + 1][slot] of its diagonal.
//   - masks (bool mask, kv_len, the ragged key edge) and the online softmax
//     in registers, a row's 4 lanes reducing with shuffles; the
//     probabilities are rounded to bf16 before P V, as the TPU kernel does.
//   - key tiles that no row of the block may weigh (past kv_len, hidden
//     by the bool mask, or past the last row's chunk under a chunk width)
//     are skipped, exactly; see the kernel.
// The fp32 body stages transposed fp32 chunks of 32 head dims and runs a
// 16 x 16 thread grid of scalar FMAs, 4 x 4 scores a thread.
// Dropout (training) zeroes a probability before P V where the TPU kernel's
// counter hash says so (tc::keep_elem); the normalizer keeps the undropped
// mass and the output is divided by 1 - rate, as on the TPU. The hash is
// keyed by the TPU kernel's tiles (tqe x tke), not by this kernel's 64 x 64
// tiles, so both draw the same mask.
// What bounds it: by bytes and operations a call needs 4-47 us at the
// decode and training shapes (PERF.md), but a block does only a few key
// tiles, each a chain of copy wait, barrier, two dependent products and a
// softmax; with 2 blocks an SM (4 without the rel-pos term, whose window
// takes 64 registers a thread) the latency of that chain, not the tensor
// cores or HBM, sets the time.
//
// Under tensor and sequence parallelism a call computes a shard of the
// full attention (tc::Shard): its bh rows may be a head slice of each batch
// row (the dropout hash then folds the full call's batch x head row), and
// its queries a contiguous block of the full call's, at offset qoff, over
// all the keys; the rel-pos diagonals, the chunk mask and the hash read the
// full call's query index, and q_v may carry one row more, the next
// shard's first, which the block's last query reads at keys past t + 1.
// Row for row the shard computes what the full call does.
//
// C interface (ctypes): rel_attention_fwd returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

constexpr int BM = 64;           // query rows per block
constexpr int BN = 64;           // keys per tile
constexpr int DC = 32;           // head-dim chunk staged per step
constexpr int NT = 256;          // 16 x 16 threads, 4 x 4 scores each
constexpr int PW = BM + BN - 1;  // diagonals of a (query tile, key tile) pair
// padded strides: the transposed stores of consecutive threads hit
// consecutive banks
constexpr int LDQ = BM + 1;
constexpr int LDQV = BM + 1;     // rows q0 .. q0 + 64
constexpr int LDK = BN + 1;
constexpr int LDP = PW + 2;
constexpr int LDS = BN + 1;
constexpr float NEG_INF = -1e30f;

using tc::keep_elem;



template <int DMAX>
struct Smem {
  // the score stage (phase 1) and the V tile (phase 3) share storage
  static constexpr int kStage = DC * LDQ + DC * LDQV + DC * LDK + DC * LDP;
  static constexpr int kV = BN * DMAX;
  static constexpr int kUnion = kStage > kV ? kStage : kV;
  static constexpr size_t kBytes = (size_t)(kUnion + BM * LDS) * sizeof(float);
};

template <int DMAX>
__global__ void __launch_bounds__(NT)
rel_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ qv,
                    const float* __restrict__ p, const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ kv_lens, float* __restrict__ out,
                    float* __restrict__ lse, int Tq, int Tk, int D, int mask_div,
                    int p_mod, float scale, int dropout, uint32_t seed, uint32_t thr,
                    float keep_div, int tqe, int tke, int chunk, tc::Shard sh) {
  extern __shared__ float smem[];
  float* sQ = smem;              // [DC][LDQ]  Q^T chunk
  float* sQv = sQ + DC * LDQ;    // [DC][LDQV] q_v^T chunk
  float* sK = sQv + DC * LDQV;   // [DC][LDK]  K^T chunk
  float* sP = sK + DC * LDK;     // [DC][LDP]  position window chunk
  float* sV = smem;              // [BN][DMAX] aliases the stage
  float* sS = smem + Smem<DMAX>::kUnion;  // [BM][LDS] probabilities

  constexpr int NC = DMAX / 16;  // output columns per thread
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int g0 = sh.qoff + q0;  // the full call's index of the block's row 0
  const uint32_t hrow = sh.hash_row(bh);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const bool has_rel = qv != nullptr;
  const int kv_len = kv_lens ? kv_lens[bh] : Tk;
  const float* qb = q + (size_t)bh * Tq * D;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;
  const float* qvb = has_rel ? qv + (size_t)bh * sh.tqv * D : nullptr;
  const float* pb = has_rel ? p + (size_t)(bh % p_mod) * Tk * D : nullptr;
  const uint8_t* mb = mask ? mask + (size_t)(bh / mask_div) * Tq * Tk : nullptr;

  float m_i[4], l_i[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // under a chunk width, key j is hidden from query t iff j >= (t / chunk
  // + 1) chunk: with every row live (kv_len > 0, no bool mask) the block's
  // walk ends at its last row's chunk end, exactly
  int kwalk = Tk;
  if (chunk > 0 && !mb && kv_len > 0)
    kwalk = min(Tk, ((sh.qoff + min(q0 + BM, Tq) - 1) / chunk + 1) * chunk);
  int cend[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    cend[i] = chunk > 0 ? ((g0 + ty + 16 * i) / chunk + 1) * chunk : Tk;

  for (int k0 = 0; k0 < kwalk; k0 += BN) {
    float s_ac[4][4], s_bd[4][4];
    bool nxt[4][4];  // key right of the query: reads q_v row t + 1
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s_ac[i][j] = 0.f;
        s_bd[i][j] = 0.f;
        nxt[i][j] = g0 + ty + 16 * i < k0 + tx + 16 * j;
      }
    // window slot w holds diagonal delta = dbase + w
    const int dbase = g0 - k0 - (BN - 1);

    for (int c0 = 0; c0 < D; c0 += DC) {
      __syncthreads();  // earlier readers of the stage / sV / sS are done
      for (int idx = tid; idx < BM * DC; idx += NT) {
        const int r = idx / DC, c = idx % DC, t = q0 + r, d = c0 + c;
        sQ[c * LDQ + r] = (t < Tq && d < D) ? qb[(size_t)t * D + d] : 0.f;
      }
      for (int idx = tid; idx < BN * DC; idx += NT) {
        const int r = idx / DC, c = idx % DC, j = k0 + r, d = c0 + c;
        sK[c * LDK + r] = (j < Tk && d < D) ? kb[(size_t)j * D + d] : 0.f;
      }
      if (has_rel) {
        for (int idx = tid; idx < (BM + 1) * DC; idx += NT) {
          const int r = idx / DC, c = idx % DC, t = q0 + r, d = c0 + c;
          sQv[c * LDQV + r] = (t < sh.tqv && d < D) ? qvb[(size_t)t * D + d] : 0.f;
        }
        for (int idx = tid; idx < PW * DC; idx += NT) {
          const int w = idx / DC, c = idx % DC, d = c0 + c;
          const int delta = dbase + w;
          const int row = delta >= 0 ? Tk - 1 - delta : -delta - 2;  // -1 at delta == -1
          sP[c * LDP + w] =
              (row >= 0 && row < Tk && d < D) ? pb[(size_t)row * D + d] : 0.f;
        }
      }
      __syncthreads();

      const int kc = min(DC, D - c0);
      for (int c = 0; c < kc; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sQ[c * LDQ + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sK[c * LDK + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s_ac[i][j] = fmaf(a[i], b[j], s_ac[i][j]);
        if (has_rel) {
          float u[4], u1[4], pw[7];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            u[i] = sQv[c * LDQV + ty + 16 * i];
            u1[i] = sQv[c * LDQV + ty + 16 * i + 1];
          }
          // slot of (i, j) is ty - tx + 16 (i - j) + BN - 1
#pragma unroll
          for (int m = 0; m < 7; ++m) pw[m] = sP[c * LDP + ty - tx + 16 * (m - 3) + BN - 1];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              s_bd[i][j] = fmaf(nxt[i][j] ? u1[i] : u[i], pw[i - j + 3], s_bd[i][j]);
        }
      }
    }

    // masks + online softmax; probabilities to sS
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float s;
        if (key >= Tk) {
          s = -INFINITY;  // ragged edge: no weight at all
        } else {
          s = (s_ac[i][j] + s_bd[i][j]) * scale;
          if (mb && t < Tq && mb[(size_t)t * Tk + key]) s = NEG_INF;
          if (key >= kv_len || key >= cend[i]) s = NEG_INF;
        }
        s_ac[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pe = expf(s_ac[i][j] - m_new);
        rs += pe;  // the normalizer sums the undropped mass
        const bool drop =
            dropout && !keep_elem(hrow, sh.qoff + t, k0 + tx + 16 * j, tqe, tke, seed, thr);
        sS[(ty + 16 * i) * LDS + tx + 16 * j] = drop ? 0.f : pe;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // sS written; the stage is free for V

    for (int idx = tid; idx < BN * DMAX; idx += NT) {
      const int r = idx / DMAX, d = idx % DMAX, j = k0 + r;
      sV[r * DMAX + d] = (j < Tk && d < D) ? vb[(size_t)j * D + d] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < BN; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sV[j * DMAX + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pp = sS[(ty + 16 * i) * LDS + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pp, vv[c], acc[i][c]);
      }
    }
  }

  float* ob = out + (size_t)bh * Tq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      float o = acc[i][c] / l;
      if (dropout) o = o / keep_div;
      if (d < D) ob[(size_t)t * D + d] = o;
    }
    // a row with no key (kv_len == 0) keeps m = NEG_INF; NEG_INF + log(l)
    // rounds to NEG_INF in fp32, and the backward zeroes such a row
    if (lse && tx == 0)
      lse[(size_t)bh * Tq + t] = l_i[i] > 0.f ? m_i[i] + logf(l) : NEG_INF;
  }
}

template <int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* qv,
                   const void* p, const uint8_t* mask, const int32_t* kv_lens,
                   void* out, float* lse, int BH, int Tq, int Tk, int D, int mask_div,
                   int p_mod, float scale, int dropout, uint32_t seed, uint32_t thr,
                   float keep_div, int tqe, int tke, int chunk, tc::Shard sh,
                   cudaStream_t stream) {
  constexpr size_t smem = Smem<DMAX>::kBytes;
  auto kernel = rel_attn_fwd_kernel<DMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BM - 1) / BM, BH);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(qv),
      static_cast<const float*>(p), mask, kv_lens, static_cast<float*>(out), lse, Tq, Tk,
      D, mask_div, p_mod, scale, dropout, seed, thr, keep_div, tqe, tke, chunk, sh);
  return cudaGetLastError();
}

// ---- the bf16 body: tensor cores, asynchronous tile loads ----

using tc::bf16;
constexpr int TC_NT = 128;  // one warpgroup; warp w owns query rows 16 w .. 16 w + 15
constexpr int LDB = 132;    // fp32 row stride of the window scores sB

template <int DMAX>
struct TcSmem {
  static constexpr int ROW = DMAX * 2;                // bytes per bf16 row
  static constexpr int kTile = BM * ROW;              // Q, K, V: 64 rows
  static constexpr int oK = kTile;                    // K, two stages
  static constexpr int oV = oK + 2 * kTile;           // V, two stages
  static constexpr int oM = oV + 2 * kTile;           // bool mask tile, two stages
  static constexpr int oQv = oM + 2 * BM * BN;        // q_v rows q0 .. q0 + 71
  static constexpr int oP = oQv + 72 * ROW;           // position window, 128 rows
  static constexpr int oB = oP + 128 * ROW;           // window scores, 65 x LDB fp32
  static constexpr size_t kPlain = oQv;               // without the rel-pos term
  static constexpr size_t kRel = oB + 65 * LDB * sizeof(float);
};

__device__ __forceinline__ bool has_zero_byte(uint32_t w) {
  return ((w - 0x01010101u) & ~w & 0x80808080u) != 0u;
}

// REL: with the rel-pos term (its window scores take 64 more registers a
// thread, which would halve the blocks an SM holds at the decoder's shapes)
template <int DMAX, bool REL>
__global__ void __launch_bounds__(TC_NT)
rel_attn_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ qv,
                       const bf16* __restrict__ p, const uint8_t* __restrict__ mask,
                       const int32_t* __restrict__ kv_lens, bf16* __restrict__ out,
                       float* __restrict__ lse, int Tq, int Tk, int D, int mask_div,
                       int p_mod, float scale, int dropout, uint32_t seed, uint32_t thr,
                       float keep_div, int tqe, int tke, int chunk, tc::Shard sh, int vec,
                       int mvec) {
  using S = TcSmem<DMAX>;
  constexpr int NCH = DMAX / 8, KS = DMAX / 16, NO = DMAX / 8;
  extern __shared__ __align__(128) char tsm[];
  __shared__ unsigned long long s_vis;
  float* sB = reinterpret_cast<float*>(tsm + S::oB);
  const uint32_t s0 = tc::smem_u32(tsm);
  const uint32_t sQ = s0, sQv = s0 + S::oQv, sP = s0 + S::oP;

  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int g0 = sh.qoff + q0;  // the full call's index of the block's row 0
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3, m0 = 16 * warp;
  const int kv_len = kv_lens ? kv_lens[bh] : Tk;
  const int nkt = (Tk + BN - 1) / BN;
  const bf16* qb = q + (size_t)bh * Tq * D;
  const bf16* kb = k + (size_t)bh * Tk * D;
  const bf16* vb = v + (size_t)bh * Tk * D;
  const bf16* qvb = REL ? qv + (size_t)bh * sh.tqv * D : nullptr;
  const bf16* pb = REL ? p + (size_t)(bh % p_mod) * Tk * D : nullptr;
  const uint8_t* mb = mask ? mask + (size_t)(bh / mask_div) * Tq * Tk : nullptr;

  // The key tiles the block walks: those that hold a key below kv_len that
  // the bool mask leaves visible to some row of the block. Another tile
  // adds exp(NEG_INF - m) = 0 to a row that has seen a real score, and a
  // row's first real score wipes what came before it (alpha = 0), so
  // skipping it is exact. A row that sees no real score at all (kv_len ==
  // 0, or a mask row that hides every key) averages V over all Tk keys, as
  // the TPU kernel does: a block with such a row walks again, every tile.
  // Bit b < 63 of vis stands for tile b, bit 63 for tiles 63 and later.
  // Under a chunk width no row of the block sees a key at or past its last
  // row's chunk end ((t / chunk + 1) chunk), so the walk ends there too;
  // a row that sees no key still walks every tile in the second pass.
  int kend = max(0, min(Tk, kv_len));
  if (chunk > 0) kend = min(kend, ((sh.qoff + min(q0 + BM, Tq) - 1) / chunk + 1) * chunk);
  unsigned long long vis = ~0ull;
  if (mb) {
    if (threadIdx.x == 0) s_vis = 0ull;
    __syncthreads();
    unsigned long long mine = 0ull;
    const int np = (kend + 15) / 16;  // 16-key pieces of a row
    for (int i = threadIdx.x; i < BM * np; i += TC_NT) {
      const int t = q0 + i / np, j0 = (i % np) * 16;
      if (t >= Tq) continue;
      const uint8_t* src = mb + (size_t)t * Tk + j0;
      bool hit = false;
      if (mvec && j0 + 16 <= kend) {
        const uint4 w = *reinterpret_cast<const uint4*>(src);
        hit = has_zero_byte(w.x) || has_zero_byte(w.y) || has_zero_byte(w.z) ||
              has_zero_byte(w.w);
      } else {
        for (int e = 0; e < 16 && j0 + e < kend; ++e) hit = hit || src[e] == 0;
      }
      if (hit) mine |= 1ull << min(j0 / BN, 63);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mine |= __shfl_xor_sync(0xffffffffu, mine, off);
    if (lane == 0 && mine) atomicOr(&s_vis, mine);
    __syncthreads();
    vis = s_vis;
  }
  auto next_tile = [&](int kt) {
    while (kt < nkt && !(kt * BN < kend && ((vis >> min(kt, 63)) & 1ull))) ++kt;
    return kt;
  };

  auto load_keys = [&](int kt, int st) {
    const int k0 = kt * BN;
    auto key = [&](int r) { return k0 + r < Tk ? k0 + r : -1; };
    tc::load_tile<NCH>(tsm + S::oK + st * S::kTile, kb, BN, D, vec, key);
    tc::load_tile<NCH>(tsm + S::oV + st * S::kTile, vb, BN, D, vec, key);
    if (REL) {
      const int dbase = g0 - k0 - (BN - 1);
      tc::load_tile<NCH>(tsm + S::oP, pb, 128, D, vec,
                         [&](int w) { return tc::window_row(dbase, w, Tk); });
    }
    if (mb) {  // the mask tile, row-major 64 x 64 bytes; 0 outside (t, j)
      uint8_t* sm = reinterpret_cast<uint8_t*>(tsm + S::oM + st * BM * BN);
      for (int i = threadIdx.x; i < BM * BN / 16; i += TC_NT) {
        const int t = q0 + (i >> 2), j0 = k0 + (i & 3) * 16;
        const uint8_t* src = mb + (size_t)t * Tk + j0;
        if (mvec) {
          tc::cp_async16(tc::smem_u32(sm + 16 * i), t < Tq && j0 < Tk ? src : mb,
                         t < Tq && j0 < Tk);
        } else {
          uint32_t w[4] = {0u, 0u, 0u, 0u};
          for (int e = 0; e < 16; ++e)
            if (t < Tq && j0 + e < Tk) w[e >> 2] |= (uint32_t)(src[e] != 0) << (8 * (e & 3));
          *reinterpret_cast<uint4*>(sm + 16 * i) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
    tc::cp_async_commit();
  };

  tc::load_tile<NCH>(tsm, qb, BM, D, vec, [&](int r) { return q0 + r < Tq ? q0 + r : -1; });
  if (REL)
    tc::load_tile<NCH>(tsm + S::oQv, qvb, 72, D, vec,
                       [&](int r) { return (r <= BM && q0 + r < sh.tqv) ? q0 + r : -1; });

  // the dropout hash's term of each of the thread's two rows, and the end
  // of each row's chunk (the first key it may not see)
  uint32_t krow[2];
  int cend[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    krow[h] = tc::keep_row(sh.hash_row(bh), g0 + m0 + g + 8 * h, tqe, seed);
    cend[h] = chunk > 0 ? ((g0 + m0 + g + 8 * h) / chunk + 1) * chunk : Tk;
  }

  float o[NO][4], m_r[2], l_r[2];
  for (int pass = 0;; ++pass) {
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m_r[0] = m_r[1] = NEG_INF;
    l_r[0] = l_r[1] = 0.f;
    int it = next_tile(0), st = 0;
    if (it < nkt) load_keys(it, st);

    while (it < nkt) {
      const int k0 = it * BN, nxt = next_tile(it + 1);
      const uint32_t sK = s0 + S::oK + st * S::kTile, sV = s0 + S::oV + st * S::kTile;
      tc::cp_async_wait_all();
      tc::fence_async_smem();
      __syncthreads();  // this tile's K, V, window, mask landed; sB readers are done
      const uint8_t* sm = reinterpret_cast<const uint8_t*>(tsm + S::oM + st * BM * BN);

      // S = Q K^T and, with the rel-pos term, the window scores B =
      // q_v[q0 .. q0+63] . window^T (64 x 128, two halves of 64 slots): one
      // batch of wgmma; meanwhile B's row 64 (the crossover q_v row q0 + 64)
      // as 128 dot products, one a thread
      float s[8][4], b0[8][4], b1[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = b0[n][e] = b1[n][e] = 0.f;
      tc::wg_fence();
      if (REL) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          tc::wg_ss_n64<0, 0>(b0, tc::wg_desc_k<NCH>(sQv, kk), tc::wg_desc_k<NCH>(sP, kk));
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          tc::wg_ss_n64<0, 0>(b1, tc::wg_desc_k<NCH>(sQv, kk),
                           tc::wg_desc_k<NCH>(sP + 64 * S::ROW, kk));
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        tc::wg_ss_n64<0, 0>(s, tc::wg_desc_k<NCH>(sQ, kk), tc::wg_desc_k<NCH>(sK, kk));
      tc::wg_commit();
      if (REL) {
        const int w = threadIdx.x;
        float acc = 0.f;
#pragma unroll 4
        for (int ch = 0; ch < NCH; ++ch) {
          const uint4 a = *reinterpret_cast<const uint4*>(tsm + S::oQv + tc::cm_off<NCH>(BM, ch));
          const uint4 b = *reinterpret_cast<const uint4*>(tsm + S::oP + tc::cm_off<NCH>(w, ch));
          const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[e]));
            const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[e]));
            acc = fmaf(fa.x, fb.x, fmaf(fa.y, fb.y, acc));
          }
        }
        sB[BM * LDB + w] = acc;
      }
      tc::wg_wait_all();
      tc::wg_hold(s);
      if (REL) {
        tc::wg_hold(b0);
        tc::wg_hold(b1);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int w = 8 * n + 2 * qd;
          float* row = sB + (m0 + g) * LDB + w;
          *reinterpret_cast<float2*>(row) = make_float2(b0[n][0], b0[n][1]);
          *reinterpret_cast<float2*>(row + 8 * LDB) = make_float2(b0[n][2], b0[n][3]);
          *reinterpret_cast<float2*>(row + 64) = make_float2(b1[n][0], b1[n][1]);
          *reinterpret_cast<float2*>(row + 8 * LDB + 64) = make_float2(b1[n][2], b1[n][3]);
        }
        __syncthreads();  // sB complete; the window buffer is free
      }
      if (nxt < nkt) load_keys(nxt, st ^ 1);  // overlaps everything below

      // the dropout hash's term of each of the thread's 16 keys
      uint32_t kcol[8][2];
      if (dropout) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) kcol[n][e] = tc::keep_col(k0 + 8 * n + 2 * qd + e, tke);
      }

      // + the rel-pos term by diagonal, scale, masks; online softmax
      const int dbase = g0 - k0 - (BN - 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + g + 8 * h;
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * n + 2 * qd + e, j = k0 + c;
            float x;
            if (j >= Tk) {
              x = -INFINITY;  // ragged edge: no weight at all
            } else {
              x = s[n][2 * h + e];
              if (REL) {
                const int w = BN - 1 + r - c, delta = dbase + w;
                if (delta >= 0) x += sB[r * LDB + w];
                else if (delta <= -2) x += sB[(r + 1) * LDB + w];
              }
              x *= scale;
              if (mb && sm[r * BN + c]) x = NEG_INF;
              if (j >= kv_len || j >= cend[h]) x = NEG_INF;
            }
            s[n][2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[h], mx);
        const float alpha = __expf(m_r[h] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float pe = __expf(s[n][2 * h + e] - m_new);
            rs += pe;  // the normalizer sums the undropped mass
            if (dropout && !tc::keep_mix(krow[h] + kcol[n][e], thr)) pe = 0.f;
            s[n][2 * h + e] = pe;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l_r[h] = l_r[h] * alpha + rs;
        m_r[h] = m_new;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][2 * h] *= alpha;
          o[n][2 * h + 1] *= alpha;
        }
      }

      // out += P V (wgmma, A from registers): the probabilities, rounded to
      // bf16 (as the TPU kernel does before its P V product), are the A
      // fragments as they lie; V is the N-major B operand
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t a[4] = {tc::pack(s[2 * kk][0], s[2 * kk][1]),
                               tc::pack(s[2 * kk][2], s[2 * kk][3]),
                               tc::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               tc::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        if constexpr (NO == 8) {
          tc::wg_rs_n64<1>(o, a, tc::wg_desc_n<NCH>(sV, kk));
        } else {
          tc::wg_rs_n128<1>(o, a, tc::wg_desc_n<NCH>(sV, kk));
        }
      }
      tc::wg_commit();
      tc::wg_wait_all();
      tc::wg_hold(o);
      it = nxt;
      st ^= 1;
    }
    if (pass == 1) break;
    bool dead = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) dead = dead || (q0 + m0 + g + 8 * h < Tq && m_r[h] == NEG_INF);
    if (!__syncthreads_or(dead)) break;
    kend = Tk;  // the second walk: every tile
    vis = ~0ull;
  }

  bf16* ob = out + (size_t)bh * Tq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q0 + m0 + g + 8 * h;
    if (t >= Tq) continue;
    const float l = fmaxf(l_r[h], 1e-30f);
    const float inv = 1.f / (dropout ? l * keep_div : l);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = 8 * n + 2 * qd;
      if (d < D) ob[(size_t)t * D + d] = __float2bfloat16(o[n][2 * h] * inv);
      if (d + 1 < D) ob[(size_t)t * D + d + 1] = __float2bfloat16(o[n][2 * h + 1] * inv);
    }
    // a row with no key keeps m = NEG_INF; NEG_INF + log(l) rounds to
    // NEG_INF in fp32, and the backward zeroes such a row
    if (lse && qd == 0) lse[(size_t)bh * Tq + t] = l_r[h] > 0.f ? m_r[h] + logf(l) : NEG_INF;
  }
}

template <int DMAX>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* qv,
                      const void* p, const uint8_t* mask, const int32_t* kv_lens, void* out,
                      float* lse, int BH, int Tq, int Tk, int D, int mask_div, int p_mod,
                      float scale, int dropout, uint32_t seed, uint32_t thr, float keep_div,
                      int tqe, int tke, int chunk, tc::Shard sh, cudaStream_t stream) {
  const size_t smem = qv ? TcSmem<DMAX>::kRel : TcSmem<DMAX>::kPlain;
  auto kernel = qv ? rel_attn_fwd_tc_kernel<DMAX, true> : rel_attn_fwd_tc_kernel<DMAX, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  auto a16 = [](const void* x) { return x == nullptr || (uintptr_t)x % 16 == 0; };
  const int vec = D % 8 == 0 && a16(q) && a16(k) && a16(v) && a16(qv) && a16(p);
  const int mvec = Tk % 16 == 0 && a16(mask);
  dim3 grid((Tq + BM - 1) / BM, BH);
  kernel<<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(qv), static_cast<const bf16*>(p), mask, kv_lens,
      static_cast<bf16*>(out), lse, Tq, Tk, D, mask_div, p_mod, scale, dropout, seed, thr,
      keep_div, tqe, tke, chunk, sh, vec, mvec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. qv/p, mask, kv_lens and lse may be null.
// dropout != 0 applies the keep test u < thr with the TPU kernel's tiles
// tqe x tke; keep_div = 1 - rate. chunk > 0 also masks key j for query t
// where j / chunk > t / chunk (0: no chunk mask). tqv, qoff, hl, ht, h0 place
// the call in the full attention (tc::Shard): qv holds tqv rows a bh (Tq, or
// Tq + 1 with the next shard's first row), local query t is the full call's
// qoff + t (Tk and the table are whole), and the hash folds bh as head
// h0 + bh % hl of ht; Tq, 0, 1, 1, 0 is the whole call.
extern "C" int rel_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                 const void* qv, const void* p, const void* mask,
                                 const void* kv_lens, void* out, void* lse, int BH,
                                 int Tq, int Tk, int D, int mask_div, int p_mod,
                                 float scale, int dropout, uint32_t seed, uint32_t thr,
                                 float keep_div, int tqe, int tke, int chunk, int tqv,
                                 int qoff, int hl, int ht, int h0, void* stream) {
  if (D < 1 || D > 128 || BH < 1 || BH > 65535 || mask_div < 1 || p_mod < 1 ||
      tqe < 1 || tke < 1 || chunk < 0 || tqv < Tq || qoff < 0 || hl < 1 || ht < hl ||
      h0 < 0 || h0 + hl > ht)
    return (int)cudaErrorInvalidValue;
  const tc::Shard sh{tqv, qoff, hl, ht, h0};
  auto ls = static_cast<float*>(lse);
  auto m = static_cast<const uint8_t*>(mask);
  auto kl = static_cast<const int32_t*>(kv_lens);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define ARGS                                                                             \
  q, k, v, qv, p, m, kl, out, ls, BH, Tq, Tk, D, mask_div, p_mod, scale, dropout, seed, thr, \
      keep_div, tqe, tke, chunk, sh, s
  if (dtype == 0) {
    err = D <= 64 ? launch<64>(ARGS) : launch<128>(ARGS);
  } else if (dtype == 1) {
    err = D <= 64 ? launch_tc<64>(ARGS) : launch_tc<128>(ARGS);
  } else {
    err = cudaErrorInvalidValue;
  }
#undef ARGS
  return (int)err;
}
