// Backward of the fused rel-pos attention, for sm_90a (K2).
//
// Replaces liteasr_tpu/ops/flash_attention.py:_bwd_kernel (the Pallas TPU
// kernel, wrapper _flash_rel_bwd_pallas); liteasr_tpu_torch/ops/
// flash_attention.py holds the function it computes, its plain PyTorch
// version and the ctypes wrapper.
//
// For one folded (batch x head) row bh, with the forward's lse and output:
//   A    = exp(S - lse)                    0 for masked keys and dead rows
//   dV   = A_v^T dO                        A_v = keep ? A / (1 - rate) : 0
//   dS   = A (dP_eff - Dvec) scale         dP_eff = keep ? dO V^T / (1-rate) : 0,
//                                          Dvec = rowsum(dO * O)
//   dK   = dS^T Q_u,  dQ_u = dS K
//   dR   = relshift^-1(dS),  dQ_v = dR P,  dP = dR^T Q_v
// The relshift adjoint is indexed by diagonal, as the forward reads it:
// score (t, j) with delta = t - j >= 0 came from table row Tk-1-delta and
// q_v row t; with delta <= -2 from table row -delta-2 and q_v row t + 1; at
// delta == -1 from nothing. So dQ_v row t gets dS[t, j <= t] and dS[t-1,
// j > t]: the row after a query tile (the crossover) takes a term from the
// tile's last row.
//
// The file holds two bodies, for the reason the forward gives: the bf16 one
// (rel_attn_bwd_tc_kernel, the training path) runs on the tensor cores, the
// fp32 one (rel_attn_bwd_kernel, the parity checks at 1e-3) on scalar fp32
// FMAs.
//
// The bf16 body follows FlashAttention-2's backward. A pre-pass
// (bwd_prep_kernel) writes Dvec = rowsum(dO * O) and dO in bf16, so the main
// kernel reads neither fp32 tensor. Then one block of 4 warps owns a key
// tile of 64 (warp w: keys 16 w .. 16 w + 15) and walks the query tiles;
// dK and dV stay in registers and are written once, without atomics. Per
// query tile (Q_u, dO, q_v rows q0 .. q0 + 64 and the 128-row window
// copied by cp.async, zero-filled at the edges, as in the forward):
//   1. the window scores B = q_v . window^T into shared memory, row 64 (the
//      crossover) as dot products, as in the forward;
//   2. S^T = K Q_u^T and dP^T = V dO^T;
//   3. A = exp(S - lse) with the rel-pos term by diagonal, A_v and dS, the
//      dropout mask regenerated with the forward's hash;
//   4. dV += A_v^T dO and dK += dS^T Q_u, with A_v and dS rounded to bf16
//      where the TPU kernel rounds them, taken straight from the
//      accumulators as A fragments;
//   5. the relshift adjoint as a window matrix dB (80 x 128 bf16), written
//      from the registers that hold dS: dS[r][c] at (r, slot) on diagonals
//      delta >= 0, at (r + 1, slot) on delta <= -2 (the score that read q_v
//      row r + 1); the two never collide;
//   6. dQ_u += dS K, added by fp32 atomics: a query row's key tiles live in
//      different blocks, and per-key-tile partials would write a (T / 64)-
//      fold fp32 copy of dQ_u and read it again in a second pass;
//   7. dQ_v += dB . window (rows q0 .. q0 + 64: row 64 is the crossover row,
//      the first row of the next query tile) and
//   8. dP_window = dB^T . q_v, both added by fp32 atomics: dQ_v's rows and
//      the shared table's rows take terms from every key tile.
// Every product is wgmma (m64nNk16, bf16 in, fp32 accumulate): S^T and
// dP^T with both operands in shared memory, dV and dK with A_v^T and dS^T
// from registers, dQ_u and dP_window with dS^T and dB^T read M-major from
// shared memory. Only step 7's crossover row is mma.sync.m16n8k16: one
// used row of a 16-row tile, its column pairs spread over the warps. The
// query tile is single-buffered: at D <= 64 a block takes 100 KB and two
// blocks share an SM, one copying while the other computes.
// The fp32 body gives a block 64 query rows instead, stages transposed
// fp32 chunks as the forward's fp32 body does, owns dQ_u and adds dK, dV,
// dQ_v and dP with atomics.
// What bounds it: by bytes a call needs 16 us at the training shape
// (PERF.md), but each query tile is a chain of a copy wait, eight dependent
// products and six barriers, and with two blocks an SM
// the latency of that chain, not the tensor cores or HBM, sets the time.
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
// C interface (ctypes): rel_attention_bwd returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

constexpr int BM = 64;           // query rows per block
constexpr int BN = 64;           // keys per tile
constexpr int DC = 32;           // head-dim chunk staged per step (phase A)
constexpr int NT = 256;          // 16 x 16 threads, 4 x 4 scores each
constexpr int PW = BM + BN - 1;  // diagonals of a (query tile, key tile) pair
constexpr int LDQ = BM + 1;
constexpr int LDQV = BM + 1;     // rows q0 .. q0 + 64
constexpr int LDK = BN + 1;
constexpr int LDP = PW + 2;
constexpr int LDS = BN + 1;
constexpr float NEG_INF = -1e30f;


using tc::keep_elem;

template <int DMAX>
struct Smem {
  // phase A's transposed chunks: Q_u, q_v (65 rows), K, P window, dO, V
  static constexpr int kStage = DC * (LDQ + LDQV + LDK + LDP + LDQ + LDK);
  static constexpr int kB1 = (BN + 2 * BM) * DMAX;  // K, Q_u, dO rows
  static constexpr int kB2 = (PW + BM + 1) * DMAX;  // P window, q_v rows
  static constexpr int kAB = kStage > kB1 ? kStage : kB1;
  static constexpr int kUnion = kAB > kB2 ? kAB : kB2;
  // + dS, A_v tiles, Dvec and lse of the block's rows
  static constexpr size_t kBytes = (size_t)(kUnion + 2 * BM * LDS + 2 * BM) * sizeof(float);
};

template <int DMAX>
__global__ void __launch_bounds__(NT)
rel_attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ qv,
                    const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ p, const int32_t* __restrict__ kv_lens,
                    const float* __restrict__ out, const float* __restrict__ lse,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    float* __restrict__ dqv, float* __restrict__ dk,
                    float* __restrict__ dv, float* __restrict__ dp, int Tq, int Tk, int D,
                    int p_mod, float scale, int dropout, uint32_t seed, uint32_t thr,
                    float inv_keep, int tqe, int tke, int chunk, tc::Shard sh) {
  extern __shared__ float smem[];
  // phase A
  float* sQ = smem;              // [DC][LDQ]  Q_u^T chunk
  float* sQv = sQ + DC * LDQ;    // [DC][LDQV] q_v^T chunk
  float* sK = sQv + DC * LDQV;   // [DC][LDK]  K^T chunk
  float* sP = sK + DC * LDK;     // [DC][LDP]  position window chunk
  float* sO = sP + DC * LDP;     // [DC][LDQ]  dO^T chunk
  float* sV = sO + DC * LDQ;     // [DC][LDK]  V^T chunk
  // phase B1 (aliases phase A)
  float* rK = smem;              // [BN][DMAX]
  float* rQ = rK + BN * DMAX;    // [BM][DMAX]
  float* rO = rQ + BM * DMAX;    // [BM][DMAX] dO
  // phase B2 (aliases phase A)
  float* rP = smem;              // [PW][DMAX] position window rows
  float* rQv = rP + PW * DMAX;   // [BM + 1][DMAX]
  float* sDS = smem + Smem<DMAX>::kUnion;  // [BM][LDS] dS
  float* sAV = sDS + BM * LDS;             // [BM][LDS] A_v
  float* sDvec = sAV + BM * LDS;           // [BM]
  float* sLse = sDvec + BM;                // [BM]

  constexpr int NC = DMAX / 16;  // output columns per thread
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int g0 = sh.qoff + q0;  // the full call's index of the block's row 0
  const uint32_t hrow = sh.hash_row(bh);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int kv_len = kv_lens ? kv_lens[bh] : Tk;
  // query rows (Q_u, O, dO, dQ_u), q_v rows (q_v, dQ_v) and key rows (K, V,
  // dK, dV) of this bh
  const size_t row0 = (size_t)bh * Tq * D, vrow0 = (size_t)bh * sh.tqv * D,
               krow0 = (size_t)bh * Tk * D;
  const float* qb = q + row0;
  const float* qvb = qv + vrow0;
  const float* kb = k + krow0;
  const float* vb = v + krow0;
  const float* pb = p + (size_t)(bh % p_mod) * Tk * D;
  const float* ob = out + row0;
  const float* dob = dout + row0;

  {  // Dvec = rowsum(dO * O) and lse of the block's rows: 4 threads a row
    const int r = tid / 4, part = tid % 4, t = q0 + r;
    float acc = 0.f;
    if (t < Tq)
      for (int d = part; d < D; d += 4) acc += dob[(size_t)t * D + d] * ob[(size_t)t * D + d];
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      sDvec[r] = acc;
      sLse[r] = t < Tq ? lse[(size_t)bh * Tq + t] : NEG_INF;
    }
  }

  float acc_dq[4][NC], acc_dqv[4][NC], acc_x[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    acc_x[c] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dq[i][c] = acc_dqv[i][c] = 0.f;
  }

  // under a chunk width key j is hidden from query t iff j >= (t / chunk
  // + 1) chunk: the key tiles past the block's last row's chunk end give
  // A = dS = 0 to every row of the block, so the walk ends there
  const int kwalk =
      chunk > 0 ? min(Tk, ((sh.qoff + min(q0 + BM, Tq) - 1) / chunk + 1) * chunk) : Tk;
  int cend[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    cend[i] = chunk > 0 ? ((g0 + ty + 16 * i) / chunk + 1) * chunk : Tk;

  for (int k0 = 0; k0 < kwalk; k0 += BN) {
    // ---- phase A: scores, dO V^T, then A, A_v, dS ----
    float s_ac[4][4], s_bd[4][4], s_dp[4][4];
    bool nxt[4][4];  // key right of the query: reads q_v row t + 1
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s_ac[i][j] = s_bd[i][j] = s_dp[i][j] = 0.f;
        nxt[i][j] = g0 + ty + 16 * i < k0 + tx + 16 * j;
      }
    // window slot w holds diagonal delta = dbase + w
    const int dbase = g0 - k0 - (BN - 1);

    for (int c0 = 0; c0 < D; c0 += DC) {
      __syncthreads();  // earlier readers of the shared buffers are done
      for (int idx = tid; idx < BM * DC; idx += NT) {
        const int r = idx / DC, c = idx % DC, t = q0 + r, d = c0 + c;
        const bool in = t < Tq && d < D;
        sQ[c * LDQ + r] = in ? qb[(size_t)t * D + d] : 0.f;
        sO[c * LDQ + r] = in ? dob[(size_t)t * D + d] : 0.f;
      }
      for (int idx = tid; idx < BN * DC; idx += NT) {
        const int r = idx / DC, c = idx % DC, j = k0 + r, d = c0 + c;
        const bool in = j < Tk && d < D;
        sK[c * LDK + r] = in ? kb[(size_t)j * D + d] : 0.f;
        sV[c * LDK + r] = in ? vb[(size_t)j * D + d] : 0.f;
      }
      for (int idx = tid; idx < (BM + 1) * DC; idx += NT) {
        const int r = idx / DC, c = idx % DC, t = q0 + r, d = c0 + c;
        sQv[c * LDQV + r] = (t < sh.tqv && d < D) ? qvb[(size_t)t * D + d] : 0.f;
      }
      for (int idx = tid; idx < PW * DC; idx += NT) {
        const int w = idx / DC, c = idx % DC, d = c0 + c;
        const int delta = dbase + w;
        const int row = delta >= 0 ? Tk - 1 - delta : -delta - 2;  // -1 at delta == -1
        sP[c * LDP + w] = (row >= 0 && row < Tk && d < D) ? pb[(size_t)row * D + d] : 0.f;
      }
      __syncthreads();

      const int kc = min(DC, D - c0);
      for (int c = 0; c < kc; ++c) {
        float a[4], b[4], e[4], f[4], u[4], u1[4], pw[7];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = sQ[c * LDQ + ty + 16 * i];
          e[i] = sO[c * LDQ + ty + 16 * i];
          u[i] = sQv[c * LDQV + ty + 16 * i];
          u1[i] = sQv[c * LDQV + ty + 16 * i + 1];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = sK[c * LDK + tx + 16 * j];
          f[j] = sV[c * LDK + tx + 16 * j];
        }
        // slot of (i, j) is ty - tx + 16 (i - j) + BN - 1
#pragma unroll
        for (int m = 0; m < 7; ++m) pw[m] = sP[c * LDP + ty - tx + 16 * (m - 3) + BN - 1];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s_ac[i][j] = fmaf(a[i], b[j], s_ac[i][j]);
            s_dp[i][j] = fmaf(e[i], f[j], s_dp[i][j]);
            s_bd[i][j] = fmaf(nxt[i][j] ? u1[i] : u[i], pw[i - j + 3], s_bd[i][j]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, t = q0 + r;
      const float lse_t = sLse[r], dvec = sDvec[r];
      const bool live = t < Tq && lse_t > NEG_INF / 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float a = 0.f;
        if (live && key < Tk && key < kv_len && key < cend[i])
          a = expf((s_ac[i][j] + s_bd[i][j]) * scale - lse_t);
        float av = a, dpe = s_dp[i][j];
        if (dropout) {
          const bool keep = keep_elem(hrow, sh.qoff + t, key, tqe, tke, seed, thr);
          av = keep ? a * inv_keep : 0.f;
          dpe = keep ? dpe * inv_keep : 0.f;
        }
        sDS[r * LDS + tx + 16 * j] = a * (dpe - dvec) * scale;
        sAV[r * LDS + tx + 16 * j] = av;
      }
    }
    __syncthreads();  // dS / A_v complete; the stage is free

    // ---- phase B1: dQ_u, dK, dV ----
    for (int idx = tid; idx < BN * DMAX; idx += NT) {
      const int r = idx / DMAX, d = idx % DMAX;
      const int j = k0 + r, t = q0 + r;
      rK[idx] = (j < Tk && d < D) ? kb[(size_t)j * D + d] : 0.f;
      rQ[idx] = (t < Tq && d < D) ? qb[(size_t)t * D + d] : 0.f;
      rO[idx] = (t < Tq && d < D) ? dob[(size_t)t * D + d] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < BN; ++j) {
      float kk[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kk[c] = rK[j * DMAX + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sDS[(ty + 16 * i) * LDS + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc_dq[i][c] = fmaf(ds, kk[c], acc_dq[i][c]);
      }
    }
    {
      float pk[4][NC], pv[4][NC];  // key rows ty + 16 i of this tile
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) pk[i][c] = pv[i][c] = 0.f;
      for (int r = 0; r < BM; ++r) {
        float qq[NC], oo[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          qq[c] = rQ[r * DMAX + tx + 16 * c];
          oo[c] = rO[r * DMAX + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ds = sDS[r * LDS + ty + 16 * i];
          const float av = sAV[r * LDS + ty + 16 * i];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            pk[i][c] = fmaf(ds, qq[c], pk[i][c]);
            pv[i][c] = fmaf(av, oo[c], pv[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = k0 + ty + 16 * i;
        if (j >= Tk) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = tx + 16 * c;
          if (d < D) {
            atomicAdd(dk + krow0 + (size_t)j * D + d, pk[i][c]);
            atomicAdd(dv + krow0 + (size_t)j * D + d, pv[i][c]);
          }
        }
      }
    }
    __syncthreads();  // B1 buffers free

    // ---- phase B2: dQ_v and dP through the relshift adjoint ----
    for (int idx = tid; idx < PW * DMAX; idx += NT) {
      const int w = idx / DMAX, d = idx % DMAX;
      const int delta = dbase + w;
      const int row = delta >= 0 ? Tk - 1 - delta : -delta - 2;
      rP[idx] = (row >= 0 && row < Tk && d < D) ? pb[(size_t)row * D + d] : 0.f;
    }
    for (int idx = tid; idx < (BM + 1) * DMAX; idx += NT) {
      const int r = idx / DMAX, d = idx % DMAX, t = q0 + r;
      rQv[idx] = (t < sh.tqv && d < D) ? qvb[(size_t)t * D + d] : 0.f;
    }
    __syncthreads();

    // dQ_v row r: dS[r, key <= t] at slot r - j + BN - 1, and dS[r - 1,
    // key > t] (the previous row's keys past t + 1 ... read row r) at slot
    // r - 1 - j + BN - 1. Row 0's second term is the previous block's.
    for (int j = 0; j < BN; ++j) {
      const int kg = k0 + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, tg = g0 + r;
        const float wl = kg <= tg ? sDS[r * LDS + j] : 0.f;
        const float wg = (r >= 1 && kg > tg) ? sDS[(r - 1) * LDS + j] : 0.f;
        const float* pl = rP + (r - j + BN - 1) * DMAX + tx;
        const float* pg = rP + max(r - 2 - j + BN, 0) * DMAX + tx;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc_dqv[i][c] = fmaf(wl, pl[16 * c], fmaf(wg, pg[16 * c], acc_dqv[i][c]));
      }
    }
    if (ty == 0) {  // the crossover: row q0 + 64 from this tile's last row
      for (int j = 0; j < BN; ++j) {
        if (k0 + j <= g0 + BM) continue;
        const float w = sDS[(BM - 1) * LDS + j];
        const float* pg = rP + (BM - 1 - j + BN - 1) * DMAX + tx;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc_x[c] = fmaf(w, pg[16 * c], acc_x[c]);
      }
    }
    // dP: window slot w (one diagonal, one table row) over the tile's rows;
    // delta >= 0 pairs dS[t, t - dl] with q_v row t, delta <= -2 with t + 1
    for (int idx = tid; idx < PW * DMAX; idx += NT) {
      const int w = idx / DMAX, d = idx % DMAX;
      const int delta = dbase + w;
      const int row = delta >= 0 ? Tk - 1 - delta : -delta - 2;
      if (delta == -1 || row < 0 || row >= Tk || d >= D) continue;
      const int dl = w - (BN - 1);  // local t - j on this diagonal
      const int shift = delta >= 0 ? 0 : 1;
      const int lo = max(0, dl), hi = min(BM, BN + dl);
      float acc = 0.f;
      for (int t = lo; t < hi; ++t)
        acc = fmaf(sDS[t * LDS + t - dl], rQv[(t + shift) * DMAX + d], acc);
      atomicAdd(dp + (size_t)(bh % p_mod) * Tk * D + (size_t)row * D + d, acc);
    }
  }

  // dQ_v rows run to tqv: the row after the local last query (the next
  // shard's first, when tqv = Tq + 1) takes that query's crossover terms
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d >= D) continue;
      if (t < Tq) dq[row0 + (size_t)t * D + d] = acc_dq[i][c];
      if (t < sh.tqv) atomicAdd(dqv + vrow0 + (size_t)t * D + d, acc_dqv[i][c]);
    }
  }
  if (ty == 0 && q0 + BM < sh.tqv) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) atomicAdd(dqv + vrow0 + (size_t)(q0 + BM) * D + d, acc_x[c]);
    }
  }
}


template <int DMAX>
cudaError_t launch(const void* q, const void* qv, const void* k, const void* v,
                   const void* p, const int32_t* kv_lens, const float* out,
                   const float* lse, const float* dout, float* dq, float* dqv, float* dk,
                   float* dv, float* dp, int BH, int Tq, int Tk, int D, int p_mod,
                   float scale, int dropout, uint32_t seed, uint32_t thr, float inv_keep,
                   int tqe, int tke, int chunk, tc::Shard sh, cudaStream_t stream) {
  constexpr size_t smem = Smem<DMAX>::kBytes;
  auto kernel = rel_attn_bwd_kernel<DMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BM - 1) / BM, BH);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(qv), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(p), kv_lens, out, lse, dout, dq,
      dqv, dk, dv, dp, Tq, Tk, D, p_mod, scale, dropout, seed, thr, inv_keep, tqe, tke, chunk,
      sh);
  return cudaGetLastError();
}

// ---- the bf16 body: tensor cores, asynchronous tile loads ----

using tc::bf16;
constexpr int TC_NT = 128;  // 4 warps; warp w owns keys 16 w .. 16 w + 15 of the tile
constexpr int LDB = 132;    // fp32 row stride of the window scores

// Dvec = rowsum(dO * O) in fp32 and dO in bf16, one warp a row: the main
// kernel then reads neither fp32 tensor
__global__ void bwd_prep_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                                bf16* __restrict__ dob, float* __restrict__ dvec, int rows,
                                int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t o = (size_t)row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float x = dout[o + d];
    acc = fmaf(x, out[o + d], acc);
    dob[o + d] = __float2bfloat16(x);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[row] = acc;
}

template <int DMAX>
struct TcSmem {
  // a query tile's stage: Q_u, dO (64 rows), q_v rows q0 .. q0 + 79 (65
  // used), the position window (128 rows), lse and Dvec. One stage: at
  // D <= 64 the block then takes 100 KB and two blocks share an SM, one
  // copying while the other computes; a second stage would leave room for
  // one block only
  static constexpr int ROW = DMAX * 2;
  static constexpr int oQ = 0, oDO = 64 * ROW, oQv = 128 * ROW, oP = oQv + 80 * ROW;
  static constexpr int oL = oP + 128 * ROW;
  static constexpr int kStage = oL + 2 * 64 * (int)sizeof(float);
  static constexpr int oK = kStage, oV = oK + 64 * ROW;  // the block's keys
  // window scores (65 x LDB fp32); once they are read, dB (80 x 128 bf16)
  static constexpr int oB = oV + 64 * ROW;
  static constexpr int oS = oB + 65 * LDB * (int)sizeof(float);  // dS^T (64 x 64 bf16)
  static constexpr int oKr = oS + 64 * 64 * 2;  // the dropout hash's row terms
  static constexpr size_t kBytes = oKr + 64 * sizeof(uint32_t);
};

// atomically adds the C fragments of n-tiles n0, n0 + 8, .. of a warp's 16
// rows into rows row(0..15) of a (., D) fp32 matrix; rows where row() < 0
// skip
template <int NT, typename Row>
__device__ __forceinline__ void red_block(float* base, int D, int n0, const float (&c)[NT][4],
                                          int lane, Row row) {
  const int g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = row(g + 8 * h);
    if (t < 0) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n0 + 8 * n + 2 * qd;
      float* dst = base + (size_t)t * D + d;
      if (d + 1 < D && D % 2 == 0) {
        atomicAdd(reinterpret_cast<float2*>(dst), make_float2(c[n][2 * h], c[n][2 * h + 1]));
      } else {
        if (d < D) atomicAdd(dst, c[n][2 * h]);
        if (d + 1 < D) atomicAdd(dst + 1, c[n][2 * h + 1]);
      }
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(TC_NT)
rel_attn_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ qv,
                       const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ p, const int32_t* __restrict__ kv_lens,
                       const float* __restrict__ lse, const bf16* __restrict__ dob,
                       const float* __restrict__ dvec, float* __restrict__ dq,
                       float* __restrict__ dqv, float* __restrict__ dk,
                       float* __restrict__ dv, float* __restrict__ dp, int Tq, int Tk,
                       int D, int p_mod, float scale, int dropout, uint32_t seed,
                       uint32_t thr, float inv_keep, int tqe, int tke, int chunk, tc::Shard sh,
                       int vec) {
  using S = TcSmem<DMAX>;
  constexpr int NCH = DMAX / 8, KS = DMAX / 16, NO = DMAX / 8;
  extern __shared__ __align__(128) char tsm[];
  const uint32_t s0 = tc::smem_u32(tsm);
  float* sB = reinterpret_cast<float*>(tsm + S::oB);
  char* sdB = tsm + S::oB;
  char* sdS = tsm + S::oS;

  const int bh = blockIdx.y, k0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3, m0 = 16 * warp;
  const int kv_len = kv_lens ? kv_lens[bh] : Tk;
  // query rows (Q_u, dO, dQ_u), q_v rows (q_v, dQ_v) and key rows (K, V, dK,
  // dV) of this bh
  const size_t row0 = (size_t)bh * Tq * D, vrow0 = (size_t)bh * sh.tqv * D,
               krow0 = (size_t)bh * Tk * D;

  // the dropout hash's term of each of the thread's two keys, whether a
  // row may weigh them, and (under a chunk width) the first query that may:
  // key j is seen by query t (the full call's index) iff t >= (j / chunk) chunk
  const uint32_t kcol[2] = {tc::keep_col(k0 + m0 + g, tke), tc::keep_col(k0 + m0 + g + 8, tke)};
  const bool key_live[2] = {k0 + m0 + g < min(Tk, kv_len), k0 + m0 + g + 8 < min(Tk, kv_len)};
  const int kfirst[2] = {chunk > 0 ? (k0 + m0 + g) / chunk * chunk : 0,
                         chunk > 0 ? (k0 + m0 + g + 8) / chunk * chunk : 0};
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // a key tile wholly past kv_len (or a row bh with no key: lse = NEG_INF
  // everywhere) has A = 0: every gradient it touches is 0
  if (k0 < kv_len) {
    const bf16* pb = p + (size_t)(bh % p_mod) * Tk * D;
    float* dpt = dp + (size_t)(bh % p_mod) * Tk * D;
    const int nq = (Tq + BM - 1) / BM;
    // the query tiles before the one that holds the tile's first key's
    // chunk start see none of its keys (A = dS = 0): skipped, exactly
    const int it0 = chunk > 0 ? max(0, k0 / chunk * chunk - sh.qoff) / BM : 0;

    auto load_query_tile = [&](int it) {
      const int q0 = it * BM;
      auto qrow = [&](int r) { return q0 + r < Tq ? q0 + r : -1; };
      tc::load_tile<NCH>(tsm + S::oQ, q + row0, 64, D, vec, qrow);
      tc::load_tile<NCH>(tsm + S::oDO, dob + row0, 64, D, vec, qrow);
      tc::load_tile<NCH>(tsm + S::oQv, qv + vrow0, 80, D, vec,
                         [&](int r) { return (r <= BM && q0 + r < sh.tqv) ? q0 + r : -1; });
      const int dbase = sh.qoff + q0 - k0 - (BN - 1);
      tc::load_tile<NCH>(tsm + S::oP, pb, 128, D, vec,
                         [&](int w) { return tc::window_row(dbase, w, Tk); });
      // lse and Dvec of the tile's rows, zero past Tq (where step 3 reads
      // neither)
      const int i = threadIdx.x, t = q0 + (i & 63);
      tc::cp_async4(tc::smem_u32(tsm + S::oL + 4 * i),
                    (i < 64 ? lse : dvec) + (size_t)bh * Tq + min(t, Tq - 1), t < Tq);
      tc::cp_async_commit();
    };

    auto krow = [&](int r) { return k0 + r < Tk ? k0 + r : -1; };
    tc::load_tile<NCH>(tsm + S::oK, k + krow0, 64, D, vec, krow);
    tc::load_tile<NCH>(tsm + S::oV, v + krow0, 64, D, vec, krow);
    load_query_tile(it0);

    for (int it = it0; it < nq; ++it) {
      const int q0 = it * BM, g0 = sh.qoff + q0;
      const float* sl = reinterpret_cast<const float*>(tsm + S::oL);
      const int dbase = g0 - k0 - (BN - 1);
      tc::cp_async_wait_all();
      tc::fence_async_smem();
      __syncthreads();  // this query tile landed
      uint32_t* skr = reinterpret_cast<uint32_t*>(tsm + S::oKr);
      if (dropout && threadIdx.x < 64)  // read in step 3, after the next barrier
        skr[threadIdx.x] = tc::keep_row(sh.hash_row(bh), g0 + threadIdx.x, tqe, seed);

      // 1. window scores B = q_v[q0 .. q0+63] . window^T into sB, two wgmma
      //    halves of 64 slots, and the crossover row 64 as dot products while
      //    the tensor cores run, as in the forward
      {
        float b0[8][4], b1[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) b0[n][e] = b1[n][e] = 0.f;
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          tc::wg_ss_n64<0, 0>(b0, tc::wg_desc_k<NCH>(s0 + S::oQv, kk),
                           tc::wg_desc_k<NCH>(s0 + S::oP, kk));
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          tc::wg_ss_n64<0, 0>(b1, tc::wg_desc_k<NCH>(s0 + S::oQv, kk),
                           tc::wg_desc_k<NCH>(s0 + S::oP + 64 * S::ROW, kk));
        tc::wg_commit();
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
        tc::wg_wait_all();
        tc::wg_hold(b0);
        tc::wg_hold(b1);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float* row = sB + (m0 + g) * LDB + 8 * n + 2 * qd;
          *reinterpret_cast<float2*>(row) = make_float2(b0[n][0], b0[n][1]);
          *reinterpret_cast<float2*>(row + 8 * LDB) = make_float2(b0[n][2], b0[n][3]);
          *reinterpret_cast<float2*>(row + 64) = make_float2(b1[n][0], b1[n][1]);
          *reinterpret_cast<float2*>(row + 8 * LDB + 64) = make_float2(b1[n][2], b1[n][3]);
        }
      }

      // 2. S^T = K Q_u^T and dP^T = V dO^T (wgmma): the warp's 16 keys x 64
      //    queries, issued before the barrier that completes sB
      float s[8][4], dpv[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dpv[n][e] = 0.f;
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        tc::wg_ss_n64<0, 0>(s, tc::wg_desc_k<NCH>(s0 + S::oK, kk),
                            tc::wg_desc_k<NCH>(s0 + S::oQ, kk));
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        tc::wg_ss_n64<0, 0>(dpv, tc::wg_desc_k<NCH>(s0 + S::oV, kk),
                         tc::wg_desc_k<NCH>(s0 + S::oDO, kk));
      tc::wg_commit();
      __syncthreads();  // sB complete
      tc::wg_wait_all();
      tc::wg_hold(s);
      tc::wg_hold(dpv);

      // 3. A = exp(S - lse) with the rel-pos term by diagonal; A_v and dS
      //    (s keeps A_v, dpv keeps dS). Branch-free: the term is B's row r
      //    (delta >= 0) or r + 1 (delta <= -2), read for delta == -1 too
      //    and dropped.
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * n + 2 * qd + e;
          const float lse_t = sl[r], dvec_t = sl[64 + r];
          const bool row_live = q0 + r < Tq && lse_t > NEG_INF / 2;
          const uint32_t krow = dropout ? skr[r] : 0u;  // the hash's row term
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = m0 + g + 8 * h, w = BN - 1 + r - c, delta = dbase + w;
            const float bd = sB[(delta < 0 ? r + 1 : r) * LDB + w];
            const float x = s[n][2 * h + e] + (delta == -1 ? 0.f : bd);
            const float a = row_live && key_live[h] && g0 + r >= kfirst[h]
                                ? __expf(x * scale - lse_t)
                                : 0.f;
            float av = a, dpe = dpv[n][2 * h + e];
            if (dropout) {
              const bool keep = tc::keep_mix(krow + kcol[h], thr);
              av = keep ? a * inv_keep : 0.f;
              dpe = keep ? dpe * inv_keep : 0.f;
            }
            s[n][2 * h + e] = av;
            dpv[n][2 * h + e] = a * (dpe - dvec_t) * scale;
          }
        }
      // dS^T in bf16, [key][query], for dQ_u and the window adjoint
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<uint32_t*>(sdS + tc::cm_elem<8>(m0 + g + 8 * h, 8 * n + 2 * qd)) =
              tc::pack(dpv[n][2 * h], dpv[n][2 * h + 1]);

      // 4. dV += A_v^T dO and dK += dS^T Q_u (wgmma, A from registers): A_v
      //    and dS rounded to bf16, as the TPU kernel rounds them, straight
      //    from the accumulators; dO and Q_u as the N-major operands
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t aa[4] = {tc::pack(s[2 * kk][0], s[2 * kk][1]),
                                tc::pack(s[2 * kk][2], s[2 * kk][3]),
                                tc::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                tc::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t ad[4] = {tc::pack(dpv[2 * kk][0], dpv[2 * kk][1]),
                                tc::pack(dpv[2 * kk][2], dpv[2 * kk][3]),
                                tc::pack(dpv[2 * kk + 1][0], dpv[2 * kk + 1][1]),
                                tc::pack(dpv[2 * kk + 1][2], dpv[2 * kk + 1][3])};
        if constexpr (NO == 8) {
          tc::wg_rs_n64<1>(dv_acc, aa, tc::wg_desc_n<NCH>(s0 + S::oDO, kk));
          tc::wg_rs_n64<1>(dk_acc, ad, tc::wg_desc_n<NCH>(s0 + S::oQ, kk));
        } else {
          tc::wg_rs_n128<1>(dv_acc, aa, tc::wg_desc_n<NCH>(s0 + S::oDO, kk));
          tc::wg_rs_n128<1>(dk_acc, ad, tc::wg_desc_n<NCH>(s0 + S::oQ, kk));
        }
      }
      tc::wg_commit();
      tc::wg_wait_all();
      tc::wg_hold(dv_acc);
      tc::wg_hold(dk_acc);
      tc::fence_async_smem();  // dS^T is read by wgmma next
      __syncthreads();  // dS^T complete; the window scores are read

      // 5. the relshift adjoint as a window matrix dB (80 x 128 bf16, over
      //    the window scores, which are read): dB[r][w] = dS[r][c] on
      //    diagonals delta >= 0 and dS[r-1][c] on delta <= -2 (the score
      //    that read q_v row r), c = 63 + r - w; the two never meet at one
      //    (r, w). Cleared, then each thread writes its 32 dS values.
      for (int i = threadIdx.x; i < 80 * 16; i += TC_NT)
        *reinterpret_cast<uint4*>(sdB + 16 * i) = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 8 * n + 2 * qd + e, w = BN - 1 + r - (m0 + g + 8 * h);
            const int delta = dbase + w;
            if (delta != -1)
              *reinterpret_cast<bf16*>(sdB + tc::cm_elem<16>(delta >= 0 ? r : r + 1, w)) =
                  __float2bfloat16(dpv[n][2 * h + e]);
          }
      tc::fence_async_smem();  // dB is read by wgmma after the next barrier

      // 6. dQ_u[q0 + m0 ..] += dS K (wgmma: dS^T as the M-major A, K
      //    N-major), by fp32 atomics: the key tiles of a query row live in
      //    different blocks
      {
        float acc[NO][4];
#pragma unroll
        for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = tc::wg_desc_n<8>(s0 + S::oS, kk);
          const uint64_t db = tc::wg_desc_n<NCH>(s0 + S::oK, kk);
          if constexpr (NO == 8) tc::wg_ss_n64<1, 1>(acc, da, db);
          else tc::wg_ss_n128<1, 1>(acc, da, db);
        }
        tc::wg_commit();
        tc::wg_wait_all();
        tc::wg_hold(acc);
        red_block(dq + row0, D, 0, acc, lane, [&](int i) {
          const int t = q0 + m0 + i;
          return t < Tq ? t : -1;
        });
      }

      __syncthreads();  // dB complete

      // 7. dQ_v[q0 + m0 ..] += dB P_window (wgmma: dB K-major, the window
      //    N-major), added by fp32 atomics. The crossover row q0 + 64 takes
      //    dB's row 64 (the tile's last dS row) in one more 16-row product
      //    (mma.sync; rows 65 .. 79 of dB are zero), its column pairs spread
      //    over the warps. dQ_v's rows run to tqv: the row after the local
      //    last query (the next shard's first) takes that query's crossover.
      if (q0 + BM < sh.tqv) {
        for (int np = warp; np < NO / 2; np += 4) {
          float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            uint32_t a[4], b[4];
            tc::ld_a<16>(a, s0 + S::oB, BM, kk, lane);
            tc::ld_b_t<NCH>(b, s0 + S::oP, 16 * np, kk, lane);
            tc::mma(c[0], a, b[0], b[1]);
            tc::mma(c[1], a, b[2], b[3]);
          }
          red_block(dqv + vrow0, D, 16 * np, c, lane, [&](int i) { return i == 0 ? q0 + BM : -1; });
        }
      }
      {
        float acc[NO][4];
#pragma unroll
        for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint64_t da = tc::wg_desc_k<16>(s0 + S::oB, kk);
          const uint64_t db = tc::wg_desc_n<NCH>(s0 + S::oP, kk);
          if constexpr (NO == 8) tc::wg_ss_n64<0, 1>(acc, da, db);
          else tc::wg_ss_n128<0, 1>(acc, da, db);
        }
        tc::wg_commit();
        tc::wg_wait_all();
        tc::wg_hold(acc);
        red_block(dqv + vrow0, D, 0, acc, lane, [&](int i) {
          const int t = q0 + m0 + i;
          return t < sh.tqv ? t : -1;
        });
      }

      // 8. dP_window = dB^T q_v[q0 .. q0+79] (wgmma: dB^T as the M-major A
      //    over k = 80 rows, q_v N-major) in two halves of 64 window slots,
      //    added into the shared table's rows
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float acc[NO][4];
#pragma unroll
        for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 5; ++kk) {
          const uint64_t da = tc::wg_desc_n<16>(s0 + S::oB + 1024 * half, kk);
          const uint64_t db = tc::wg_desc_n<NCH>(s0 + S::oQv, kk);
          if constexpr (NO == 8) tc::wg_ss_n64<1, 1>(acc, da, db);
          else tc::wg_ss_n128<1, 1>(acc, da, db);
        }
        tc::wg_commit();
        tc::wg_wait_all();
        tc::wg_hold(acc);
        red_block(dpt, D, 0, acc, lane,
                  [&](int i) { return tc::window_row(dbase, 64 * half + m0 + i, Tk); });
      }
      if (it + 1 < nq) {
        __syncthreads();  // the stage's and dB's readers are done
        load_query_tile(it + 1);  // the SM's other block computes meanwhile
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = k0 + m0 + g + 8 * h;
    if (j >= Tk) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = 8 * n + 2 * qd;
      const size_t o = krow0 + (size_t)j * D + d;
      if (d < D) {
        dk[o] = dk_acc[n][2 * h];
        dv[o] = dv_acc[n][2 * h];
      }
      if (d + 1 < D) {
        dk[o + 1] = dk_acc[n][2 * h + 1];
        dv[o + 1] = dv_acc[n][2 * h + 1];
      }
    }
  }
}

template <int DMAX>
cudaError_t launch_tc(const void* q, const void* qv, const void* k, const void* v,
                      const void* p, const int32_t* kv_lens, const float* out,
                      const float* lse, const float* dout, float* dq, float* dqv, float* dk,
                      float* dv, float* dp, bf16* dob, float* dvec, int BH, int Tq, int Tk,
                      int D, int p_mod, float scale, int dropout, uint32_t seed, uint32_t thr,
                      float inv_keep, int tqe, int tke, int chunk, tc::Shard sh,
                      cudaStream_t stream) {
  const int rows = BH * Tq;
  bwd_prep_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(out, dout, dob, dvec, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = TcSmem<DMAX>::kBytes;
  auto kernel = rel_attn_bwd_tc_kernel<DMAX>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  auto a16 = [](const void* x) { return (uintptr_t)x % 16 == 0; };
  const int vec = D % 8 == 0 && a16(q) && a16(qv) && a16(k) && a16(v) && a16(p) && a16(dob);
  dim3 grid((Tk + BN - 1) / BN, BH);
  kernel<<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(qv), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(p), kv_lens, lse, dob, dvec, dq,
      dqv, dk, dv, dp, Tq, Tk, D, p_mod, scale, dropout, seed, thr, inv_keep, tqe, tke, chunk,
      sh, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q_u, qv, k, v, p); out, lse, dout and
// every gradient are fp32; dp is the (p_mod, T, D) table gradient, summed
// over the rows bh that share a table. kv_lens may be null. fp32: dqv, dk,
// dv and dp must be zeroed (atomics), dob/dvec are unused (may be null).
// bf16: dq, dqv and dp must be zeroed, dk and dv are written; dob (BH, Tq, D)
// bf16 and dvec (BH, Tq) fp32 are scratch. chunk > 0 masks key j for query t
// where j / chunk > t / chunk, as the forward did (0: no chunk mask). tqv,
// qoff, hl, ht, h0 place the call in the full attention as the forward's
// do (tc::Shard): q_u, out, lse, dout and dq have Tq rows a bh, qv and dqv
// tqv (dqv's row Tq, when tqv = Tq + 1, is the gradient of the next shard's
// first q_v row), k, v, dk, dv and the table Tk; Tq = Tk, tqv = Tq, 0, 1, 1,
// 0 is the whole call.
extern "C" int rel_attention_bwd(int dtype, const void* q, const void* qv, const void* k,
                                 const void* v, const void* p, const void* kv_lens,
                                 const void* out, const void* lse, const void* dout,
                                 void* dq, void* dqv, void* dk, void* dv, void* dp,
                                 void* dob, void* dvec, int BH, int Tq, int Tk, int D,
                                 int p_mod, float scale, int dropout, uint32_t seed,
                                 uint32_t thr, float inv_keep, int tqe, int tke, int chunk,
                                 int tqv, int qoff, int hl, int ht, int h0, void* stream) {
  if (D < 1 || D > 128 || BH < 1 || BH > 65535 || p_mod < 1 || tqe < 1 || tke < 1 ||
      chunk < 0 || tqv < Tq || qoff < 0 || hl < 1 || ht < hl || h0 < 0 || h0 + hl > ht)
    return (int)cudaErrorInvalidValue;
  const tc::Shard sh{tqv, qoff, hl, ht, h0};
  auto kl = static_cast<const int32_t*>(kv_lens);
  auto o = static_cast<const float*>(out);
  auto ls = static_cast<const float*>(lse);
  auto go = static_cast<const float*>(dout);
  auto f = [](void* x) { return static_cast<float*>(x); };
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
#define LAUNCH(DM)                                                                      \
  launch<DM>(q, qv, k, v, p, kl, o, ls, go, f(dq), f(dqv), f(dk), f(dv), f(dp), BH, \
                    Tq, Tk, D, p_mod, scale, dropout, seed, thr, inv_keep, tqe, tke, chunk, sh, s)
    err = D <= 64 ? LAUNCH(64) : LAUNCH(128);
#undef LAUNCH
  } else if (dtype == 1) {
    if (dob == nullptr || dvec == nullptr) return (int)cudaErrorInvalidValue;
#define LAUNCH(DM)                                                                        \
  launch_tc<DM>(q, qv, k, v, p, kl, o, ls, go, f(dq), f(dqv), f(dk), f(dv), f(dp),          \
                static_cast<bf16*>(dob), f(dvec), BH, Tq, Tk, D, p_mod, scale, dropout, seed,   \
                thr, inv_keep, tqe, tke, chunk, sh, s)
    err = D <= 64 ? LAUNCH(64) : LAUNCH(128);
#undef LAUNCH
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
