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
// One block computes 64 query rows of one row bh and walks the keys in
// tiles of 64. Per key tile:
//   A. S (Q_u K^T + the rel-pos term) and dO V^T, accumulated over
//      head-dim chunks of 32 staged transposed in shared memory, as in the
//      forward; then A, A_v and dS into shared memory.
//   B1. dQ_u += dS K in registers; this tile's dK and dV partials.
//   B2. dQ_v += (dS by diagonal) P-window in registers; this tile's dP
//       partial per window diagonal.
// Accumulation across query tiles uses fp32 atomics into fp32 buffers the
// wrapper zeroes: dK, dV, dQ_v (whose crossover row belongs to the next
// block) and dP, written per row bh and summed over the batch rows that
// share a table by the wrapper. dQ_u is owned by the block and stored.
// The dropout keep mask is regenerated with the forward's hash and the TPU
// kernel's tile coordinates.
// What bounds it: everything a block reads is reused 64 times from shared
// memory; it is bound by shared-memory loads and fp32 FMA issue, and by the
// atomics of dK/dV/dP. Tensor cores (wgmma) and a key-tile-owning layout
// without dK/dV atomics are later work.
//
// C interface (ctypes): rel_attention_bwd returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// the forward's keep test (csrc/rel_attention_fwd.cu, _dropout_keep)
__device__ __forceinline__ bool keep_elem(uint32_t bh, int t, int j, int tqe, int tke,
                                          uint32_t seed, uint32_t thr) {
  const uint32_t qi = (uint32_t)(t / tqe), row = (uint32_t)(t % tqe);
  const uint32_t kj = (uint32_t)(j / tke), col = (uint32_t)(j % tke);
  const uint32_t tile = ((bh * 65537u + qi) * 8191u + kj) * 131071u + seed;
  uint32_t u = row * 0x9E3779B1u + col * 0x85EBCA77u + tile * 0xC2B2AE3Du;
  u ^= u >> 16;
  u *= 0x7FEB352Du;
  u ^= u >> 15;
  u *= 0x846CA68Bu;
  u ^= u >> 16;
  return u < thr;
}

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

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
rel_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ qv,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ p, const int32_t* __restrict__ kv_lens,
                    const float* __restrict__ out, const float* __restrict__ lse,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    float* __restrict__ dqv, float* __restrict__ dk,
                    float* __restrict__ dv, float* __restrict__ dp_rows, int Tn, int D,
                    int p_mod, float scale, int dropout, uint32_t seed, uint32_t thr,
                    float inv_keep, int tqe, int tke) {
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
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int kv_len = kv_lens ? kv_lens[bh] : Tn;
  const size_t row0 = (size_t)bh * Tn * D;
  const T* qb = q + row0;
  const T* qvb = qv + row0;
  const T* kb = k + row0;
  const T* vb = v + row0;
  const T* pb = p + (size_t)(bh % p_mod) * Tn * D;
  const float* ob = out + row0;
  const float* dob = dout + row0;

  {  // Dvec = rowsum(dO * O) and lse of the block's rows: 4 threads a row
    const int r = tid / 4, part = tid % 4, t = q0 + r;
    float acc = 0.f;
    if (t < Tn)
      for (int d = part; d < D; d += 4) acc += dob[(size_t)t * D + d] * ob[(size_t)t * D + d];
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      sDvec[r] = acc;
      sLse[r] = t < Tn ? lse[(size_t)bh * Tn + t] : NEG_INF;
    }
  }

  float acc_dq[4][NC], acc_dqv[4][NC], acc_x[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    acc_x[c] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dq[i][c] = acc_dqv[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += BN) {
    // ---- phase A: scores, dO V^T, then A, A_v, dS ----
    float s_ac[4][4], s_bd[4][4], s_dp[4][4];
    bool nxt[4][4];  // key right of the query: reads q_v row t + 1
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s_ac[i][j] = s_bd[i][j] = s_dp[i][j] = 0.f;
        nxt[i][j] = q0 + ty + 16 * i < k0 + tx + 16 * j;
      }
    // window slot w holds diagonal delta = dbase + w
    const int dbase = q0 - k0 - (BN - 1);

    for (int c0 = 0; c0 < D; c0 += DC) {
      __syncthreads();  // earlier readers of the shared buffers are done
      for (int idx = tid; idx < BM * DC; idx += NT) {
        const int r = idx / DC, c = idx % DC, t = q0 + r, d = c0 + c;
        const bool in = t < Tn && d < D;
        sQ[c * LDQ + r] = in ? to_f(qb[(size_t)t * D + d]) : 0.f;
        sO[c * LDQ + r] = in ? dob[(size_t)t * D + d] : 0.f;
      }
      for (int idx = tid; idx < BN * DC; idx += NT) {
        const int r = idx / DC, c = idx % DC, j = k0 + r, d = c0 + c;
        const bool in = j < Tn && d < D;
        sK[c * LDK + r] = in ? to_f(kb[(size_t)j * D + d]) : 0.f;
        sV[c * LDK + r] = in ? to_f(vb[(size_t)j * D + d]) : 0.f;
      }
      for (int idx = tid; idx < (BM + 1) * DC; idx += NT) {
        const int r = idx / DC, c = idx % DC, t = q0 + r, d = c0 + c;
        sQv[c * LDQV + r] = (t < Tn && d < D) ? to_f(qvb[(size_t)t * D + d]) : 0.f;
      }
      for (int idx = tid; idx < PW * DC; idx += NT) {
        const int w = idx / DC, c = idx % DC, d = c0 + c;
        const int delta = dbase + w;
        const int row = delta >= 0 ? Tn - 1 - delta : -delta - 2;  // -1 at delta == -1
        sP[c * LDP + w] = (row >= 0 && row < Tn && d < D) ? to_f(pb[(size_t)row * D + d]) : 0.f;
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
      const bool live = t < Tn && lse_t > NEG_INF / 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float a = 0.f;
        if (live && key < Tn && key < kv_len)
          a = expf((s_ac[i][j] + s_bd[i][j]) * scale - lse_t);
        float av = a, dpe = s_dp[i][j];
        if (dropout) {
          const bool keep = keep_elem((uint32_t)bh, t, key, tqe, tke, seed, thr);
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
      rK[idx] = (j < Tn && d < D) ? to_f(kb[(size_t)j * D + d]) : 0.f;
      rQ[idx] = (t < Tn && d < D) ? to_f(qb[(size_t)t * D + d]) : 0.f;
      rO[idx] = (t < Tn && d < D) ? dob[(size_t)t * D + d] : 0.f;
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
        if (j >= Tn) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = tx + 16 * c;
          if (d < D) {
            atomicAdd(dk + row0 + (size_t)j * D + d, pk[i][c]);
            atomicAdd(dv + row0 + (size_t)j * D + d, pv[i][c]);
          }
        }
      }
    }
    __syncthreads();  // B1 buffers free

    // ---- phase B2: dQ_v and dP through the relshift adjoint ----
    for (int idx = tid; idx < PW * DMAX; idx += NT) {
      const int w = idx / DMAX, d = idx % DMAX;
      const int delta = dbase + w;
      const int row = delta >= 0 ? Tn - 1 - delta : -delta - 2;
      rP[idx] = (row >= 0 && row < Tn && d < D) ? to_f(pb[(size_t)row * D + d]) : 0.f;
    }
    for (int idx = tid; idx < (BM + 1) * DMAX; idx += NT) {
      const int r = idx / DMAX, d = idx % DMAX, t = q0 + r;
      rQv[idx] = (t < Tn && d < D) ? to_f(qvb[(size_t)t * D + d]) : 0.f;
    }
    __syncthreads();

    // dQ_v row r: dS[r, key <= t] at slot r - j + BN - 1, and dS[r - 1,
    // key > t] (the previous row's keys past t + 1 ... read row r) at slot
    // r - 1 - j + BN - 1. Row 0's second term is the previous block's.
    for (int j = 0; j < BN; ++j) {
      const int kg = k0 + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, tg = q0 + r;
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
        if (k0 + j <= q0 + BM) continue;
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
      const int row = delta >= 0 ? Tn - 1 - delta : -delta - 2;
      if (delta == -1 || row < 0 || row >= Tn || d >= D) continue;
      const int dl = w - (BN - 1);  // local t - j on this diagonal
      const int shift = delta >= 0 ? 0 : 1;
      const int lo = max(0, dl), hi = min(BM, BN + dl);
      float acc = 0.f;
      for (int t = lo; t < hi; ++t)
        acc = fmaf(sDS[t * LDS + t - dl], rQv[(t + shift) * DMAX + d], acc);
      atomicAdd(dp_rows + row0 + (size_t)row * D + d, acc);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tn) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d >= D) continue;
      dq[row0 + (size_t)t * D + d] = acc_dq[i][c];
      atomicAdd(dqv + row0 + (size_t)t * D + d, acc_dqv[i][c]);
    }
  }
  if (ty == 0 && q0 + BM < Tn) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) atomicAdd(dqv + row0 + (size_t)(q0 + BM) * D + d, acc_x[c]);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* qv, const void* k, const void* v,
                   const void* p, const int32_t* kv_lens, const float* out,
                   const float* lse, const float* dout, float* dq, float* dqv, float* dk,
                   float* dv, float* dp_rows, int BH, int Tn, int D, int p_mod,
                   float scale, int dropout, uint32_t seed, uint32_t thr, float inv_keep,
                   int tqe, int tke, cudaStream_t stream) {
  constexpr size_t smem = Smem<DMAX>::kBytes;
  auto kernel = rel_attn_bwd_kernel<T, DMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tn + BM - 1) / BM, BH);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(qv), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(p), kv_lens, out, lse, dout, dq,
      dqv, dk, dv, dp_rows, Tn, D, p_mod, scale, dropout, seed, thr, inv_keep, tqe, tke);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q_u, qv, k, v, p); out, lse, dout and
// every gradient are fp32. kv_lens may be null. dqv, dk, dv and dp_rows
// must be zeroed; dp_rows is (BH, T, D), one table gradient per row bh.
extern "C" int rel_attention_bwd(int dtype, const void* q, const void* qv, const void* k,
                                 const void* v, const void* p, const void* kv_lens,
                                 const void* out, const void* lse, const void* dout,
                                 void* dq, void* dqv, void* dk, void* dv, void* dp_rows,
                                 int BH, int Tn, int D, int p_mod, float scale,
                                 int dropout, uint32_t seed, uint32_t thr, float inv_keep,
                                 int tqe, int tke, void* stream) {
  if (D < 1 || D > 128 || BH < 1 || BH > 65535 || p_mod < 1 || tqe < 1 || tke < 1)
    return (int)cudaErrorInvalidValue;
  auto kl = static_cast<const int32_t*>(kv_lens);
  auto o = static_cast<const float*>(out);
  auto ls = static_cast<const float*>(lse);
  auto go = static_cast<const float*>(dout);
  auto f = [](void* x) { return static_cast<float*>(x); };
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define LAUNCH(T, DM)                                                                  \
  launch<T, DM>(q, qv, k, v, p, kl, o, ls, go, f(dq), f(dqv), f(dk), f(dv), f(dp_rows), \
                BH, Tn, D, p_mod, scale, dropout, seed, thr, inv_keep, tqe, tke, s)
  if (dtype == 0) {
    err = D <= 64 ? LAUNCH(float, 64) : LAUNCH(float, 128);
  } else if (dtype == 1) {
    err = D <= 64 ? LAUNCH(__nv_bfloat16, 64) : LAUNCH(__nv_bfloat16, 128);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)err;
}
