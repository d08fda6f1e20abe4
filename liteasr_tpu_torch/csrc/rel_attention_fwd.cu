// Fused attention forward with the in-kernel rel-pos term, for sm_90a.
//
// Replaces liteasr_tpu/ops/flash_attention.py:_attn_kernel (the Pallas TPU
// kernel), with its training options: the per-row lse and the
// attention-probability dropout (K1'). liteasr_tpu_torch/ops/
// flash_attention.py holds the function it computes, its plain PyTorch
// version and the ctypes wrapper.
//
// One block computes 64 query rows of one (batch x head) row `bh`. It walks
// the keys in tiles of 64 with an online softmax, so the scores never reach
// device memory. Per key tile:
//   1. scores: Q K^T and the rel-pos term are accumulated over head-dim
//      chunks of 32 staged (transposed, fp32) in shared memory. Thread
//      (ty, tx) of the 16 x 16 grid owns query rows ty + 16 i and keys
//      tx + 16 j (i, j < 4). The rel-pos term of score (t, j) depends only
//      on the diagonal delta = t - j: delta >= 0 reads table row
//      Tk - 1 - delta with q_v row t, delta <= -2 reads row -delta - 2 with
//      q_v row t + 1 (which may lie in the next query tile, so the tile
//      stages 65 q_v rows), delta == -1 gives 0. The 127 diagonals of a
//      (query tile, key tile) pair are staged once as a "position window",
//      and a thread's 16 scores touch only 7 of them.
//   2. masks (structured bool mask, kv_len, the ragged key edge), then the
//      online-softmax update in registers; rows reduce over the 16 lanes
//      that share ty with warp shuffles. The probabilities are rounded to
//      the input type (as the TPU kernel does before its P V product) and
//      stored in shared memory.
//   3. out += P V with V staged in shared memory.
// Dropout (training) zeroes a probability before P V where the TPU kernel's
// counter hash says so (keep_elem below); the normalizer keeps the
// undropped mass and the output is divided by 1 - rate, as on the TPU. The
// hash is keyed by the TPU kernel's tiles (tqe x tke), not by this kernel's
// 64 x 64 tiles, so both draw the same mask.
// What bounds it: at the decode shapes everything a block reads is reused
// 64 times from shared memory, so it is bound by shared-memory loads and
// fp32 FMA issue, not by HBM. Tensor-core (wgmma) tiles are later work.
//
// C interface (ctypes): rel_attention_fwd returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// _dropout_keep (liteasr_tpu/ops/flash_attention.py:149-174) for global
// query t and key j: a murmur3 finalizer over the in-tile row/column and the
// (bh, q-tile, k-tile, seed) tile id, uint32 with wraparound.
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DMAX>
struct Smem {
  // the score stage (phase 1) and the V tile (phase 3) share storage
  static constexpr int kStage = DC * LDQ + DC * LDQV + DC * LDK + DC * LDP;
  static constexpr int kV = BN * DMAX;
  static constexpr int kUnion = kStage > kV ? kStage : kV;
  static constexpr size_t kBytes = (size_t)(kUnion + BM * LDS) * sizeof(float);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
rel_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ qv,
                    const T* __restrict__ p, const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ kv_lens, T* __restrict__ out,
                    float* __restrict__ lse, int Tq, int Tk, int D, int mask_div,
                    int p_mod, float scale, int dropout, uint32_t seed, uint32_t thr,
                    float keep_div, int tqe, int tke) {
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
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const bool has_rel = qv != nullptr;
  const int kv_len = kv_lens ? kv_lens[bh] : Tk;
  const T* qb = q + (size_t)bh * Tq * D;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const T* qvb = has_rel ? qv + (size_t)bh * Tq * D : nullptr;
  const T* pb = has_rel ? p + (size_t)(bh % p_mod) * Tk * D : nullptr;
  const uint8_t* mb = mask ? mask + (size_t)(bh / mask_div) * Tq * Tk : nullptr;

  float m_i[4], l_i[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += BN) {
    float s_ac[4][4], s_bd[4][4];
    bool nxt[4][4];  // key right of the query: reads q_v row t + 1
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s_ac[i][j] = 0.f;
        s_bd[i][j] = 0.f;
        nxt[i][j] = q0 + ty + 16 * i < k0 + tx + 16 * j;
      }
    // window slot w holds diagonal delta = dbase + w
    const int dbase = q0 - k0 - (BN - 1);

    for (int c0 = 0; c0 < D; c0 += DC) {
      __syncthreads();  // earlier readers of the stage / sV / sS are done
      for (int idx = tid; idx < BM * DC; idx += NT) {
        const int r = idx / DC, c = idx % DC, t = q0 + r, d = c0 + c;
        sQ[c * LDQ + r] = (t < Tq && d < D) ? to_f(qb[(size_t)t * D + d]) : 0.f;
      }
      for (int idx = tid; idx < BN * DC; idx += NT) {
        const int r = idx / DC, c = idx % DC, j = k0 + r, d = c0 + c;
        sK[c * LDK + r] = (j < Tk && d < D) ? to_f(kb[(size_t)j * D + d]) : 0.f;
      }
      if (has_rel) {
        for (int idx = tid; idx < (BM + 1) * DC; idx += NT) {
          const int r = idx / DC, c = idx % DC, t = q0 + r, d = c0 + c;
          sQv[c * LDQV + r] = (t < Tq && d < D) ? to_f(qvb[(size_t)t * D + d]) : 0.f;
        }
        for (int idx = tid; idx < PW * DC; idx += NT) {
          const int w = idx / DC, c = idx % DC, d = c0 + c;
          const int delta = dbase + w;
          const int row = delta >= 0 ? Tk - 1 - delta : -delta - 2;  // -1 at delta == -1
          sP[c * LDP + w] =
              (row >= 0 && row < Tk && d < D) ? to_f(pb[(size_t)row * D + d]) : 0.f;
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
          if (key >= kv_len) s = NEG_INF;
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
            dropout && !keep_elem((uint32_t)bh, t, k0 + tx + 16 * j, tqe, tke, seed, thr);
        sS[(ty + 16 * i) * LDS + tx + 16 * j] = drop ? 0.f : to_f(from_f<T>(pe));
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
      sV[r * DMAX + d] = (j < Tk && d < D) ? to_f(vb[(size_t)j * D + d]) : 0.f;
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

  T* ob = out + (size_t)bh * Tq * D;
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
      if (d < D) ob[(size_t)t * D + d] = from_f<T>(o);
    }
    // a row with no key (kv_len == 0) keeps m = NEG_INF; NEG_INF + log(l)
    // rounds to NEG_INF in fp32, and the backward zeroes such a row
    if (lse && tx == 0)
      lse[(size_t)bh * Tq + t] = l_i[i] > 0.f ? m_i[i] + logf(l) : NEG_INF;
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* qv,
                   const void* p, const uint8_t* mask, const int32_t* kv_lens,
                   void* out, float* lse, int BH, int Tq, int Tk, int D, int mask_div,
                   int p_mod, float scale, int dropout, uint32_t seed, uint32_t thr,
                   float keep_div, int tqe, int tke, cudaStream_t stream) {
  constexpr size_t smem = Smem<DMAX>::kBytes;
  auto kernel = rel_attn_fwd_kernel<T, DMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BM - 1) / BM, BH);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(qv), static_cast<const T*>(p), mask, kv_lens,
      static_cast<T*>(out), lse, Tq, Tk, D, mask_div, p_mod, scale, dropout, seed, thr,
      keep_div, tqe, tke);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. qv/p, mask, kv_lens and lse may be null.
// dropout != 0 applies the keep test u < thr with the TPU kernel's tiles
// tqe x tke; keep_div = 1 - rate.
extern "C" int rel_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                 const void* qv, const void* p, const void* mask,
                                 const void* kv_lens, void* out, void* lse, int BH,
                                 int Tq, int Tk, int D, int mask_div, int p_mod,
                                 float scale, int dropout, uint32_t seed, uint32_t thr,
                                 float keep_div, int tqe, int tke, void* stream) {
  if (D < 1 || D > 128 || BH < 1 || BH > 65535 || mask_div < 1 || p_mod < 1 ||
      tqe < 1 || tke < 1)
    return (int)cudaErrorInvalidValue;
  auto ls = static_cast<float*>(lse);
  auto m = static_cast<const uint8_t*>(mask);
  auto kl = static_cast<const int32_t*>(kv_lens);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = D <= 64 ? launch<float, 64>(q, k, v, qv, p, m, kl, out, ls, BH, Tq, Tk, D, mask_div, p_mod, scale, dropout, seed, thr, keep_div, tqe, tke, s)
                  : launch<float, 128>(q, k, v, qv, p, m, kl, out, ls, BH, Tq, Tk, D, mask_div, p_mod, scale, dropout, seed, thr, keep_div, tqe, tke, s);
  } else if (dtype == 1) {
    err = D <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, qv, p, m, kl, out, ls, BH, Tq, Tk, D, mask_div, p_mod, scale, dropout, seed, thr, keep_div, tqe, tke, s)
                  : launch<__nv_bfloat16, 128>(q, k, v, qv, p, m, kl, out, ls, BH, Tq, Tk, D, mask_div, p_mod, scale, dropout, seed, thr, keep_div, tqe, tke, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
