// The RNN-T loss's lattice DP, forward and backward, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package runs this DP as a lax.scan
// over T' (liteasr_tpu/ops/rnnt.py:77-83) and takes its gradient by
// autodiff through the scan. liteasr_tpu_torch/ops/rnnt.py holds the
// function it computes, its plain PyTorch version (a Python loop over T')
// and the ctypes wrapper. Both kernels read the two fp32 planes of the
// lattice's log-softmax, lp_blank (B, T, U+1) and lp_emit (B, T, U):
//
//   alpha[0, 0] = 0
//   alpha[t, u] = logadd(alpha[t-1, u] + blank[t-1, u],
//                        alpha[t,   u-1] + emit[t,   u-1])
//   loss[b]     = -(alpha[Tb-1, Ub] + blank[Tb-1, Ub])
//
// with Tb = clamp(input_lengths[b], 1, T) (the plain loop always computes
// row 0) and Ub = clamp(label_lengths[b], 0, U), read on the device. The
// backward runs the reverse variable
//
//   beta[Tb-1, Ub] = blank[Tb-1, Ub]
//   beta[t, u]     = logadd(beta[t+1, u] + blank[t, u], beta[t, u+1] + emit[t, u])
//
// and in the same pass writes, with g = grad[b] and logZ = -loss[b],
//
//   d blank[t, u] = -g exp(alpha[t, u] + blank[t, u] + beta[t+1, u] - logZ)
//   d emit[t, u]  = -g exp(alpha[t, u] + emit[t, u]  + beta[t, u+1] - logZ)
//
// d blank[Tb-1, Ub] = -g, and exactly 0 outside the row's lattice (t >= Tb,
// u > Ub, and emit cells with u >= Ub) or on a row with g == 0.
//
// What bounds it: the work is tiny (2 B T (U+1) fp32 planes read, about
// 13 MB at the transducer cell's largest batch, 4 us at 3.35 TB/s), but
// each row is a chain of Tb + Ub dependent steps. So one block walks one
// utterance, as a wavefront over the anti-diagonals d = t + u: every cell
// of a diagonal depends only on the diagonal before, so a step is one
// barrier, one shared-memory read of the neighbour and one logadd. Thread
// i owns column u0 + i (u1 - i in the backward): it keeps its own previous
// value in a register and reads its neighbour's from a double-buffered
// diagonal in shared memory. The planes' next cells are loaded a step
// ahead, so their latency hides behind the barrier. Columns past the
// block's width (1024) are walked in strips of blockDim columns, one after
// another; a strip's first column reads its neighbour, the last column of
// the strip before, from device memory: alpha in the forward, a carried
// (B, T) column in the backward. No atomics: the result is the same from
// run to run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float logadd(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// The row's live lattice: Tb frames (at least 1), Ub labels (0..U).
__device__ __forceinline__ void row_lengths(const int64_t* in_lens, const int64_t* lab_lens,
                                            int b, int T, int U, int& Tb, int& Ub) {
  const int64_t t = in_lens[b], u = lab_lens[b];
  Tb = (int)(t < 1 ? 1 : (t > T ? T : t));
  Ub = (int)(u < 0 ? 0 : (u > U ? U : u));
}

// One block an utterance; blockDim.x threads, 2 blockDim.x floats of
// shared memory. alpha (B, T, U+1) is written on the row's lattice only.
__global__ void rnnt_dp_fwd_kernel(const float* __restrict__ lp_blank,
                                   const float* __restrict__ lp_emit,
                                   const int64_t* __restrict__ in_lens,
                                   const int64_t* __restrict__ lab_lens, float* alpha,
                                   float* __restrict__ loss, int T, int U) {
  extern __shared__ float diag[];  // [2][blockDim.x]: the last two diagonals
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, U1 = U + 1;
  int Tb, Ub;
  row_lengths(in_lens, lab_lens, b, T, U, Tb, Ub);
  const float* blank = lp_blank + (size_t)b * T * U1;
  const float* emit = lp_emit + (size_t)b * T * U;
  float* al = alpha + (size_t)b * T * U1;

  for (int u0 = 0; u0 <= Ub; u0 += nt) {
    const int width = min(nt, Ub + 1 - u0), u = u0 + tid;
    const bool col = tid < width;
    // blank[t-1, u] and emit[t, u-1] of the cell this thread takes at a step
    auto up_in = [&](int t) {
      return col && t > 0 && t < Tb ? blank[(size_t)(t - 1) * U1 + u] : 0.f;
    };
    auto left_in = [&](int t) {
      return col && u > 0 && t >= 0 && t < Tb ? emit[(size_t)t * U + u - 1] : 0.f;
    };
    float own = 0.f;  // alpha[t-1, u]: this thread's value of the step before
    float nb = up_in(-tid), ne = left_in(-tid);
    for (int s = 0; s < Tb + width - 1; ++s) {
      const int t = s - tid;
      const float cb = nb, ce = ne;
      nb = up_in(t + 1);
      ne = left_in(t + 1);
      if (col && t >= 0 && t < Tb) {
        float a = 0.f;  // alpha[0, 0]
        if (u > 0) {
          const float left =
              tid > 0 ? diag[((s - 1) & 1) * nt + tid - 1] : al[(size_t)t * U1 + u - 1];
          a = left + ce;
          if (t > 0) a = logadd(own + cb, a);
        } else if (t > 0) {
          a = own + cb;
        }
        own = a;
        diag[(s & 1) * nt + tid] = a;
        al[(size_t)t * U1 + u] = a;
      }
      __syncthreads();
    }
  }
  if (tid == 0) {
    const size_t last = (size_t)(Tb - 1) * U1 + Ub;
    loss[b] = -(al[last] + blank[last]);
  }
}

// One block an utterance, as the forward. carry (B, T): the last column
// of the strip before (the backward walks its strips from the right).
__global__ void rnnt_dp_bwd_kernel(const float* __restrict__ lp_blank,
                                   const float* __restrict__ lp_emit,
                                   const int64_t* __restrict__ in_lens,
                                   const int64_t* __restrict__ lab_lens,
                                   const float* __restrict__ alpha, const float* __restrict__ loss,
                                   const float* __restrict__ grad, float* carry,
                                   float* __restrict__ d_blank, float* __restrict__ d_emit, int T,
                                   int U) {
  extern __shared__ float diag[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, U1 = U + 1;
  int Tb, Ub;
  row_lengths(in_lens, lab_lens, b, T, U, Tb, Ub);
  const float g = grad[b];
  const bool off = g == 0.f;  // a weight-0 row: no gradient, whatever its lattice holds
  const float* blank = lp_blank + (size_t)b * T * U1;
  const float* emit = lp_emit + (size_t)b * T * U;
  const float* al = alpha + (size_t)b * T * U1;
  float* db = d_blank + (size_t)b * T * U1;
  float* de = d_emit + (size_t)b * T * U;
  float* cr = carry + (size_t)b * T;

  // the cells the walk below does not write
  for (int t = 0; t < T; ++t) {
    for (int u = tid; u < U1; u += nt) {
      if (off || t >= Tb || u > Ub) db[(size_t)t * U1 + u] = 0.f;
      if (u < U && (off || t >= Tb || u >= Ub)) de[(size_t)t * U + u] = 0.f;
    }
  }
  if (off) return;
  const float log_z = -loss[b];

  for (int u1 = Ub; u1 >= 0; u1 -= nt) {
    const int width = min(nt, u1 + 1), u = u1 - tid;
    const bool col = tid < width;
    // alpha[t, u], blank[t, u], emit[t, u] of the cell this thread takes at a step
    auto at = [&](int s) { return Tb - 1 - (s - tid); };
    auto live = [&](int t) { return col && t >= 0 && t < Tb; };
    auto fetch = [&](int t, float& a, float& bl, float& em) {
      const bool on = live(t);
      a = on ? al[(size_t)t * U1 + u] : 0.f;
      bl = on ? blank[(size_t)t * U1 + u] : 0.f;
      em = on && u < Ub ? emit[(size_t)t * U + u] : 0.f;
    };
    float own = 0.f;  // beta[t+1, u]: this thread's value of the step before
    float na, nb, ne;
    fetch(at(0), na, nb, ne);
    for (int s = 0; s < Tb + width - 1; ++s) {
      const int t = at(s);
      const float ca = na, cb = nb, ce = ne;
      fetch(t - 1, na, nb, ne);
      if (live(t)) {
        const size_t cell = (size_t)t * U1 + u;
        float beta = cb;  // beta[Tb-1, Ub]
        float gb = u == Ub ? -g : 0.f;
        if (t + 1 < Tb) {
          beta = own + cb;
          gb = -g * expf(ca + cb + own - log_z);
        }
        if (u < Ub) {
          const float right = tid > 0 ? diag[((s - 1) & 1) * nt + tid - 1] : cr[t];
          de[(size_t)t * U + u] = -g * expf(ca + ce + right - log_z);
          beta = t + 1 < Tb ? logadd(beta, right + ce) : right + ce;
        }
        db[cell] = gb;
        own = beta;
        diag[(s & 1) * nt + tid] = beta;
        if (tid == width - 1) cr[t] = beta;  // after this thread's own read of cr[t]
      }
      __syncthreads();
    }
  }
}

int block_threads(int U) {
  const int cols = U + 1;
  return cols >= MAX_THREADS ? MAX_THREADS : (cols + 31) / 32 * 32;
}

}  // namespace

// lp_blank (B, T, U+1), lp_emit (B, T, U), fp32, contiguous; in_lens and
// lab_lens (B,) int64; alpha (B, T, U+1) and loss (B,) fp32 outputs.
// Returns a cudaError_t.
extern "C" int rnnt_dp_fwd(const void* lp_blank, const void* lp_emit, const void* in_lens,
                           const void* lab_lens, void* alpha, void* loss, int B, int T, int U,
                           void* stream) {
  if (B < 1 || T < 1 || U < 0) return (int)cudaErrorInvalidValue;
  const int nt = block_threads(U);
  rnnt_dp_fwd_kernel<<<B, nt, 2 * nt * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp_blank), static_cast<const float*>(lp_emit),
      static_cast<const int64_t*>(in_lens), static_cast<const int64_t*>(lab_lens),
      static_cast<float*>(alpha), static_cast<float*>(loss), T, U);
  return (int)cudaGetLastError();
}

// As rnnt_dp_fwd, plus the forward's alpha and loss, grad (B,) fp32 (the
// loss's cotangent), carry (B, T) fp32 scratch, and the outputs d_blank
// (B, T, U+1) and d_emit (B, T, U), fp32.
extern "C" int rnnt_dp_bwd(const void* lp_blank, const void* lp_emit, const void* in_lens,
                           const void* lab_lens, const void* alpha, const void* loss,
                           const void* grad, void* carry, void* d_blank, void* d_emit, int B,
                           int T, int U, void* stream) {
  if (B < 1 || T < 1 || U < 0) return (int)cudaErrorInvalidValue;
  const int nt = block_threads(U);
  rnnt_dp_bwd_kernel<<<B, nt, 2 * nt * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp_blank), static_cast<const float*>(lp_emit),
      static_cast<const int64_t*>(in_lens), static_cast<const int64_t*>(lab_lens),
      static_cast<const float*>(alpha), static_cast<const float*>(loss),
      static_cast<const float*>(grad), static_cast<float*>(carry), static_cast<float*>(d_blank),
      static_cast<float*>(d_emit), T, U);
  return (int)cudaGetLastError();
}
