// LayerNorm over the last dimension, forward and backward, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package's LayerNorm
// (liteasr_tpu/ops/layer_norm.py) is XLA code, a custom VJP whose backward
// is the closed form below. liteasr_tpu_torch/ops/layer_norm.py holds the
// function, its plain PyTorch version (the path CPU tensors take, and the
// kernels' oracle) and the ctypes wrapper. For each row x of D values
// (bf16 or fp32) with the fp32 weight w and bias b:
//
//   mean = sum(x) / D,  var = sum((x - mean)^2) / D     (fp32, two passes)
//   rstd = rsqrt(var + 1e-12),  xhat = (x - mean) rstd
//   y    = xhat w + b, rounded to x's dtype, stored in the compute dtype
//
// and for the cotangent dy (in the compute dtype, rounded to x's dtype):
//
//   g  = dy w
//   dx = rstd (g - mean(g) - xhat mean(g xhat))         (rounded to x's dtype)
//   dw = sum over the rows of dy xhat,  db = sum over the rows of dy  (fp32)
//
// A zero-variance row has rstd = 1e6 and xhat = 0, as in the plain version.
//
// What bounds it: the bytes. The forward reads x and writes y, the
// backward reads x and dy and writes dx, each once in its own dtype: at
// 51,200 rows of 256 bf16 values, 52 MB forward (16 us at 3.35 TB/s) and
// 79 MB backward (23 us). So nothing else reaches device memory: a warp
// takes one row at a time with the row in registers (a lane holds D / 32
// values, in packs of 16 bytes where D and the pointers allow), so both
// passes of the variance read no memory, and the backward recomputes mean
// and rstd from x instead of keeping them. The blocks walk the rows
// grid-stride, as many blocks as the SMs hold at once, each warp loading
// its next row before it reduces the current one. In the backward each
// lane sums dw and db over its rows in registers; a block sums its warps
// in shared memory, in warp order, into one row of partials (a grid x D
// array), and a second kernel sums those rows in a fixed order. No
// atomics: two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 8;       // a block's warps; a warp takes one row at a time
constexpr int MAX_D = 1024;    // 32 values a lane
constexpr float EPS = 1e-12f;  // LN_EPS
constexpr int RED_COLS = 32, RED_ROWS = 32;  // the reduction's block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T's precision
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

// VEC consecutive values of a row, moved in accesses of up to 16 bytes
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC < 16 ? sizeof(T) * VEC : 16) Pack {
  T v[VEC];
};

// A lane's share of a row: pack j holds columns (32 j + lane) VEC + k, k < VEC.
template <typename T, int VEC, int J>
struct Slice {
  Pack<T, VEC> p[J];

  static __device__ __forceinline__ bool live(int j, int lane, int D) {
    return (32 * j + lane) * VEC < D;
  }
  __device__ __forceinline__ void load(const T* row, int lane, int D) {
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (live(j, lane, D))
        p[j] = *reinterpret_cast<const Pack<T, VEC>*>(row + (32 * j + lane) * VEC);
  }
  __device__ __forceinline__ void store(T* row, int lane, int D) const {
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (live(j, lane, D))
        *reinterpret_cast<Pack<T, VEC>*>(row + (32 * j + lane) * VEC) = p[j];
  }
  // the values as fp32, 0 outside the row
  __device__ __forceinline__ void unpack(float (&v)[J][VEC], int lane, int D) const {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[j][k] = live(j, lane, D) ? to_float(p[j].v[k]) : 0.f;
  }
};

// The sum over the warp, the same bits in every lane (each step adds two
// lanes' values, and a + b == b + a).
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int m = 16; m; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// mean and rstd of the warp's row, v 0 outside it.
template <int VEC, int J>
__device__ __forceinline__ void row_stats(const float (&v)[J][VEC], int lane, int D, float& mean,
                                          float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int k = 0; k < VEC; ++k) s += v[j][k];
  mean = warp_sum(s) / (float)D;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (Slice<float, VEC, J>::live(j, lane, D))
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = v[j][k] - mean;
        q = __fmaf_rn(d, d, q);
      }
  rstd = rsqrtf(warp_sum(q) / (float)D + EPS);  // as torch.rsqrt computes it on the card
}

template <typename TX, typename TY, int VEC, int J>
__global__ void __launch_bounds__(WARPS * 32)
    ln_fwd_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, TY* __restrict__ y, int rows, int D) {
  const int lane = threadIdx.x & 31, stride = gridDim.x * WARPS;
  int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  float wv[J][VEC], bv[J][VEC];
  {
    Slice<float, VEC, J> s;
    s.load(w, lane, D);
    s.unpack(wv, lane, D);
    s.load(b, lane, D);
    s.unpack(bv, lane, D);
  }
  Slice<TX, VEC, J> cur, next;
  if (r < rows) cur.load(x + (size_t)r * D, lane, D);
  for (; r < rows; r += stride) {
    if (r + stride < rows) next.load(x + (size_t)(r + stride) * D, lane, D);
    float v[J][VEC], mean, rstd;
    cur.unpack(v, lane, D);
    row_stats(v, lane, D, mean, rstd);
    Slice<TY, VEC, J> out;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        // the plain version's order: ((x - mean) rstd) w + b, each op rounded
        const float t = __fmul_rn(__fmul_rn(__fsub_rn(v[j][k], mean), rstd), wv[j][k]);
        out.p[j].v[k] = from_float<TY>(round_to<TX>(__fadd_rn(t, bv[j][k])));
      }
    out.store(y + (size_t)r * D, lane, D);
    cur = next;
  }
}

// dx, and the block's partial sums of dw and db: part (2, gridDim.x, D)
// fp32, dw's rows then db's. WARPS x D floats of shared memory.
template <typename TX, typename TY, int VEC, int J>
__global__ void __launch_bounds__(WARPS * 32)
    ln_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                  const TY* __restrict__ dy, TX* __restrict__ dx, float* __restrict__ part,
                  int rows, int D) {
  extern __shared__ float red[];  // [WARPS][D]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, stride = gridDim.x * WARPS;
  int r = blockIdx.x * WARPS + warp;
  float wv[J][VEC], dw[J][VEC], db[J][VEC];
  {
    Slice<float, VEC, J> s;
    s.load(w, lane, D);
    s.unpack(wv, lane, D);
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int k = 0; k < VEC; ++k) dw[j][k] = db[j][k] = 0.f;
  Slice<TX, VEC, J> xc, xn;
  Slice<TY, VEC, J> gc, gn;
  if (r < rows) {
    xc.load(x + (size_t)r * D, lane, D);
    gc.load(dy + (size_t)r * D, lane, D);
  }
  for (; r < rows; r += stride) {
    if (r + stride < rows) {
      xn.load(x + (size_t)(r + stride) * D, lane, D);
      gn.load(dy + (size_t)(r + stride) * D, lane, D);
    }
    float v[J][VEC], g[J][VEC], mean, rstd;
    xc.unpack(v, lane, D);
    gc.unpack(g, lane, D);
    row_stats(v, lane, D, mean, rstd);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        // v becomes xhat, g becomes dy w; both stay 0 outside the row
        const float xhat = __fmul_rn(__fsub_rn(v[j][k], mean), rstd);
        const float d = round_to<TX>(g[j][k]);
        if (Slice<float, VEC, J>::live(j, lane, D)) {
          v[j][k] = xhat;
          dw[j][k] = __fmaf_rn(d, xhat, dw[j][k]);
          db[j][k] += d;
        }
        g[j][k] = d * wv[j][k];
        s1 += g[j][k];
        s2 = __fmaf_rn(g[j][k], v[j][k], s2);
      }
    const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
    Slice<TX, VEC, J> out;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        out.p[j].v[k] = from_float<TX>(rstd * (g[j][k] - m1 - v[j][k] * m2));
    out.store(dx + (size_t)r * D, lane, D);
    xc = xn;
    gc = gn;
  }
  // the block's partials: each warp's lanes, then the warps summed in order
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (Slice<float, VEC, J>::live(j, lane, D))
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          red[warp * D + (32 * j + lane) * VEC + k] = which ? db[j][k] : dw[j][k];
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float s = 0.f;
      for (int i = 0; i < WARPS; ++i) s += red[i * D + c];
      part[((size_t)which * gridDim.x + blockIdx.x) * D + c] = s;
    }
    __syncthreads();
  }
}

// dw and db from the partials (2, grid, D): a block sums RED_COLS columns,
// its RED_ROWS thread rows each every RED_ROWS-th partial row in order,
// then the thread rows in order.
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                     float* __restrict__ db, int grid, int D) {
  __shared__ float s[RED_ROWS][RED_COLS + 1];
  const int c = blockIdx.x * RED_COLS + threadIdx.x, which = blockIdx.y;
  const float* p = part + (size_t)which * grid * D;
  float acc = 0.f;
  if (c < D)
#pragma unroll 4
    for (int i = threadIdx.y; i < grid; i += RED_ROWS) acc += p[(size_t)i * D + c];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < D) {
    float t = 0.f;
    for (int i = 0; i < RED_ROWS; ++i) t += s[i][threadIdx.x];
    (which ? db : dw)[c] = t;
  }
}

template <typename TX_, typename TY_, int VEC_, int J_>
struct Cfg {
  using TX = TX_;
  using TY = TY_;
  static constexpr int VEC = VEC_, J = J_;
};

// f(Cfg) for a row of D values: packs of 16 bytes of x where vec (D a
// multiple of them, the pointers 16-byte aligned), else single values;
// J the fewest packs a lane that cover D, of those compiled.
template <typename TX, typename TY, typename F>
int with_width(int D, int vec, F&& f) {
  if (vec) {
    constexpr int V = 16 / sizeof(TX);
    const int j = (D + 32 * V - 1) / (32 * V);
    if (j <= 1) return f(Cfg<TX, TY, V, 1>{});
    if (j <= 2) return f(Cfg<TX, TY, V, 2>{});
    if (j <= 3) return f(Cfg<TX, TY, V, 3>{});
    if constexpr (V == 8) {
      return f(Cfg<TX, TY, V, 4>{});  // bf16: 4 packs hold MAX_D
    } else {
      if (j <= 4) return f(Cfg<TX, TY, V, 4>{});
      return f(Cfg<TX, TY, V, 8>{});
    }
  }
  const int j = (D + 31) / 32;
  if (j <= 2) return f(Cfg<TX, TY, 1, 2>{});
  if (j <= 8) return f(Cfg<TX, TY, 1, 8>{});
  return f(Cfg<TX, TY, 1, 32>{});
}

template <typename F>
int with_types(int x_bf16, int y_bf16, int D, int vec, F&& f) {
  if (x_bf16)
    return y_bf16 ? with_width<bf16, bf16>(D, vec, f) : with_width<bf16, float>(D, vec, f);
  return y_bf16 ? with_width<float, bf16>(D, vec, f) : with_width<float, float>(D, vec, f);
}

// The blocks of `kernel` (WARPS warps, smem bytes of shared memory each)
// that the current device's SMs hold at once.
template <typename K>
int resident_blocks(K kernel, size_t smem) {
  int dev = 0, sms = 1, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32, smem);
  return sms * (per_sm > 0 ? per_sm : 1);
}

size_t bwd_smem(int D) { return (size_t)WARPS * D * sizeof(float); }

}  // namespace

// x (rows, D) contiguous, bf16 if x_bf16 else fp32; w and b (D,) fp32; y
// (rows, D) contiguous, bf16 if y_bf16 else fp32. vec: D a multiple of 16
// bytes of x and every pointer 16-byte aligned. 1 <= D <= 1024.
extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b, void* y, int rows,
                              int D, int x_bf16, int y_bf16, int vec, void* stream) {
  if (rows < 1 || D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  return with_types(x_bf16, y_bf16, D, vec, [&](auto cfg) {
    using C = decltype(cfg);
    auto kernel = ln_fwd_kernel<typename C::TX, typename C::TY, C::VEC, C::J>;
    static const int cap = resident_blocks(kernel, 0);
    const int want = (rows + WARPS - 1) / WARPS, grid = want < cap ? want : cap;
    kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const typename C::TX*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<typename C::TY*>(y), rows, D);
    return (int)cudaGetLastError();
  });
}

// The most blocks layer_norm_bwd may take for this D and these dtypes:
// what the SMs hold at once. Negative on a bad argument.
extern "C" int layer_norm_bwd_blocks(int D, int x_bf16, int y_bf16, int vec) {
  if (D < 1 || D > MAX_D) return -(int)cudaErrorInvalidValue;
  return with_types(x_bf16, y_bf16, D, vec, [&](auto cfg) {
    using C = decltype(cfg);
    return resident_blocks(ln_bwd_kernel<typename C::TX, typename C::TY, C::VEC, C::J>,
                           bwd_smem(D));
  });
}

// As layer_norm_fwd for x, w and the cotangent dy (y's dtype); dx (rows,
// D) in x's dtype; part (2, blocks, D) fp32 scratch; blocks at most
// layer_norm_bwd_blocks'. Then layer_norm_bwd_reduce on part.
extern "C" int layer_norm_bwd(const void* x, const void* w, const void* dy, void* dx, void* part,
                              int rows, int D, int x_bf16, int y_bf16, int vec, int blocks,
                              void* stream) {
  if (rows < 1 || D < 1 || D > MAX_D || blocks < 1) return (int)cudaErrorInvalidValue;
  return with_types(x_bf16, y_bf16, D, vec, [&](auto cfg) {
    using C = decltype(cfg);
    ln_bwd_kernel<typename C::TX, typename C::TY, C::VEC, C::J>
        <<<blocks, WARPS * 32, bwd_smem(D), static_cast<cudaStream_t>(stream)>>>(
            static_cast<const typename C::TX*>(x), static_cast<const float*>(w),
            static_cast<const typename C::TY*>(dy), static_cast<typename C::TX*>(dx),
            static_cast<float*>(part), rows, D);
    return (int)cudaGetLastError();
  });
}

// dw and db (D,) fp32 from layer_norm_bwd's part (2, blocks, D).
extern "C" int layer_norm_bwd_reduce(const void* part, void* dw, void* db, int blocks, int D,
                                     void* stream) {
  if (blocks < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((D + RED_COLS - 1) / RED_COLS, 2), block(RED_COLS, RED_ROWS);
  ln_bwd_reduce_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), static_cast<float*>(db), blocks,
      D);
  return (int)cudaGetLastError();
}
