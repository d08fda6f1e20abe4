// Building blocks shared by the tensor-core bodies of the rel-pos attention
// kernels (csrc/rel_attention_fwd.cu, csrc/rel_attention_bwd.cu), sm_90a.
//
// Tiles of bf16 live in shared memory in the "core-matrix" layout: a tile of
// R rows (R a multiple of 8) and NCH chunks of 8 columns stores the 8 x 8
// block (row group G, chunk C) as 128 contiguous bytes at
// ((G * NCH + C) * 8) * 16, row r % 8 of the block at 16 (r % 8). So the
// 16-byte piece number i of the tile is row (i / 8 / NCH) * 8 + i % 8,
// chunk (i / 8) % NCH: consecutive threads of a loader fill consecutive
// 16 bytes (no bank conflict), and each 8 x 8 matrix that ldmatrix reads is
// one 128-byte line (no bank conflict either). It is also the layout that
// wgmma's shared-memory descriptors take without swizzle.
//
// Products are wgmma (a warpgroup's 64-row tile) where they fill 64 rows;
// the backward's one-row crossover product is mma.sync.m16n8k16 on one
// warp's 16 rows (bf16 in, fp32 accumulate both). A warp owns the same 16
// rows and accumulator layout in both. Fragment layouts (g = lane/4, q =
// lane%4): A (16 x 16) a0 = (g, 2q..2q+1), a1 = (g+8, 2q..), a2 = (g,
// 2q+8..), a3 = (g+8, 2q+8..); B (16 x 8) b0 = (k 2q..2q+1, n g), b1 = (k
// 2q+8.., n g); C (16 x 8) c0,c1 = (g, 2q..2q+1), c2,c3 = (g+8, 2q..).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

// _dropout_keep (liteasr_tpu/ops/flash_attention.py:149-174) for global
// query t and key j: a murmur3 finalizer over the in-tile row/column and the
// (bh, q-tile, k-tile, seed) tile id of the TPU kernel's tqe x tke tiles,
// uint32 with wraparound. The finalizer's input is a sum of a term of the
// query and a term of the key (the ring of uint32), so the tensor-core
// bodies compute each term once per row or column: keep_mix(keep_row(bh, t)
// + keep_col(j)) == keep_elem(bh, t, j).
__device__ __forceinline__ uint32_t keep_row(uint32_t bh, int t, int tqe, uint32_t seed) {
  const uint32_t qi = (uint32_t)t / (uint32_t)tqe, row = (uint32_t)t % (uint32_t)tqe;
  return row * 0x9E3779B1u + ((bh * 65537u + qi) * 8191u * 131071u + seed) * 0xC2B2AE3Du;
}
__device__ __forceinline__ uint32_t keep_col(int j, int tke) {
  const uint32_t kj = (uint32_t)j / (uint32_t)tke, col = (uint32_t)j % (uint32_t)tke;
  return col * 0x85EBCA77u + kj * (131071u * 0xC2B2AE3Du);
}
__device__ __forceinline__ bool keep_mix(uint32_t u, uint32_t thr) {
  u ^= u >> 16;
  u *= 0x7FEB352Du;
  u ^= u >> 15;
  u *= 0x846CA68Bu;
  u ^= u >> 16;
  return u < thr;
}
__device__ __forceinline__ bool keep_elem(uint32_t bh, int t, int j, int tqe, int tke,
                                          uint32_t seed, uint32_t thr) {
  return keep_mix(keep_row(bh, t, tqe, seed) + keep_col(j, tke), thr);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of (row, chunk) in a core-matrix tile of NCH chunks
template <int NCH>
__device__ __forceinline__ uint32_t cm_off(int row, int chunk) {
  return (uint32_t)((((row >> 3) * NCH + chunk) << 7) + ((row & 7) << 4));
}

// byte offset of element (row, col) in a core-matrix tile of NCH chunks
template <int NCH>
__device__ __forceinline__ uint32_t cm_elem(int row, int col) {
  return cm_off<NCH>(row, col >> 3) + ((col & 7) << 1);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Loads `rows` (a multiple of 8) rows of a (., D) bf16 matrix into the
// core-matrix tile at `tile`: tile row r holds global row row_of(r), or zeros
// where row_of gives -1; columns D .. 8 NCH are zeros. With `vec` (D % 8 == 0
// and 16-byte aligned rows) every 16 bytes is one cp.async (zero-filled when
// out of range) that the caller commits and waits for; otherwise (a row of
// D = 100 is 200 bytes) the elements are loaded one by one and stored.
template <int NCH, typename RowOf>
__device__ __forceinline__ void load_tile(char* tile, const bf16* __restrict__ g, int rows,
                                          int D, bool vec, RowOf row_of) {
  const uint32_t base = smem_u32(tile);
  for (int i = threadIdx.x; i < rows * NCH; i += blockDim.x) {
    const int row = (i / (8 * NCH)) * 8 + (i & 7), d0 = ((i >> 3) % NCH) * 8;
    const int gr = row_of(row);
    if (vec) {
      const bool ok = gr >= 0 && d0 < D;
      cp_async16(base + i * 16, ok ? g + (size_t)gr * D + d0 : g, ok);
    } else {
      const unsigned short* src = reinterpret_cast<const unsigned short*>(g) + (size_t)gr * D;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + 2 * e;
        const uint32_t lo = (gr >= 0 && d < D) ? src[d] : 0u;
        const uint32_t hi = (gr >= 0 && d + 1 < D) ? src[d + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(tile + i * 16) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A fragment (16 x 16 at rows m0, k-step kk) of a tile stored [m][k]
template <int NCH>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], uint32_t tile, int m0, int kk, int lane) {
  ldsm_x4(a, tile + cm_off<NCH>(m0 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * kk + (lane >> 4)));
}
// B fragments of n-tiles n0 and n0 + 8 at k-step kk, of a tile stored [k][n]
// (b[0], b[1] for n0; b[2], b[3] for n0 + 8)
template <int NCH>
__device__ __forceinline__ void ld_b_t(uint32_t (&b)[4], uint32_t tile, int n0, int kk, int lane) {
  ldsm_x4_t(b, tile + cm_off<NCH>(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  (n0 >> 3) + (lane >> 4)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- wgmma: a warpgroup's (128 threads) 64 x N x 16 product, bf16 in,
// fp32 accumulate, asynchronous. TA / TB = 1 read A / B M- or N-major
// (wg_desc_n) instead of K-major (wg_desc_k). The accumulator d[n][0..3]
// of thread (warp w, lane) holds rows 16 w + g (0, 1) and 16 w + g + 8 (2,
// 3), columns 8 n + 2 q (0, 2) and 8 n + 2 q + 1 (1, 3): the layout of mma()
// above, and an A operand in registers is mma()'s A fragment of the warp's
// 16 rows.

// shared-memory descriptor of a core-matrix tile without swizzle: `lbo` is
// the byte stride between core matrices along K, `sbo` along M (or N)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
// a K-major operand ([m][k] or [n][k]) of NCH chunks at k-step kk
template <int NCH>
__device__ __forceinline__ uint64_t wg_desc_k(uint32_t tile, int kk) {
  return wg_desc(tile + 256 * kk, 128, NCH * 128);
}
// an M- or N-major operand ([k][m] or [k][n]) of NCH chunks at k-step kk
template <int NCH>
__device__ __forceinline__ uint64_t wg_desc_n(uint32_t tile, int kk) {
  return wg_desc(tile + 2 * kk * NCH * 128, NCH * 128, 128);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of an accumulator across the
// asynchronous product
template <int NT>
__device__ __forceinline__ void wg_hold(float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
// makes this thread's shared-memory writes (stores, cp.async) visible to
// wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wg_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wg_ss_n128(float (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wg_rs_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wg_rs_n128(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// the table row of window slot w for a (query tile, key tile) pair whose
// slot 0 is diagonal delta = dbase: score (t, j), delta = t - j, reads table
// row Tk-1-delta for delta >= 0 and row -delta-2 (with q_v row t + 1) for
// delta <= -2; delta == -1 and slot 127 read nothing (-1)
__device__ __forceinline__ int window_row(int dbase, int w, int Tk) {
  const int delta = dbase + w;
  const int row = delta >= 0 ? Tk - 1 - delta : -delta - 2;
  return (w < 127 && delta != -1 && row >= 0 && row < Tk) ? row : -1;
}

// A call on one shard of the full attention, as tensor and sequence
// parallelism split it: the local rows answer for rows of the full call.
//   tqv:  q_v rows per bh, Tq, or Tq + 1 when the next shard's first q_v
//         row (the crossover of the local last row) follows them;
//   qoff: the full call's index of local query 0 (the keys and the table
//         are whole): the rel-pos diagonals, the chunk mask and the dropout
//         hash read qoff + t;
//   hl, ht, h0: the local bh holds head h0 + bh % hl of ht, of batch row
//         bh / hl: the hash's folded row is (bh / hl) ht + h0 + bh % hl.
// {Tq, 0, 1, 1, 0} is the whole call.
struct Shard {
  int tqv, qoff, hl, ht, h0;
  __device__ __forceinline__ uint32_t hash_row(int bh) const {
    return (uint32_t)((bh / hl) * ht + h0 + bh % hl);
  }
};

}  // namespace tc
