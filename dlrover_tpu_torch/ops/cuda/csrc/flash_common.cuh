// Shared building blocks of the three flash-attention kernels (sm_90a).
//
// Layouts, as the Python wrapper hands them over (all contiguous):
//   q, o, dO, dq : [B, S, H,   D] bf16
//   k, v, dk, dv : [B, S, KVH, D] bf16   (query head h reads kv head h / G)
//   lse, delta   : [B, H, S]      fp32
//
// Every kernel runs 4 warps (128 threads) on 64-row tiles: each warp owns
// 16 rows of the tile's M dimension. Tiles are staged in shared memory
// with a padded row stride of D + 8 bf16 (D*2 + 16 bytes), which makes
// the 8 row addresses of every ldmatrix phase fall on distinct banks.
// Products are mma.sync m16n8k16 bf16 -> fp32; the operands come from
// shared memory through ldmatrix, or straight from the fp32 registers of
// an earlier product (P and dS), rounded to bf16 where the TPU kernels
// cast them (`.astype(v.dtype)` etc.).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;       // rows of a q tile and of a k/v tile
constexpr int kThreads = 128;   // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF

typedef __nv_bfloat16 bf16;

template <int D>
struct Smem {
  static constexpr int ld = D + 8;                 // padded row stride
  static constexpr int tile_elems = kTile * ld;    // one 64 x D tile
  static constexpr int tile_bytes = tile_elems * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy a 64 x D tile whose rows are `row_stride` elements apart in global
// memory into shared memory (stride D + 8), 16 bytes per cp.async.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long row_stride) {
  constexpr int chunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTile * chunks; c += kThreads) {
    const int r = c / chunks;
    const int col = (c % chunks) * 8;
    cp_async16(dst + r * Smem<D>::ld + col, src + r * row_stride + col);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] * b[16x8]; bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two fp32 values -> one register of two bf16 (round to nearest even),
// the lower column in the low half as mma fragments expect.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[8][4] = A * Bt^T for this warp's 16 rows: A is rows
// [a_row0, a_row0 + 16) of a 64 x D tile in shared memory, Bt a 64 x D
// tile whose 64 rows are the N dimension. acc[n][e] holds the element
// (row a_row0 + g + 8 * (e >= 2), col 8n + 2t + (e & 1)), with
// g = lane / 4 and t = lane % 4 (the mma accumulator layout).
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* sa,
                                        int a_row0, const bf16* sb) {
  constexpr int ld = Smem<D>::ld;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    // matrices: (rows 0-7, k 0-7), (rows 8-15, k 0-7), (0-7, 8-15), (8-15, 8-15)
    ldmatrix_x4(a, sa + (a_row0 + (lane & 15)) * ld + kk * 16 +
                       (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      // Bt rows are N, columns K: matrices (n 0-7, k 0-7), (n 0-7, k 8-15),
      // (n 8-15, k 0-7), (n 8-15, k 8-15) -> b0,b1 of two n-tiles
      ldmatrix_x4(b, sb + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * ld +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * np], a, b);
      mma16816(acc[2 * np + 1], a, b + 2);
    }
  }
}

// acc[D/8][4] += P * B for this warp's 16 rows: P is a 16 x 64 fp32 block
// in the accumulator layout of mma_abt (rounded to bf16 here), B a 64 x D
// tile in shared memory whose rows are the K dimension.
template <int D>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4],
                                       const float (&p)[8][4],
                                       const bf16* sb) {
  constexpr int ld = Smem<D>::ld;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      // B rows are K, columns N; transposed loads of (k 0-7, n 0-7),
      // (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
      ldmatrix_x4_trans(b, sb + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                 (lane & 7)) * ld +
                               np * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * np], a, b);
      mma16816(acc[2 * np + 1], a, b + 2);
    }
  }
}

// Sum over the 4 threads of a quad (the threads that share an mma row).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

// Store this warp's 16 x D fp32 block (accumulator layout, times `mul`)
// as bf16 into rows [row0, row0 + 16) of a global matrix with
// `row_stride` elements between rows.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long row_stride,
                                           int row0,
                                           const float (&acc)[D / 8][4],
                                           float mul0, float mul1) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dst + (row0 + g) * row_stride + col) =
        pack_bf16(acc[n][0] * mul0, acc[n][1] * mul0);
    *reinterpret_cast<uint32_t*>(dst + (row0 + g + 8) * row_stride + col) =
        pack_bf16(acc[n][2] * mul1, acc[n][3] * mul1);
  }
}

// Raise the dynamic shared memory limit of `kernel` when it needs more
// than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace flash
