// Flash-attention backward, dK and dV, GQA, causal or full, for Hopper
// (sm_90a).
//
// Replaces: dlrover_tpu/ops/pallas/flash_attention.py, `_dkv_kernel`
// (launched in `_bwd` through pl.pallas_call).
//
// Bound on an H100 SXM at the Llama-1.1B train step's shape (B=3, H=32,
// KVH=4, S=2048, D=64, causal): four products of 1.03e11 FLOP in all,
// 104 us at the 989 TFLOP/s bf16 dense peak; its bytes (about 44 MB)
// take about 13 us at 3.35 TB/s, so the tensor cores bound it.
//
// Design: one CTA of 4 warps per (batch, kv head, 64-row k/v tile), the
// FlashAttention-2 dK/dV pass. The TPU kernel folded the G query heads of
// a kv head into its matmul rows so the contraction summed the GQA group;
// here the CTA that owns a k/v tile loops over the G query heads and, for
// each, over the q tiles (from the diagonal on under causal masking), so
// the group sum happens in the CTA's fp32 registers with no atomics and no
// second pass. Each warp owns 16 keys and computes the transposed products
// directly -- S^T = K Q^T and dP^T = V dO^T -- so P^T and dS^T come out in
// the accumulator layout that dV += P^T dO and dK += dS^T Q take as their
// A operand, rounded to bf16 where the TPU kernel casts them, without a
// trip through shared memory. lse and delta of the q tile sit in shared
// memory because they index the columns. dK is scaled once at the end.
#include "flash_common.cuh"

namespace flash {

template <int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int S, int H, int KVH, float scale,
               int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + Smem<D>::tile_elems;
  bf16* sq = sv + Smem<D>::tile_elems;
  bf16* sdo = sq + Smem<D>::tile_elems;
  float* slse = reinterpret_cast<float*>(sdo + Smem<D>::tile_elems);
  float* sdelta = slse + kTile;

  const int nq = S / kTile;
  const int kt = blockIdx.x;  // k tile 0 has the most causal work: first
  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y % KVH;
  const int G = H / KVH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;

  const long q_stride = (long)H * D;
  const long kv_stride = (long)KVH * D;
  const long kv_off = ((long)b * S + (long)kt * kTile) * kv_stride + kvh * D;

  load_tile<D>(sk, k + kv_off, kv_stride);
  load_tile<D>(sv, v + kv_off, kv_stride);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[n][e] = 0.f;
      dv_acc[n][e] = 0.f;
    }

  for (int hg = 0; hg < G; ++hg) {
    const int h = kvh * G + hg;
    for (int qt = causal ? kt : 0; qt < nq; ++qt) {
      __syncthreads();  // every warp is done with the previous q tile
      const long q_off = ((long)b * S + (long)qt * kTile) * q_stride + h * D;
      load_tile<D>(sq, q + q_off, q_stride);
      load_tile<D>(sdo, dout + q_off, q_stride);
      const long r_off = ((long)b * H + h) * S + (long)qt * kTile;
      if (threadIdx.x < kTile)
        slse[threadIdx.x] = lse[r_off + threadIdx.x];
      else
        sdelta[threadIdx.x - kTile] = delta[r_off + threadIdx.x - kTile];
      cp_async_wait_all();
      __syncthreads();

      float p[8][4], dp[8][4];
      mma_abt<D>(p, sk, row0, sq);   // S^T: rows keys, cols queries
      mma_abt<D>(dp, sv, row0, sdo); // dP^T
      const bool diag = causal && qt == kt;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          float s = p[n][e] * scale;
          if (diag && row0 + g + 8 * (e >> 1) > col) s = kNegInf;
          p[n][e] = __expf(s - slse[col]);
        }
      mma_pb<D>(dv_acc, p, sdo);  // dV += P^T dO
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          p[n][e] *= dp[n][e] - sdelta[col];  // dS^T
        }
      mma_pb<D>(dk_acc, p, sq);  // dK += dS^T Q
    }
  }
  store_rows<D>(dk + kv_off, kv_stride, row0, dk_acc, scale, scale);
  store_rows<D>(dv + kv_off, kv_stride, row0, dv_acc, 1.f, 1.f);
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int S, int H, int KVH,
                       float scale, int causal, cudaStream_t stream) {
  const int smem = 4 * Smem<D>::tile_bytes + 2 * kTile * sizeof(float);
  cudaError_t err = allow_smem(dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / kTile, B * KVH);
  dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, KVH, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace flash

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int B, int S,
                         int H, int KVH, int D, float scale, int causal,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return flash::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                                 KVH, scale, causal, st);
  if (D == 128)
    return flash::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, S,
                                  H, KVH, scale, causal, st);
  return cudaErrorInvalidValue;
}
