// Flash-attention backward, dQ, GQA, causal or full, for Hopper (sm_90a).
//
// Replaces: dlrover_tpu/ops/pallas/flash_attention.py, `_dq_kernel`
// (launched in `_bwd` through pl.pallas_call).
//
// Bound on an H100 SXM at the Llama-1.1B train step's shape (B=3, H=32,
// KVH=4, S=2048, D=64, causal): three products of 7.7e10 FLOP in all,
// 78 us at the 989 TFLOP/s bf16 dense peak; its bytes (q, dO, k, v, lse,
// delta in, dq out, about 44 MB) take about 13 us at 3.35 TB/s, so the
// tensor cores bound it.
//
// Design: one CTA of 4 warps per (batch, query head, 64-row q tile), the
// FlashAttention-2 dQ pass. The TPU kernel accumulated dQ in VMEM scratch
// across its sequential k-block grid axis; here the k tiles are a loop
// inside the CTA, stopping at the diagonal under causal masking, and dQ
// stays in fp32 registers until one scaled bf16 store at the end. Per
// k tile each warp recomputes its 16 rows of P = exp(S - lse) from the
// saved lse, forms dP = dO V^T, dS = P (dP - delta) in registers, and
// feeds dS (rounded to bf16, as the TPU kernel casts it) straight into
// dS K. delta = rowsum(O * dO) comes from the caller, as in the JAX
// package.
#include "flash_common.cuh"

namespace flash {

template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int S, int H, int KVH, float scale,
              int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + Smem<D>::tile_elems;
  bf16* sk = sdo + Smem<D>::tile_elems;
  bf16* sv = sk + Smem<D>::tile_elems;

  const int nq = S / kTile;
  const int qt = nq - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;

  const long q_stride = (long)H * D;
  const long kv_stride = (long)KVH * D;
  const long q_off = ((long)b * S + (long)qt * kTile) * q_stride + h * D;
  const bf16* kb = k + (long)b * S * kv_stride + kvh * D;
  const bf16* vb = v + (long)b * S * kv_stride + kvh * D;

  load_tile<D>(sq, q + q_off, q_stride);
  load_tile<D>(sdo, dout + q_off, q_stride);

  // lse and delta of this thread's two rows (g and g + 8 of its warp)
  const long row_off = ((long)b * H + h) * S + (long)qt * kTile + row0 + g;
  const float lse_r[2] = {lse[row_off], lse[row_off + 8]};
  const float delta_r[2] = {delta[row_off], delta[row_off + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_kt = causal ? qt + 1 : nq;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<D>(sk, kb + (long)kt * kTile * kv_stride, kv_stride);
    load_tile<D>(sv, vb + (long)kt * kTile * kv_stride, kv_stride);
    cp_async_wait_all();
    __syncthreads();

    float p[8][4], dp[8][4];
    mma_abt<D>(p, sq, row0, sk);
    mma_abt<D>(dp, sdo, row0, sv);
    const bool diag = causal && kt == qt;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = p[n][e] * scale;
        if (diag) {
          const int row = row0 + g + 8 * (e >> 1);
          const int col = n * 8 + 2 * t + (e & 1);
          if (col > row) s = kNegInf;
        }
        const float pe = __expf(s - lse_r[e >> 1]);
        p[n][e] = pe * (dp[n][e] - delta_r[e >> 1]);  // dS
      }
    mma_pb<D>(acc, p, sk);
  }
  store_rows<D>(dq + q_off, q_stride, row0, acc, scale, scale);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int S, int H, int KVH, float scale,
                      int causal, cudaStream_t stream) {
  const int smem = 4 * Smem<D>::tile_bytes;
  cudaError_t err = allow_smem(dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / kTile, B * H);
  dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), S, H, KVH, scale, causal);
  return cudaGetLastError();
}

}  // namespace flash

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int S, int H, int KVH, int D,
                        float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return flash::launch_dq<64>(q, k, v, dout, lse, delta, dq, B, S, H, KVH,
                                scale, causal, st);
  if (D == 128)
    return flash::launch_dq<128>(q, k, v, dout, lse, delta, dq, B, S, H,
                                 KVH, scale, causal, st);
  return cudaErrorInvalidValue;
}
