// Flash-attention forward, GQA, causal or full, for Hopper (sm_90a).
//
// Replaces: dlrover_tpu/ops/pallas/flash_attention.py, `_fwd_kernel`
// (launched by `_fwd` through pl.pallas_call).
//
// Bound on an H100 SXM at the Llama-1.1B train step's shape (B=3, H=32,
// KVH=4, S=2048, D=64, causal): two products of 5.15e10 FLOP in all,
// 52 us at the 989 TFLOP/s bf16 dense peak, against about 17 us to move
// its 57 MB at 3.35 TB/s -- the kernel is bound by the tensor cores.
//
// Design: one CTA of 4 warps per (batch, query head, 64-row q tile). The
// TPU kernel walked k blocks on the sequential minor grid axis with m, l
// and acc in VMEM scratch; here that axis is a loop inside the CTA with
// m, l and acc in registers, and under causal masking it stops at the
// diagonal tile instead of clamping block indices. Each warp owns 16
// query rows: S = Q K^T goes through mma.sync into fp32, the online
// softmax runs on the accumulator registers (row max and sum across the
// 4 threads of a quad), and P, rounded to bf16 as the TPU kernel casts
// it, feeds P V from the same registers without a trip through shared
// memory. K and V tiles come into shared memory by cp.async; q tiles are
// scheduled heaviest first so that the causal tail is short. GQA needs
// no repeat: query head h reads kv head h / G.
#include "flash_common.cuh"

namespace flash {

template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int S, int H, int KVH,
               float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + Smem<D>::tile_elems;
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
  const bf16* qb = q + ((long)b * S + (long)qt * kTile) * q_stride + h * D;
  const bf16* kb = k + (long)b * S * kv_stride + kvh * D;
  const bf16* vb = v + (long)b * S * kv_stride + kvh * D;

  load_tile<D>(sq, qb, q_stride);

  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_kt = causal ? qt + 1 : nq;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<D>(sk, kb + (long)kt * kTile * kv_stride, kv_stride);
    load_tile<D>(sv, vb + (long)kt * kTile * kv_stride, kv_stride);
    cp_async_wait_all();
    __syncthreads();

    float s[8][4];
    mma_abt<D>(s, sq, row0, sk);
    const bool diag = causal && kt == qt;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale;
        if (diag) {
          const int row = row0 + g + 8 * (e >> 1);
          const int col = n * 8 + 2 * t + (e & 1);
          if (col > row) s[n][e] = kNegInf;
        }
      }

    float m_new[2], corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      m_new[r] = quad_max(mx);
      corr[r] = __expf(m_run[r] - m_new[r]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - m_new[e >> 1]);
        rsum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * corr[r] + quad_sum(rsum[r]);
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    mma_pb<D>(acc, s, sv);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = l_run[r] == 0.f ? 1.f : l_run[r];
    inv[r] = 1.f / l_safe;
    if (t == 0) {
      lse[((long)b * H + h) * S + (long)qt * kTile + row0 + g + 8 * r] =
          m_run[r] + logf(l_safe);
    }
  }
  store_rows<D>(o + ((long)b * S + (long)qt * kTile) * q_stride + h * D,
                q_stride, row0, acc, inv[0], inv[1]);
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int S, int H, int KVH, float scale,
                       int causal, cudaStream_t stream) {
  const int smem = 3 * Smem<D>::tile_bytes;
  cudaError_t err = allow_smem(fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / kTile, B * H);
  fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), S, H, KVH, scale, causal);
  return cudaGetLastError();
}

}  // namespace flash

// Returns a cudaError_t; cudaErrorInvalidValue for a head_dim the kernel
// was not built for.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int S, int H, int KVH,
                         int D, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return flash::launch_fwd<64>(q, k, v, o, lse, B, S, H, KVH, scale,
                                 causal, st);
  if (D == 128)
    return flash::launch_fwd<128>(q, k, v, o, lse, B, S, H, KVH, scale,
                                  causal, st);
  return cudaErrorInvalidValue;
}
