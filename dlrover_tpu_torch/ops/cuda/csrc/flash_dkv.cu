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
// Design: the FlashAttention-2 dK/dV pass on a persistent grid, one CTA
// per SM. A work item is (batch, kv head, part of the GQA group, 128-row
// k/v tile); the wrapper builds a longest-first list of them and deals it
// out to the CTAs (ops/cuda/schedule.py), so that the causal tail -- k
// tile 0 sees every q tile, the last one sees two -- spreads over the SMs.
// The TPU kernel folded the G query heads of a kv head into its matmul
// rows so the contraction summed the group; here an item loops over its
// part's query heads and, for each, over the 64-row q tiles (from the
// diagonal on under causal masking), summing in fp32 registers. With the
// group cut into `parts`, each part writes an fp32 partial and a second
// small kernel adds the parts in a fixed order, so the result is the
// same bits on every launch (no atomics).
//
// A CTA is three warpgroups. K and V of the item stay in shared memory;
// one producer thread streams q, dO (TMA, 128-byte swizzle), lse and
// delta (bulk copies) of each q tile through a ring of kStages stages
// with full/empty mbarriers, so the next tile's loads run under this
// tile's four products. Each consumer warpgroup owns 64 keys and computes
// the transposed products directly -- S^T = K Q^T and dP^T = V dO^T, wgmma
// with both operands in shared memory -- so P^T and dS^T come out in the
// accumulator layout that dV += P^T dO and dK += dS^T Q take as their
// register A operand, rounded to bf16 where the TPU kernel casts them;
// dO and Q are read through the transpose bit. The two warpgroups take
// turns issuing (ping-pong), so one's exponentials and dS run under the
// other's products. dK is scaled once at the end.
#include "flash_sm90.cuh"

namespace flash {

template <int D>
struct DkvCfg {
  static constexpr int kKRows = 128;  // keys of an item
  static constexpr int kQRows = 64;   // queries of a q tile
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kKvElems = kKRows * D;
  static constexpr int kQElems = kQRows * D;
  static constexpr int kKvBytes = kKvElems * 2;
  static constexpr int kQBytes = kQElems * 2;
  static constexpr int kRowBytes = kQRows * 4;  // lse or delta of a tile
  // k | v | q[kStages] | dO[kStages] | lse[kStages] | delta[kStages] | bars
  static constexpr int kQOff = 2 * kKvBytes;
  static constexpr int kDoOff = kQOff + kStages * kQBytes;
  static constexpr int kLseOff = kDoOff + kStages * kQBytes;
  static constexpr int kDeltaOff = kLseOff + kStages * kRowBytes;
  static constexpr int kBarOff = kDeltaOff + kStages * kRowBytes;
  static constexpr int kBars = 2 + 2 * kStages;
  static constexpr int kSmem = kBarOff + 8 * kBars + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, float* __restrict__ partial,
               const int* __restrict__ sched, int n_ctas, int B, int S,
               int H, int KVH, int parts, float scale, int causal) {
  using C = DkvCfg<D>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + C::kKvElems;
  bf16* sq = reinterpret_cast<bf16*>(smem + C::kQOff);
  bf16* sdo = reinterpret_cast<bf16*>(smem + C::kDoOff);
  float* slse = reinterpret_cast<float*>(smem + C::kLseOff);
  float* sdelta = reinterpret_cast<float*>(smem + C::kDeltaOff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumerThreads);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int nk = S / C::kKRows;
  const int nq = S / C::kQRows;
  const int G = H / KVH;
  const int heads = G / parts;  // query heads of one part of the group
  const int begin = sched[blockIdx.x], end = sched[blockIdx.x + 1];
  const int* items = sched + n_ctas + 1;

  if (threadIdx.x >= kConsumerThreads) {
    // ---- producer ----
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      prefetch_map(&tdo);
      int it = 0;  // q tiles issued by this CTA
      for (int i = begin; i < end; ++i) {
        const int item = items[i];
        const int kt = item % nk, rest = item / nk;
        const int part = rest % parts, bk = rest / parts;
        const int b = bk / KVH, kvh = bk % KVH;
        mbar_wait(kv_empty, ((i - begin) & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * C::kKvBytes);
        tma_tile<D>(sk, &tk, kv_full, kvh * D, b * S + kt * C::kKRows,
                    C::kKRows);
        tma_tile<D>(sv, &tv, kv_full, kvh * D, b * S + kt * C::kKRows,
                    C::kKRows);
        for (int hh = 0; hh < heads; ++hh) {
          const int h = kvh * G + part * heads + hh;
          for (int qt = causal ? 2 * kt : 0; qt < nq; ++qt, ++it) {
            const int s = it % kStages;
            mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(full + s, 2 * C::kQBytes + 2 * C::kRowBytes);
            const int row = b * S + qt * C::kQRows;
            tma_tile<D>(sq + s * C::kQElems, &tq, full + s, h * D, row,
                        C::kQRows);
            tma_tile<D>(sdo + s * C::kQElems, &tdo, full + s, h * D, row,
                        C::kQRows);
            const long r_off = ((long)b * H + h) * S + (long)qt * C::kQRows;
            bulk_load(slse + s * C::kQRows, lse + r_off, C::kRowBytes,
                      full + s);
            bulk_load(sdelta + s * C::kQRows, delta + r_off, C::kRowBytes,
                      full + s);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns keys [64c, 64c + 64) of the item ----
    reg_alloc<kConsumerRegs>();
    const int c = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = 64 * c + 16 * warp;  // this warp's keys in the tile
    const float scale_log2 = scale * kLog2e;
    // ping-pong, as in the forward: the warpgroups take turns issuing a q
    // tile's first two products, so one's exponentials and dS run under
    // the other's wgmma; a skipped tile still passes its turn
    auto my_turn = [&] { bar_sync(1 + c, kConsumerThreads); };
    auto your_turn = [&] { bar_arrive(2 - c, kConsumerThreads); };
    if (c == 1) your_turn();  // warpgroup 0 goes first
    int it = 0;
    for (int i = begin; i < end; ++i) {
      const int item = items[i];
      const int kt = item % nk, rest = item / nk;
      const int part = rest % parts, bk = rest / parts;
      const int b = bk / KVH, kvh = bk % KVH;
      const int key0 = kt * C::kKRows + row0 + g;  // key of register rows 0

      float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) {
        dk_acc[j] = 0.f;
        dv_acc[j] = 0.f;
      }
      mbar_wait(kv_full, (i - begin) & 1);
      for (int hh = 0; hh < heads; ++hh) {
        for (int qt = causal ? 2 * kt : 0; qt < nq; ++qt, ++it) {
          const int s = it % kStages;
          mbar_wait(full + s, (it / kStages) & 1);
          // under causal masking the first q tile is before every key of
          // warpgroup 1: nothing to add
          if (causal && qt * C::kQRows + C::kQRows <=
                            kt * C::kKRows + 64 * c) {
            my_turn();
            your_turn();
            mbar_arrive(empty + s);
            continue;
          }
          const bf16* q_s = sq + s * C::kQElems;
          const bf16* do_s = sdo + s * C::kQElems;
          const float* lse_s = slse + s * C::kQRows;
          const float* delta_s = sdelta + s * C::kQRows;
          float p[C::kQRows / 2], dp[C::kQRows / 2];
          my_turn();
          wgmma_fence();
          wg_mma_abt<D, C::kKRows, C::kQRows>(p, sk, 64 * c, q_s);
          wg_mma_abt<D, C::kKRows, C::kQRows>(dp, sv, 64 * c, do_s);
          wgmma_commit();
          your_turn();
          wgmma_wait<0>();
          fence_regs(p);
          fence_regs(dp);

          const bool mask = causal && qt * C::kQRows < (kt + 1) * C::kKRows;
#pragma unroll
          for (int j = 0; j < C::kQRows / 2; ++j) {
            const int col = 8 * (j >> 2) + 2 * t + (j & 1);
            float x = p[j];
            if (mask && key0 + 8 * ((j >> 1) & 1) > qt * C::kQRows + col)
              x = kNegInf;
            // P^T = exp(scale * s - lse), one FFMA and one ex2
            p[j] = ex2(fmaf(x, scale_log2, -lse_s[col] * kLog2e));
          }
          uint32_t pa[C::kQRows / 16][4];
          pack_a(pa, p);
          wgmma_fence();
          wg_mma_ab<D, C::kQRows / 16, C::kQRows>(dv_acc, pa, do_s);
          wgmma_commit();
#pragma unroll
          for (int j = 0; j < C::kQRows / 2; ++j) {
            const int col = 8 * (j >> 2) + 2 * t + (j & 1);
            p[j] *= dp[j] - delta_s[col];  // dS^T
          }
          uint32_t da[C::kQRows / 16][4];
          pack_a(da, p);
          wgmma_fence();
          wg_mma_ab<D, C::kQRows / 16, C::kQRows>(dk_acc, da, q_s);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          fence_regs(pa);
          fence_regs(da);
          mbar_arrive(empty + s);
        }
      }
      mbar_arrive(kv_empty);

      // epilogue: rows key0 and key0 + 8 of [B, S, KVH, D]
      const long kv_stride = (long)KVH * D;
      const long off = ((long)b * S + key0) * kv_stride + (long)kvh * D;
      if (parts == 1) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const long e0 = off + 8 * n + 2 * t, e1 = e0 + 8 * kv_stride;
          *reinterpret_cast<uint32_t*>(dk + e0) =
              pack_bf16(dk_acc[4 * n] * scale, dk_acc[4 * n + 1] * scale);
          *reinterpret_cast<uint32_t*>(dk + e1) = pack_bf16(
              dk_acc[4 * n + 2] * scale, dk_acc[4 * n + 3] * scale);
          *reinterpret_cast<uint32_t*>(dv + e0) =
              pack_bf16(dv_acc[4 * n], dv_acc[4 * n + 1]);
          *reinterpret_cast<uint32_t*>(dv + e1) =
              pack_bf16(dv_acc[4 * n + 2], dv_acc[4 * n + 3]);
        }
      } else {
        // fp32 partials [2][parts][B, S, KVH, D]: dK (unscaled), then dV
        const long n_el = (long)B * S * kv_stride;
        float* pk = partial + part * n_el;
        float* pv = partial + (parts + part) * n_el;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const long e0 = off + 8 * n + 2 * t, e1 = e0 + 8 * kv_stride;
          *reinterpret_cast<float2*>(pk + e0) =
              make_float2(dk_acc[4 * n], dk_acc[4 * n + 1]);
          *reinterpret_cast<float2*>(pk + e1) =
              make_float2(dk_acc[4 * n + 2], dk_acc[4 * n + 3]);
          *reinterpret_cast<float2*>(pv + e0) =
              make_float2(dv_acc[4 * n], dv_acc[4 * n + 1]);
          *reinterpret_cast<float2*>(pv + e1) =
              make_float2(dv_acc[4 * n + 2], dv_acc[4 * n + 3]);
        }
      }
    }
  }
}

// dK = bf16(scale * sum of the dK partials), dV = bf16(sum of the dV
// partials), the parts added in order 0, 1, ...; four elements a thread.
__global__ void dkv_sum_parts(const float* __restrict__ partial,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              long n_el, int parts, float scale) {
  const long i = 4 * ((long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n_el) return;
  float4 k4 = *reinterpret_cast<const float4*>(partial + i);
  float4 v4 = *reinterpret_cast<const float4*>(partial + parts * n_el + i);
  for (int p = 1; p < parts; ++p) {
    const float4 a = *reinterpret_cast<const float4*>(partial + p * n_el + i);
    const float4 b =
        *reinterpret_cast<const float4*>(partial + (parts + p) * n_el + i);
    k4.x += a.x, k4.y += a.y, k4.z += a.z, k4.w += a.w;
    v4.x += b.x, v4.y += b.y, v4.z += b.z, v4.w += b.w;
  }
  *reinterpret_cast<uint2*>(dk + i) = make_uint2(
      pack_bf16(k4.x * scale, k4.y * scale),
      pack_bf16(k4.z * scale, k4.w * scale));
  *reinterpret_cast<uint2*>(dv + i) =
      make_uint2(pack_bf16(v4.x, v4.y), pack_bf16(v4.z, v4.w));
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int S, int H, int KVH,
                       float scale, int causal, const int* sched, int n_ctas,
                       int parts, void* partial, cudaStream_t stream) {
  using C = DkvCfg<D>;
  if ((H / KVH) % parts || (parts > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  const uint64_t rows = (uint64_t)B * S;
  if (!make_map(&tq, q, rows, (uint64_t)H * D, C::kQRows) ||
      !make_map(&tdo, dout, rows, (uint64_t)H * D, C::kQRows) ||
      !make_map(&tk, k, rows, (uint64_t)KVH * D, C::kKRows) ||
      !make_map(&tv, v, rows, (uint64_t)KVH * D, C::kKRows))
    return cudaErrorInvalidResourceHandle;
  cudaError_t err = allow_smem(dkv_kernel<D>, C::kSmem);
  if (err != cudaSuccess) return err;
  dkv_kernel<D><<<n_ctas, kSm90Threads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(partial), sched, n_ctas,
      B, S, H, KVH, parts, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return err;
  const long n_el = (long)B * S * KVH * D;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_el / 4 + threads - 1) / threads);
  dkv_sum_parts<<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n_el, parts, scale);
  return cudaGetLastError();
}

}  // namespace flash

// Returns a cudaError_t; cudaErrorInvalidValue for a head_dim the kernel
// was not built for. `sched` is the work list of ops/cuda/schedule.py on
// the device (n_ctas + 1 offsets, then the items); with parts > 1,
// `partial` is fp32 scratch of 2 x parts x B x S x KVH x D.
extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int B, int S,
                         int H, int KVH, int D, float scale, int causal,
                         const void* sched, int n_ctas, int parts,
                         void* partial, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sc = static_cast<const int*>(sched);
  if (D == 64)
    return flash::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                                 KVH, scale, causal, sc, n_ctas, parts,
                                 partial, st);
  if (D == 128)
    return flash::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, S,
                                  H, KVH, scale, causal, sc, n_ctas, parts,
                                  partial, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the dK/dV kernel at head_dim D (0 if none).
extern "C" int flash_dkv_smem(int D) {
  return D == 64 ? flash::DkvCfg<64>::kSmem
                 : D == 128 ? flash::DkvCfg<128>::kSmem : 0;
}
