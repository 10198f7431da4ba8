// Flash-attention backward, dQ, GQA, causal or full, for Hopper (sm_90a).
//
// Replaces: dlrover_tpu/ops/pallas/flash_attention.py, `_dq_kernel`
// (launched in `_bwd` through pl.pallas_call).
//
// Bound on an H100 SXM at the Llama-1.1B train step's shape (B=3, H=32,
// KVH=4, S=2048, D=64, causal): three products of 7.7e10 FLOP in all,
// 78 us at the 989 TFLOP/s bf16 dense peak; its bytes (q, dO, k, v, lse,
// delta in, dq out, about 83 MB) take about 25 us at 3.35 TB/s, so the
// tensor cores bound it.
//
// Design: the FlashAttention-2 dQ pass, built like the forward
// (flash_fwd.cu). A persistent grid, one CTA per SM, each walking its
// share of a longest-first list of (batch, query head, 128-row q tile)
// items that the wrapper builds (ops/cuda/schedule.py). The TPU kernel
// accumulated dQ in VMEM scratch across its sequential k-block grid axis;
// here that axis is a loop inside the item, stopping at the diagonal under
// causal masking, and dQ stays in fp32 registers until one scaled bf16
// store at the end. A CTA is three warpgroups. One thread of the producer
// warpgroup (registers lowered by setmaxnreg) issues TMA loads: the
// item's q and dO tiles and its lse and delta rows, resident for the
// item, then k and v tiles through a ring of kStages stages guarded by
// full/empty mbarriers, running ahead across items, so that one item's
// epilogue overlaps the next one's loads. Each of the two consumer
// warpgroups owns 64 query rows. Per k tile it issues S = Q K^T and
// dP = dO V^T, wgmma with both operands in shared memory, together with
// dQ += dS K of the previous k tile (dS the register A operand, K read
// through the transpose bit), and forms this tile's P = exp(scale S -
// lse) -- one FFMA and one ex2 a score -- and dS = P (dP - delta),
// rounded to bf16 as the TPU kernel casts it, while that product runs.
// The two warpgroups take turns issuing (ping-pong), so one's
// exponentials run under the other's products. GQA needs no repeat:
// query head h reads kv head h / G. delta = rowsum(O dO) comes from the
// caller, as in the JAX package. No atomics: the result is the same bits
// on every launch.
//
// At D = 128 a k tile is 64 keys: S, dP, the dQ accumulator and the dS
// fragments of 128 keys would take 224 of a consumer's 240 registers.
#include "flash_sm90.cuh"

namespace flash {

template <int D>
struct DqCfg {
  static constexpr int kQRows = 128;               // rows of a q tile
  static constexpr int kKRows = D == 64 ? 128 : 64;  // keys of a k tile
  static constexpr int kStages = 3;
  static constexpr int kQElems = kQRows * D;
  static constexpr int kKvElems = kKRows * D;
  static constexpr int kQBytes = kQElems * 2;
  static constexpr int kKvBytes = kKvElems * 2;
  static constexpr int kRowBytes = kQRows * 4;  // lse or delta of a q tile
  // q | dO | k[kStages] | v[kStages] | lse | delta | barriers
  static constexpr int kKOff = 2 * kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKvBytes;
  static constexpr int kLseOff = kVOff + kStages * kKvBytes;
  static constexpr int kDeltaOff = kLseOff + kRowBytes;
  static constexpr int kBarOff = kDeltaOff + kRowBytes;
  static constexpr int kBars = 2 + 2 * kStages;
  static constexpr int kSmem = kBarOff + 8 * kBars + 1024;  // + alignment
};

// dS = P (dP - delta) in place of the raw scores `sc` (accumulator layout,
// this thread's q-tile rows `row` and `row + 8`): P = exp(scale * s - lse)
// as one FFMA and one ex2 on the raw score, with keys past the diagonal
// masked to NEG_INF (P exactly 0) when `diag`; `lim` is the last key of
// the k tile that row `row` sees, counted from the tile's first key.
template <int N>
__device__ __forceinline__ void ds_step(float (&sc)[N], const float (&dp)[N],
                                        const float (&lse_l2)[2],
                                        const float (&delta)[2],
                                        float scale_log2, bool diag, int lim,
                                        int t) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int r = (j >> 1) & 1;
    float x = sc[j];
    if (diag && 8 * (j >> 2) + 2 * t + (j & 1) > lim + 8 * r) x = kNegInf;
    sc[j] = ex2(fmaf(x, scale_log2, -lse_l2[r])) * (dp[j] - delta[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, const int* __restrict__ sched,
              int n_ctas, int S, int H, int KVH, float scale, int causal) {
  using C = DqCfg<D>;
  constexpr int kStages = C::kStages;
  constexpr int kN = C::kKRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + C::kQElems;
  bf16* sk = reinterpret_cast<bf16*>(smem + C::kKOff);
  bf16* sv = reinterpret_cast<bf16*>(smem + C::kVOff);
  float* slse = reinterpret_cast<float*>(smem + C::kLseOff);
  float* sdelta = reinterpret_cast<float*>(smem + C::kDeltaOff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* kv_full = bars + 2;
  uint64_t* kv_empty = kv_full + kStages;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerThreads);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kv_full + s, 1);
      mbar_init(kv_empty + s, kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int nq = S / C::kQRows;
  const int G = H / KVH;
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
      int it = 0;  // k/v tiles issued by this CTA
      for (int i = begin; i < end; ++i) {
        const int item = items[i];
        const int qt = item % nq, bh = item / nq;
        const int b = bh / H, h = bh % H, kvh = h / G;
        const int n_kt = (causal ? qt + 1 : nq) * (C::kQRows / kN);
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(kv_empty + s, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(kv_full + s, 2 * C::kKvBytes);
          tma_tile<D>(sk + s * C::kKvElems, &tk, kv_full + s, kvh * D,
                      b * S + kt * kN, kN);
          tma_tile<D>(sv + s * C::kKvElems, &tv, kv_full + s, kvh * D,
                      b * S + kt * kN, kN);
          if (kt == 0) {  // q, dO, lse, delta, once the last are let go
            mbar_wait(q_empty, ((i - begin) & 1) ^ 1);
            mbar_expect_tx(q_full, 2 * C::kQBytes + 2 * C::kRowBytes);
            const int row = b * S + qt * C::kQRows;
            tma_tile<D>(sq, &tq, q_full, h * D, row, C::kQRows);
            tma_tile<D>(sdo, &tdo, q_full, h * D, row, C::kQRows);
            const long r_off = ((long)b * H + h) * S + (long)qt * C::kQRows;
            bulk_load(slse, lse + r_off, C::kRowBytes, q_full);
            bulk_load(sdelta, delta + r_off, C::kRowBytes, q_full);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns q rows [64c, 64c + 64) ----
    reg_alloc<kConsumerRegs>();
    const int c = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = 64 * c + 16 * warp;  // this warp's rows in the q tile
    const long q_stride = (long)H * D;
    const float scale_log2 = scale * kLog2e;
    // ping-pong, as in the forward: warpgroup c waits on barrier 1 + c and
    // lets the other go by arriving on its barrier; both pass the same
    // number of turns per item
    auto my_turn = [&] { bar_sync(1 + c, kConsumerThreads); };
    auto your_turn = [&] { bar_arrive(2 - c, kConsumerThreads); };
    if (c == 1) your_turn();  // warpgroup 0 goes first
    int it = 0;
    for (int i = begin; i < end; ++i) {
      const int item = items[i];
      const int qt = item % nq, bh = item / nq;
      const int b = bh / H, h = bh % H;
      const int n_kt = (causal ? qt + 1 : nq) * (C::kQRows / kN);
      // under causal masking the k tiles from `first_diag` on cross the
      // diagonal; lim0 is the last key row row0 + g sees
      const int lim0 = qt * C::kQRows + row0 + g;
      const int first_diag = causal ? (qt * C::kQRows) / kN : n_kt;

      float acc[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

      mbar_wait(q_full, (i - begin) & 1);
      float lse_l2[2], dlt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse_l2[r] = slse[row0 + g + 8 * r] * kLog2e;
        dlt[r] = sdelta[row0 + g + 8 * r];
      }
      float sc[kN / 2], dp[kN / 2];
      uint32_t da[kN / 16][4];
      // k tile 0: S and dP, with no dS K to overlap yet
      int s = it % kStages;
      uint32_t parity = (it / kStages) & 1;
      mbar_wait(kv_full + s, parity);
      my_turn();
      wgmma_fence();
      wg_mma_abt<D, C::kQRows, kN>(sc, sq, 64 * c, sk + s * C::kKvElems);
      wg_mma_abt<D, C::kQRows, kN>(dp, sdo, 64 * c, sv + s * C::kKvElems);
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (n_kt == 1) mbar_arrive(q_empty);
      ds_step(sc, dp, lse_l2, dlt, scale_log2, first_diag == 0, lim0, t);
      pack_a(da, sc);
      for (int kt = 1; kt < n_kt; ++kt) {
        const int sp = s;
        ++it;
        s = it % kStages;
        parity = (it / kStages) & 1;
        // S and dP of this k tile and dQ += dS K of the last, in flight
        // together
        mbar_wait(kv_full + s, parity);
        my_turn();
        wgmma_fence();
        wg_mma_abt<D, C::kQRows, kN>(sc, sq, 64 * c, sk + s * C::kKvElems);
        wg_mma_abt<D, C::kQRows, kN>(dp, sdo, 64 * c, sv + s * C::kKvElems);
        wgmma_commit();
        wg_mma_ab<D, kN / 16, kN>(acc, da, sk + sp * C::kKvElems);
        wgmma_commit();
        your_turn();
        wgmma_wait<1>();
        fence_regs(sc);
        fence_regs(dp);
        if (kt == n_kt - 1) mbar_arrive(q_empty);
        // this tile's dS runs under the last tile's dS K
        ds_step(sc, dp, lse_l2, dlt, scale_log2, kt >= first_diag,
                lim0 - kt * kN, t);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(da);
        mbar_arrive(kv_empty + sp);
        pack_a(da, sc);
      }
      my_turn();
      wgmma_fence();
      wg_mma_ab<D, kN / 16, kN>(acc, da, sk + s * C::kKvElems);
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      mbar_arrive(kv_empty + s);
      ++it;

      // epilogue: dq = scale * acc, rows row0 + g and row0 + g + 8
      const long row_g = (long)b * S + (long)qt * C::kQRows + row0 + g;
      bf16* out = dq + row_g * q_stride + h * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(out + col) =
            pack_bf16(acc[4 * n] * scale, acc[4 * n + 1] * scale);
        *reinterpret_cast<uint32_t*>(out + 8 * q_stride + col) =
            pack_bf16(acc[4 * n + 2] * scale, acc[4 * n + 3] * scale);
      }
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int S, int H, int KVH, float scale,
                      int causal, const int* sched, int n_ctas,
                      cudaStream_t stream) {
  using C = DqCfg<D>;
  CUtensorMap tq, tk, tv, tdo;
  const uint64_t rows = (uint64_t)B * S;
  if (!make_map(&tq, q, rows, (uint64_t)H * D, C::kQRows) ||
      !make_map(&tdo, dout, rows, (uint64_t)H * D, C::kQRows) ||
      !make_map(&tk, k, rows, (uint64_t)KVH * D, C::kKRows) ||
      !make_map(&tv, v, rows, (uint64_t)KVH * D, C::kKRows))
    return cudaErrorInvalidResourceHandle;
  cudaError_t err = allow_smem(dq_kernel<D>, C::kSmem);
  if (err != cudaSuccess) return err;
  dq_kernel<D><<<n_ctas, kSm90Threads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), sched,
      n_ctas, S, H, KVH, scale, causal);
  return cudaGetLastError();
}

}  // namespace flash

// Returns a cudaError_t; cudaErrorInvalidValue for a head_dim the kernel
// was not built for. `sched` is the work list of ops/cuda/schedule.py on
// the device: n_ctas + 1 offsets, then the items.
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int S, int H, int KVH, int D,
                        float scale, int causal, const void* sched,
                        int n_ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sc = static_cast<const int*>(sched);
  if (D == 64)
    return flash::launch_dq<64>(q, k, v, dout, lse, delta, dq, B, S, H, KVH,
                                scale, causal, sc, n_ctas, st);
  if (D == 128)
    return flash::launch_dq<128>(q, k, v, dout, lse, delta, dq, B, S, H,
                                 KVH, scale, causal, sc, n_ctas, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the dQ kernel at head_dim D (0 if none).
extern "C" int flash_dq_smem(int D) {
  return D == 64 ? flash::DqCfg<64>::kSmem
                 : D == 128 ? flash::DqCfg<128>::kSmem : 0;
}
