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
// Design: a persistent grid, one CTA per SM, each walking its share of a
// longest-first list of (batch, query head, 128-row q tile) items that
// the wrapper builds (ops/cuda/schedule.py). The TPU kernel walked k
// blocks on the sequential minor grid axis with m, l and acc in VMEM
// scratch; here that axis is a loop inside the item with m, l and acc in
// registers, stopping at the diagonal under causal masking. A CTA is
// three warpgroups. One thread of the producer warpgroup (registers
// lowered by setmaxnreg) issues TMA loads: the q tile, then 128-row k and
// v tiles through a ring of kStages stages guarded by full/empty
// mbarriers, running ahead across items, so that one item's epilogue
// overlaps the next one's loads. Each of the two consumer warpgroups owns
// 64 query rows: S = Q K^T is one wgmma chain with both operands in
// shared memory, the online softmax runs on its fp32 accumulator
// registers, and P, rounded to bf16 as the TPU kernel casts it, is the
// register A operand of O += P V, with V read from shared memory through
// the transpose bit. At D = 64 the softmax's exponentials take the SFUs
// about as long as the products take the tensor cores, so both are kept
// busy at once: a warpgroup issues S of k tile j together with P V of
// tile j - 1 and computes tile j's softmax while P V runs, and the two
// warpgroups take turns issuing (ping-pong), so one's softmax runs under
// the other's products. GQA needs no repeat: query head h reads kv head
// h / G.
#include "flash_sm90.cuh"

namespace flash {

template <int D>
struct FwdCfg {
  static constexpr int kRows = 128;  // rows of a q tile and of a k/v tile
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kTileElems = kRows * D;
  static constexpr int kTileBytes = kTileElems * 2;
  // q | k[kStages] | v[kStages] | barriers
  static constexpr int kBarOff = (1 + 2 * kStages) * kTileBytes;
  static constexpr int kBars = 2 + 3 * kStages;
  static constexpr int kSmem = kBarOff + 8 * kBars + 1024;  // + alignment
};

// One k tile of the online softmax on a warpgroup's raw scores (Q K^T,
// accumulator layout, this thread's rows `row` and `row + 8` of the q
// tile): masked past the diagonal when `diag`, P = exp(scale * s - m) in
// place, the running max m and sum l updated, and `corr`, the factor
// that rescales the output rows, returned. Since scale > 0 the max is
// taken on the raw scores, and each P is one FFMA and one ex2.
template <int N>
__device__ __forceinline__ void softmax_step(float (&sc)[N],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&corr)[2], float scale,
                                             bool diag, int row, int t) {
  if (diag) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int col = 8 * (j >> 2) + 2 * t + (j & 1);
      if (col > row + 8 * ((j >> 1) & 1)) sc[j] = kNegInf;
    }
  }
  float mb[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = sc[2 * r];
#pragma unroll
    for (int n = 0; n < N / 4; ++n)
      mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
    const float m_new = fmaxf(m_run[r], quad_max(mx) * scale);
    corr[r] = ex2((m_run[r] - m_new) * kLog2e);
    m_run[r] = m_new;
    mb[r] = m_new * kLog2e;
  }
  const float scale_log2 = scale * kLog2e;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int r = (j >> 1) & 1;
    sc[j] = ex2(fmaf(sc[j], scale_log2, -mb[r]));
    rsum[r] += sc[j];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l_run[r] = l_run[r] * corr[r] + quad_sum(rsum[r]);
}

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
               float* __restrict__ lse, const int* __restrict__ sched,
               int n_ctas, int S, int H, int KVH, float scale, int causal) {
  using C = FwdCfg<D>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + C::kTileElems;
  bf16* sv = sk + kStages * C::kTileElems;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerThreads);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(kv_empty + s, kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int nq = S / C::kRows;
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
      int it = 0;  // k/v tiles issued by this CTA
      for (int i = begin; i < end; ++i) {
        const int item = items[i];
        const int qt = item % nq, bh = item / nq;
        const int b = bh / H, h = bh % H, kvh = h / G;
        const int n_kt = causal ? qt + 1 : nq;
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(kv_empty + s, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(k_full + s, C::kTileBytes);
          tma_tile<D>(sk + s * C::kTileElems, &tk, k_full + s, kvh * D,
                      b * S + kt * C::kRows, C::kRows);
          mbar_expect_tx(v_full + s, C::kTileBytes);
          tma_tile<D>(sv + s * C::kTileElems, &tv, v_full + s, kvh * D,
                      b * S + kt * C::kRows, C::kRows);
          if (kt == 0) {  // q, once the consumers let go of the last one
            mbar_wait(q_empty, ((i - begin) & 1) ^ 1);
            mbar_expect_tx(q_full, C::kTileBytes);
            tma_tile<D>(sq, &tq, q_full, h * D, b * S + qt * C::kRows,
                        C::kRows);
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
    // the two warpgroups take turns issuing their products (ping-pong),
    // so that one's softmax runs while the other's wgmma does: warpgroup
    // c waits on barrier 1 + c and lets the other go by arriving on its
    // barrier; both pass the same number of turns per item
    auto my_turn = [&] { bar_sync(1 + c, kConsumerThreads); };
    auto your_turn = [&] { bar_arrive(2 - c, kConsumerThreads); };
    if (c == 1) your_turn();  // warpgroup 0 goes first
    int it = 0;
    for (int i = begin; i < end; ++i) {
      const int item = items[i];
      const int qt = item % nq, bh = item / nq;
      const int b = bh / H, h = bh % H;
      const int n_kt = causal ? qt + 1 : nq;

      float m_run[2] = {kNegInf, kNegInf};
      float l_run[2] = {0.f, 0.f};
      float acc[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

      mbar_wait(q_full, (i - begin) & 1);
      float sc[C::kRows / 2];
      uint32_t pa[C::kRows / 16][4];
      float corr[2];
      // k tile 0: scores and softmax, with no product to overlap yet
      int s = it % kStages;
      uint32_t parity = (it / kStages) & 1;
      mbar_wait(k_full + s, parity);
      my_turn();
      wgmma_fence();
      wg_mma_abt<D, C::kRows, C::kRows>(sc, sq, 64 * c,
                                        sk + s * C::kTileElems);
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      if (n_kt == 1) mbar_arrive(q_empty);
      softmax_step(sc, m_run, l_run, corr, scale, causal && qt == 0,
                   row0 + g, t);
      pack_a(pa, sc);
      for (int kt = 1; kt < n_kt; ++kt) {
        const int sp = s;
        const uint32_t pp = parity;
        ++it;
        s = it % kStages;
        parity = (it / kStages) & 1;
        // S of this k tile and O += P V of the last one, in flight together
        mbar_wait(k_full + s, parity);
        mbar_wait(v_full + sp, pp);
        my_turn();
        wgmma_fence();
        wg_mma_abt<D, C::kRows, C::kRows>(sc, sq, 64 * c,
                                          sk + s * C::kTileElems);
        wgmma_commit();
        wg_mma_ab<D, C::kRows / 16, C::kRows>(acc, pa,
                                              sv + sp * C::kTileElems);
        wgmma_commit();
        your_turn();
        wgmma_wait<1>();
        fence_regs(sc);
        if (kt == n_kt - 1) mbar_arrive(q_empty);
        // the softmax of this tile runs under the last tile's P V
        softmax_step(sc, m_run, l_run, corr, scale, causal && kt == qt,
                     row0 + g, t);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        mbar_arrive(kv_empty + sp);
#pragma unroll
        for (int j = 0; j < D / 2; ++j) acc[j] *= corr[(j >> 1) & 1];
        pack_a(pa, sc);
      }
      mbar_wait(v_full + s, parity);
      my_turn();
      wgmma_fence();
      wg_mma_ab<D, C::kRows / 16, C::kRows>(acc, pa, sv + s * C::kTileElems);
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(kv_empty + s);
      ++it;

      // epilogue: o = acc / l, lse = m + log(l), l = 0 read as 1
      float inv[2];
      const long row_g = (long)b * S + (long)qt * C::kRows + row0 + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l_safe = l_run[r] == 0.f ? 1.f : l_run[r];
        inv[r] = 1.f / l_safe;
        if (t == 0)
          lse[((long)b * H + h) * S + (long)qt * C::kRows + row0 + g +
              8 * r] = m_run[r] + logf(l_safe);
      }
      bf16* ob = o + row_g * q_stride + h * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(ob + col) =
            pack_bf16(acc[4 * n] * inv[0], acc[4 * n + 1] * inv[0]);
        *reinterpret_cast<uint32_t*>(ob + 8 * q_stride + col) =
            pack_bf16(acc[4 * n + 2] * inv[1], acc[4 * n + 3] * inv[1]);
      }
    }
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int S, int H, int KVH, float scale,
                       int causal, const int* sched, int n_ctas,
                       cudaStream_t stream) {
  using C = FwdCfg<D>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, (uint64_t)B * S, (uint64_t)H * D, C::kRows) ||
      !make_map(&tk, k, (uint64_t)B * S, (uint64_t)KVH * D, C::kRows) ||
      !make_map(&tv, v, (uint64_t)B * S, (uint64_t)KVH * D, C::kRows))
    return cudaErrorInvalidResourceHandle;
  cudaError_t err = allow_smem(fwd_kernel<D>, C::kSmem);
  if (err != cudaSuccess) return err;
  fwd_kernel<D><<<n_ctas, kSm90Threads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), sched,
      n_ctas, S, H, KVH, scale, causal);
  return cudaGetLastError();
}

}  // namespace flash

// Returns a cudaError_t; cudaErrorInvalidValue for a head_dim the kernel
// was not built for. `sched` is the work list of ops/cuda/schedule.py on
// the device: n_ctas + 1 offsets, then the items.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int S, int H, int KVH,
                         int D, float scale, int causal, const void* sched,
                         int n_ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sc = static_cast<const int*>(sched);
  if (D == 64)
    return flash::launch_fwd<64>(q, k, v, o, lse, B, S, H, KVH, scale,
                                 causal, sc, n_ctas, st);
  if (D == 128)
    return flash::launch_fwd<128>(q, k, v, o, lse, B, S, H, KVH, scale,
                                  causal, sc, n_ctas, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the forward kernel at head_dim D (0 if none).
extern "C" int flash_fwd_smem(int D) {
  return D == 64 ? flash::FwdCfg<64>::kSmem
                 : D == 128 ? flash::FwdCfg<128>::kSmem : 0;
}
