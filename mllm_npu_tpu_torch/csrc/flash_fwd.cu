// K1: flash-attention forward for Hopper (bf16 in, fp32 softmax and
// accumulation): TMA loads into an mbarrier-guarded ring, wgmma for both
// products, one producer warp feeding one or two consumer warpgroups.
//
// Replaces the Pallas TPU kernel mllm_npu_tpu/ops/flash_attention.py:100
// `_fwd_kernel` (launched by `_fwd` :211 through `pl.pallas_call` :282).
// Python wrapper and plain PyTorch version:
// mllm_npu_tpu_torch/ops/flash_attention.py (`flash_attention`).
//
// What it computes, per (batch b, query head h, KV head h·Hkv/Hq):
//   O = softmax(scale·Q Kᵀ + mask) V, mask = top-left causal ∧ segment ids
//   (q_seg == kv_seg) ∧ the keys that exist; a row with no visible key
//   writes 0. With an LSE pointer it also writes each row's natural-log
//   log-sum-exp, (m + log2 l)·ln 2, and 0 for a row with no visible key:
//   K2 and K3 (flash_bwd.cu) recompute P from it.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s). 4·D flops per
// visible (query, key) pair per head, Q, K, V and O moved once. At the
// paths' shapes: SigLIP (B5 S729 H16 D72) 12.2 GFLOP against 4.7 MB,
// bound 0.012 ms by the tensor cores; Llama prefill (B1 S339 H32/8 D128,
// causal) 0.002 ms and the resampler (B5 64×729 H32 D128) 0.019 ms, both
// by the bytes. So the long shapes need the full wgmma rate with the
// softmax hidden behind it, and the short ones are latency: a call's
// first TMA loads, then a causal work tile's chain of K/V tiles in
// series, so they need few, short steps on a grid that fills the card.
//
// Design:
//  * Persistent blocks: as many as fit on the card at once (at most one
//    per work tile), each walking work tiles (BQ query rows of one head and
//    batch) i, i + gridDim.x, ... Causal: a head's last query tiles see the
//    most keys, so those come first over every head and the cheapest fill
//    the last round; otherwise a head's query tiles are neighbours and
//    share its K/V in L2. Block set-up, barrier init and the first loads
//    are paid once per block, and the next tile's Q loads while this one
//    computes.
//  * Warp specialisation. The last warpgroup is the producer (registers
//    cut with setmaxnreg): its first warp loads Q (2 stages) and K, and
//    writes each K tile's segment ids (read from memory a tile ahead) and
//    their min and max into the stage; its second warp loads V. Every load
//    is TMA. K and V have their own 2-stage rings, each stage with a
//    "full" mbarrier (TMA bytes, plus the K warp's 32 lanes for the ids)
//    and an "empty" one that every consumer warp arrives on: for K once
//    its mask has read the ids, for V once the PV product that read it has
//    completed.
//  * Two tile shapes, chosen by the wrapper from the grid size:
//    BQ = BK = 128 with two consumer warpgroups (one block per SM) where
//    that grid fills the 132 SMs, else BQ = BK = 64 with one consumer
//    warpgroup (two blocks per SM). Each consumer warpgroup owns 64 query
//    rows; its warps 16 each.
//  * S = Q·Kᵀ: wgmma m64nBKk16 with A = Q and B = K, both K-major from
//    shared memory, into fp32 registers. The online softmax runs in base 2
//    on the accumulator layout (one FFMA and one ex2 per element; maxima
//    and sums as trees). P is rounded to bf16 in registers and is the
//    register A operand of O += P·V: wgmma m64nNk16 with B = V in its
//    stored [keys, D] layout, the MN-major ("transposed") B. No scalar
//    loads of any operand.
//  * Overlap. In each warpgroup, S of tile j and its softmax run beside PV
//    of tile j − 1 (issue QK_j and PV_{j-1}, wait for QK_j, softmax, wait
//    for PV_{j-1}, rescale O). Two warpgroups also take turns issuing their
//    products (named barriers), so one's softmax runs while the other's
//    products hold the tensor cores.
//  * Masks only where needed: per warp and tile, the elementwise mask runs
//    only if the tile holds keys past Sk, crosses the causal diagonal of
//    the warp's rows, or holds a segment other than the warp's one segment
//    (from the min and max of the tile's kv ids and of the warp's q ids);
//    a warp whose rows all lie past Sq never masks. Every other tile takes
//    the unmasked path. Causal: tiles above a work tile's diagonal are
//    never loaded.
//  * Padding by TMA: one 4-D tensor map over [B, S, H, D] per operand and
//    swizzle (dims ordered D, H, S, B), with the tensor's own strides,
//    encoded on the host on every call. Rows past S and columns past D
//    arrive as zeros (out-of-bounds fill); nothing is zeroed by stores and
//    nothing is padded in device memory.
//  * GQA reads KV head h·Hkv/Hq directly; K/V are never repeated.
//  * O and the LSE are written from registers (rows < Sq, columns < D).

// Trouble spots, and what the design does about each:
//  * D = 72 with swizzle. A 128-byte swizzle wants an inner box of 64 bf16
//    and 80 × 2 = 160 bytes is not one atom. So the head dim is split: the
//    first 64·⌊DP/64⌋ columns (DP = D rounded up to 16) in 64-column boxes
//    under the 128-byte swizzle, the rest (16, 32 or 48 columns) in
//    16-column boxes under the 32-byte swizzle, each box a separate buffer
//    in shared memory. QKᵀ walks the first part in k-steps of 32 bytes
//    inside each 128-byte row (K-major, SBO 1024 B) and the rest one
//    16-column box per k-step (K-major, SBO 256 B). PV issues one wgmma for
//    each part: N = 64 or 128 from the 128-byte boxes (MN-major, SBO 1024 B
//    between 8-key groups, LBO BK·128 B between 64-column boxes) and
//    N = 16, 32 or 48 from the 32-byte boxes (SBO 256 B, LBO BK·32 B).
//    D = 72 → 64 + 16 (cols 72–79 zero-filled), 128 → 128, 32 → 0 + 32,
//    104 → 64 + 48 (Qwen-ViT-G), 160 → 128 + 32 (the SEED-X input
//    projector): no wgmma shape beyond those D ≤ 128 already uses.
//  * Shared memory above D = 128. Q (2 stages) and K and V (2 stages
//    each) take 6·BQ·DP·2 bytes: at BQ = 128 that is 168 KB at DP = 112
//    and 216 KB at DP = 144, within the 227 KB a block may use, but 240 KB
//    at DP = 160. So DP = 160 takes only the 64-row tiles (120 KB, one
//    block per SM); the wrapper's plan (`k1_block_q`, `k1_smem_bytes`)
//    mirrors Cfg::SMEM and never asks for a shape that does not fit, and
//    the host entry refuses one. Registers: O at DP = 160 is 80 fp32 a
//    consumer thread (o_hi 64 + o_lo 16), beside S (BK/2) and P (BK/4).
//  * The P fragment layout. The m64nNk16 fp32 accumulator gives each
//    thread, per 8-column slice, (row g, cols 2t, 2t+1) and (row g+8, same
//    cols) of its warp's 16 rows; the register A operand of m64nNk16 wants
//    (g, 2t..), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..) per 16 keys. So
//    for bf16 the S slices 2kk and 2kk+1 pack directly into A k-step kk:
//    no shuffles.
//  * Fences and waits. wgmma.fence before each batch (the accumulators and
//    P were written by ordinary instructions), commit_group, then
//    wait_group 1 (S is ready, PV may run) or 0, each followed by a
//    register fence on what the wait released, so that the compiler
//    neither reads accumulators early nor reuses P's registers while the
//    asynchronous product still reads them. A warp arrives on a V stage's
//    "empty" barrier only after the wait that follows the PV reading it,
//    so the producer never overwrites V that a product still reads.
//  * Deadlock. A lost arrival hangs the card. Every wait has its matching
//    arrival on every path: the producer's loops walk the same tiles as
//    the consumers', the K and V rings are separate so V's late release
//    never holds K back, and the named-barrier turns are balanced
//    (warpgroup 1 hands out the first turn and keeps its last). While
//    changing the kernel, bound the spin in mbar_wait (trap after a few
//    seconds of clock64) so a lost arrival faults instead of hanging.
//  * The LSE is unchanged: natural log, 0 for a row with no visible key.
//  * Registers. setmaxnreg needs the entry count fixed by the launch
//    bounds: 384 threads at 168 (producer 40, consumers 232) or 256 threads
//    at two blocks per SM, 128 (producer 32, consumers 224).

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int STAGES = 2;

struct Params {
  // tensor maps over [B, S, H, D] (dims ordered D, H, S, B): 64-column
  // boxes under the 128-byte swizzle and 16-column boxes under the 32-byte
  // swizzle; a part the head dim does not use is left unencoded
  CUtensorMap q128, q32, k128, k32, v128, v32;
  __nv_bfloat16* o;
  float* lse;       // [B, Hq, Sq] or null
  const int* qseg;  // [B, Sq] or null
  const int* kseg;  // [B, Sk] or null
  int B, Sq, Sk, Hq, Hkv, D;
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // softmax scale · log2(e): the softmax runs in base 2
  int causal;
};

// Tile sizes and the shared-memory plan of one instantiation. A tile of
// `rows` rows is HI/64 buffers of [rows][64] (128-byte swizzle) followed by
// LO/16 buffers of [rows][16] (32-byte swizzle).
template <int NWG, int DP>
struct Cfg {
  static constexpr int BQ = 64 * NWG;  // query rows per work tile
  static constexpr int BK = 64 * NWG;  // keys per K/V tile
  static constexpr int HI = DP / 64 * 64, LO = DP % 64;
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int Q_BYTES = BQ * DP * 2;   // one Q tile (2 stages)
  static constexpr int KV_BYTES = BK * DP * 2;  // one K or V tile
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int SEG_STRIDE = BK + 2;  // ids, then their min and max
  static constexpr int SEG_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF =
      SEG_OFF + (STAGES * SEG_STRIDE * 4 + 7) / 8 * 8;
  // Q full and empty for 2 stages; K full, V full, K empty and V empty
  // for each K/V stage
  static constexpr int SMEM = BAR_OFF + 8 * (4 + 4 * STAGES) + 1024;
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0,
                "buffers stay 1024-byte aligned for the 128-byte swizzle");
  // what one block may use on an H100 (227 KB)
  static constexpr bool FITS = SMEM <= 232448;
};

// The work of one call: tiles of BQ query rows of one (head, batch), in
// the order the persistent blocks take them (block i takes tiles i,
// i + gridDim.x, ...). Causal: the last query tiles see the most keys, so
// they come first, over every head, and the cheapest tiles fill the last
// round. Otherwise the query tiles of one head are neighbours, so the
// blocks that read one K/V head run together and share it in L2.
struct Work {
  int n_qt, n_kv_all, Hq, hb, BQ, BK, Sq;
  bool causal;
  __device__ void tile(int t, int& q0, int& h, int& b, int& n_kv) const {
    int r, i;
    if (causal) {
      i = t / hb;
      r = t - i * hb;
    } else {
      r = t / n_qt;
      i = t - r * n_qt;
    }
    q0 = (causal ? n_qt - 1 - i : i) * BQ;
    h = r % Hq;
    b = r / Hq;
    n_kv = n_kv_all;
    if (causal) n_kv = min(n_kv, (min(q0 + BQ, Sq) - 1) / BK + 1);
  }
};

template <int NWG, int DP>
__global__ void __launch_bounds__(128 * (NWG + 1), NWG == 1 ? 2 : 1)
    flash_fwd_kernel(const __grid_constant__ Params p) {
  using C = Cfg<NWG, DP>;
  constexpr int BQ = C::BQ, BK = C::BK, HI = C::HI, LO = C::LO;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  int* sseg = reinterpret_cast<int*>(smem_raw + (base - raw) + C::SEG_OFF);
  const uint32_t bar_qf = base + C::BAR_OFF, bar_qe = bar_qf + 16;
  const uint32_t bar_k = bar_qe + 16, bar_v = bar_k + 8 * STAGES,
                 bar_ke = bar_v + 8 * STAGES, bar_ve = bar_ke + 8 * STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Work work{(p.Sq + BQ - 1) / BQ, (p.Sk + BK - 1) / BK, p.Hq,
                  p.Hq * p.B, BQ, BK, p.Sq, p.causal != 0};
  const int n_tiles = work.n_qt * work.hb;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_qf + 8 * s, 1);
      mbar_init(bar_qe + 8 * s, 4 * NWG);  // every consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 32);  // the K producer warp's 32 lanes
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ke + 8 * s, 4 * NWG);
      mbar_init(bar_ve + 8 * s, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ---- producer warpgroup: warp 0 loads Q, K and the kv segment ids,
    // warp 1 (one lane) loads V; the other warps leave ------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(NWG == 1 ? 32
                                                                      : 40));
    const int pw = warp - 4 * NWG;
    if (pw > 1 || (pw == 1 && lane != 0)) return;
    if (lane == 0) {
      if (HI) {
        prefetch_map(pw == 0 ? &p.q128 : &p.v128);
        if (pw == 0) prefetch_map(&p.k128);
      }
      if (LO) {
        prefetch_map(pw == 0 ? &p.q32 : &p.v32);
        if (pw == 0) prefetch_map(&p.k32);
      }
    }
    // the kv segment ids of a K tile, one per lane and 32 keys, read from
    // memory a tile ahead of their stage
    int ids[BK / 32];
    auto fetch_ids = [&](int b, int j) {
      const int* kseg = p.kseg + static_cast<long long>(b) * p.Sk;
#pragma unroll
      for (int r = 0; r < BK / 32; ++r) {
        const int c = j * BK + 32 * r + lane;
        ids[r] = c < p.Sk ? kseg[c] : 0;
      }
    };
    if (pw == 0 && p.kseg != nullptr) {
      int q0, h, b, n_kv;
      work.tile(blockIdx.x, q0, h, b, n_kv);
      fetch_ids(b, 0);
    }
    int it = 0;  // K/V tiles loaded so far: the ring position
    for (int t = blockIdx.x, tc = 0; t < n_tiles; t += gridDim.x, ++tc) {
      int q0, h, b, n_kv;
      work.tile(t, q0, h, b, n_kv);
      const int hk = h / (p.Hq / p.Hkv);
      if (pw == 1) {
        for (int j = 0; j < n_kv; ++j, ++it) {
          const int s = it % STAGES;
          mbar_wait(bar_ve + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_v + 8 * s, C::KV_BYTES);
          load_tile<DP>(base + C::V_OFF + s * C::KV_BYTES, BK, &p.v128,
                        &p.v32, bar_v + 8 * s, hk, j * BK, b);
        }
        continue;
      }
      if (lane == 0) {
        mbar_wait(bar_qe + 8 * (tc & 1), ((tc >> 1) & 1) ^ 1);
        mbar_expect_tx(bar_qf + 8 * (tc & 1), C::Q_BYTES);
        load_tile<DP>(base + (tc & 1) * C::Q_BYTES, BQ, &p.q128, &p.q32,
                      bar_qf + 8 * (tc & 1), h, q0, b);
      }
      for (int j = 0; j < n_kv; ++j, ++it) {
        const int s = it % STAGES, k0 = j * BK;
        mbar_wait(bar_ke + 8 * s, ((it / STAGES) & 1) ^ 1);
        if (p.kseg != nullptr) {
          // the tile's ids and, over the keys that exist, their min and
          // max (the consumers' "needs a mask" test); then the next tile's
          // ids, read from memory while this one computes
          int* ts = sseg + s * C::SEG_STRIDE;
          int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
          for (int r = 0; r < BK / 32; ++r) {
            ts[32 * r + lane] = ids[r];
            if (k0 + 32 * r + lane < p.Sk) {
              lo = min(lo, ids[r]);
              hi = max(hi, ids[r]);
            }
          }
          lo = __reduce_min_sync(0xffffffffu, lo);
          hi = __reduce_max_sync(0xffffffffu, hi);
          if (lane == 0) {
            ts[BK] = lo;
            ts[BK + 1] = hi;
          }
          if (j + 1 < n_kv) {
            fetch_ids(b, j + 1);
          } else if (t + static_cast<int>(gridDim.x) < n_tiles) {
            int nq0, nh, nb, nn;
            work.tile(t + gridDim.x, nq0, nh, nb, nn);
            fetch_ids(nb, 0);
          }
        }
        if (lane == 0) {
          mbar_expect_tx(bar_k + 8 * s, C::KV_BYTES);
          load_tile<DP>(base + C::K_OFF + s * C::KV_BYTES, BK, &p.k128,
                        &p.k32, bar_k + 8 * s, hk, k0, b);
        } else {
          mbar_arrive(bar_k + 8 * s);
        }
      }
      __syncwarp();
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each, 16 per warp ------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(NWG == 1 ? 224
                                                                      : 232));
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const float sl2 = p.scale_log2;
  float o_hi[HI ? HI / 2 : 1], o_lo[LO ? LO / 2 : 1];
  float sc[BK / 2];         // S of the newest tile, then its exp
  uint32_t pa[BK / 16][4];  // P of the tile before, bf16, PV's A operand
  int it = 0;               // K/V tiles consumed so far: the ring position

  // Two consumer warpgroups take turns issuing their products (named
  // barriers 1 and 2), so one's softmax runs while the other's products
  // hold the tensor cores. Warpgroup 1 hands warpgroup 0 the first turn.
  auto turn_wait = [&]() {
    if constexpr (NWG == 2)
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  };
  auto turn_pass = [&]() {
    if constexpr (NWG == 2)
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
  };
  if (wg == 1) turn_pass();
  // a stage's buffer is no longer read: one arrival per warp
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // issue O += P V, V as the MN-major B operand in its [keys, D] layout
  auto issue_pv = [&](int i) {
    const int s = i % STAGES;
    const uint32_t vb = base + C::V_OFF + s * C::KV_BYTES;
    mbar_wait(bar_v + 8 * s, (i / STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (HI > 0)
        mma_pv<HI>(o_hi, pa[kk],
                   desc(vb + kk * 16 * 128, BK * 128, 1024, SW128));
      if constexpr (LO > 0)
        mma_pv<LO>(o_lo, pa[kk],
                   desc(vb + HI * BK * 2 + kk * 16 * 32, BK * 32, 256, SW32));
    }
    wg_commit();
  };

  for (int t = blockIdx.x, tc = 0; t < n_tiles; t += gridDim.x, ++tc) {
    int q0, h, b, n_kv;
    work.tile(t, q0, h, b, n_kv);
    const int rw = q0 + 16 * warp;  // this warp's first row
    const int r0 = rw + g, r1 = r0 + 8;
    int qs0 = 0, qs1 = 0, wseg = 0;
    bool wuni = false;  // every row of the warp in one segment, wseg
    if (p.qseg != nullptr) {
      const int* qs = p.qseg + static_cast<long long>(b) * p.Sq;
      int lo = INT_MAX, hi = INT_MIN;
      if (r0 < p.Sq) {
        qs0 = qs[r0];
        lo = min(lo, qs0);
        hi = max(hi, qs0);
      }
      if (r1 < p.Sq) {
        qs1 = qs[r1];
        lo = min(lo, qs1);
        hi = max(hi, qs1);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      wuni = lo == hi;
      wseg = lo;
    }
#pragma unroll
    for (int i = 0; i < (HI ? HI / 2 : 1); ++i) o_hi[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (LO ? LO / 2 : 1); ++i) o_lo[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    // this warpgroup's 64 rows of Q: the A operand of QKᵀ
    const uint32_t qa = base + (tc & 1) * C::Q_BYTES + wg * 64 * 128;
    const uint32_t qa_lo =
        base + (tc & 1) * C::Q_BYTES + HI * BQ * 2 + wg * 64 * 32;

    // issue S = Q K_jᵀ (64 rows × BK keys, fp32, the accumulator layout)
    auto issue_qk = [&](int i) {
      const int s = i % STAGES;
      const uint32_t kb = base + C::K_OFF + s * C::KV_BYTES;
      mbar_wait(bar_k + 8 * s, (i / STAGES) & 1);
      wg_fence();
#pragma unroll
      for (int c = 0; c < HI / 64; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_qk<BK>(sc, desc(qa + c * BQ * 128 + 32 * kk, 16, 1024, SW128),
                     desc(kb + c * BK * 128 + 32 * kk, 16, 1024, SW128),
                     c + kk > 0);
#pragma unroll
      for (int c = 0; c < LO / 16; ++c)
        mma_qk<BK>(sc, desc(qa_lo + c * BQ * 32, 16, 256, SW32),
                   desc(kb + HI * BK * 2 + c * BK * 32, 16, 256, SW32),
                   HI > 0 || c > 0);
      wg_commit();
    };
    // on S_j, complete in sc: the mask where the tile needs one, the new
    // running max, sc ← exp2(scale·log2e·S − max), the row sums; returns
    // the factors that rescale what O and l hold (base 2)
    auto softmax = [&](int j, float& al0, float& al1) {
      const int k0 = j * BK, s = (it + j) % STAGES;
      const int* ts = sseg + s * C::SEG_STRIDE;
      // a warp whose rows all lie past Sq writes nothing: it skips masks
      bool need = rw < p.Sq &&
                  (k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > rw));
      if (p.kseg != nullptr && rw < p.Sq && !need)
        need = !(wuni && ts[BK] == wseg && ts[BK + 1] == wseg);
      if (need) {
        // key 8n + e (e in 0, 1) of this thread's pair is visible to row
        // r0 (r1) iff 8n + e <= lim0 (lim1), and its segment matches
        const int last0 = p.causal ? min(p.Sk - 1, r0) : p.Sk - 1;
        const int last1 = p.causal ? min(p.Sk - 1, r1) : p.Sk - 1;
        const int lim0 = last0 - k0 - 2 * t4, lim1 = last1 - k0 - 2 * t4;
        if (p.kseg != nullptr) {
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
            const int2 id = *reinterpret_cast<const int2*>(ts + 8 * n + 2 * t4);
            if (!(8 * n <= lim0 && id.x == qs0)) sc[4 * n] = -INFINITY;
            if (!(8 * n + 1 <= lim0 && id.y == qs0)) sc[4 * n + 1] = -INFINITY;
            if (!(8 * n <= lim1 && id.x == qs1)) sc[4 * n + 2] = -INFINITY;
            if (!(8 * n + 1 <= lim1 && id.y == qs1)) sc[4 * n + 3] = -INFINITY;
          }
        } else {
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
            if (8 * n > lim0) sc[4 * n] = -INFINITY;
            if (8 * n + 1 > lim0) sc[4 * n + 1] = -INFINITY;
            if (8 * n > lim1) sc[4 * n + 2] = -INFINITY;
            if (8 * n + 1 > lim1) sc[4 * n + 3] = -INFINITY;
          }
        }
      }
      release(bar_ke + 8 * s);  // K and the tile's segment ids are read
      // row maxima as a tree (independent steps); a row's 4 owner threads
      // are lanes 4g..4g+3
      float mx[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) mx[q][0] = mx[q][1] = -INFINITY;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        mx[n % 4][0] = fmaxf(mx[n % 4][0], fmaxf(sc[4 * n], sc[4 * n + 1]));
        mx[n % 4][1] =
            fmaxf(mx[n % 4][1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
      float mx0 = fmaxf(fmaxf(mx[0][0], mx[1][0]), fmaxf(mx[2][0], mx[3][0]));
      float mx1 = fmaxf(fmaxf(mx[0][1], mx[1][1]), fmaxf(mx[2][1], mx[3][1]));
      mx0 = fmaxf(m0, fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1)));
      mx1 = fmaxf(m1, fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1)));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // a row with no visible key so far keeps max -inf: subtract 0
      // instead, so every ex2 below is of -inf (→ 0) and never of NaN
      const float mu0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
      const float mu1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
      al0 = ex2(m0 * sl2 - mu0);
      al1 = ex2(m1 * sl2 - mu1);
      m0 = mx0;
      m1 = mx1;
      float ps[4][2] = {};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        sc[4 * n] = ex2(fmaf(sc[4 * n], sl2, -mu0));
        sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], sl2, -mu0));
        sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], sl2, -mu1));
        sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], sl2, -mu1));
        ps[n % 4][0] += sc[4 * n] + sc[4 * n + 1];
        ps[n % 4][1] += sc[4 * n + 2] + sc[4 * n + 3];
      }
      const float ps0 = (ps[0][0] + ps[1][0]) + (ps[2][0] + ps[3][0]);
      const float ps1 = (ps[0][1] + ps[1][1]) + (ps[2][1] + ps[3][1]);
      l0 = l0 * al0 + ps0;  // per-thread partial sums, reduced at the end
      l1 = l1 * al1 + ps1;
    };
    // once PV of the tile before has completed: rescale O, and P ← sc in
    // bf16 (S slices 2kk and 2kk+1 are the A operand of PV's k-step kk)
    auto rescale_and_pack = [&](float al0, float al1) {
#pragma unroll
      for (int i = 0; i < (HI ? HI / 2 : 1); ++i)
        o_hi[i] *= (i & 2) ? al1 : al0;
#pragma unroll
      for (int i = 0; i < (LO ? LO / 2 : 1); ++i)
        o_lo[i] *= (i & 2) ? al1 : al0;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        pa[n / 2][(n & 1) * 2] = pack_f32(sc[4 * n], sc[4 * n + 1]);
        pa[n / 2][(n & 1) * 2 + 1] = pack_f32(sc[4 * n + 2], sc[4 * n + 3]);
      }
    };

    // Software pipeline: S of tile j and the softmax of tile j run beside
    // PV of tile j − 1 on the tensor cores.
    float al0, al1;
    mbar_wait(bar_qf + 8 * (tc & 1), (tc >> 1) & 1);
    turn_wait();
    issue_qk(it);
    turn_pass();
    wg_wait<0>();
    fence_regs(sc);
    if (n_kv == 1) release(bar_qe + 8 * (tc & 1));  // Q is read
    softmax(0, al0, al1);
    rescale_and_pack(al0, al1);
    for (int j = 1; j < n_kv; ++j) {
      turn_wait();
      issue_qk(it + j);
      issue_pv(it + j - 1);
      turn_pass();
      wg_wait<1>();  // S_j is complete, PV_{j-1} may still run
      fence_regs(sc);
      if (j == n_kv - 1) release(bar_qe + 8 * (tc & 1));  // Q is read
      softmax(j, al0, al1);
      wg_wait<0>();  // PV_{j-1} is complete: O, P and V_{j-1} are free
      fence_regs(o_hi);
      fence_regs(o_lo);
      fence_regs(pa);
      release(bar_ve + 8 * ((it + j - 1) % STAGES));
      rescale_and_pack(al0, al1);
    }
    turn_wait();
    issue_pv(it + n_kv - 1);
    // every turn passed is taken: warpgroup 1 keeps its last one
    if (wg == 0 || t + static_cast<int>(gridDim.x) < n_tiles) turn_pass();
    wg_wait<0>();
    fence_regs(o_hi);
    fence_regs(o_lo);
    fence_regs(pa);
    release(bar_ve + 8 * ((it + n_kv - 1) % STAGES));
    it += n_kv;

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float i1 = l1 > 0.f ? 1.f / l1 : 0.f;
    if (p.lse != nullptr && t4 == 0) {
      // natural-log LSE of the scaled logits: m·scale·log2(e) + log2 l is
      // the base-2 one
      float* lg = p.lse + (static_cast<long long>(b) * p.Hq + h) * p.Sq;
      if (r0 < p.Sq)
        lg[r0] = l0 > 0.f ? (m0 * sl2 + log2f(l0)) * 0.6931471805599453f
                          : 0.f;
      if (r1 < p.Sq)
        lg[r1] = l1 > 0.f ? (m1 * sl2 + log2f(l1)) * 0.6931471805599453f
                          : 0.f;
    }
    __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < HI / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col < p.D) {
        if (r0 < p.Sq)
          *reinterpret_cast<uint32_t*>(og + r0 * p.o_ss + col) =
              pack_f32(o_hi[4 * n] * i0, o_hi[4 * n + 1] * i0);
        if (r1 < p.Sq)
          *reinterpret_cast<uint32_t*>(og + r1 * p.o_ss + col) =
              pack_f32(o_hi[4 * n + 2] * i1, o_hi[4 * n + 3] * i1);
      }
    }
#pragma unroll
    for (int n = 0; n < LO / 8; ++n) {
      const int col = HI + 8 * n + 2 * t4;
      if (col < p.D) {
        if (r0 < p.Sq)
          *reinterpret_cast<uint32_t*>(og + r0 * p.o_ss + col) =
              pack_f32(o_lo[4 * n] * i0, o_lo[4 * n + 1] * i0);
        if (r1 < p.Sq)
          *reinterpret_cast<uint32_t*>(og + r1 * p.o_ss + col) =
              pack_f32(o_lo[4 * n + 2] * i1, o_lo[4 * n + 3] * i1);
      }
    }
  }
}

template <int NWG, int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<NWG, DP>;
  // per device: the shared-memory limit (an attribute that must be set)
  // and how many blocks fill the card
  static int blocks[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (blocks[dev] == 0) {
    e = cudaFuncSetAttribute(flash_fwd_kernel<NWG, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flash_fwd_kernel<NWG, DP>, C::THREADS, C::SMEM);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks[dev] = sms * per_sm;
  }
  // persistent blocks: as many as fit at once, at most one per work tile
  const long long tiles =
      static_cast<long long>((p.Sq + C::BQ - 1) / C::BQ) * p.Hq * p.B;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < blocks[dev] ? tiles : blocks[dev]);
  flash_fwd_kernel<NWG, DP><<<grid, C::THREADS, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// a tile shape whose shared memory does not fit is never instantiated
template <int NWG, int DP>
cudaError_t launch_fit(const Params& p, cudaStream_t stream) {
  if constexpr (Cfg<NWG, DP>::FITS) return launch<NWG, DP>(p, stream);
  else return cudaErrorInvalidValue;
}

template <int NWG>
cudaError_t launch_dp(const Params& p, cudaStream_t stream) {
  switch ((p.D + 15) / 16) {
    case 1: return launch<NWG, 16>(p, stream);
    case 2: return launch<NWG, 32>(p, stream);
    case 3: return launch<NWG, 48>(p, stream);
    case 4: return launch<NWG, 64>(p, stream);
    case 5: return launch<NWG, 80>(p, stream);
    case 6: return launch<NWG, 96>(p, stream);
    case 7: return launch<NWG, 112>(p, stream);
    case 8: return launch<NWG, 128>(p, stream);
    case 9: return launch_fit<NWG, 144>(p, stream);
    case 10: return launch_fit<NWG, 160>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns 0 on success, else a CUDA error code (cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments or tensor maps the
// kernel does not take, a head dim above 160 or a tile shape whose shared
// memory does not fit among them). Pointers are device pointers, strides
// are in elements, lse and q_seg/kv_seg may be null. block_q (64 or 128)
// picks the tile shape: query rows per block, which is also the keys per
// K/V tile.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* q_seg,
                              const void* kv_seg,
                              int B, int Sq, int Sk, int Hq, int Hkv, int D,
                              long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              long long o_sb, long long o_ss, long long o_sh,
                              float scale, int causal, int block_q,
                              void* stream) {
  if ((q_seg == nullptr) != (kv_seg == nullptr) || D % 8 != 0 || D < 8 ||
      D > 160 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0 ||
      (block_q != 64 && block_q != 128))
    return cudaErrorInvalidValue;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorInvalidValue;
  Params p;
  const int dp = (D + 15) / 16 * 16, hi = dp / 64 * 64;
  const struct {
    CUtensorMap *m128, *m32;
    const void* ptr;
    int S, H;
    long long sb, ss, sh;
  } ops[3] = {{&p.q128, &p.q32, q, Sq, Hq, q_sb, q_ss, q_sh},
              {&p.k128, &p.k32, k, Sk, Hkv, k_sb, k_ss, k_sh},
              {&p.v128, &p.v32, v, Sk, Hkv, v_sb, v_ss, v_sh}};
  for (const auto& op : ops) {
    if (hi > 0 && !encode(fn, op.m128, op.ptr, B, op.S, op.H, D, op.sb, op.ss,
                          op.sh, 64, block_q, CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
    if (dp > hi && !encode(fn, op.m32, op.ptr, B, op.S, op.H, D, op.sb, op.ss,
                           op.sh, 16, block_q, CU_TENSOR_MAP_SWIZZLE_32B))
      return cudaErrorInvalidValue;
  }
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.qseg = static_cast<const int*>(q_seg);
  p.kseg = static_cast<const int*>(kv_seg);
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.Hkv = Hkv; p.D = D;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return block_q == 128 ? launch_dp<2>(p, st) : launch_dp<1>(p, st);
}
