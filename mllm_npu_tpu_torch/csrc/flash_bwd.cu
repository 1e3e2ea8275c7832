// K2 and K3: flash-attention backward for Hopper (bf16 in and out, fp32
// softmax and accumulation): TMA loads into mbarrier rings, wgmma for every
// product, a producer warp feeding a consumer warpgroup.
//
// Replace the Pallas TPU kernels mllm_npu_tpu/ops/flash_attention.py:333
// `_bwd_dq_kernel` (K2, launched through `pl.pallas_call` :572) and :407
// `_bwd_dkv_kernel` (K3, :640), both from `_bwd` :502. Python wrappers,
// regime choice and plain PyTorch versions:
// mllm_npu_tpu_torch/ops/flash_attention.py (flash_bwd_dq, flash_bwd_dkv,
// k23_regime, flash_bwd_*_reference).
//
// What they compute, per (batch, query head h, KV head hk = h·Hkv/Hq), with
// P recomputed from the forward's natural-log LSE (K1 writes it) and K1's
// masks (top-left causal, segment ids, the ragged tail in Sq and Sk):
//   P   = exp(scale·Q Kᵀ − lse)      (0 where masked), in base 2 here
//   dP  = dO Vᵀ
//   dS  = P ∘ (dP − δ),  δ = rowsum(dO ∘ O) (computed by the wrapper)
//   K2: dQ = scale · dS K
//   K3: dV = Σ_h Pᵀ dO,  dK = scale · Σ_h dSᵀ Q, summed over the G = Hq/Hkv
//       query heads of each KV head inside the block.
// A row whose keys are all masked has lse 0 and P 0, so its gradients are
// 0, never NaN. No atomics and a fixed order of every sum: a repeat is
// bit-identical (the reason the backward is split in two kernels).
//
// What bounds them on an H100 (989 TFLOP/s bf16, 3.35 TB/s). K2 does 3
// and K3 4 products of 2·D flops per visible (query, key) pair per query
// head; each reads Q, K, V, dO, the LSE and δ once and writes dQ (K2) or
// dK and dV (K3). At the Llama training layer (B8 S600 H32/8 D128, causal,
// two packed segments) that is 17.8 / 23.7 GFLOP against ~0.14 / 0.12 GB:
// the bytes bound them at 0.042 / 0.036 ms, the flops at 0.018 / 0.024 ms.
// At the resampler (B56, 64 × 729 keys, H32, D128) K and V (334 MB each)
// and K3's dK and dV dominate: 0.23 / 0.42 ms of bytes. So the Llama layer
// needs the tensor cores kept busy on the tiles the masks keep, and the
// resampler needs K and V read, and dK and dV written, at the memory's
// rate.
//
// Design (the Hopper regime, head dims 32 to 256):
//  * Persistent blocks of 256 threads, two per SM, as many as fit (at most
//    one per work tile), each walking work tiles i, i + gridDim.x, ... K2's
//    work tile is 64 query rows of one (batch, query head); causal, the
//    last query tiles (the most keys) come first over every head. K3's is
//    64 keys of one (batch, KV head); causal, the first key tiles (the most
//    query tiles) come first.
//  * Warp specialisation. The second warpgroup is the producer (setmaxnreg
//    32); only its first warp works. K2: it loads Q and dO once per work
//    tile and streams the 64-key K/V tiles through a 2-stage ring. K3: it
//    loads K and V once per work tile and streams (query tile, query head)
//    pairs of Q and dO through a 2-stage ring. Every operand load is TMA;
//    each buffer has a "full" mbarrier (the TMA bytes, and for a ring stage
//    the producer warp's 32 lanes, which also write the stage's metadata)
//    and an "empty" one that each consumer warp arrives on once the
//    products that read it have completed. The other block on the SM
//    covers one block's work-tile boundary (the next Q or K/V loads only
//    once this tile's are released).
//  * One consumer warpgroup (setmaxnreg 224) owns the work tile's 64 rows,
//    16 a warp. All products are wgmma m64nNk16 with fp32 accumulators:
//      K2  S = Q·Kᵀ, dP = dO·Vᵀ: A and B K-major from shared memory (N 64);
//          dQ += dS·K: dS rounded to bf16 in registers is the register A
//          operand (the accumulator layout packs into it with no shuffle,
//          as K1's P), K the MN-major B from the same tile (as K1 reads V).
//      K3  Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ (N 64 query columns); dV += Pᵀ·dO and
//          dK += dSᵀ·Q with Pᵀ and dSᵀ as register A operands and dO and Q
//          as MN-major B operands from the stage the first two read.
//    dQ (K2) and dK, dV (K3) stay in fp32 registers across the work tile,
//    through every kept K/V tile (K2) or every pair of the group (K3), and
//    are written once. No scalar loads of any operand.
//    Two consumer warpgroups per block (128-row work tiles, one block per
//    SM, the next tile's resident operands double-buffered, a 3-stage K2
//    ring) were built and timed at the four training shapes: never faster,
//    and K2 slower at the Llama layer. So one.
//  * Order of issue: the two K-major products, wait, the elementwise work,
//    then the register-A products, wait, release. No instruction defines a
//    wgmma input register while a product that reads it is in flight, so
//    ptxas keeps the products pipelined (no C7513); the two blocks on an
//    SM overlap one's elementwise work with the other's products.
//  * K3 reads the LSE (times log2 e) and δ by column: the producer writes
//    the 64 values of the pair's rows into the stage, and each thread reads
//    its columns' pairs as float2 from shared memory.
//  * Masks only where needed, per warp and tile (K2: 16 query rows against
//    64 keys; K3: 16 keys against 64 query rows): the elementwise mask runs
//    only if the tile holds keys past Sk (K2) or queries past Sq (K3),
//    crosses the causal diagonal of the warp's rows, or holds a segment id
//    other than the warp's one segment (the tile's id min and max in the
//    stage); a warp wholly past Sq (K2) or Sk (K3) never masks.
//  * Tiles skipped: causal, K2 loads no K/V tile above its diagonal and K3
//    no query tile that ends before its keys start. With segment ids, a
//    tile pair whose id ranges [min, max] (over the rows below Sq and the
//    keys below Sk) are disjoint has no matching pair whatever the order of
//    the ids, so K2 skips such K/V tiles and K3 such query tiles (for every
//    head of the group); the producer decides and marks the last tile it
//    sends, and if it keeps none it sends the last one, which the mask
//    zeroes. The skipped tiles contribute exactly 0: no value changes.
//  * The epilogue: in the 64-column part of the head dim the four threads
//    of a quad exchange their pairs by shuffles, so each stores 16
//    contiguous bytes and a warp's store fills whole 32-byte sectors
//    (stored 4 bytes at a time, half a sector a store, dK and dV held K3 at
//    the resampler far below its byte bound).
//  * Padding by TMA: 4-D tensor maps over [B, S, H, D] with the tensors'
//    own strides, encoded per call; rows past S and columns past D arrive
//    as zeros. The head dim is split as in K1: 64-column boxes under the
//    128-byte swizzle, then 16-column boxes under the 32-byte swizzle
//    (72 → 64 + 16, 104 → 64 + 48, 32 → 0 + 32), with K1's descriptors.
//  * GQA reads KV head h·Hkv/Hq directly; K/V are never repeated.
//
//  * Head dims 144 and 160 (SEED-X's input projector: 64 queries over 256
//    keys, 32 heads of 160). A tile is then 20 KB, so a K2 or K3 block
//    takes about 122 KB of shared memory and one block fits on an SM, not
//    two (at 144, 110 KB: two K2 blocks fit). K2 keeps its design (dQ is
//    80 fp32 a thread). K3's one consumer
//    warpgroup would hold dK and dV (2 · 80 fp32 a thread) beside Sᵀ and
//    dPᵀ (64): more than a thread's 255 registers. So above DP 128 a K3
//    block has two consumer warpgroups over the same 64 keys and ring
//    stage (384 threads; setmaxnreg 208, producer 40): the first computes
//    Sᵀ, Pᵀ and dV += Pᵀ·dO, the second Sᵀ, dPᵀ, dSᵀ and dK += dSᵀ·Q.
//    The cost: Sᵀ = K·Qᵀ is computed twice, five products a pair instead
//    of four, and the second warpgroup does three of them.
//
//  * Head dims above 160 (the reference's bench shape's 256): computed at
//    192 or 256 (padded_dp in hopper.cuh; TMA zero-fills the columns past
//    D, as the reference pads D to 256), in 64-column boxes, the register-A
//    products one m64n192k16 or m64n256k16. Six tiles of 64 × 256 bf16
//    take 192 KB (K2: Q, dO and a 2-stage K/V ring; K3: K, V and a 2-stage
//    Q/dO ring), so one block per SM. K2 keeps one consumer warpgroup: dQ
//    (128 fp32 a thread at 256) with S, dP and dS fits the 255 registers
//    every thread of a one-block launch may hold, so K2 runs no setmaxnreg
//    there. K3 keeps its dV / dK split, the consumers raised to 232
//    registers and the producer cut to 32 (of the launch bounds' 168).
//
// The mma.sync regime (namespace mma_sync, the first design of these
// kernels, unchanged): head dims below 32, chosen by shape in k23_regime.
// mma.sync m16n8k16 from cp.async double-buffered shared tiles, 4 warps a
// block, scalar B-operand gathers for the products over the sequence; it
// takes head dims 8 to 160 when forced (the card tests run every case in
// it too).
//
// Registers (ptxas, sm_90a): the Hopper instantiations up to DP 128 at
// the launch bounds' 128 (two blocks of 256 threads per SM), split by
// setmaxnreg into producer 32 and consumers 224, no C7513; K2 spills 8
// bytes at DP 96 to 128, K3 40 to 56 bytes. (At 24 / 232 K3's producer
// spilled 32 bytes; at 40 / 216 K3's consumers spilled and ran slower.)
// K3 above DP 128: 168 at the launch bounds (one block of 384 threads),
// producer 40 and consumers 208, 8 bytes spilled; K2 at DP 144 none, at
// 160 8 bytes. DP 192 / 256: K2 213 / 241 registers (one block, no
// setmaxnreg), no spill; K3 producer 32 and consumers 232, no spill at
// 192, 16 bytes at 256; no C7513.

// Develop with MLLM_NVCC_EXTRA=-DMBAR_TRAP_CYCLES=... (csrc/hopper.cuh):
// a lost mbarrier arrival then traps instead of hanging the card.

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int STAGES = 2;      // ring stages of the streamed operands
constexpr int TILE = 64;       // rows of every tile, resident or streamed
constexpr int THREADS = 256;   // one consumer warpgroup and the producer
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  // tensor maps over [B, S, H, D] (dims ordered D, H, S, B): 64-column
  // boxes under the 128-byte swizzle and 16-column boxes under the 32-byte
  // swizzle, each with the box rows its kernel streams or keeps resident
  CUtensorMap q128, q32, k128, k32, v128, v32, do128, do32;
  const float* lse;    // [B, Hq, Sq], natural log
  const float* delta;  // [B, Hq, Sq]
  const int* qseg;     // [B, Sq] or null
  const int* kseg;     // [B, Sk] or null
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, Sq, Sk, Hq, Hkv, D;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  float scale;       // softmax scale
  float scale_log2;  // scale · log2(e): P is recomputed in base 2
  int causal;
};

// the min and max over a warp of values each lane holds (INT_MAX / INT_MIN
// for a lane that holds none)
__device__ __forceinline__ void warp_range(int& lo, int& hi) {
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
}

// the segment ids of rows [r0, r0 + 32·N) of one batch row, N per lane
// (0 past S), and their range over the rows below S
template <int N>
__device__ __forceinline__ void read_ids(const int* seg, int r0, int S,
                                         int lane, int (&ids)[N], int& lo,
                                         int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int row = r0 + 32 * r + lane;
    ids[r] = row < S ? seg[row] : 0;
    if (row < S) {
      lo = min(lo, ids[r]);
      hi = max(hi, ids[r]);
    }
  }
  warp_range(lo, hi);
}

// a stage's buffer is no longer read: one arrival per warp
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The products of both kernels, for the consumer warpgroup's 64 rows:
// d (64 × 64 fp32) = A·Bᵀ with A (the resident 64-row tile) and B (a
// streamed 64-row tile), both K-major over the head dim (HI part in k-steps
// of 32 bytes, LO part one 16-column box per k-step).
template <int HI, int LO>
__device__ __forceinline__ void mma_abt(float (&d)[32], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int c = 0; c < HI / 64; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_qk<64>(d, desc(a + c * TILE * 128 + 32 * kk, 16, 1024, SW128),
                 desc(b + c * TILE * 128 + 32 * kk, 16, 1024, SW128),
                 c + kk > 0);
#pragma unroll
  for (int c = 0; c < LO / 16; ++c)
    mma_qk<64>(d,
               desc(a + HI * TILE * 2 + c * TILE * 32, 16, 256, SW32),
               desc(b + HI * TILE * 2 + c * TILE * 32, 16, 256, SW32),
               HI > 0 || c > 0);
}

// d_hi/d_lo (64 × DP fp32) += X·B with X (64 × 64 bf16) in registers, the
// A operand k-step by k-step, and B a streamed 64-row tile in its stored
// [rows, D] layout: the MN-major B (as K1 reads V)
template <int HI, int LO>
__device__ __forceinline__ void mma_xb(float (&d_hi)[HI ? HI / 2 : 1],
                                       float (&d_lo)[LO ? LO / 2 : 1],
                                       const uint32_t (&x)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    if constexpr (HI > 0)
      mma_pv<HI>(d_hi, x[kk],
                 desc(b + kk * 16 * 128, TILE * 128, 1024, SW128));
    if constexpr (LO > 0)
      mma_pv<LO>(d_lo, x[kk],
                 desc(b + HI * TILE * 2 + kk * 16 * 32, TILE * 32, 256, SW32));
  }
}

// the accumulator layout (slices of 8 columns: (g, 2t..2t+1), (g+8, ..))
// packed to bf16 as wgmma's register A operand, 16 columns a k-step
__device__ __forceinline__ void pack_a(uint32_t (&x)[4][4],
                                       const float (&v)[32]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    x[n / 2][(n & 1) * 2] = pack_f32(v[4 * n], v[4 * n + 1]);
    x[n / 2][(n & 1) * 2 + 1] = pack_f32(v[4 * n + 2], v[4 * n + 3]);
  }
}

// one of four values by a runtime index, by selects (no local memory)
__device__ __forceinline__ uint32_t pick(const uint32_t (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// rows r0 and r1 (< S) and columns < D of a 64 × DP fp32 accumulator pair
// (the accumulator layout), times `mul`, to bf16 out (row stride ss, 16-
// byte aligned rows). In the HI part the 4 threads of a quad first
// exchange their 4-byte pairs (a 4 × 4 transpose over 4 slices of 8
// columns, by shuffles), so each thread stores 16 contiguous bytes and a
// warp's store fills whole 32-byte sectors of 8 rows (stored 4 bytes at a
// time, half a sector per store, dK and dV held K3 at the resampler far
// below its byte bound). The LO part (at most 48 columns) is stored as
// it lies.
template <int HI, int LO>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ss,
                                           int r0, int r1, int S, int D,
                                           int t4,
                                           const float (&d_hi)[HI ? HI / 2 : 1],
                                           const float (&d_lo)[LO ? LO / 2 : 1],
                                           float mul) {
#pragma unroll
  for (int n0 = 0; n0 < HI / 8; n0 += 4) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // v[i]: columns 8(n0+i) + 2·t4, +1 of this thread's row
      uint32_t v[4], r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = pack_f32(d_hi[4 * (n0 + i) + 2 * half] * mul,
                        d_hi[4 * (n0 + i) + 2 * half + 1] * mul);
      // round s: lane t4 receives, from lane t4 ^ s, that lane's pair of
      // slice n0 + t4
#pragma unroll
      for (int s = 0; s < 4; ++s)
        r[s] = __shfl_xor_sync(0xffffffffu, pick(v, t4 ^ s), s);
      const int row = half ? r1 : r0, col = 8 * (n0 + t4);
      if (row < S && col < D)
        *reinterpret_cast<uint4*>(out + row * ss + col) =
            make_uint4(pick(r, t4), pick(r, 1 ^ t4), pick(r, 2 ^ t4),
                       pick(r, 3 ^ t4));
    }
  }
#pragma unroll
  for (int n = 0; n < LO / 8; ++n) {
    const int col = HI + 8 * n + 2 * t4;
    if (col < D) {
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(out + r0 * ss + col) =
            pack_f32(d_lo[4 * n] * mul, d_lo[4 * n + 1] * mul);
      if (r1 < S)
        *reinterpret_cast<uint32_t*>(out + r1 * ss + col) =
            pack_f32(d_lo[4 * n + 2] * mul, d_lo[4 * n + 3] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dQ. A work tile is 64 query rows of one (batch, query head); its K/V
// tiles of 64 keys stream through a 2-stage ring.
// ---------------------------------------------------------------------------

template <int DP>
struct Cfg2 {
  static constexpr int HI = DP / 64 * 64, LO = DP % 64;
  static constexpr int BYTES = TILE * DP * 2;  // one Q, dO, K or V tile
  static constexpr int KV_OFF = 2 * BYTES;     // after Q and dO
  // per K/V stage: the tile's kv ids, then k0, "last tile", id min, max
  static constexpr int META = TILE + 4;
  static constexpr int META_OFF = KV_OFF + STAGES * 2 * BYTES;
  static constexpr int BAR_OFF = META_OFF + (STAGES * META * 4 + 7) / 8 * 8;
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 2 * STAGES) + 1024;
  static_assert(BYTES % 1024 == 0,
                "buffers stay 1024-byte aligned for the 128-byte swizzle");
  // DP 192 and 256: one block per SM (shared memory), whose threads all
  // keep the 255 registers a thread may hold (dQ is 96 or 128 fp32 a
  // consumer thread beside S and dP), so no setmaxnreg
  static constexpr bool WIDE = DP > 160;
  static constexpr int MIN_BLOCKS = WIDE ? 1 : 2;
};

// K2's work tiles in the order the persistent blocks take them. Causal:
// the last query tiles see the most keys, so they come first over every
// head; otherwise a head's query tiles are neighbours (they share its K/V
// in L2).
struct Work2 {
  int n_qt, Hq, hb, Sq, Sk;
  bool causal;
  __device__ void tile(int t, int& q0, int& h, int& b, int& n_kv) const {
    int r, i;
    if (causal) {
      i = t / hb;
      r = t - i * hb;
      i = n_qt - 1 - i;
    } else {
      r = t / n_qt;
      i = t - r * n_qt;
    }
    q0 = i * TILE;
    h = r % Hq;
    b = r / Hq;
    n_kv = (Sk + TILE - 1) / TILE;
    if (causal) n_kv = min(n_kv, (min(q0 + TILE, Sq) - 1) / TILE + 1);
  }
};

template <int DP>
__global__ void __launch_bounds__(THREADS, Cfg2<DP>::MIN_BLOCKS)
    flash_bwd_dq_kernel(const __grid_constant__ Params p) {
  using C = Cfg2<DP>;
  constexpr int HI = C::HI, LO = C::LO;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  int* meta = reinterpret_cast<int*>(smem_raw + (base - raw) + C::META_OFF);
  const uint32_t bar_qf = base + C::BAR_OFF, bar_qe = bar_qf + 8,
                 bar_kf = bar_qe + 8, bar_ke = bar_kf + 8 * STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Work2 work{(p.Sq + TILE - 1) / TILE, p.Hq, p.Hq * p.B, p.Sq, p.Sk,
                   p.causal != 0};
  const int n_tiles = work.n_qt * work.hb;

  if (tid == 0) {
    mbar_init(bar_qf, 1);
    mbar_init(bar_qe, 4);  // every consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_kf + 8 * s, 32);  // the producer warp's 32 lanes
      mbar_init(bar_ke + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4) {
    // ---- producer: its first warp loads Q, dO, K, V and the kv ids ----
    if constexpr (!C::WIDE)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    if (warp > 4) return;
    if (lane == 0) {
      if (HI) {
        prefetch_map(&p.q128);
        prefetch_map(&p.do128);
        prefetch_map(&p.k128);
        prefetch_map(&p.v128);
      }
      if (LO) {
        prefetch_map(&p.q32);
        prefetch_map(&p.do32);
        prefetch_map(&p.k32);
        prefetch_map(&p.v32);
      }
    }
    int it = 0;  // K/V tiles sent so far: the ring position
    for (int t = blockIdx.x, tc = 0; t < n_tiles; t += gridDim.x, ++tc) {
      int q0, h, b, n_kv;
      work.tile(t, q0, h, b, n_kv);
      const int hk = h / (p.Hq / p.Hkv);
      const int* qs = p.qseg ? p.qseg + static_cast<long long>(b) * p.Sq
                             : nullptr;
      const int* ks = p.kseg ? p.kseg + static_cast<long long>(b) * p.Sk
                             : nullptr;
      int qlo = 0, qhi = 0;
      if (qs != nullptr) {
        int ids[TILE / 32];
        read_ids<TILE / 32>(qs, q0, p.Sq, lane, ids, qlo, qhi);
      }
      if (lane == 0) {
        mbar_wait(bar_qe, (tc & 1) ^ 1);
        mbar_expect_tx(bar_qf, 2 * C::BYTES);
        load_tile<DP>(base, TILE, &p.q128, &p.q32, bar_qf, h, q0, b);
        load_tile<DP>(base + C::BYTES, TILE, &p.do128, &p.do32, bar_qf, h,
                      q0, b);
      }
      // one K/V tile into the ring, with its ids, k0, whether it is the
      // work tile's last, and the ids' range
      auto send = [&](int j, bool last) {
        const int s = it % STAGES;
        int* m = meta + s * C::META;
        mbar_wait(bar_ke + 8 * s, ((it / STAGES) & 1) ^ 1);
        if (ks != nullptr) {
          int ids[TILE / 32], lo, hi;
          read_ids<TILE / 32>(ks, j * TILE, p.Sk, lane, ids, lo, hi);
#pragma unroll
          for (int r = 0; r < TILE / 32; ++r) m[32 * r + lane] = ids[r];
          if (lane == 0) {
            m[TILE + 2] = lo;
            m[TILE + 3] = hi;
          }
        }
        if (lane == 0) {
          m[TILE] = j * TILE;
          m[TILE + 1] = last;
          const uint32_t kb = base + C::KV_OFF + s * 2 * C::BYTES;
          mbar_expect_tx(bar_kf + 8 * s, 2 * C::BYTES);
          load_tile<DP>(kb, TILE, &p.k128, &p.k32, bar_kf + 8 * s, hk,
                        j * TILE, b);
          load_tile<DP>(kb + C::BYTES, TILE, &p.v128, &p.v32, bar_kf + 8 * s,
                        hk, j * TILE, b);
        } else {
          mbar_arrive(bar_kf + 8 * s);
        }
        ++it;
      };
      // The K/V tiles up to the causal bound, less those whose kv-id range
      // is disjoint from the work tile's q-id range (no pair can match).
      // Each is sent once the next kept one is known, so that the last is
      // marked; if none is kept, the last tile is (its mask zeroes it).
      int pend = -1;
      for (int j = 0; j < n_kv; ++j) {
        if (ks != nullptr) {
          int ids[TILE / 32], lo, hi;
          read_ids<TILE / 32>(ks, j * TILE, p.Sk, lane, ids, lo, hi);
          if ((hi < qlo || lo > qhi) && !(j == n_kv - 1 && pend < 0))
            continue;
        }
        if (pend >= 0) send(pend, false);
        pend = j;
      }
      send(pend, true);
      __syncwarp();
    }
    return;
  }

  // ---- the consumer warpgroup: 64 query rows, 16 a warp ----------------
  if constexpr (!C::WIDE)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int g = lane / 4, t4 = lane % 4;
  const float sl2 = p.scale_log2;
  float dq_hi[HI ? HI / 2 : 1], dq_lo[LO ? LO / 2 : 1];
  float sc[32], dp[32];  // S and dP of the current K/V tile, then P and dS
  uint32_t da[4][4];     // dS in bf16: the A operand of dQ += dS·K
  int it = 0;            // K/V tiles consumed so far: the ring position
  for (int t = blockIdx.x, tc = 0; t < n_tiles; t += gridDim.x, ++tc) {
    int q0, h, b, n_kv;
    work.tile(t, q0, h, b, n_kv);
    const int rw = q0 + 16 * warp;  // this warp's first row
    const int r0 = rw + g, r1 = r0 + 8;
    const long long rb = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
    const float lse0 = r0 < p.Sq ? p.lse[rb + r0] * LOG2E : 0.f;
    const float lse1 = r1 < p.Sq ? p.lse[rb + r1] * LOG2E : 0.f;
    const float dl0 = r0 < p.Sq ? p.delta[rb + r0] : 0.f;
    const float dl1 = r1 < p.Sq ? p.delta[rb + r1] : 0.f;
    int qs0 = 0, qs1 = 0, wseg = 0;
    bool wuni = false;  // every row of the warp below Sq in segment wseg
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
      warp_range(lo, hi);
      wuni = lo == hi;
      wseg = lo;
    }
    // key 8n + e (e in 0, 1) of this thread's pair is visible to row r0
    // (r1) iff 8n + e <= lim0 (lim1) and its segment matches
    const int last0 = p.causal ? min(p.Sk - 1, r0) : p.Sk - 1;
    const int last1 = p.causal ? min(p.Sk - 1, r1) : p.Sk - 1;
#pragma unroll
    for (int i = 0; i < (HI ? HI / 2 : 1); ++i) dq_hi[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (LO ? LO / 2 : 1); ++i) dq_lo[i] = 0.f;
    mbar_wait(bar_qf, tc & 1);
    for (;;) {
      const int s = it % STAGES;
      const int* m = meta + s * C::META;
      const uint32_t kb = base + C::KV_OFF + s * 2 * C::BYTES;
      mbar_wait(bar_kf + 8 * s, (it / STAGES) & 1);
      const int k0 = m[TILE], last = m[TILE + 1];
      // S = Q·Kᵀ and dP = dO·Vᵀ
      wg_fence();
      mma_abt<HI, LO>(sc, base, kb);
      mma_abt<HI, LO>(dp, base + C::BYTES, kb + C::BYTES);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // P = exp2(S·scale·log2e − lse) where visible, dS = P∘(dP − δ); the
      // mask only where the tile needs one (a warp past Sq never does)
      bool need = rw < p.Sq &&
                  (k0 + TILE > p.Sk || (p.causal && k0 + TILE - 1 > rw));
      if (p.kseg != nullptr && rw < p.Sq && !need)
        need = !(wuni && m[TILE + 2] == wseg && m[TILE + 3] == wseg);
      if (need) {
        const int lim0 = last0 - k0 - 2 * t4, lim1 = last1 - k0 - 2 * t4;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          int2 id = make_int2(qs0, qs1);
          if (p.kseg != nullptr)
            id = *reinterpret_cast<const int2*>(m + 8 * n + 2 * t4);
          const bool v0 = 8 * n <= lim0 && id.x == qs0;
          const bool v1 = 8 * n + 1 <= lim0 && id.y == qs0;
          const bool v2 = 8 * n <= lim1 && id.x == qs1;
          const bool v3 = 8 * n + 1 <= lim1 && id.y == qs1;
          sc[4 * n] = v0 ? ex2(fmaf(sc[4 * n], sl2, -lse0)) : 0.f;
          sc[4 * n + 1] = v1 ? ex2(fmaf(sc[4 * n + 1], sl2, -lse0)) : 0.f;
          sc[4 * n + 2] = v2 ? ex2(fmaf(sc[4 * n + 2], sl2, -lse1)) : 0.f;
          sc[4 * n + 3] = v3 ? ex2(fmaf(sc[4 * n + 3], sl2, -lse1)) : 0.f;
        }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          sc[4 * n] = ex2(fmaf(sc[4 * n], sl2, -lse0));
          sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], sl2, -lse0));
          sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], sl2, -lse1));
          sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], sl2, -lse1));
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        dp[4 * n] = sc[4 * n] * (dp[4 * n] - dl0);
        dp[4 * n + 1] = sc[4 * n + 1] * (dp[4 * n + 1] - dl0);
        dp[4 * n + 2] = sc[4 * n + 2] * (dp[4 * n + 2] - dl1);
        dp[4 * n + 3] = sc[4 * n + 3] * (dp[4 * n + 3] - dl1);
      }
      pack_a(da, dp);
      // dQ += dS·K, K as the MN-major B from the same tile
      wg_fence();
      mma_xb<HI, LO>(dq_hi, dq_lo, da, kb);
      wg_commit();
      wg_wait<0>();
      fence_regs(dq_hi);
      fence_regs(dq_lo);
      fence_regs(da);
      release(bar_ke + 8 * s, lane);  // K, V and the ids are read
      ++it;
      if (last) break;
    }
    release(bar_qe, lane);  // Q and dO are read
    store_rows<HI, LO>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, r0, r1,
                       p.Sq, p.D, t4, dq_hi, dq_lo, p.scale);
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV. A work tile is 64 keys of one (batch, KV head), resident;
// the (query tile, query head of the group) pairs stream Q, dO, the LSE, δ
// and the q ids through a 2-stage ring.
// ---------------------------------------------------------------------------

template <int DP>
struct Cfg3 {
  static constexpr int HI = DP / 64 * 64, LO = DP % 64;
  static constexpr int BYTES = TILE * DP * 2;  // one K, V, Q or dO tile
  static constexpr int Q_OFF = 2 * BYTES;      // after K and V
  // per Q stage: lse·log2e, δ and the q ids of the tile's 64 rows, then
  // q0, "last pair", id min, max
  static constexpr int META = 3 * TILE + 4;
  static constexpr int META_OFF = Q_OFF + STAGES * 2 * BYTES;
  static constexpr int BAR_OFF = META_OFF + (STAGES * META * 4 + 7) / 8 * 8;
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 2 * STAGES) + 1024;
  static_assert(BYTES % 1024 == 0,
                "buffers stay 1024-byte aligned for the 128-byte swizzle");
  // consumer warpgroups: one holds dK and dV up to DP = 128; above, dV's
  // and dK's accumulators (80 fp32 a thread each at DP = 160) with Sᵀ and
  // dPᵀ would pass a thread's registers, so one warpgroup holds dV and
  // recomputes Sᵀ for it, the other dK (dk_dv_split below)
  static constexpr int CW = DP > 128 ? 2 : 1;
  static constexpr int THREADS = 128 * (CW + 1);
  // setmaxnreg from the launch bounds' 168 (384 threads) or 128 (256):
  // at DP 192 and 256 (dV or dK 96 or 128 fp32 a thread beside Sᵀ, dPᵀ and
  // dSᵀ) the consumers take 232 and the producer 32, else 208 and 40; one
  // consumer warpgroup 224 and the producer 32
  static constexpr int CONSUMER_REGS = CW == 1 ? 224 : DP > 160 ? 232 : 208;
  static constexpr int PRODUCER_REGS = CW == 1 || DP > 160 ? 32 : 40;
};

// K3's work tiles in the order the persistent blocks take them. Causal:
// the first key tiles see the most query tiles, so they come first over
// every head; otherwise a head's key tiles are neighbours (they share its
// queries in L2).
struct Work3 {
  int n_kt, Hkv, hb;
  bool causal;
  __device__ void tile(int t, int& k0, int& hk, int& b) const {
    int r, i;
    if (causal) {
      i = t / hb;
      r = t - i * hb;
    } else {
      r = t / n_kt;
      i = t - r * n_kt;
    }
    k0 = i * TILE;
    hk = r % Hkv;
    b = r / Hkv;
  }
};

// DP > 128, one of the two consumer warpgroups of a K3 block (the other
// holds the other accumulator): 64 keys, 16 a warp (`wi`). DK false: Sᵀ,
// Pᵀ and dV += Pᵀ·dO; DK true: Sᵀ and dPᵀ, dSᵀ and dK += dSᵀ·Q. Both wait
// on the same ring stage and release it, with the walk, masks and stores
// of the one-warpgroup consumer.
template <int DP, bool DK>
__device__ __forceinline__ void dk_dv_split(const Params& p, const Work3& work,
                                            int n_tiles, uint32_t base,
                                            const int* meta, uint32_t bar_kf,
                                            uint32_t bar_ke, uint32_t bar_qf,
                                            uint32_t bar_qe, int wi,
                                            int lane) {
  using C = Cfg3<DP>;
  constexpr int HI = C::HI, LO = C::LO;
  const int g = lane / 4, t4 = lane % 4;
  const float sl2 = p.scale_log2;
  float acc_hi[HI / 2], acc_lo[LO ? LO / 2 : 1];
  float st[32], dpt[DK ? 32 : 1];  // Sᵀ (then Pᵀ) and dPᵀ (then dSᵀ)
  uint32_t xa[4][4];               // Pᵀ or dSᵀ in bf16: the A operand
  int it = 0;                      // pairs consumed so far
  for (int t = blockIdx.x, tc = 0; t < n_tiles; t += gridDim.x, ++tc) {
    int k0, hk, b;
    work.tile(t, k0, hk, b);
    const int kw = k0 + 16 * wi;  // this warp's first key
    const int c0 = kw + g, c1 = c0 + 8;
    int ks0 = 0, ks1 = 0, wseg = 0;
    bool wuni = false;
    if (p.kseg != nullptr) {
      const int* ks = p.kseg + static_cast<long long>(b) * p.Sk;
      int lo = INT_MAX, hi = INT_MIN;
      if (c0 < p.Sk) {
        ks0 = ks[c0];
        lo = min(lo, ks0);
        hi = max(hi, ks0);
      }
      if (c1 < p.Sk) {
        ks1 = ks[c1];
        lo = min(lo, ks1);
        hi = max(hi, ks1);
      }
      warp_range(lo, hi);
      wuni = lo == hi;
      wseg = lo;
    }
#pragma unroll
    for (int i = 0; i < HI / 2; ++i) acc_hi[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (LO ? LO / 2 : 1); ++i) acc_lo[i] = 0.f;
    mbar_wait(bar_kf, tc & 1);
    for (;;) {
      const int s = it % STAGES;
      const int* m = meta + s * C::META;
      const float* ml = reinterpret_cast<const float*>(m);
      const uint32_t qb = base + C::Q_OFF + s * 2 * C::BYTES;
      mbar_wait(bar_qf + 8 * s, (it / STAGES) & 1);
      const int q0 = m[3 * TILE], last = m[3 * TILE + 1];
      wg_fence();
      mma_abt<HI, LO>(st, base, qb);
      if constexpr (DK) mma_abt<HI, LO>(dpt, base + C::BYTES, qb + C::BYTES);
      wg_commit();
      wg_wait<0>();
      fence_regs(st);
      if constexpr (DK) fence_regs(dpt);
      bool need = kw < p.Sk &&
                  (q0 + TILE > p.Sq || (p.causal && kw + 15 > q0));
      if (p.qseg != nullptr && kw < p.Sk && !need)
        need = !(wuni && m[3 * TILE + 2] == wseg && m[3 * TILE + 3] == wseg);
      const int hi_c = p.Sq - q0 - 2 * t4;
      const int lo0 = (p.causal ? c0 - q0 : 0) - 2 * t4;
      const int lo1 = (p.causal ? c1 - q0 : 0) - 2 * t4;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(ml + 8 * n + 2 * t4);
        float e0 = ex2(fmaf(st[4 * n], sl2, -l.x));
        float e1 = ex2(fmaf(st[4 * n + 1], sl2, -l.y));
        float e2 = ex2(fmaf(st[4 * n + 2], sl2, -l.x));
        float e3 = ex2(fmaf(st[4 * n + 3], sl2, -l.y));
        if (need) {
          int2 id = make_int2(ks0, ks1);
          if (p.qseg != nullptr)
            id = *reinterpret_cast<const int2*>(m + 2 * TILE + 8 * n + 2 * t4);
          if (!(8 * n >= lo0 && 8 * n < hi_c && id.x == ks0)) e0 = 0.f;
          if (!(8 * n + 1 >= lo0 && 8 * n + 1 < hi_c && id.y == ks0)) e1 = 0.f;
          if (!(8 * n >= lo1 && 8 * n < hi_c && id.x == ks1)) e2 = 0.f;
          if (!(8 * n + 1 >= lo1 && 8 * n + 1 < hi_c && id.y == ks1)) e3 = 0.f;
        }
        if constexpr (DK) {
          const float2 dl =
              *reinterpret_cast<const float2*>(ml + TILE + 8 * n + 2 * t4);
          dpt[4 * n] = e0 * (dpt[4 * n] - dl.x);
          dpt[4 * n + 1] = e1 * (dpt[4 * n + 1] - dl.y);
          dpt[4 * n + 2] = e2 * (dpt[4 * n + 2] - dl.x);
          dpt[4 * n + 3] = e3 * (dpt[4 * n + 3] - dl.y);
        } else {
          st[4 * n] = e0;
          st[4 * n + 1] = e1;
          st[4 * n + 2] = e2;
          st[4 * n + 3] = e3;
        }
      }
      if constexpr (DK) pack_a(xa, dpt);
      else pack_a(xa, st);
      // dK += dSᵀ·Q or dV += Pᵀ·dO, Q or dO the MN-major B from the stage
      wg_fence();
      mma_xb<HI, LO>(acc_hi, acc_lo, xa, DK ? qb : qb + C::BYTES);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc_hi);
      fence_regs(acc_lo);
      fence_regs(xa);
      release(bar_qe + 8 * s, lane);
      ++it;
      if (last) break;
    }
    release(bar_ke, lane);
    if constexpr (DK)
      store_rows<HI, LO>(p.dk + b * p.dk_sb + hk * p.dk_sh, p.dk_ss, c0, c1,
                         p.Sk, p.D, t4, acc_hi, acc_lo, p.scale);
    else
      store_rows<HI, LO>(p.dv + b * p.dv_sb + hk * p.dv_sh, p.dv_ss, c0, c1,
                         p.Sk, p.D, t4, acc_hi, acc_lo, 1.f);
  }
}

template <int DP>
__global__ void __launch_bounds__(Cfg3<DP>::THREADS, 3 - Cfg3<DP>::CW)
    flash_bwd_dkv_kernel(const __grid_constant__ Params p) {
  using C = Cfg3<DP>;
  constexpr int HI = C::HI, LO = C::LO, CW = C::CW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  int* meta = reinterpret_cast<int*>(smem_raw + (base - raw) + C::META_OFF);
  const uint32_t bar_kf = base + C::BAR_OFF, bar_ke = bar_kf + 8,
                 bar_qf = bar_ke + 8, bar_qe = bar_qf + 8 * STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = p.Hq / p.Hkv;
  const int nq = (p.Sq + TILE - 1) / TILE;
  const Work3 work{(p.Sk + TILE - 1) / TILE, p.Hkv, p.Hkv * p.B,
                   p.causal != 0};
  const int n_tiles = work.n_kt * work.hb;

  if (tid == 0) {
    mbar_init(bar_kf, 1);
    mbar_init(bar_ke, 4 * CW);  // every consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_qf + 8 * s, 32);  // the producer warp's 32 lanes
      mbar_init(bar_qe + 8 * s, 4 * CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CW) {
    // ---- producer: its first warp loads K, V, then Q, dO, the LSE, δ and
    // the q ids of every pair ------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     C::PRODUCER_REGS) : "memory");
    if (warp > 4 * CW) return;
    if (lane == 0) {
      if (HI) {
        prefetch_map(&p.q128);
        prefetch_map(&p.do128);
        prefetch_map(&p.k128);
        prefetch_map(&p.v128);
      }
      if (LO) {
        prefetch_map(&p.q32);
        prefetch_map(&p.do32);
        prefetch_map(&p.k32);
        prefetch_map(&p.v32);
      }
    }
    int it = 0;  // pairs sent so far: the ring position
    for (int t = blockIdx.x, tc = 0; t < n_tiles; t += gridDim.x, ++tc) {
      int k0, hk, b;
      work.tile(t, k0, hk, b);
      const int* qs = p.qseg ? p.qseg + static_cast<long long>(b) * p.Sq
                             : nullptr;
      int klo = 0, khi = 0;
      if (qs != nullptr) {
        int ids[TILE / 32];
        read_ids<TILE / 32>(p.kseg + static_cast<long long>(b) * p.Sk, k0,
                            p.Sk, lane, ids, klo, khi);
      }
      if (lane == 0) {
        mbar_wait(bar_ke, (tc & 1) ^ 1);
        mbar_expect_tx(bar_kf, 2 * C::BYTES);
        load_tile<DP>(base, TILE, &p.k128, &p.k32, bar_kf, hk, k0, b);
        load_tile<DP>(base + C::BYTES, TILE, &p.v128, &p.v32, bar_kf, hk, k0,
                      b);
      }
      // one (query tile i, head of the group g) pair into the ring
      auto send = [&](int i, int g, bool last) {
        const int s = it % STAGES, h = hk * G + g;
        int* m = meta + s * C::META;
        float* ml = reinterpret_cast<float*>(m);
        mbar_wait(bar_qe + 8 * s, ((it / STAGES) & 1) ^ 1);
        const long long rb = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
#pragma unroll
        for (int r = 0; r < TILE / 32; ++r) {
          const int row = i * TILE + 32 * r + lane;
          ml[32 * r + lane] = row < p.Sq ? p.lse[rb + row] * LOG2E : 0.f;
          ml[TILE + 32 * r + lane] = row < p.Sq ? p.delta[rb + row] : 0.f;
        }
        if (qs != nullptr) {
          int ids[TILE / 32], lo, hi;
          read_ids<TILE / 32>(qs, i * TILE, p.Sq, lane, ids, lo, hi);
#pragma unroll
          for (int r = 0; r < TILE / 32; ++r) m[2 * TILE + 32 * r + lane] = ids[r];
          if (lane == 0) {
            m[3 * TILE + 2] = lo;
            m[3 * TILE + 3] = hi;
          }
        }
        if (lane == 0) {
          m[3 * TILE] = i * TILE;
          m[3 * TILE + 1] = last;
          const uint32_t qb = base + C::Q_OFF + s * 2 * C::BYTES;
          mbar_expect_tx(bar_qf + 8 * s, 2 * C::BYTES);
          load_tile<DP>(qb, TILE, &p.q128, &p.q32, bar_qf + 8 * s, h,
                        i * TILE, b);
          load_tile<DP>(qb + C::BYTES, TILE, &p.do128, &p.do32,
                        bar_qf + 8 * s, h, i * TILE, b);
        } else {
          mbar_arrive(bar_qf + 8 * s);
        }
        ++it;
      };
      // The query tiles from the causal bound on (at least the last one),
      // less those whose q-id range is disjoint from the work tile's kv-id
      // range; each kept tile once per query head of the group. A pair is
      // sent once the next kept one is known, so that the last is marked;
      // if none is kept, the last tile is (its mask zeroes it).
      int pi = -1, pg = 0;
      for (int i = p.causal ? min(k0 / TILE, nq - 1) : 0; i < nq; ++i) {
        if (qs != nullptr) {
          int ids[TILE / 32], lo, hi;
          read_ids<TILE / 32>(qs, i * TILE, p.Sq, lane, ids, lo, hi);
          if ((hi < klo || lo > khi) && !(i == nq - 1 && pi < 0)) continue;
        }
        for (int g = 0; g < G; ++g) {
          if (pi >= 0) send(pi, pg, false);
          pi = i;
          pg = g;
        }
      }
      send(pi, pg, true);
      __syncwarp();
    }
    return;
  }

  if constexpr (CW == 2) {
    // ---- two consumer warpgroups: dV (warps 0-3) and dK (4-7) ----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     C::CONSUMER_REGS) : "memory");
    if (warp < 4)
      dk_dv_split<DP, false>(p, work, n_tiles, base, meta, bar_kf, bar_ke,
                             bar_qf, bar_qe, warp, lane);
    else
      dk_dv_split<DP, true>(p, work, n_tiles, base, meta, bar_kf, bar_ke,
                            bar_qf, bar_qe, warp - 4, lane);
    return;
  }

  // ---- the consumer warpgroup: 64 keys, 16 a warp ----------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                   C::CONSUMER_REGS) : "memory");
  const int g = lane / 4, t4 = lane % 4;
  const float sl2 = p.scale_log2;
  float dk_hi[HI ? HI / 2 : 1], dk_lo[LO ? LO / 2 : 1];
  float dv_hi[HI ? HI / 2 : 1], dv_lo[LO ? LO / 2 : 1];
  float st[32], dpt[32];  // Sᵀ and dPᵀ of the current pair, then Pᵀ, dSᵀ
  uint32_t pa[4][4], da[4][4];  // Pᵀ and dSᵀ in bf16: the A operands
  int it = 0;                   // pairs consumed so far: the ring position
  for (int t = blockIdx.x, tc = 0; t < n_tiles; t += gridDim.x, ++tc) {
    int k0, hk, b;
    work.tile(t, k0, hk, b);
    const int kw = k0 + 16 * warp;  // this warp's first key
    const int c0 = kw + g, c1 = c0 + 8;
    int ks0 = 0, ks1 = 0, wseg = 0;
    bool wuni = false;  // every key of the warp below Sk in segment wseg
    if (p.kseg != nullptr) {
      const int* ks = p.kseg + static_cast<long long>(b) * p.Sk;
      int lo = INT_MAX, hi = INT_MIN;
      if (c0 < p.Sk) {
        ks0 = ks[c0];
        lo = min(lo, ks0);
        hi = max(hi, ks0);
      }
      if (c1 < p.Sk) {
        ks1 = ks[c1];
        lo = min(lo, ks1);
        hi = max(hi, ks1);
      }
      warp_range(lo, hi);
      wuni = lo == hi;
      wseg = lo;
    }
#pragma unroll
    for (int i = 0; i < (HI ? HI / 2 : 1); ++i) dk_hi[i] = dv_hi[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (LO ? LO / 2 : 1); ++i) dk_lo[i] = dv_lo[i] = 0.f;
    mbar_wait(bar_kf, tc & 1);
    for (;;) {
      const int s = it % STAGES;
      const int* m = meta + s * C::META;
      const float* ml = reinterpret_cast<const float*>(m);
      const uint32_t qb = base + C::Q_OFF + s * 2 * C::BYTES;
      mbar_wait(bar_qf + 8 * s, (it / STAGES) & 1);
      const int q0 = m[3 * TILE], last = m[3 * TILE + 1];
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
      wg_fence();
      mma_abt<HI, LO>(st, base, qb);
      mma_abt<HI, LO>(dpt, base + C::BYTES, qb + C::BYTES);
      wg_commit();
      wg_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      // Pᵀ = exp2(Sᵀ·scale·log2e − lse of each query column) where
      // visible, dSᵀ = Pᵀ∘(dPᵀ − δ of each column); the mask only where
      // the pair needs one (a warp past Sk never does)
      bool need = kw < p.Sk &&
                  (q0 + TILE > p.Sq || (p.causal && kw + 15 > q0));
      if (p.qseg != nullptr && kw < p.Sk && !need)
        need = !(wuni && m[3 * TILE + 2] == wseg && m[3 * TILE + 3] == wseg);
      // query column 8n + e of this thread's pair is visible to key c0
      // (c1) iff lo0 <= 8n + e < hi (lo1 <= ...) and its segment matches
      const int hi_c = p.Sq - q0 - 2 * t4;
      const int lo0 = (p.causal ? c0 - q0 : 0) - 2 * t4;
      const int lo1 = (p.causal ? c1 - q0 : 0) - 2 * t4;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(ml + 8 * n + 2 * t4);
        const float2 dl =
            *reinterpret_cast<const float2*>(ml + TILE + 8 * n + 2 * t4);
        float e0 = ex2(fmaf(st[4 * n], sl2, -l.x));
        float e1 = ex2(fmaf(st[4 * n + 1], sl2, -l.y));
        float e2 = ex2(fmaf(st[4 * n + 2], sl2, -l.x));
        float e3 = ex2(fmaf(st[4 * n + 3], sl2, -l.y));
        if (need) {
          int2 id = make_int2(ks0, ks1);
          if (p.qseg != nullptr)
            id = *reinterpret_cast<const int2*>(m + 2 * TILE + 8 * n + 2 * t4);
          if (!(8 * n >= lo0 && 8 * n < hi_c && id.x == ks0)) e0 = 0.f;
          if (!(8 * n + 1 >= lo0 && 8 * n + 1 < hi_c && id.y == ks0)) e1 = 0.f;
          if (!(8 * n >= lo1 && 8 * n < hi_c && id.x == ks1)) e2 = 0.f;
          if (!(8 * n + 1 >= lo1 && 8 * n + 1 < hi_c && id.y == ks1)) e3 = 0.f;
        }
        st[4 * n] = e0;
        st[4 * n + 1] = e1;
        st[4 * n + 2] = e2;
        st[4 * n + 3] = e3;
        dpt[4 * n] = e0 * (dpt[4 * n] - dl.x);
        dpt[4 * n + 1] = e1 * (dpt[4 * n + 1] - dl.y);
        dpt[4 * n + 2] = e2 * (dpt[4 * n + 2] - dl.x);
        dpt[4 * n + 3] = e3 * (dpt[4 * n + 3] - dl.y);
      }
      pack_a(pa, st);
      pack_a(da, dpt);
      // dV += Pᵀ·dO and dK += dSᵀ·Q, dO and Q as MN-major B operands from
      // the tiles the first two products read
      wg_fence();
      mma_xb<HI, LO>(dv_hi, dv_lo, pa, qb + C::BYTES);
      mma_xb<HI, LO>(dk_hi, dk_lo, da, qb);
      wg_commit();
      wg_wait<0>();
      fence_regs(dv_hi);
      fence_regs(dv_lo);
      fence_regs(dk_hi);
      fence_regs(dk_lo);
      fence_regs(pa);
      fence_regs(da);
      release(bar_qe + 8 * s, lane);  // Q, dO, the LSE, δ and ids are read
      ++it;
      if (last) break;
    }
    release(bar_ke, lane);  // K and V are read
    store_rows<HI, LO>(p.dk + b * p.dk_sb + hk * p.dk_sh, p.dk_ss, c0, c1,
                       p.Sk, p.D, t4, dk_hi, dk_lo, p.scale);
    store_rows<HI, LO>(p.dv + b * p.dv_sb + hk * p.dv_sh, p.dv_ss, c0, c1,
                       p.Sk, p.D, t4, dv_hi, dv_lo, 1.f);
  }
}

// Launch with persistent blocks: as many as fit on the card at once, at
// most one per work tile. The shared-memory limit (an attribute that must
// be set) and the blocks that fit are found once per device.
template <typename Kernel>
cudaError_t launch_persistent(Kernel kernel, int threads, int smem,
                              long long tiles, int (&blocks)[MAX_DEVICES],
                              const Params& p, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (blocks[dev] == 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks[dev] = sms * per_sm;
  }
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < blocks[dev] ? tiles : blocks[dev]);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  static int blocks[MAX_DEVICES] = {};
  const long long tiles =
      static_cast<long long>((p.Sq + TILE - 1) / TILE) * p.Hq * p.B;
  return launch_persistent(flash_bwd_dq_kernel<DP>, THREADS, Cfg2<DP>::SMEM,
                           tiles, blocks, p, stream);
}

template <int DP>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  static int blocks[MAX_DEVICES] = {};
  const long long tiles =
      static_cast<long long>((p.Sk + TILE - 1) / TILE) * p.Hkv * p.B;
  return launch_persistent(flash_bwd_dkv_kernel<DP>, Cfg3<DP>::THREADS,
                           Cfg3<DP>::SMEM,
                           tiles, blocks, p, stream);
}

template <bool DKV>
cudaError_t launch_dp(const Params& p, cudaStream_t stream) {
  switch (padded_dp(p.D)) {
    case 32: return DKV ? launch_dkv<32>(p, stream) : launch_dq<32>(p, stream);
    case 48: return DKV ? launch_dkv<48>(p, stream) : launch_dq<48>(p, stream);
    case 64: return DKV ? launch_dkv<64>(p, stream) : launch_dq<64>(p, stream);
    case 80: return DKV ? launch_dkv<80>(p, stream) : launch_dq<80>(p, stream);
    case 96: return DKV ? launch_dkv<96>(p, stream) : launch_dq<96>(p, stream);
    case 112:
      return DKV ? launch_dkv<112>(p, stream) : launch_dq<112>(p, stream);
    case 128:
      return DKV ? launch_dkv<128>(p, stream) : launch_dq<128>(p, stream);
    case 144:
      return DKV ? launch_dkv<144>(p, stream) : launch_dq<144>(p, stream);
    case 160:
      return DKV ? launch_dkv<160>(p, stream) : launch_dq<160>(p, stream);
    case 192:
      return DKV ? launch_dkv<192>(p, stream) : launch_dq<192>(p, stream);
    case 256:
      return DKV ? launch_dkv<256>(p, stream) : launch_dq<256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The Hopper regime's parameters: the tensor maps (boxes of 64 rows) and
// the rest. False if a map cannot be encoded.
bool make_params(Params& p, const void* q, const void* k,
                 const void* v, const void* dout, const void* lse,
                 const void* delta, const void* q_seg, const void* kv_seg,
                 void* dq, void* dk, void* dv, int B, int Sq, int Sk, int Hq,
                 int Hkv, int D, const long long* st, float scale,
                 int causal) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int dp = padded_dp(D), hi = dp / 64 * 64;
  const struct {
    CUtensorMap *m128, *m32;
    const void* ptr;
    int S, H;
    const long long* st;
  } ops[4] = {{&p.q128, &p.q32, q, Sq, Hq, st},
              {&p.k128, &p.k32, k, Sk, Hkv, st + 3},
              {&p.v128, &p.v32, v, Sk, Hkv, st + 6},
              {&p.do128, &p.do32, dout, Sq, Hq, st + 9}};
  for (const auto& op : ops) {
    if (hi > 0 && !encode(fn, op.m128, op.ptr, B, op.S, op.H, D, op.st[0],
                          op.st[1], op.st[2], 64, TILE,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return false;
    if (dp > hi && !encode(fn, op.m32, op.ptr, B, op.S, op.H, D, op.st[0],
                           op.st[1], op.st[2], 16, TILE,
                           CU_TENSOR_MAP_SWIZZLE_32B))
      return false;
  }
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.qseg = static_cast<const int*>(q_seg);
  p.kseg = static_cast<const int*>(kv_seg);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.Hkv = Hkv; p.D = D;
  p.dq_sb = st[12]; p.dq_ss = st[13]; p.dq_sh = st[14];
  p.dk_sb = st[15]; p.dk_ss = st[16]; p.dk_sh = st[17];
  p.dv_sb = st[18]; p.dv_ss = st[19]; p.dv_sh = st[20];
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  return true;
}

}  // namespace

namespace {
namespace mma_sync {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ2 = 64;   // K2: query rows per block
constexpr int BK2 = 64;   // K2: key rows per tile
constexpr int BK3 = 64;   // K3: key rows per block
constexpr int BQ3 = 32;   // K3: query rows per tile
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // [B, Hq, Sq], natural log
  const float* delta;  // [B, Hq, Sq]
  const int* qseg;     // [B, Sq] or null
  const int* kseg;     // [B, Sk] or null
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, Sq, Sk, Hq, Hkv, D;
  // element strides (batch, sequence, head) of q, k, v, do, dq, dk, dv
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  float scale;       // softmax scale
  float scale_log2;  // scale · log2(e): P is recomputed in base 2
  int causal;
};

// 16-byte async copy; src_size 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a · b, one 16×8×16 bf16 product with fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + ROWS) of a [S, D] slice (row stride ss) into a
// [ROWS][LD] shared tile; rows at or past S are zero-filled.
template <int ROWS, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int row0, int S,
                                          int D, int tid) {
  const int chunks = D / 8;
  for (int i = tid; i < ROWS * chunks; i += THREADS) {
    const int r = i / chunks, c = i - r * chunks;
    const int gr = row0 + r;
    const bool ok = gr < S;
    cp_async16(dst + r * LD + c * 8, ok ? src + gr * ss + c * 8 : src, ok);
  }
}

// zero the head-dim padding columns [D, DP) of `rows` rows of stride LD
template <int LD>
__device__ __forceinline__ void zero_pad(__nv_bfloat16* base, int rows,
                                         int D, int DP, int tid) {
  if (DP > D) {
    const int padc = DP - D;
    for (int i = tid; i < rows * padc; i += THREADS) {
      const int r = i / padc, c = D + (i - r * padc);
      base[r * LD + c] = __float2bfloat16(0.f);
    }
  }
}

// A-operand fragment of rows [16·warp, 16·warp + 16) × cols [16·kk, +16)
// of a row-major shared tile.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int kk,
                                       int g, int t) {
  const __nv_bfloat16* p = tile + kk * 16 + 2 * t;
  a[0] = ld32(p + g * LD);
  a[1] = ld32(p + (g + 8) * LD);
  a[2] = ld32(p + g * LD + 8);
  a[3] = ld32(p + (g + 8) * LD + 8);
}

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = DP + 8;
  constexpr int NKK = DP / 16;  // k-steps over the head dim
  constexpr int ND = DP / 8;    // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + BQ2 * LD;      // dO
  __nv_bfloat16* Ks = Os + BQ2 * LD;      // 2 buffers
  __nv_bfloat16* Vs = Ks + 2 * BK2 * LD;  // 2 buffers
  int* Ss = reinterpret_cast<int*>(Vs + 2 * BK2 * LD);  // 2 × BK2 kv seg

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ2, h = blockIdx.y, b = blockIdx.z;
  const int hk = h * p.Hkv / p.Hq;
  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dog = p.dout + b * p.do_sb + h * p.do_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + hk * p.v_sh;

  zero_pad<LD>(Qs, 2 * BQ2 + 4 * BK2, p.D, DP, tid);  // all tiles

  int n_kv = (p.Sk + BK2 - 1) / BK2;
  if (p.causal) {
    const int last_row = min(q0 + BQ2, p.Sq) - 1;
    n_kv = min(n_kv, last_row / BK2 + 1);
  }

  auto load_kv = [&](int j, int buf) {
    load_tile<BK2, LD>(Ks + buf * BK2 * LD, kg, p.k_ss, j * BK2, p.Sk, p.D,
                       tid);
    load_tile<BK2, LD>(Vs + buf * BK2 * LD, vg, p.v_ss, j * BK2, p.Sk, p.D,
                       tid);
    if (p.kseg) {
      for (int i = tid; i < BK2; i += THREADS) {
        const int c = j * BK2 + i;
        Ss[buf * BK2 + i] = c < p.Sk ? p.kseg[b * p.Sk + c] : 0;
      }
    }
  };

  load_tile<BQ2, LD>(Qs, qg, p.q_ss, q0, p.Sq, p.D, tid);
  load_tile<BQ2, LD>(Os, dog, p.do_ss, q0, p.Sq, p.D, tid);
  if (n_kv > 0) load_kv(0, 0);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  int qs0 = 0, qs1 = 0;
  if (p.qseg) {
    qs0 = r0 < p.Sq ? p.qseg[b * p.Sq + r0] : 0;
    qs1 = r1 < p.Sq ? p.qseg[b * p.Sq + r1] : 0;
  }
  const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
  const float lse0 = r0 < p.Sq ? p.lse[row_base + r0] * LOG2E : 0.f;
  const float lse1 = r1 < p.Sq ? p.lse[row_base + r1] * LOG2E : 0.f;
  const float dl0 = r0 < p.Sq ? p.delta[row_base + r0] : 0.f;
  const float dl1 = r1 < p.Sq ? p.delta[row_base + r1] : 0.f;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const __nv_bfloat16* Qw = Qs + (warp * 16) * LD;
  const __nv_bfloat16* Ow = Os + (warp * 16) * LD;

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kv) {
      load_kv(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* Kb = Ks + buf * BK2 * LD;
    const __nv_bfloat16* Vb = Vs + buf * BK2 * LD;
    const int* Sb = Ss + buf * BK2;

    // S = Q Kᵀ and dP = dO Vᵀ for this warp's 16 rows × 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk) {
      uint32_t qa[4], oa[4];
      frag_a<LD>(qa, Qw, kk, g, t);
      frag_a<LD>(oa, Ow, kk, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int off = (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[n], qa, ld32(Kb + off), ld32(Kb + off + 8));
        mma_bf16(dp[n], oa, ld32(Vb + off), ld32(Vb + off + 8));
      }
    }

    // P from the LSE (masked to 0), then dS = P ∘ (dP − δ) in place of s
    const int k0 = j * BK2;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int cl = n * 8 + 2 * t + (e & 1);
        const int col = k0 + cl;
        bool ok = col < p.Sk && row < p.Sq;
        if (p.causal) ok = ok && col <= row;
        if (p.kseg) ok = ok && (e < 2 ? qs0 : qs1) == Sb[cl];
        const float pv =
            ok ? exp2f(s[n][e] * p.scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
        s[n][e] = pv * (dp[n][e] - (e < 2 ? dl0 : dl1));
      }
    }

    // dQ += dS K: dS's accumulator layout is the A-operand layout
#pragma unroll
    for (int kk = 0; kk < BK2 / 16; ++kk) {
      const uint32_t da[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                              pack_f32(s[2 * kk][2], s[2 * kk][3]),
                              pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* kr = Kb + (kk * 16 + 2 * t) * LD;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = n * 8 + g;
        mma_bf16(acc[n], da, pack_bf16(kr[c], kr[LD + c]),
                 pack_bf16(kr[8 * LD + c], kr[9 * LD + c]));
      }
    }
    __syncthreads();  // this buffer is reloaded two tiles on
  }
  cp_async_wait<0>();

  __nv_bfloat16* dqg = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (col < p.D) {
      if (r0 < p.Sq)
        *reinterpret_cast<uint32_t*>(dqg + r0 * p.dq_ss + col) =
            pack_f32(acc[n][0] * p.scale, acc[n][1] * p.scale);
      if (r1 < p.Sq)
        *reinterpret_cast<uint32_t*>(dqg + r1 * p.dq_ss + col) =
            pack_f32(acc[n][2] * p.scale, acc[n][3] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = DP + 8;
  constexpr int NKK = DP / 16;  // k-steps over the head dim
  constexpr int ND = DP / 8;    // n-tiles of dK / dV
  constexpr int NQ = BQ3 / 8;   // n-tiles of Sᵀ over a query tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BK3 * LD;
  __nv_bfloat16* Qs = Vs + BK3 * LD;      // 2 buffers
  __nv_bfloat16* Os = Qs + 2 * BQ3 * LD;  // dO, 2 buffers
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ3 * LD);  // 2 × BQ3 lse
  float* Dl = Ls + 2 * BQ3;                                 // 2 × BQ3 δ
  int* Qg = reinterpret_cast<int*>(Dl + 2 * BQ3);           // 2 × BQ3 seg

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK3, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + hk * p.v_sh;

  zero_pad<LD>(Ks, 2 * BK3 + 4 * BQ3, p.D, DP, tid);  // all tiles

  const int nq = (p.Sq + BQ3 - 1) / BQ3;
  // causal: a query tile whose last row is before k0 sees none of the keys
  const int qt0 = p.causal ? min(k0 / BQ3, nq) : 0;
  const int per_head = nq - qt0;
  const int n_it = per_head * G;

  auto load_q = [&](int it, int buf) {
    const int h = hk * G + it / per_head;
    const int qrow0 = (qt0 + it % per_head) * BQ3;
    load_tile<BQ3, LD>(Qs + buf * BQ3 * LD, p.q + b * p.q_sb + h * p.q_sh,
                       p.q_ss, qrow0, p.Sq, p.D, tid);
    load_tile<BQ3, LD>(Os + buf * BQ3 * LD,
                       p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, qrow0,
                       p.Sq, p.D, tid);
    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
    for (int i = tid; i < BQ3; i += THREADS) {
      const int r = qrow0 + i;
      const bool ok = r < p.Sq;
      Ls[buf * BQ3 + i] = ok ? p.lse[row_base + r] * LOG2E : 0.f;
      Dl[buf * BQ3 + i] = ok ? p.delta[row_base + r] : 0.f;
      if (p.qseg) Qg[buf * BQ3 + i] = ok ? p.qseg[b * p.Sq + r] : 0;
    }
  };

  load_tile<BK3, LD>(Ks, kg, p.k_ss, k0, p.Sk, p.D, tid);
  load_tile<BK3, LD>(Vs, vg, p.v_ss, k0, p.Sk, p.D, tid);
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;  // this thread's keys
  int ks0 = 0, ks1 = 0;
  if (p.kseg) {
    ks0 = r0 < p.Sk ? p.kseg[b * p.Sk + r0] : 0;
    ks1 = r1 < p.Sk ? p.kseg[b * p.Sk + r1] : 0;
  }

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const __nv_bfloat16* Kw = Ks + (warp * 16) * LD;
  const __nv_bfloat16* Vw = Vs + (warp * 16) * LD;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      load_q(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* Qb = Qs + buf * BQ3 * LD;
    const __nv_bfloat16* Ob = Os + buf * BQ3 * LD;
    const float* Lb = Ls + buf * BQ3;
    const float* Db = Dl + buf * BQ3;
    const int* Gb = Qg + buf * BQ3;
    const int qrow0 = (qt0 + it % per_head) * BQ3;

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ for this warp's 16 keys × BQ3 queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk) {
      uint32_t ka[4], va[4];
      frag_a<LD>(ka, Kw, kk, g, t);
      frag_a<LD>(va, Vw, kk, g, t);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int off = (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(st[n], ka, ld32(Qb + off), ld32(Qb + off + 8));
        mma_bf16(dpt[n], va, ld32(Ob + off), ld32(Ob + off + 8));
      }
    }

    // Pᵀ from the LSE of each query column (masked to 0) in st; dSᵀ in dpt
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? r0 : r1;
        const int cl = n * 8 + 2 * t + (e & 1);
        const int col = qrow0 + cl;
        bool ok = col < p.Sq && key < p.Sk;
        if (p.causal) ok = ok && key <= col;
        if (p.kseg) ok = ok && (e < 2 ? ks0 : ks1) == Gb[cl];
        const float pv = ok ? exp2f(st[n][e] * p.scale_log2 - Lb[cl]) : 0.f;
        st[n][e] = pv;
        dpt[n][e] = pv * (dpt[n][e] - Db[cl]);
      }
    }

    // dV += Pᵀ dO and dK += dSᵀ Q, the reduction over this tile's queries
#pragma unroll
    for (int kk = 0; kk < BQ3 / 16; ++kk) {
      const uint32_t pa[4] = {pack_f32(st[2 * kk][0], st[2 * kk][1]),
                              pack_f32(st[2 * kk][2], st[2 * kk][3]),
                              pack_f32(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_f32(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t da[4] = {
          pack_f32(dpt[2 * kk][0], dpt[2 * kk][1]),
          pack_f32(dpt[2 * kk][2], dpt[2 * kk][3]),
          pack_f32(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
          pack_f32(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
      const __nv_bfloat16* orow = Ob + (kk * 16 + 2 * t) * LD;
      const __nv_bfloat16* qrow = Qb + (kk * 16 + 2 * t) * LD;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = n * 8 + g;
        mma_bf16(dv[n], pa, pack_bf16(orow[c], orow[LD + c]),
                 pack_bf16(orow[8 * LD + c], orow[9 * LD + c]));
        mma_bf16(dk[n], da, pack_bf16(qrow[c], qrow[LD + c]),
                 pack_bf16(qrow[8 * LD + c], qrow[9 * LD + c]));
      }
    }
    __syncthreads();  // this buffer is reloaded two tiles on
  }
  cp_async_wait<0>();

  __nv_bfloat16* dkg = p.dk + b * p.dk_sb + hk * p.dk_sh;
  __nv_bfloat16* dvg = p.dv + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (col < p.D) {
      if (r0 < p.Sk) {
        *reinterpret_cast<uint32_t*>(dkg + r0 * p.dk_ss + col) =
            pack_f32(dk[n][0] * p.scale, dk[n][1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvg + r0 * p.dv_ss + col) =
            pack_f32(dv[n][0], dv[n][1]);
      }
      if (r1 < p.Sk) {
        *reinterpret_cast<uint32_t*>(dkg + r1 * p.dk_ss + col) =
            pack_f32(dk[n][2] * p.scale, dk[n][3] * p.scale);
        *reinterpret_cast<uint32_t*>(dvg + r1 * p.dv_ss + col) =
            pack_f32(dv[n][2], dv[n][3]);
      }
    }
  }
}

// The shared-memory limit is a per-device attribute: set it once each.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int smem, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int DP>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  const int smem = (2 * BQ2 + 4 * BK2) * (DP + 8) * sizeof(__nv_bfloat16) +
                   2 * BK2 * sizeof(int);
  static bool done[MAX_DEVICES] = {};
  cudaError_t e = set_smem(flash_bwd_dq_kernel<DP>, smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + BQ2 - 1) / BQ2, p.Hq, p.B);
  flash_bwd_dq_kernel<DP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  const int smem = (2 * BK3 + 4 * BQ3) * (DP + 8) * sizeof(__nv_bfloat16) +
                   2 * BQ3 * (2 * sizeof(float) + sizeof(int));
  static bool done[MAX_DEVICES] = {};
  cudaError_t e = set_smem(flash_bwd_dkv_kernel<DP>, smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sk + BK3 - 1) / BK3, p.Hkv, p.B);
  flash_bwd_dkv_kernel<DP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// strides: 21 element strides, (batch, sequence, head) of q, k, v, do, dq,
// dk, dv in that order (dq or dk/dv may be unused by one entry point)
Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* q_seg, const void* kv_seg, void* dq, void* dk,
                   void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                   const long long* st, float scale, int causal) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.qseg = static_cast<const int*>(q_seg);
  p.kseg = static_cast<const int*>(kv_seg);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.Hkv = Hkv; p.D = D;
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.do_sb = st[9]; p.do_ss = st[10]; p.do_sh = st[11];
  p.dq_sb = st[12]; p.dq_ss = st[13]; p.dq_sh = st[14];
  p.dk_sb = st[15]; p.dk_ss = st[16]; p.dk_sh = st[17];
  p.dv_sb = st[18]; p.dv_ss = st[19]; p.dv_sh = st[20];
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  return p;
}

bool valid(const Params& p) {
  return (p.qseg == nullptr) == (p.kseg == nullptr) && p.D % 8 == 0 &&
         p.D >= 8 && p.D <= 160 && p.Hkv > 0 && p.Hq % p.Hkv == 0;
}

cudaError_t dq(const Params& p, cudaStream_t st) {
  switch ((p.D + 15) / 16) {
    case 1: return launch_dq<16>(p, st);
    case 2: return launch_dq<32>(p, st);
    case 3: return launch_dq<48>(p, st);
    case 4: return launch_dq<64>(p, st);
    case 5: return launch_dq<80>(p, st);
    case 6: return launch_dq<96>(p, st);
    case 7: return launch_dq<112>(p, st);
    case 8: return launch_dq<128>(p, st);
    case 9: return launch_dq<144>(p, st);
    default: return launch_dq<160>(p, st);
  }
}

cudaError_t dkv(const Params& p, cudaStream_t st) {
  switch ((p.D + 15) / 16) {
    case 1: return launch_dkv<16>(p, st);
    case 2: return launch_dkv<32>(p, st);
    case 3: return launch_dkv<48>(p, st);
    case 4: return launch_dkv<64>(p, st);
    case 5: return launch_dkv<80>(p, st);
    case 6: return launch_dkv<96>(p, st);
    case 7: return launch_dkv<112>(p, st);
    case 8: return launch_dkv<128>(p, st);
    case 9: return launch_dkv<144>(p, st);
    default: return launch_dkv<160>(p, st);
  }
}

}  // namespace mma_sync
}  // namespace

// Both return 0 on success, else a CUDA error code (cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments or tensor maps
// the kernels do not take). Pointers are device pointers, `strides` a host
// array of 21 element strides, (batch, sequence, head) of q, k, v, do, dq,
// dk, dv in that order (dq or dk/dv unused by one entry point); q_seg and
// kv_seg may be null. lse (natural log) and delta are fp32 [B, Hq, Sq],
// contiguous. wgmma picks the regime: 1 the Hopper kernels (head dims 32
// to 256), 0 the mma.sync ones (8 to 160).
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* q_seg,
                                 const void* kv_seg, void* dq, int B, int Sq,
                                 int Sk, int Hq, int Hkv, int D,
                                 const long long* strides, float scale,
                                 int causal, int wgmma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgmma == 0) {
    const mma_sync::Params p = mma_sync::make_params(
        q, k, v, dout, lse, delta, q_seg, kv_seg, dq, nullptr, nullptr, B,
        Sq, Sk, Hq, Hkv, D, strides, scale, causal);
    return mma_sync::valid(p) ? mma_sync::dq(p, st) : cudaErrorInvalidValue;
  }
  Params p;
  if ((q_seg == nullptr) != (kv_seg == nullptr) || D % 8 != 0 || D < 32 ||
      D > 256 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0 ||
      wgmma != 1 ||
      !make_params(p, q, k, v, dout, lse, delta, q_seg, kv_seg, dq, nullptr,
                   nullptr, B, Sq, Sk, Hq, Hkv, D, strides, scale, causal))
    return cudaErrorInvalidValue;
  return launch_dp<false>(p, st);
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* q_seg, const void* kv_seg,
                                  void* dk, void* dv, int B, int Sq, int Sk,
                                  int Hq, int Hkv, int D,
                                  const long long* strides, float scale,
                                  int causal, int wgmma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgmma == 0) {
    const mma_sync::Params p = mma_sync::make_params(
        q, k, v, dout, lse, delta, q_seg, kv_seg, nullptr, dk, dv, B, Sq, Sk,
        Hq, Hkv, D, strides, scale, causal);
    return mma_sync::valid(p) ? mma_sync::dkv(p, st) : cudaErrorInvalidValue;
  }
  Params p;
  if ((q_seg == nullptr) != (kv_seg == nullptr) || D % 8 != 0 || D < 32 ||
      D > 256 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0 ||
      wgmma != 1 ||
      !make_params(p, q, k, v, dout, lse, delta, q_seg, kv_seg, nullptr, dk,
                   dv, B, Sq, Sk, Hq, Hkv, D, strides, scale, causal))
    return cudaErrorInvalidValue;
  return launch_dp<true>(p, st);
}
