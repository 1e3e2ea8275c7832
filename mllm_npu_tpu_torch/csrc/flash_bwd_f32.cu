// K2 f32 and K3 f32: the flash-attention backward on fp32 operands (fp32 in,
// fp32 out), for Hopper, accurate to fp32: every product in split TF32 on
// the tensor cores.
//
// Replace the Pallas TPU kernels mllm_npu_tpu/ops/flash_attention.py:333
// `_bwd_dq_kernel` (K2, launched through `pl.pallas_call` :572) and :407
// `_bwd_dkv_kernel` (K3, :640), both from `_bwd` :502, for fp32 operands:
// the reference forms its products in the operands' dtype (`ds.astype(
// k.dtype)` :388, `pt` and `dst` :474-489), so the fp32 de-tokenizer's
// training (SDXLAdapter.loss_fn over the fp32 UNet, IPAdapterSD.loss_fn)
// reaches them with fp32 operands. The bf16 variants are flash_bwd.cu; the
// forward that writes the LSE they read is flash_fwd_f32.cu (K1 f32).
// Python wrappers, plans and plain PyTorch versions:
// mllm_npu_tpu_torch/ops/flash_attention.py (flash_bwd_dq, flash_bwd_dkv,
// k23_f32_plan, k2_f32_kv_tiles, k3_f32_q_tiles, flash_bwd_*_reference).
//
// What they compute, per (batch, query head h, KV head hk = h·Hkv/Hq), with
// P recomputed from the forward's natural-log LSE (0 for a row with no
// visible key) and K1's masks (top-left causal, segment ids, the ragged
// tail in Sq and Sk):
//   P   = exp(scale·Q Kᵀ − lse)      (0 where masked), in base 2 here
//   dP  = dO Vᵀ
//   dS  = P ∘ (dP − δ),  δ = rowsum(dO ∘ O) in fp32 (the wrapper's)
//   K2: dQ = scale · dS K
//   K3: dV = Σ_h Pᵀ dO,  dK = scale · Σ_h dSᵀ Q over the G = Hq/Hkv query
//       heads of each KV head, inside the block.
// P and dS stay fp32 (no rounding to the operands' dtype is needed: it is
// fp32). A row whose keys are all masked gets P 0, so zero gradients and no
// NaN. No atomics and a fixed order of every sum: a repeat is bit-identical.
//
// What bounds them on an H100 (494.7 TFLOP/s dense TF32, 67 TFLOP/s fp32
// outside the tensor cores, 3.35 TB/s). K2 does 3 and K3 4 products of
// 2·D flops per visible (query, key) pair and query head. The UNet's
// self-attention at 4096 positions (B 4, H 10, D 64) is 258 / 344 GFLOP
// against 210 / 252 MB: bound by operations, 0.52 / 0.70 ms at the TF32
// rate.
// The tensor cores take fp32 only as TF32 (10-bit mantissa), which is not
// an fp32 product, so each product here is three TF32 products: the bound
// counts one.
//
// Design (a kernel that is right first, on the lines of K1 f32; speed is
// later work):
//  * Accuracy: each operand x is split into big = tf32(x) and
//    small = tf32(x − big), and a·b is summed as small·big + big·small +
//    big·big (mma.sync m16n8k8 TF32, fp32 accumulation); the dropped
//    small·small term is about 2^-22 of a product. `passes` = 1 runs
//    big·big alone (one-pass TF32): the control that shows the tolerance
//    the checks hold the kernels to has power, never a training path.
//  * Cancellation: dS = P∘(dP − δ) cancels where dP ≈ δ; δ comes in fp32
//    from the wrapper (attention_delta) and dP is fp32-accurate, so the
//    difference loses no more than fp32's own rounding of each.
//  * K2: blocks of 64 query rows of one (b, h), four warps of 16 rows. Q
//    and dO stay in shared memory for the block's life; K/V tiles of 32
//    keys are double-buffered by cp.async (16-byte copies, zero-filled past
//    Sk and past D), causal tiles above the last row's diagonal not loaded.
//    Per tile a warp computes S and dP (16 × 32), P and dS in registers,
//    then dS goes through a per-warp patch of shared memory to become the A
//    fragments of dQ += dS·K (16 × D per warp, in registers).
//  * K3: blocks of 64 keys of one (b, hk). K and V stay in shared memory;
//    (query tile of 32 rows, query head of the group) pairs of Q, dO, the
//    LSE (times log2 e), δ and the rows' segment ids are double-buffered
//    (causal: no query tile that ends before the block's first key). Per
//    pair a warp computes Sᵀ and dPᵀ (16 keys × 32 queries), Pᵀ and dSᵀ,
//    each through the warp's patch into the A fragments of dV += Pᵀ·dO and
//    dK += dSᵀ·Q. Up to a padded head dim of 128 four warps hold both dK
//    and dV (2·DP/2 fp32 a thread); above, a block has eight warps over the
//    same 64 keys, four for dV (Sᵀ, Pᵀ) and four for dK (Sᵀ, dPᵀ, dSᵀ), as
//    bf16 K3 splits there: 160 fp32 accumulators a thread would not fit
//    beside the tiles' fragments in 255 registers without spills.
//  * Shared memory in fp32 is twice bf16's: at a padded D of 160 a K2
//    block takes 173 KB (Q, dO, two K and V stages, the patches), a K3
//    block 183 KB; one block an SM there, two or more at D = 64. Row
//    strides are D + 4 floats: the products that read a tile along its rows
//    (S, dP, Sᵀ, dPᵀ) are free of bank conflicts, those that read it down
//    its columns (dQ, dK, dV) have 2-way conflicts.
//  * The mask runs on every tile (keys past Sk, queries past Sq, causal,
//    segment ids).
//  * GQA reads KV head h·Hkv/Hq directly; [B, S, H, D] through strides.
//  * Head dims: multiples of 8 up to 160, computed at D rounded up to 16
//    (one instantiation per rounded width; the padded columns are zeros).
//    ops/flash_attention.py k23_f32_plan mirrors the shared memory and the
//    warps, and the wrapper hands its byte count in: a launch whose plan
//    differs from the kernel's is refused.
//
// Registers (ptxas, sm_90a; launch bounds 128 threads, K3 split 256): K2
// 74 to 168 a thread, 4 bytes spilled at DP 112, none elsewhere; K3 up to
// 240 at DP 128 (four warps holding dK and dV), 166 and 168 split at DP
// 144 and 160; no spills.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // K2: query rows a block; K3: keys a block
constexpr int BN = 32;          // K2: keys a K/V tile; K3: rows a Q/dO tile
constexpr int PST = BN + 4;     // row stride of a warp's patch
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;     // [B, Hq, Sq], natural log
  const float* delta;   // [B, Hq, Sq]
  const int* qseg;      // [B, Sq] or null
  const int* kseg;      // [B, Sk] or null
  float* dq;
  float* dk;
  float* dv;
  int B, Sq, Sk, Hq, Hkv, D;
  // element strides (batch, sequence, head) of q, k, v, do, dq, dk, dv
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  float scale;        // softmax scale
  float scale_log2;   // scale · log2 e: P is recomputed in base 2
  int causal;
  int three;          // split TF32 (1) or one pass (0)
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in split TF32, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0, uint32_t bs1,
                                     bool three) {
  if (three) {
    mma(c, as, bb0, bb1);
    mma(c, ab, bs0, bs1);
  }
  mma(c, ab, bb0, bb1);
}

// The A fragment (m16 × k8) of rows [0, 16) × columns [c0, c0 + 8) of a
// row-major tile of row stride ST, split
template <int ST>
__device__ __forceinline__ void frag_a(uint32_t (&ab)[4], uint32_t (&as)[4],
                                       const float* tile, int c0, int g,
                                       int t4) {
  const float* r = tile + g * ST + c0 + t4;
  const float a[4] = {r[0], r[8 * ST], r[4], r[8 * ST + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ab[i], as[i]);
}

// acc[nt] (16 × 8 each, nt < NT) += A · Bᵀ over the k-chunks [0, NK·8),
// A rows of the warp's tile (row-major, stride SA), B the rows
// [nt·8, nt·8 + 8) of a row-major tile (stride SB): the products S = Q·Kᵀ
// and dP = dO·Vᵀ (K2), Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (K3)
template <int NT, int NK, int SA, int SB>
__device__ __forceinline__ void rows_by_rows(float (&acc)[NT][4],
                                             const float* a, const float* b,
                                             int g, int t4, bool three) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t ab[4], as[4];
    frag_a<SA>(ab, as, a, kk * 8, g, t4);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* br = b + (nt * 8 + g) * SB + kk * 8 + t4;
      uint32_t bb0, bs0, bb1, bs1;
      split(br[0], bb0, bs0);
      split(br[4], bb1, bs1);
      mma3(acc[nt], ab, as, bb0, bb1, bs0, bs1, three);
    }
  }
}

// acc[dn] (16 × 8 each, dn < ND) += X · Y, X the warp's 16 × 32 patch
// (stride PST) and Y a row-major 32-row tile (stride SY): dQ += dS·K (K2),
// dV += Pᵀ·dO and dK += dSᵀ·Q (K3)
template <int ND, int SY>
__device__ __forceinline__ void patch_by_tile(float (&acc)[ND][4],
                                              const float* x, const float* y,
                                              int g, int t4, bool three) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    uint32_t ab[4], as[4];
    frag_a<PST>(ab, as, x, kk * 8, g, t4);
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      const float* yr = y + (kk * 8 + t4) * SY + dn * 8 + g;
      uint32_t bb0, bs0, bb1, bs1;
      split(yr[0], bb0, bs0);
      split(yr[4 * SY], bb1, bs1);
      mma3(acc[dn], ab, as, bb0, bb1, bs0, bs1, three);
    }
  }
}

// a 16 × 32 accumulator (C layout) into the warp's patch
__device__ __forceinline__ void to_patch(float* pw, const float (&c)[4][4],
                                         int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = nt * 8 + 2 * t4;
    pw[g * PST + col] = c[nt][0];
    pw[g * PST + col + 1] = c[nt][1];
    pw[(g + 8) * PST + col] = c[nt][2];
    pw[(g + 8) * PST + col + 1] = c[nt][3];
  }
}

__device__ __forceinline__ void cp16(float* smem, const float* gmem,
                                     bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// rows [row0, row0 + ROWS) of a [S, D] slice (row stride ss) into a
// [ROWS][ST] tile, zero past S and past D (DP columns)
template <int ROWS, int DP, int ST, int NTH>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ss, int row0, int S,
                                          int D, int tid) {
  for (int c = tid; c < ROWS * DP / 4; c += NTH) {
    const int r = c / (DP / 4), col = c % (DP / 4) * 4;
    const bool ok = row0 + r < S && col < D;
    cp16(dst + r * ST + col, ok ? src + (row0 + r) * ss + col : src, ok);
  }
}

// Shared memory of a block, in floats (the mirror: k23_f32_plan)
template <int DP>
constexpr int k2_smem_floats() {
  return 2 * BM * (DP + 4) + 4 * BN * (DP + 4) + 4 * 16 * PST + 2 * BN;
}

template <int DP, int WARPS>
constexpr int k3_smem_floats() {
  return 2 * BM * (DP + 4) + 4 * BN * (DP + 4) + WARPS * 16 * PST +
         3 * 2 * BN;
}

// ---------------------------------------------------------------------------
// K2 f32: dQ
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32_kernel(const Params p) {
  constexpr int NC = DP / 8;            // 8-column chunks of the head dim
  constexpr int ST = DP + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Os = Qs + BM * ST;             // dO
  float* Ks = Os + BM * ST;             // two stages
  float* Vs = Ks + 2 * BN * ST;         // two stages
  float* Ps = Vs + 2 * BN * ST;         // a patch per warp
  int* kid = reinterpret_cast<int*>(Ps + 4 * 16 * PST);  // two stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h * p.Hkv / p.Hq;
  const bool three = p.three != 0;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* ob = p.dout + b * p.do_sb + h * p.do_sh;
  const float* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = p.v + b * p.v_sb + hk * p.v_sh;

  auto load_kv = [&](int j, int s) {
    load_rows<BN, DP, ST, 128>(Ks + s * BN * ST, kb, p.k_ss, j * BN, p.Sk,
                               p.D, tid);
    load_rows<BN, DP, ST, 128>(Vs + s * BN * ST, vb, p.v_ss, j * BN, p.Sk,
                               p.D, tid);
    if (p.kseg != nullptr && tid < BN) {
      const int c = j * BN + tid;
      kid[s * BN + tid] =
          c < p.Sk ? p.kseg[static_cast<long long>(b) * p.Sk + c] : 0;
    }
  };

  int n_kv = (p.Sk + BN - 1) / BN;
  if (p.causal) n_kv = min(n_kv, (min(q0 + BM, p.Sq) - 1) / BN + 1);
  load_rows<BM, DP, ST, 128>(Qs, qb, p.q_ss, q0, p.Sq, p.D, tid);
  load_rows<BM, DP, ST, 128>(Os, ob, p.do_ss, q0, p.Sq, p.D, tid);
  load_kv(0, 0);
  cp_commit();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const long long rb = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
  float lse2[2], dl[2];
  int qid[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < p.Sq;
    lse2[i] = in ? p.lse[rb + row[i]] * LOG2E : 0.f;
    dl[i] = in ? p.delta[rb + row[i]] : 0.f;
    if (p.qseg != nullptr && in)
      qid[i] = p.qseg[static_cast<long long>(b) * p.Sq + row[i]];
  }
  float acc[NC][4];
#pragma unroll
  for (int dn = 0; dn < NC; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  const float* Qw = Qs + warp * 16 * ST;
  const float* Ow = Os + warp * 16 * ST;
  float* Pw = Ps + warp * 16 * PST;

  for (int j = 0; j < n_kv; ++j) {
    const int s = j & 1, k0 = j * BN;
    cp_wait_all();
    __syncthreads();    // tile j landed for all; tile j - 1 is done with
    if (j + 1 < n_kv) load_kv(j + 1, s ^ 1);
    cp_commit();
    const float* Kt = Ks + s * BN * ST;
    const float* Vt = Vs + s * BN * ST;

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
    rows_by_rows<4, NC, ST, ST>(sc, Qw, Kt, g, t4, three);
    rows_by_rows<4, NC, ST, ST>(dp, Ow, Vt, g, t4, three);

    // P from the LSE (0 where masked), then dS = P ∘ (dP − δ) in sc
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1, c = nt * 8 + 2 * t4 + (e & 1), col = k0 + c;
        const bool vis =
            col < p.Sk && row[ri] < p.Sq && (!p.causal || col <= row[ri]) &&
            (p.qseg == nullptr || qid[ri] == kid[s * BN + c]);
        const float pv =
            vis ? exp2f(sc[nt][e] * p.scale_log2 - lse2[ri]) : 0.f;
        sc[nt][e] = pv * (dp[nt][e] - dl[ri]);
      }
    to_patch(Pw, sc, g, t4);
    __syncwarp();
    patch_by_tile<NC, ST>(acc, Pw, Kt, g, t4, three);
    __syncwarp();       // the patch is rewritten by the next tile
  }

  float* dqb = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row[ri] >= p.Sq) continue;
    float* r = dqb + row[ri] * p.dq_ss;
#pragma unroll
    for (int dn = 0; dn < NC; ++dn) {
      const int col = dn * 8 + 2 * t4;     // D % 8 == 0: col + 1 < D too
      if (col < p.D) {
        r[col] = acc[dn][2 * ri] * p.scale;
        r[col + 1] = acc[dn][2 * ri + 1] * p.scale;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3 f32: dK and dV
// ---------------------------------------------------------------------------

// SPLIT: eight warps, 0-3 dV and 4-7 dK over the same 16-key rows
template <int DP, bool SPLIT>
__global__ void __launch_bounds__(SPLIT ? 256 : 128)
    flash_bwd_dkv_f32_kernel(const Params p) {
  constexpr int NTH = SPLIT ? 256 : 128;
  constexpr int NC = DP / 8;
  constexpr int ST = DP + 4;
  constexpr int NACC = SPLIT ? 1 : 2;   // [0] dV (or this warp's), [NACC-1] dK
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BM * ST;
  float* Qs = Vs + BM * ST;             // two stages
  float* Os = Qs + 2 * BN * ST;         // dO, two stages
  float* Ps = Os + 2 * BN * ST;         // a patch per warp
  float* Ls = Ps + (NTH / 32) * 16 * PST;   // two stages of lse·log2 e
  float* Dl = Ls + 2 * BN;                  // two stages of δ
  int* qid = reinterpret_cast<int*>(Dl + 2 * BN);  // two stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * BM, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const bool three = p.three != 0;
  const bool want_dv = !SPLIT || warp < 4;
  const bool want_dk = !SPLIT || warp >= 4;
  const int kw = warp & 3;              // the warp's 16 keys

  const int nq = (p.Sq + BN - 1) / BN;
  // causal: a query tile whose last row is before k0 sees none of the keys
  const int qt0 = p.causal ? min(k0 / BN, nq) : 0;
  const int per_head = nq - qt0;
  const int n_it = per_head * G;

  auto load_q = [&](int it, int s) {
    const int h = hk * G + it / per_head;
    const int r0 = (qt0 + it % per_head) * BN;
    load_rows<BN, DP, ST, NTH>(Qs + s * BN * ST,
                               p.q + b * p.q_sb + h * p.q_sh, p.q_ss, r0,
                               p.Sq, p.D, tid);
    load_rows<BN, DP, ST, NTH>(Os + s * BN * ST,
                               p.dout + b * p.do_sb + h * p.do_sh, p.do_ss,
                               r0, p.Sq, p.D, tid);
    if (tid < BN) {
      const int r = r0 + tid;
      const bool ok = r < p.Sq;
      const long long rb = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
      Ls[s * BN + tid] = ok ? p.lse[rb + r] * LOG2E : 0.f;
      Dl[s * BN + tid] = ok ? p.delta[rb + r] : 0.f;
      qid[s * BN + tid] =
          ok && p.qseg != nullptr
              ? p.qseg[static_cast<long long>(b) * p.Sq + r]
              : 0;
    }
  };

  load_rows<BM, DP, ST, NTH>(Ks, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, k0,
                             p.Sk, p.D, tid);
  load_rows<BM, DP, ST, NTH>(Vs, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, k0,
                             p.Sk, p.D, tid);
  if (n_it > 0) load_q(0, 0);
  cp_commit();

  const int key[2] = {k0 + kw * 16 + g, k0 + kw * 16 + g + 8};
  int kid[2] = {0, 0};
  if (p.kseg != nullptr)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (key[i] < p.Sk)
        kid[i] = p.kseg[static_cast<long long>(b) * p.Sk + key[i]];
  float acc[NACC][NC][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int dn = 0; dn < NC; ++dn)
      acc[a][dn][0] = acc[a][dn][1] = acc[a][dn][2] = acc[a][dn][3] = 0.f;
  const float* Kw = Ks + kw * 16 * ST;
  const float* Vw = Vs + kw * 16 * ST;
  float* Pw = Ps + warp * 16 * PST;

  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1;
    const int r0 = (qt0 + it % per_head) * BN;
    cp_wait_all();
    __syncthreads();    // pair it landed for all; pair it - 1 is done with
    if (it + 1 < n_it) load_q(it + 1, s ^ 1);
    cp_commit();
    const float* Qt = Qs + s * BN * ST;
    const float* Ot = Os + s * BN * ST;
    const float* Lt = Ls + s * BN;
    const float* Dt = Dl + s * BN;
    const int* It = qid + s * BN;

    // Sᵀ = K·Qᵀ (and for dK dPᵀ = V·dOᵀ), 16 keys × 32 queries a warp
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    rows_by_rows<4, NC, ST, ST>(st, Kw, Qt, g, t4, three);
    if (want_dk) rows_by_rows<4, NC, ST, ST>(dpt, Vw, Ot, g, t4, three);

    // Pᵀ from each query column's LSE (0 where masked) in st; dSᵀ in dpt
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ki = e >> 1, c = nt * 8 + 2 * t4 + (e & 1), col = r0 + c;
        const bool vis =
            col < p.Sq && key[ki] < p.Sk && (!p.causal || key[ki] <= col) &&
            (p.kseg == nullptr || kid[ki] == It[c]);
        const float pv = vis ? exp2f(st[nt][e] * p.scale_log2 - Lt[c]) : 0.f;
        st[nt][e] = pv;
        dpt[nt][e] = pv * (dpt[nt][e] - Dt[c]);
      }
    if (want_dv) {      // dV += Pᵀ·dO
      to_patch(Pw, st, g, t4);
      __syncwarp();
      patch_by_tile<NC, ST>(acc[0], Pw, Ot, g, t4, three);
      __syncwarp();
    }
    if (want_dk) {      // dK += dSᵀ·Q
      to_patch(Pw, dpt, g, t4);
      __syncwarp();
      patch_by_tile<NC, ST>(acc[NACC - 1], Pw, Qt, g, t4, three);
      __syncwarp();
    }
  }
  cp_wait_all();        // with no pair to visit, K and V are still landing

  float* dkb = p.dk + b * p.dk_sb + hk * p.dk_sh;
  float* dvb = p.dv + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int ki = 0; ki < 2; ++ki) {
    if (key[ki] >= p.Sk) continue;
    float* rk = dkb + key[ki] * p.dk_ss;
    float* rv = dvb + key[ki] * p.dv_ss;
#pragma unroll
    for (int dn = 0; dn < NC; ++dn) {
      const int col = dn * 8 + 2 * t4;
      if (col < p.D) {
        if (want_dv) {
          rv[col] = acc[0][dn][2 * ki];
          rv[col + 1] = acc[0][dn][2 * ki + 1];
        }
        if (want_dk) {
          rk[col] = acc[NACC - 1][dn][2 * ki] * p.scale;
          rk[col + 1] = acc[NACC - 1][dn][2 * ki + 1] * p.scale;
        }
      }
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, int bytes, const Params& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
int launch_dq(const Params& p, int smem, cudaStream_t st) {
  const int bytes = k2_smem_floats<DP>() * 4;
  if (smem != bytes) return cudaErrorInvalidValue;   // the plan differs
  return launch(flash_bwd_dq_f32_kernel<DP>,
                dim3((p.Sq + BM - 1) / BM, p.Hq, p.B), 128, bytes, p, st);
}

template <int DP>
int launch_dkv(const Params& p, int smem, cudaStream_t st) {
  constexpr bool SPLIT = DP > 128;
  const int bytes = k3_smem_floats<DP, SPLIT ? 8 : 4>() * 4;
  if (smem != bytes) return cudaErrorInvalidValue;
  return launch(flash_bwd_dkv_f32_kernel<DP, SPLIT>,
                dim3((p.Sk + BM - 1) / BM, p.Hkv, p.B), SPLIT ? 256 : 128,
                bytes, p, st);
}

bool aligned(const void* ptr, long long sb, long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 4 == 0 &&
         ss % 4 == 0 && sh % 4 == 0;
}

// strides: 21 element strides, (batch, sequence, head) of q, k, v, do, dq,
// dk, dv in that order (dq or dk/dv unused by one entry point)
bool make_params(Params& p, const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* q_seg, const void* kv_seg, void* dq, void* dk,
                 void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                 const long long* st, float scale, int causal, int passes) {
  if ((q_seg == nullptr) != (kv_seg == nullptr) || D % 8 != 0 || D < 8 ||
      D > 160 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0 ||
      Hq > 65535 || B > 65535 || (passes != 1 && passes != 3) ||
      !aligned(q, st[0], st[1], st[2]) || !aligned(k, st[3], st[4], st[5]) ||
      !aligned(v, st[6], st[7], st[8]) ||
      !aligned(dout, st[9], st[10], st[11]))
    return false;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.qseg = static_cast<const int*>(q_seg);
  p.kseg = static_cast<const int*>(kv_seg);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
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
  p.three = passes == 3;
  return true;
}

}  // namespace

// q, do [B, Sq, Hq, D], k, v [B, Sk, Hkv, D], all fp32 with a unit last
// stride, strides multiples of 4 elements and 16-byte aligned bases; lse
// and delta fp32 [B, Hq, Sq] contiguous; q_seg [B, Sq] and kv_seg [B, Sk]
// int32 contiguous, or both null; dq [B, Sq, Hq, D] (K2) and dk, dv
// [B, Sk, Hkv, D] (K3) fp32. passes: 3 (split TF32) or 1 (one-pass TF32,
// the control). smem: the wrapper's plan of the block's shared memory in
// bytes, which must be the kernel's. Both return 0 on success, else a CUDA
// error code (cudaErrorInvalidValue for arguments they do not take).
extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* q_seg,
                                const void* kv_seg, void* dq, int B, int Sq,
                                int Sk, int Hq, int Hkv, int D,
                                const long long* strides, float scale,
                                int causal, int passes, int smem,
                                void* stream) {
  Params p;
  if (!make_params(p, q, k, v, dout, lse, delta, q_seg, kv_seg, dq, nullptr,
                   nullptr, B, Sq, Sk, Hq, Hkv, D, strides, scale, causal,
                   passes))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16: return launch_dq<16>(p, smem, st);
    case 32: return launch_dq<32>(p, smem, st);
    case 48: return launch_dq<48>(p, smem, st);
    case 64: return launch_dq<64>(p, smem, st);
    case 80: return launch_dq<80>(p, smem, st);
    case 96: return launch_dq<96>(p, smem, st);
    case 112: return launch_dq<112>(p, smem, st);
    case 128: return launch_dq<128>(p, smem, st);
    case 144: return launch_dq<144>(p, smem, st);
    case 160: return launch_dq<160>(p, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* q_seg,
                                 const void* kv_seg, void* dk, void* dv,
                                 int B, int Sq, int Sk, int Hq, int Hkv,
                                 int D, const long long* strides,
                                 float scale, int causal, int passes,
                                 int smem, void* stream) {
  Params p;
  if (!make_params(p, q, k, v, dout, lse, delta, q_seg, kv_seg, nullptr, dk,
                   dv, B, Sq, Sk, Hq, Hkv, D, strides, scale, causal,
                   passes))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16: return launch_dkv<16>(p, smem, st);
    case 32: return launch_dkv<32>(p, smem, st);
    case 48: return launch_dkv<48>(p, smem, st);
    case 64: return launch_dkv<64>(p, smem, st);
    case 80: return launch_dkv<80>(p, smem, st);
    case 96: return launch_dkv<96>(p, smem, st);
    case 112: return launch_dkv<112>(p, smem, st);
    case 128: return launch_dkv<128>(p, smem, st);
    case 144: return launch_dkv<144>(p, smem, st);
    case 160: return launch_dkv<160>(p, smem, st);
    default: return cudaErrorInvalidValue;
  }
}
