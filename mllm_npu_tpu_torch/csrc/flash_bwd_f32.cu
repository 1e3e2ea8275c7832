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
// Accuracy: each operand x is split into big = tf32(x) and
// small = tf32(x − big), and a·b is summed as small·big + big·small +
// big·big, in that order at every k-step of 8, into one fp32 accumulator;
// the dropped small·small term is about 2^-22 of a product. `passes` = 1
// is one-pass TF32 (big·big alone; the wgmma route zeroes the small parts
// instead of branching, so its products add exact zeros): the control
// that shows the tolerance the checks hold the kernels to has power, never
// a training path.
// Cancellation: dS = P∘(dP − δ) cancels where dP ≈ δ; δ comes in fp32 from
// the wrapper (attention_delta) and dP is fp32-accurate, so the difference
// loses no more than fp32's own rounding of each.
//
// Two routes by the padded head dim DP (`padded_dp`: D rounded up to 16 up
// to 160, above it 192 or 256; the padded columns are zeros), one
// instantiation per width; ops/flash_attention.py k23_f32_plan mirrors
// each route's shared memory and the wrapper hands its byte count in: a
// launch whose plan differs from the kernel's is refused.
//
// The wgmma route (DP up to 128: the de-tokenizer's D = 64, the IP UNet's
// 40 and 80). Hopper's wgmma takes TF32 only with both operands K-major
// (contiguous along the product's k). Design:
//  * Blocks of G consumer warpgroups (K2: 64 query rows each; K3: 64 keys
//    each), G = 2 where the shared memory fits (DP <= 64), else 1; every
//    thread loads, splits and computes (no producer warp).
//  * The split once: the block's resident operands (K2: Q and dO; K3: K and
//    V) are read from device memory and split into their TF32 big and
//    small parts at the block's start; each streamed tile (K2: T keys of K
//    and V; K3: T query rows of Q and dO, T = 32, or 16 where 32 do not
//    fit) lands raw by cp.async in one stage, and a split pass writes its
//    parts once, in every layout its products read: K-major for the
//    products over D, and transposed for the products over the tile's
//    rows, those rows permuted within each group of 8 (slot s < 4 holds
//    row 2s, slot s >= 4 row 2(s − 4) + 1). No warp splits a shared
//    operand again. The next tile's raw load runs under this tile's
//    products.
//  * Layout: the core-matrix layout wgmma reads without a swizzle (8 rows ×
//    16 bytes a core matrix, contiguous; leading byte offset 128 along k,
//    stride byte offset k-extent·32 between 8-row groups); the split pass
//    writes 16 bytes a lane, 8 lanes filling one core matrix, and reads the
//    raw tile (rows of DP + 4 floats) without bank conflicts.
//  * Products: each is three wgmma m64nNk8 .tf32 a k-step, with no branch
//    in the sequence (a runtime branch there cost 255 registers, spills
//    and a warpgroup.arrive before nearly every wgmma). S = Q·Kᵀ,
//    dP = dO·Vᵀ (K2), Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ (K3) take A and B from shared
//    memory (N = T), in two commit groups: P (Pᵀ, and K3's dV products)
//    are formed while the second group's products run. dQ += dS·K (K2),
//    dV += Pᵀ·dO and dK += dSᵀ·Q (K3) take A from registers (N = DP): the
//    accumulator gives a thread columns 2t and 2t + 1 of each 8-wide
//    chunk, which against the permuted transpose are the TF32 A fragment's
//    k = t and t + 4, so dS, Pᵀ and dSᵀ go from the accumulators straight
//    into A fragments (c0 → a0, c2 → a1, c1 → a2, c3 → a3), split big /
//    small by the thread that owns them: no shuffle and no trip through
//    shared memory. TF32 rounding there and in the split passes is two
//    integer instructions (cvt.rna.tf32 issues at a quarter of their
//    rate).
//  * Shared memory binds: fp32 parts take four times bf16's bytes. At DP
//    64 a K2 block (128 query rows) takes 193 KB: Q and dO split 128 KB, a
//    32-key tile's K, V and Kᵀ split 48 KB, the raw K and V 17 KB; a K3
//    block (128 keys) 210 KB: K and V split 128 KB, a 32-row tile's Q, dO,
//    Qᵀ, dOᵀ split 64 KB, raw 17 KB. One block an SM.
//  * The mask runs only on a tile that needs it (keys past Sk, queries past
//    Sq, the causal diagonal, segment ids); causal tiles wholly above the
//    diagonal are not visited.
//  * Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): at the
//    de-tokenizer's S = 4096 (B 4, H 10, D 64) K2 3.94 ms, K3 5.11, against
//    the mma.sync design's 8.13 / 10.64; a tile and warpgroup spend about
//    a fifth of their cycles in the split pass and the rest in the
//    products and the elementwise work, which one block an SM leaves
//    mostly unoverlapped.
//
// The mma.sync route (DP above 128; the IP UNet's D = 160, the reference's
// bench shape's 256), the first design:
//  * Products on mma.sync m16n8k8 TF32, every fragment split as it is
//    loaded from shared memory.
//  * K2: blocks of 64 query rows of one (b, h), four warps of 16 rows. Q
//    and dO stay in shared memory for the block's life; K/V tiles of T
//    keys (`tile_rows`: 32, 16 at a padded head dim of 256) are
//    double-buffered by cp.async (16-byte copies, zero-filled past Sk and
//    past D), causal tiles above the last row's diagonal not loaded. Per
//    tile a warp computes S and dP (16 × T), P and dS in registers, then dS
//    goes through a per-warp patch of shared memory to become the A
//    fragments of dQ += dS·K (16 × D per warp, in registers).
//  * K3: blocks of 64 keys of one (b, hk), eight warps, four for dV (Sᵀ,
//    Pᵀ) and four for dK (Sᵀ, dPᵀ, dSᵀ) over the same 64 keys. K and V
//    stay in shared memory; (query tile of T rows, query head of the group)
//    pairs of Q, dO, the LSE (times log2 e), δ and the rows' segment ids
//    are double-buffered (causal: no query tile that ends before the
//    block's first key). Per pair a warp computes its products, each
//    through the warp's patch into A fragments.
//  * Shared memory: at a padded D of 160 a K2 block takes 173 KB, a K3
//    block 183 KB; at 192 205 and 215 KB; at 256 the streamed tiles are 16
//    rows (32 would bring K2 to 269 KB and K3 to 279 KB), 200 and 205 KB.
//    Row strides are D + 4 floats.
//
// GQA reads KV head h·Hkv/Hq directly (K3 sums the G query heads of its KV
// head inside the block, in a fixed order); [B, S, H, D] through strides.
//
// The file holds K2 f32; K3 f32 is flash_bwd_dkv_f32.cu, and what both
// share is flash_bwd_f32.cuh (two nvcc processes instead of one).
//
// Registers (ptxas, sm_90a), the mma.sync route: K2 166 / 168 at DP 144 /
// 160, 166 / 230 at 192 / 256; K3 (eight warps) 166 / 168 and 241 / 239;
// no spills.

#include "flash_bwd_f32.cuh"

namespace {

// ---------------------------------------------------------------------------
// K2 f32 on wgmma (padded head dims up to 128)
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(128 * K2W<DP>::G, 1)
    flash_bwd_dq_f32_wg(const Params p) {
  constexpr int G = K2W<DP>::G, T = K2W<DP>::T;
  constexpr int NTH = 128 * G, ROWS = 64 * G, RST = DP + 4, NK = T / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qb = smem;                     // Q and dO resident, split
  float* Qs = Qb + ROWS * DP;
  float* Ob = Qs + ROWS * DP;
  float* Os = Ob + ROWS * DP;
  float* Kb = Os + ROWS * DP;           // the tile's K, V (K-major) and
  float* Ks = Kb + T * DP;              // permuted Kᵀ, split
  float* Vb = Ks + T * DP;
  float* Vs = Vb + T * DP;
  float* Ktb = Vs + T * DP;
  float* Kts = Ktb + T * DP;
  float* Kr = Kts + T * DP;             // the raw K and V tile
  float* Vr = Kr + T * RST;
  int* kid = reinterpret_cast<int*>(Vr + T * RST);   // two stages

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hk = h * p.Hkv / p.Hq;
  const bool three = p.three != 0;
  const float* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = p.v + b * p.v_sb + hk * p.v_sh;

  auto load_kv = [&](int j) {
    load_rows<T, DP, RST, NTH>(Kr, kb, p.k_ss, j * T, p.Sk, p.D, tid);
    load_rows<T, DP, RST, NTH>(Vr, vb, p.v_ss, j * T, p.Sk, p.D, tid);
    if (p.kseg != nullptr && tid < T) {
      const int c = j * T + tid;
      cp4(kid + (j & 1) * T + tid,
          p.kseg + static_cast<long long>(b) * p.Sk + min(c, p.Sk - 1),
          c < p.Sk);
    }
  };

  int n_kv = (p.Sk + T - 1) / T;
  if (p.causal) n_kv = min(n_kv, (min(q0 + ROWS, p.Sq) - 1) / T + 1);
  load_kv(0);
  cp_commit();
  split_resident<ROWS, DP, NTH>(Qb, Qs, p.q + b * p.q_sb + h * p.q_sh,
                                p.q_ss, q0, p.Sq, p.D, tid, three);
  split_resident<ROWS, DP, NTH>(Ob, Os, p.dout + b * p.do_sb + h * p.do_sh,
                                p.do_ss, q0, p.Sq, p.D, tid, three);

  const int r0 = q0 + 64 * wg + 16 * warp + g;
  const int row[2] = {r0, r0 + 8};
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
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  // this warpgroup's 64 rows of Q and dO, the tile's operands
  const uint64_t qB = kdesc<DP>(Qb + 64 * wg * DP);
  const uint64_t qS = kdesc<DP>(Qs + 64 * wg * DP);
  const uint64_t oB = kdesc<DP>(Ob + 64 * wg * DP);
  const uint64_t oS = kdesc<DP>(Os + 64 * wg * DP);
  const uint64_t kB = kdesc<DP>(Kb), kS = kdesc<DP>(Ks);
  const uint64_t vB = kdesc<DP>(Vb), vS = kdesc<DP>(Vs);
  const uint64_t tB = kdesc<T>(Ktb), tS = kdesc<T>(Kts);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * T;
    const int* kt = kid + (j & 1) * T;
    cp_wait_all();
    __syncthreads();    // tile j landed; every product of tile j - 1 ended
    split_rows<T, DP, NTH>(Kr, Kb, Ks, tid, three);
    split_rows<T, DP, NTH>(Vr, Vb, Vs, tid, three);
    split_cols<T, DP, NTH>(Kr, Ktb, Kts, tid, three);
    fence_proxy_async();
    __syncthreads();    // the split tile is visible to wgmma; raw is free
    if (j + 1 < n_kv) load_kv(j + 1);
    cp_commit();

    // S = Q·Kᵀ and dP = dO·Vᵀ, 64 rows × T keys a warpgroup, in two
    // groups: P is formed while dP's products run
    float sc[T / 2], dp[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) sc[i] = dp[i] = 0.f;
    wg_fence();
    mma3_ss<T, DP / 8>(sc, qB, qS, kB, kS);
    wg_commit();
    mma3_ss<T, DP / 8>(dp, oB, oS, vB, vS);
    wg_commit();
    wg_wait<1>();
    fence_regs(sc);

    // P from the LSE in sc; the mask (P 0) only where the tile holds keys
    // past Sk, rows past Sq, the causal diagonal or segment ids
    if (k0 + T > p.Sk || q0 + ROWS > p.Sq || p.qseg != nullptr ||
        (p.causal && k0 + T - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < T / 2; ++i) {
        const int ri = (i >> 1) & 1, c = (i >> 2) * 8 + 2 * t4 + (i & 1);
        const int col = k0 + c;
        const bool vis =
            col < p.Sk && row[ri] < p.Sq && (!p.causal || col <= row[ri]) &&
            (p.qseg == nullptr || qid[ri] == kt[c]);
        sc[i] = vis ? exp2f(sc[i] * p.scale_log2 - lse2[ri]) : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < T / 2; ++i)
        sc[i] = exp2f(sc[i] * p.scale_log2 - lse2[(i >> 1) & 1]);
    }
    // dS = P ∘ (dP − δ), straight from the accumulator into A fragments
    wg_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < T / 2; ++i) sc[i] *= dp[i] - dl[(i >> 1) & 1];
    uint32_t fb[NK][4], fs[NK][4];
    a_frag<NK>(sc, fb, fs, three);
    // dQ += dS·K
    wg_fence();
    mma3_rs<DP, NK>(acc, fb, fs, tB, tS);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(fb);
    fence_regs(fs);
  }
  cp_wait_all();        // with no tile to visit, nothing is in flight

  float* dqb = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row[ri] >= p.Sq) continue;
    float* r = dqb + row[ri] * p.dq_ss;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      const int col = dn * 8 + 2 * t4;   // D % 8 == 0: col + 1 < D too
      if (col < p.D) {
        r[col] = acc[4 * dn + 2 * ri] * p.scale;
        r[col + 1] = acc[4 * dn + 2 * ri + 1] * p.scale;
      }
    }
  }
}

template <int DP>
int launch_dq_wg(const Params& p, int smem, cudaStream_t st) {
  if (smem != K2W<DP>::BYTES) return cudaErrorInvalidValue;  // plan differs
  return launch(flash_bwd_dq_f32_wg<DP>,
                dim3((p.Sq + 64 * K2W<DP>::G - 1) / (64 * K2W<DP>::G), p.Hq,
                     p.B),
                128 * K2W<DP>::G, K2W<DP>::BYTES, p, st);
}

// ---------------------------------------------------------------------------
// K2 f32 on mma.sync (padded head dims above 128)
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32_kernel(const Params p) {
  constexpr int NC = DP / 8;            // 8-column chunks of the head dim
  constexpr int ST = DP + 4;
  constexpr int T = tile_rows<DP>(), NT = T / 8, PST = T + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Os = Qs + BM * ST;             // dO
  float* Ks = Os + BM * ST;             // two stages
  float* Vs = Ks + 2 * T * ST;          // two stages
  float* Ps = Vs + 2 * T * ST;          // a patch per warp
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
    load_rows<T, DP, ST, 128>(Ks + s * T * ST, kb, p.k_ss, j * T, p.Sk,
                              p.D, tid);
    load_rows<T, DP, ST, 128>(Vs + s * T * ST, vb, p.v_ss, j * T, p.Sk,
                              p.D, tid);
    if (p.kseg != nullptr && tid < T) {
      const int c = j * T + tid;
      kid[s * T + tid] =
          c < p.Sk ? p.kseg[static_cast<long long>(b) * p.Sk + c] : 0;
    }
  };

  int n_kv = (p.Sk + T - 1) / T;
  if (p.causal) n_kv = min(n_kv, (min(q0 + BM, p.Sq) - 1) / T + 1);
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
    const int s = j & 1, k0 = j * T;
    cp_wait_all();
    __syncthreads();    // tile j landed for all; tile j - 1 is done with
    if (j + 1 < n_kv) load_kv(j + 1, s ^ 1);
    cp_commit();
    const float* Kt = Ks + s * T * ST;
    const float* Vt = Vs + s * T * ST;

    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
    rows_by_rows<NT, NC, ST, ST>(sc, Qw, Kt, g, t4, three);
    rows_by_rows<NT, NC, ST, ST>(dp, Ow, Vt, g, t4, three);

    // P from the LSE (0 where masked), then dS = P ∘ (dP − δ) in sc
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1, c = nt * 8 + 2 * t4 + (e & 1), col = k0 + c;
        const bool vis =
            col < p.Sk && row[ri] < p.Sq && (!p.causal || col <= row[ri]) &&
            (p.qseg == nullptr || qid[ri] == kid[s * T + c]);
        const float pv =
            vis ? exp2f(sc[nt][e] * p.scale_log2 - lse2[ri]) : 0.f;
        sc[nt][e] = pv * (dp[nt][e] - dl[ri]);
      }
    to_patch<NT>(Pw, sc, g, t4);
    __syncwarp();
    patch_by_tile<T, NC, ST>(acc, Pw, Kt, g, t4, three);
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

template <int DP>
int launch_dq(const Params& p, int smem, cudaStream_t st) {
  const int bytes = k2_smem_floats<DP>() * 4;
  if (smem != bytes) return cudaErrorInvalidValue;   // the plan differs
  return launch(flash_bwd_dq_f32_kernel<DP>,
                dim3((p.Sq + BM - 1) / BM, p.Hq, p.B), 128, bytes, p, st);
}

}  // namespace

// K2 f32. q, do [B, Sq, Hq, D], k, v [B, Sk, Hkv, D], all fp32 with a unit
// last stride, strides multiples of 4 elements and 16-byte aligned bases;
// lse and delta fp32 [B, Hq, Sq] contiguous; q_seg [B, Sq] and kv_seg
// [B, Sk] int32 contiguous, or both null; dq [B, Sq, Hq, D] fp32 out.
// strides: the 21 of make_params. passes: 3 (split TF32) or 1 (one-pass
// TF32, the control). smem: the wrapper's plan of the block's shared
// memory in bytes, which must be the kernel's. Returns 0 on success, else
// a CUDA error code (cudaErrorInvalidValue for arguments it does not
// take).
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
  switch (padded_dp(D)) {
    case 16: return launch_dq_wg<16>(p, smem, st);
    case 32: return launch_dq_wg<32>(p, smem, st);
    case 48: return launch_dq_wg<48>(p, smem, st);
    case 64: return launch_dq_wg<64>(p, smem, st);
    case 80: return launch_dq_wg<80>(p, smem, st);
    case 96: return launch_dq_wg<96>(p, smem, st);
    case 112: return launch_dq_wg<112>(p, smem, st);
    case 128: return launch_dq_wg<128>(p, smem, st);
    case 144: return launch_dq<144>(p, smem, st);
    case 160: return launch_dq<160>(p, smem, st);
    case 192: return launch_dq<192>(p, smem, st);
    case 256: return launch_dq<256>(p, smem, st);
    default: return cudaErrorInvalidValue;
  }
}
