// K3 f32: dK and dV of the flash-attention backward on fp32 operands (fp32
// in, fp32 out), for Hopper, accurate to fp32: every product in split TF32
// on the tensor cores.
//
// Replaces the Pallas TPU kernel mllm_npu_tpu/ops/flash_attention.py:407
// `_bwd_dkv_kernel` (launched through `pl.pallas_call` :640 from `_bwd`
// :502) for fp32 operands. Its design, its bound and its registers are
// noted with K2 f32's at the top of flash_bwd_f32.cu; the parts the two
// share are flash_bwd_f32.cuh. Python wrapper, plan and plain PyTorch
// version: mllm_npu_tpu_torch/ops/flash_attention.py (flash_bwd_dkv,
// k23_f32_plan, k3_f32_q_tiles, flash_bwd_dkv_reference).

#include "flash_bwd_f32.cuh"

namespace {

// ---------------------------------------------------------------------------
// K3 f32 on wgmma (padded head dims up to 128)
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(128 * K3W<DP>::G, 1)
    flash_bwd_dkv_f32_wg(const Params p) {
  constexpr int G = K3W<DP>::G, T = K3W<DP>::T;
  constexpr int NTH = 128 * G, ROWS = 64 * G, RST = DP + 4, NK = T / 8;
  extern __shared__ __align__(16) float smem[];
  float* Kb = smem;                     // K and V resident, split
  float* Ks = Kb + ROWS * DP;
  float* Vb = Ks + ROWS * DP;
  float* Vs = Vb + ROWS * DP;
  float* Qb = Vs + ROWS * DP;           // the tile's Q and dO (K-major) and
  float* Qs = Qb + T * DP;              // their permuted transposes, split
  float* Ob = Qs + T * DP;
  float* Os = Ob + T * DP;
  float* Qtb = Os + T * DP;
  float* Qts = Qtb + T * DP;
  float* Otb = Qts + T * DP;
  float* Ots = Otb + T * DP;
  float* Qr = Ots + T * DP;             // the raw Q and dO tile
  float* Or = Qr + T * RST;
  float* Ls = Or + T * RST;             // two stages of T LSEs (natural log)
  float* Dl = Ls + 2 * T;               // two stages of δ
  int* qid = reinterpret_cast<int*>(Dl + 2 * T);   // two stages

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int k0 = blockIdx.x * ROWS, hk = blockIdx.y, b = blockIdx.z;
  const int GH = p.Hq / p.Hkv;
  const bool three = p.three != 0;

  const int nq = (p.Sq + T - 1) / T;
  // causal: a query tile whose last row is before k0 sees none of the keys
  const int qt0 = p.causal ? min(k0 / T, nq) : 0;
  const int per_head = nq - qt0;
  const int n_it = per_head * GH;

  auto load_q = [&](int it) {
    const int h = hk * GH + it / per_head;
    const int r0 = (qt0 + it % per_head) * T;
    load_rows<T, DP, RST, NTH>(Qr, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, r0,
                               p.Sq, p.D, tid);
    load_rows<T, DP, RST, NTH>(Or, p.dout + b * p.do_sb + h * p.do_sh,
                               p.do_ss, r0, p.Sq, p.D, tid);
    if (tid < T) {
      const int s = (it & 1) * T + tid, r = r0 + tid, rc = min(r, p.Sq - 1);
      const bool ok = r < p.Sq;
      const long long rb = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
      cp4(Ls + s, p.lse + rb + rc, ok);
      cp4(Dl + s, p.delta + rb + rc, ok);
      if (p.qseg != nullptr)
        cp4(qid + s, p.qseg + static_cast<long long>(b) * p.Sq + rc, ok);
    }
  };

  if (n_it > 0) load_q(0);
  cp_commit();
  split_resident<ROWS, DP, NTH>(Kb, Ks, p.k + b * p.k_sb + hk * p.k_sh,
                                p.k_ss, k0, p.Sk, p.D, tid, three);
  split_resident<ROWS, DP, NTH>(Vb, Vs, p.v + b * p.v_sb + hk * p.v_sh,
                                p.v_ss, k0, p.Sk, p.D, tid, three);

  const int key0 = k0 + 64 * wg + 16 * warp + g;
  const int key[2] = {key0, key0 + 8};
  int kid[2] = {0, 0};
  if (p.kseg != nullptr)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (key[i] < p.Sk)
        kid[i] = p.kseg[static_cast<long long>(b) * p.Sk + key[i]];
  float dv[DP / 2], dk[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dv[i] = dk[i] = 0.f;
  // this warpgroup's 64 keys of K and V, the tile's operands
  const uint64_t kB = kdesc<DP>(Kb + 64 * wg * DP);
  const uint64_t kS = kdesc<DP>(Ks + 64 * wg * DP);
  const uint64_t vB = kdesc<DP>(Vb + 64 * wg * DP);
  const uint64_t vS = kdesc<DP>(Vs + 64 * wg * DP);
  const uint64_t qB = kdesc<DP>(Qb), qS = kdesc<DP>(Qs);
  const uint64_t oB = kdesc<DP>(Ob), oS = kdesc<DP>(Os);
  const uint64_t qtB = kdesc<T>(Qtb), qtS = kdesc<T>(Qts);
  const uint64_t otB = kdesc<T>(Otb), otS = kdesc<T>(Ots);

  for (int it = 0; it < n_it; ++it) {
    const int r0 = (qt0 + it % per_head) * T, s = (it & 1) * T;
    cp_wait_all();
    __syncthreads();    // pair it landed; every product of pair it - 1 ended
    split_rows<T, DP, NTH>(Qr, Qb, Qs, tid, three);
    split_rows<T, DP, NTH>(Or, Ob, Os, tid, three);
    split_cols<T, DP, NTH>(Qr, Qtb, Qts, tid, three);
    split_cols<T, DP, NTH>(Or, Otb, Ots, tid, three);
    fence_proxy_async();
    __syncthreads();    // the split tile is visible to wgmma; raw is free
    if (it + 1 < n_it) load_q(it + 1);
    cp_commit();

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, 64 keys × T queries a warpgroup, in two
    // groups: Pᵀ and dV's products run while dPᵀ's finish
    float st[T / 2], dpt[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) st[i] = dpt[i] = 0.f;
    wg_fence();
    mma3_ss<T, DP / 8>(st, kB, kS, qB, qS);
    wg_commit();
    mma3_ss<T, DP / 8>(dpt, vB, vS, oB, oS);
    wg_commit();
    wg_wait<1>();
    fence_regs(st);

    // Pᵀ from each query column's LSE in st; the mask (P 0) only where the
    // tile holds rows past Sq, keys past Sk, the causal diagonal or segment
    // ids
    if (r0 + T > p.Sq || k0 + ROWS > p.Sk || p.kseg != nullptr ||
        (p.causal && k0 + ROWS - 1 > r0)) {
#pragma unroll
      for (int i = 0; i < T / 2; ++i) {
        const int ki = (i >> 1) & 1, c = (i >> 2) * 8 + 2 * t4 + (i & 1);
        const int col = r0 + c;
        const bool vis =
            col < p.Sq && key[ki] < p.Sk && (!p.causal || key[ki] <= col) &&
            (p.kseg == nullptr || kid[ki] == qid[s + c]);
        st[i] = vis ? exp2f(st[i] * p.scale_log2 - Ls[s + c] * LOG2E) : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < T / 2; ++i) {
        const int c = (i >> 2) * 8 + 2 * t4 + (i & 1);
        st[i] = exp2f(st[i] * p.scale_log2 - Ls[s + c] * LOG2E);
      }
    }
    // dV += Pᵀ·dO, Pᵀ straight from the accumulator into A fragments
    uint32_t pb[NK][4], ps[NK][4], db[NK][4], ds[NK][4];
    a_frag<NK>(st, pb, ps, three);
    wg_fence();
    mma3_rs<DP, NK>(dv, pb, ps, otB, otS);
    wg_commit();
    // dSᵀ = Pᵀ ∘ (dPᵀ − δ) once dPᵀ's group has ended; dK += dSᵀ·Q
    wg_wait<1>();
    fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < T / 2; ++i)
      dpt[i] = st[i] * (dpt[i] - Dl[s + (i >> 2) * 8 + 2 * t4 + (i & 1)]);
    a_frag<NK>(dpt, db, ds, three);
    wg_fence();
    mma3_rs<DP, NK>(dk, db, ds, qtB, qtS);
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pb);
    fence_regs(ps);
    fence_regs(db);
    fence_regs(ds);
  }
  cp_wait_all();        // with no pair to visit, nothing is in flight

  float* dkb = p.dk + b * p.dk_sb + hk * p.dk_sh;
  float* dvb = p.dv + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int ki = 0; ki < 2; ++ki) {
    if (key[ki] >= p.Sk) continue;
    float* rk = dkb + key[ki] * p.dk_ss;
    float* rv = dvb + key[ki] * p.dv_ss;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      const int col = dn * 8 + 2 * t4;
      if (col < p.D) {
        rv[col] = dv[4 * dn + 2 * ki];
        rv[col + 1] = dv[4 * dn + 2 * ki + 1];
        rk[col] = dk[4 * dn + 2 * ki] * p.scale;
        rk[col + 1] = dk[4 * dn + 2 * ki + 1] * p.scale;
      }
    }
  }
}

template <int DP>
int launch_dkv_wg(const Params& p, int smem, cudaStream_t st) {
  if (smem != K3W<DP>::BYTES) return cudaErrorInvalidValue;  // plan differs
  return launch(flash_bwd_dkv_f32_wg<DP>,
                dim3((p.Sk + 64 * K3W<DP>::G - 1) / (64 * K3W<DP>::G), p.Hkv,
                     p.B),
                128 * K3W<DP>::G, K3W<DP>::BYTES, p, st);
}

// ---------------------------------------------------------------------------
// K3 f32 on mma.sync (padded head dims above 128)
// ---------------------------------------------------------------------------

// eight warps, 0-3 dV and 4-7 dK over the same 16-key rows
template <int DP>
__global__ void __launch_bounds__(256) flash_bwd_dkv_f32_kernel(const Params p) {
  constexpr int NTH = 256;
  constexpr int NC = DP / 8;
  constexpr int ST = DP + 4;
  constexpr int T = tile_rows<DP>(), NT = T / 8, PST = T + 4;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BM * ST;
  float* Qs = Vs + BM * ST;             // two stages
  float* Os = Qs + 2 * T * ST;          // dO, two stages
  float* Ps = Os + 2 * T * ST;          // a patch per warp
  float* Ls = Ps + (NTH / 32) * 16 * PST;   // two stages of lse·log2 e
  float* Dl = Ls + 2 * T;                   // two stages of δ
  int* qid = reinterpret_cast<int*>(Dl + 2 * T);  // two stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * BM, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const bool three = p.three != 0;
  const bool want_dv = warp < 4;
  const bool want_dk = warp >= 4;
  const int kw = warp & 3;              // the warp's 16 keys

  const int nq = (p.Sq + T - 1) / T;
  // causal: a query tile whose last row is before k0 sees none of the keys
  const int qt0 = p.causal ? min(k0 / T, nq) : 0;
  const int per_head = nq - qt0;
  const int n_it = per_head * G;

  auto load_q = [&](int it, int s) {
    const int h = hk * G + it / per_head;
    const int r0 = (qt0 + it % per_head) * T;
    load_rows<T, DP, ST, NTH>(Qs + s * T * ST,
                              p.q + b * p.q_sb + h * p.q_sh, p.q_ss, r0,
                              p.Sq, p.D, tid);
    load_rows<T, DP, ST, NTH>(Os + s * T * ST,
                              p.dout + b * p.do_sb + h * p.do_sh, p.do_ss,
                              r0, p.Sq, p.D, tid);
    if (tid < T) {
      const int r = r0 + tid;
      const bool ok = r < p.Sq;
      const long long rb = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
      Ls[s * T + tid] = ok ? p.lse[rb + r] * LOG2E : 0.f;
      Dl[s * T + tid] = ok ? p.delta[rb + r] : 0.f;
      qid[s * T + tid] =
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
  float acc[NC][4];     // this warp's dV or dK
#pragma unroll
  for (int dn = 0; dn < NC; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  const float* Kw = Ks + kw * 16 * ST;
  const float* Vw = Vs + kw * 16 * ST;
  float* Pw = Ps + warp * 16 * PST;

  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1;
    const int r0 = (qt0 + it % per_head) * T;
    cp_wait_all();
    __syncthreads();    // pair it landed for all; pair it - 1 is done with
    if (it + 1 < n_it) load_q(it + 1, s ^ 1);
    cp_commit();
    const float* Qt = Qs + s * T * ST;
    const float* Ot = Os + s * T * ST;
    const float* Lt = Ls + s * T;
    const float* Dt = Dl + s * T;
    const int* It = qid + s * T;

    // Sᵀ = K·Qᵀ (and for dK dPᵀ = V·dOᵀ), 16 keys × T queries a warp
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    rows_by_rows<NT, NC, ST, ST>(st, Kw, Qt, g, t4, three);
    if (want_dk) rows_by_rows<NT, NC, ST, ST>(dpt, Vw, Ot, g, t4, three);

    // Pᵀ from each query column's LSE (0 where masked) in st; dSᵀ in dpt
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
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
      to_patch<NT>(Pw, st, g, t4);
      __syncwarp();
      patch_by_tile<T, NC, ST>(acc, Pw, Ot, g, t4, three);
      __syncwarp();
    }
    if (want_dk) {      // dK += dSᵀ·Q
      to_patch<NT>(Pw, dpt, g, t4);
      __syncwarp();
      patch_by_tile<T, NC, ST>(acc, Pw, Qt, g, t4, three);
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
          rv[col] = acc[dn][2 * ki];
          rv[col + 1] = acc[dn][2 * ki + 1];
        }
        if (want_dk) {
          rk[col] = acc[dn][2 * ki] * p.scale;
          rk[col + 1] = acc[dn][2 * ki + 1] * p.scale;
        }
      }
    }
  }
}

template <int DP>
int launch_dkv(const Params& p, int smem, cudaStream_t st) {
  const int bytes = k3_smem_floats<DP>() * 4;
  if (smem != bytes) return cudaErrorInvalidValue;
  return launch(flash_bwd_dkv_f32_kernel<DP>,
                dim3((p.Sk + BM - 1) / BM, p.Hkv, p.B), 256, bytes, p, st);
}

}  // namespace

// K3 f32. q, do [B, Sq, Hq, D], k, v [B, Sk, Hkv, D], all fp32 with a unit
// last stride, strides multiples of 4 elements and 16-byte aligned bases;
// lse and delta fp32 [B, Hq, Sq] contiguous; q_seg [B, Sq] and kv_seg
// [B, Sk] int32 contiguous, or both null; dk, dv [B, Sk, Hkv, D] fp32 out.
// strides: the 21 of make_params. passes: 3 (split TF32) or 1 (one-pass
// TF32, the control). smem: the wrapper's plan of the block's shared
// memory in bytes, which must be the kernel's. Returns 0 on success, else
// a CUDA error code (cudaErrorInvalidValue for arguments it does not
// take).
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
  switch (padded_dp(D)) {
    case 16: return launch_dkv_wg<16>(p, smem, st);
    case 32: return launch_dkv_wg<32>(p, smem, st);
    case 48: return launch_dkv_wg<48>(p, smem, st);
    case 64: return launch_dkv_wg<64>(p, smem, st);
    case 80: return launch_dkv_wg<80>(p, smem, st);
    case 96: return launch_dkv_wg<96>(p, smem, st);
    case 112: return launch_dkv_wg<112>(p, smem, st);
    case 128: return launch_dkv_wg<128>(p, smem, st);
    case 144: return launch_dkv<144>(p, smem, st);
    case 160: return launch_dkv<160>(p, smem, st);
    case 192: return launch_dkv<192>(p, smem, st);
    case 256: return launch_dkv<256>(p, smem, st);
    default: return cudaErrorInvalidValue;
  }
}
