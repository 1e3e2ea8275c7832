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
// K3 f32: dK and dV
// ---------------------------------------------------------------------------

// SPLIT: eight warps, 0-3 dV and 4-7 dK over the same 16-key rows
template <int DP, bool SPLIT>
__global__ void __launch_bounds__(SPLIT ? 256 : 128)
    flash_bwd_dkv_f32_kernel(const Params p) {
  constexpr int NTH = SPLIT ? 256 : 128;
  constexpr int NC = DP / 8;
  constexpr int ST = DP + 4;
  constexpr int T = tile_rows<DP>(), NT = T / 8, PST = T + 4;
  constexpr int NACC = SPLIT ? 1 : 2;   // [0] dV (or this warp's), [NACC-1] dK
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
  const bool want_dv = !SPLIT || warp < 4;
  const bool want_dk = !SPLIT || warp >= 4;
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
      patch_by_tile<T, NC, ST>(acc[0], Pw, Ot, g, t4, three);
      __syncwarp();
    }
    if (want_dk) {      // dK += dSᵀ·Q
      to_patch<NT>(Pw, dpt, g, t4);
      __syncwarp();
      patch_by_tile<T, NC, ST>(acc[NACC - 1], Pw, Qt, g, t4, three);
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

template <int DP>
int launch_dkv(const Params& p, int smem, cudaStream_t st) {
  constexpr bool SPLIT = DP > 128;
  const int bytes = k3_smem_floats<DP, SPLIT ? 8 : 4>() * 4;
  if (smem != bytes) return cudaErrorInvalidValue;
  return launch(flash_bwd_dkv_f32_kernel<DP, SPLIT>,
                dim3((p.Sk + BM - 1) / BM, p.Hkv, p.B), SPLIT ? 256 : 128,
                bytes, p, st);
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
    case 192: return launch_dkv<192>(p, smem, st);
    case 256: return launch_dkv<256>(p, smem, st);
    default: return cudaErrorInvalidValue;
  }
}
