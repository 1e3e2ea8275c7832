// K2 and K3: flash-attention backward (bf16 in and out, fp32 softmax and
// accumulation).
//
// Replace the Pallas TPU kernels mllm_npu_tpu/ops/flash_attention.py:333
// `_bwd_dq_kernel` (K2) and :407 `_bwd_dkv_kernel` (K3), both launched by
// `_bwd` :502. Python wrappers and plain PyTorch versions:
// mllm_npu_tpu_torch/ops/flash_attention.py (flash_bwd_dq, flash_bwd_dkv).
//
// What they compute, per (batch, query head h, KV head hk = h·Hkv/Hq), with
// P recomputed from the forward's log-sum-exp (K1 writes it) and the masks
// of K1 (causal top-left, segment ids, the ragged tail):
//   P   = exp(scale·Q Kᵀ − lse)      (0 where masked)
//   dP  = dO Vᵀ
//   dS  = P ∘ (dP − δ),  δ = rowsum(dO ∘ O) (computed by the wrapper)
//   K2: dQ = scale · dS K
//   K3: dV = Σ_h Pᵀ dO,  dK = scale · Σ_h dSᵀ Q, summed over the G = Hq/Hkv
//       query heads of each KV head inside the block.
// A row whose keys are all masked has lse 0 and P 0, so its gradients are
// 0, never NaN.
//
// What bounds them on an H100. K2 does 3 and K3 4 products of
// 2·Sq·Sk·D flops per (batch, query head) over the pairs the masks keep,
// and each moves Q, K, V, dO and one or two outputs once. At the training
// shapes (Llama S=600 D=128, GQA 32/8; the resampler 64×729 D=128) the
// flops per byte are far above the card's ~295 balance point, so the
// tensor cores bound them; this first design, like K1, is held back by
// mma.sync, scalar B-operand loads for the products whose reduction runs
// over the sequence, and per-element masks.
//
// Design, simple first (wgmma, TMA and a fused dQ are later work):
//  * K2: one block of 4 warps per (64-row query tile, query head, batch);
//    each warp owns 16 query rows. Q and dO stay in shared memory; a loop
//    over 64-row K/V tiles (double-buffered with cp.async; causal: up to
//    the diagonal) recomputes S and dP on the tensor cores, forms dS in
//    the accumulator registers and feeds it, as bf16, straight into the
//    A operand of dS·K (the FlashAttention-2 register layout). dQ stays in
//    fp32 registers and is written once. No atomics.
//  * K3: one block of 4 warps per (64-row KV tile, KV head, batch); each
//    warp owns 16 key rows. K and V stay in shared memory; the block walks
//    every (query head of the group, 32-row query tile) pair, Q/dO/lse/δ
//    double-buffered, recomputes Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, and
//    accumulates dV += Pᵀ dO and dK += dSᵀ Q in fp32 registers across the
//    whole group. Each KV head is written once: no per-query-head
//    temporaries and no group sum afterwards. Causal: query tiles that end
//    before the KV tile starts are skipped.
//  * GQA reads KV head h·Hkv/Hq directly; K/V are never repeated.
//  * head dims: any D % 8 == 0 up to 128, padded in shared memory only to
//    the MMA k-granule of 16 (72 → 80); layout [B, S, H, D] through
//    strides for the inputs and outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_DEVICES = 64;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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
         p.D >= 8 && p.D <= 128 && p.Hkv > 0 && p.Hq % p.Hkv == 0;
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 on success). Pointers
// are device pointers, `strides` a host array of 21 element strides;
// q_seg/kv_seg may be null. lse (natural log) and delta are fp32
// [B, Hq, Sq], contiguous.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* q_seg,
                                 const void* kv_seg, void* dq, int B, int Sq,
                                 int Sk, int Hq, int Hkv, int D,
                                 const long long* strides, float scale,
                                 int causal, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, q_seg, kv_seg, dq,
                               nullptr, nullptr, B, Sq, Sk, Hq, Hkv, D,
                               strides, scale, causal);
  if (!valid(p)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return launch_dq<16>(p, st);
    case 2: return launch_dq<32>(p, st);
    case 3: return launch_dq<48>(p, st);
    case 4: return launch_dq<64>(p, st);
    case 5: return launch_dq<80>(p, st);
    case 6: return launch_dq<96>(p, st);
    case 7: return launch_dq<112>(p, st);
    default: return launch_dq<128>(p, st);
  }
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* q_seg, const void* kv_seg,
                                  void* dk, void* dv, int B, int Sq, int Sk,
                                  int Hq, int Hkv, int D,
                                  const long long* strides, float scale,
                                  int causal, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, q_seg, kv_seg,
                               nullptr, dk, dv, B, Sq, Sk, Hq, Hkv, D,
                               strides, scale, causal);
  if (!valid(p)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return launch_dkv<16>(p, st);
    case 2: return launch_dkv<32>(p, st);
    case 3: return launch_dkv<48>(p, st);
    case 4: return launch_dkv<64>(p, st);
    case 5: return launch_dkv<80>(p, st);
    case 6: return launch_dkv<96>(p, st);
    case 7: return launch_dkv<112>(p, st);
    default: return launch_dkv<128>(p, st);
  }
}
