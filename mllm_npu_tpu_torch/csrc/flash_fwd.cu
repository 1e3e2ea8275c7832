// K1: flash-attention forward (bf16 in, fp32 softmax and accumulation).
//
// Replaces the Pallas TPU kernel mllm_npu_tpu/ops/flash_attention.py:100
// `_fwd_kernel` (launched by `_fwd` :211). Python wrapper and plain
// PyTorch version: mllm_npu_tpu_torch/ops/flash_attention.py.
//
// What bounds it on an H100. Attention forward does 4·Sq·Sk·D flops per
// (batch, query head) over the pairs the masks keep, and moves Q, K, V and
// O once. At the path's shapes (SigLIP S=729 D=72 over 80 heads·images;
// Llama prefill S≈340 D=128, GQA 32/8; resampler 64×729 D=128) the flops
// per byte exceed the card's ~295 flops/byte balance point except for the
// short causal prefill, so the tensor cores bound the long shapes and
// memory (plus launch latency) the short ones.
//
// Design, simple first (wgmma/TMA and warp specialisation are later work):
//  * one block of 4 warps per (64-row query tile, query head, batch); each
//    warp owns 16 query rows. A loop over 64-row KV tiles replaces the TPU
//    kernel's sequential grid axis; running max, running sum and the
//    output accumulator stay in registers in fp32.
//  * QKᵀ and PV on the tensor cores with mma.sync m16n8k16 bf16→fp32. The
//    P tile goes from the QKᵀ accumulator registers straight into the A
//    operand of PV (the FlashAttention-2 register layout), never to memory.
//  * K/V tiles are double-buffered in shared memory with cp.async, so the
//    next tile loads while this one computes. Loads are 16 bytes a thread,
//    rows padded by 8 elements so fragment reads are bank-conflict free.
//  * GQA: the block reads KV head h·Hkv/Hq directly; K/V are never
//    repeated in memory.
//  * causal: the KV loop ends at the tile holding the diagonal of the
//    block's last row; masks (causal, segment ids, the ragged tail) are
//    applied per element. Tail rows are zero-filled by cp.async, and a row
//    with every key masked leaves l == 0 and writes 0, never NaN.
//  * head dims: the head dim is padded in shared memory only, to the MMA
//    k-granule of 16 (72 → 80); the pad columns are zeroed once. Any
//    D % 8 == 0 up to 128 runs natively; no 128-lane padding in memory.
//  * layout [B, S, H, D] through strides, so no transposes.
//  * the training forward also writes each row's log-sum-exp (fp32
//    [B, Hq, Sq], natural log: m + log l from the running max and sum the
//    softmax keeps anyway, 0 for a row whose keys are all masked, as the
//    reference's `_finish`). K2 and K3 (flash_bwd.cu) recompute P from
//    it. Serving passes a null pointer and writes none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // key rows per KV tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_DEVICES = 64;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;       // [B, Hq, Sq] or null
  const int* qseg;  // [B, Sq] or null
  const int* kseg;  // [B, Sk] or null
  int B, Sq, Sk, Hq, Hkv, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // softmax scale · log2(e): the softmax runs in base 2
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

// rows [row0, row0 + 64) of a [S, D] slice (row stride ss) into a
// [64][LD] shared tile; rows at or past S are zero-filled.
template <int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int row0, int S,
                                          int D, int tid) {
  const int chunks = D / 8;
  for (int i = tid; i < 64 * chunks; i += THREADS) {
    const int r = i / chunks, c = i - r * chunks;
    const int gr = row0 + r;
    const bool ok = gr < S;
    cp_async16(dst + r * LD + c * 8, ok ? src + gr * ss + c * 8 : src, ok);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const Params p) {
  constexpr int LD = DP + 8;
  constexpr int NKK = DP / 16;  // k-steps of QKᵀ
  constexpr int ND = DP / 8;    // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;      // 2 buffers
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;  // 2 buffers
  int* Ss = reinterpret_cast<int*>(Vs + 2 * BK * LD);  // 2 × BK kv seg ids

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h * p.Hkv / p.Hq;
  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + hk * p.v_sh;

  // the head-dim padding columns are never written by cp.async: zero them
  // once in the Q tile and all four K/V buffers (contiguous rows of LD)
  if (DP > p.D) {
    const int padc = DP - p.D;
    for (int i = tid; i < (BQ + 4 * BK) * padc; i += THREADS) {
      const int r = i / padc, c = p.D + (i - r * padc);
      Qs[r * LD + c] = __float2bfloat16(0.f);
    }
  }

  int n_kv = (p.Sk + BK - 1) / BK;
  if (p.causal) {
    const int last_row = min(q0 + BQ, p.Sq) - 1;
    n_kv = min(n_kv, last_row / BK + 1);
  }

  auto load_kv = [&](int j, int buf) {
    load_tile<LD>(Ks + buf * BK * LD, kg, p.k_ss, j * BK, p.Sk, p.D, tid);
    load_tile<LD>(Vs + buf * BK * LD, vg, p.v_ss, j * BK, p.Sk, p.D, tid);
    if (p.kseg) {
      for (int i = tid; i < BK; i += THREADS) {
        const int c = j * BK + i;
        Ss[buf * BK + i] = c < p.Sk ? p.kseg[b * p.Sk + c] : 0;
      }
    }
  };

  load_tile<LD>(Qs, qg, p.q_ss, q0, p.Sq, p.D, tid);
  if (n_kv > 0) load_kv(0, 0);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  int qs0 = 0, qs1 = 0;
  if (p.qseg) {
    qs0 = r0 < p.Sq ? p.qseg[b * p.Sq + r0] : 0;
    qs1 = r1 < p.Sq ? p.qseg[b * p.Sq + r1] : 0;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  uint32_t qf[NKK][4];

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

    if (j == 0) {
      const __nv_bfloat16* qw = Qs + (warp * 16) * LD;
#pragma unroll
      for (int kk = 0; kk < NKK; ++kk) {
        const __nv_bfloat16* a = qw + kk * 16 + 2 * t;
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(a + g * LD);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(a + (g + 8) * LD);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(a + g * LD + 8);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(a + (g + 8) * LD + 8);
      }
    }
    const __nv_bfloat16* Kb = Ks + buf * BK * LD;
    const __nv_bfloat16* Vb = Vs + buf * BK * LD;
    const int* Sb = Ss + buf * BK;

    // S = Q Kᵀ for this warp's 16 rows × 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kr = Kb + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale and mask (tail, causal, segments)
    const int k0 = j * BK;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int cl = n * 8 + 2 * t + (e & 1);
        const int col = k0 + cl;
        bool ok = col < p.Sk;
        if (p.causal) ok = ok && col <= row;
        if (p.kseg) ok = ok && (e < 2 ? qs0 : qs1) == Sb[cl];
        s[n][e] = ok ? s[n][e] * p.scale_log2 : -INFINITY;
      }
    }

    // online softmax (base 2); a row's 4 owner threads are lanes 4g..4g+3
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no visible key so far keeps max -inf: subtract 0 instead,
    // so every exp2 below is of -inf (→ 0) and never of NaN
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = exp2f(m0 - mu0), al1 = exp2f(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mu0);
      s[n][1] = exp2f(s[n][1] - mu0);
      s[n][2] = exp2f(s[n][2] - mu1);
      s[n][3] = exp2f(s[n][3] - mu1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + ps0;  // per-thread partial sums, reduced at the end
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // O += P V: P's accumulator layout is PV's A-operand layout
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                              pack_f32(s[2 * kk][2], s[2 * kk][3]),
                              pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = Vb + (kk * 16 + 2 * t) * LD;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = n * 8 + g;
        mma_bf16(acc[n], pa, pack_bf16(vr[c], vr[LD + c]),
                 pack_bf16(vr[8 * LD + c], vr[9 * LD + c]));
      }
    }
    __syncthreads();  // this buffer is reloaded two tiles on
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float i1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if (p.lse != nullptr && t == 0) {
    // natural-log LSE of the scaled logits: m and l are in base 2
    float* lg = p.lse + ((long long)b * p.Hq + h) * p.Sq;
    if (r0 < p.Sq) lg[r0] = l0 > 0.f ? (m0 + log2f(l0)) * 0.6931471805599453f : 0.f;
    if (r1 < p.Sq) lg[r1] = l1 > 0.f ? (m1 + log2f(l1)) * 0.6931471805599453f : 0.f;
  }
  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (col < p.D) {
      if (r0 < p.Sq)
        *reinterpret_cast<uint32_t*>(og + r0 * p.o_ss + col) =
            pack_f32(acc[n][0] * i0, acc[n][1] * i0);
      if (r1 < p.Sq)
        *reinterpret_cast<uint32_t*>(og + r1 * p.o_ss + col) =
            pack_f32(acc[n][2] * i1, acc[n][3] * i1);
    }
  }
}

template <int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = (BQ + 4 * BK) * (DP + 8) * sizeof(__nv_bfloat16) +
                   2 * BK * sizeof(int);
  // the shared-memory limit is a per-device attribute: set it once each
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    e = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    attr_set[dev] = true;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_fwd_kernel<DP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). Pointers are
// device pointers; strides are in elements; lse and q_seg/kv_seg may be
// null.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* q_seg,
                              const void* kv_seg,
                              int B, int Sq, int Sk, int Hq, int Hkv, int D,
                              long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              long long o_sb, long long o_ss, long long o_sh,
                              float scale, int causal, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.qseg = static_cast<const int*>(q_seg);
  p.kseg = static_cast<const int*>(kv_seg);
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.Hkv = Hkv; p.D = D;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((p.qseg == nullptr) != (p.kseg == nullptr) || D % 8 != 0)
    return cudaErrorInvalidValue;
  switch ((D + 15) / 16) {
    case 1: return launch<16>(p, st);
    case 2: return launch<32>(p, st);
    case 3: return launch<48>(p, st);
    case 4: return launch<64>(p, st);
    case 5: return launch<80>(p, st);
    case 6: return launch<96>(p, st);
    case 7: return launch<112>(p, st);
    case 8: return launch<128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}
