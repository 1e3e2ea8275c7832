// K1 f32: flash-attention forward on fp32 operands (fp32 in, fp32 out), for
// Hopper, accurate to fp32: both products in split TF32 on the tensor cores.
//
// Replaces the Pallas TPU kernel mllm_npu_tpu/ops/flash_attention.py:100
// `_fwd_kernel` (launched by `_fwd` :211 through `pl.pallas_call` :282) for
// fp32 q/k/v: the reference computes in the operands' dtype and writes
// q.dtype, so the fp32 de-tokenizer and fp32 serving reach it with fp32
// operands. The bf16 variant is flash_fwd.cu; the fp32 backward (K2 f32,
// K3 f32) is flash_bwd_f32.cu. Python wrapper and plain PyTorch version:
// mllm_npu_tpu_torch/ops/flash_attention.py (`flash_attention`,
// `flash_attention_reference`).
//
// What it computes, per (batch b, query head h, KV head h·Hkv/Hq):
//   O = softmax(scale·Q Kᵀ + mask) V, mask = top-left causal ∧ segment ids
//   (q_seg == kv_seg) ∧ the keys that exist; a row with no visible key
//   writes 0. Where the caller asks (training), also each row's
//   natural-log LSE, fp32 [B, Hq, Sq], 0 for a row with no visible key:
//   bf16 K1's and the reference's convention (:195-201), which K2 f32 and
//   K3 f32 read.
//
// What bounds it on an H100 (495 TFLOP/s dense TF32, 67 TFLOP/s fp32 outside
// the tensor cores, 3.35 TB/s). 4·D flops per visible (query, key) pair and
// head; the UNet's self-attention at 4096 positions (B 2, H 10, D 64) is
// 8.6 GFLOP against 21 MB, so it is bound by operations, 0.017 ms at the
// TF32 rate. fp32 FMA alone would bound it at 0.13 ms; the tensor cores take
// fp32 only as TF32 (10-bit mantissa, about three decimal digits), which is
// not an fp32 product.
//
// Design (a kernel that is right first; speed is later work):
//  * Accuracy: each operand x is split into big = tf32(x) and
//    small = tf32(x − big), and a·b is summed as small·big + big·small +
//    big·big (mma.sync m16n8k8 TF32, fp32 accumulation). The dropped
//    small·small term is about 2^-22 of the product: fp32's own rounding.
//    `passes` = 1 runs big·big alone (one-pass TF32): a control for the
//    tolerance the checks hold the kernel to, never the serving path.
//  * Blocks of 64 query rows of one (b, h), four warps of 16 rows each; K/V
//    tiles of 32 keys double-buffered in shared memory by cp.async (16-byte
//    copies, zero-filled past Sk and past D). Q stays in shared memory for
//    the block's life. Row strides are padded so that every fragment load
//    is free of bank conflicts.
//  * S = Q·Kᵀ per warp (16 × 32), the mask, then the online softmax in base
//    2 on the accumulator layout (row maxima and sums across the quad of
//    lanes that share a row). P goes through a per-warp patch of shared
//    memory to become the A operand of O += P·V (16 × D per warp, in
//    registers). P stays fp32: the reference casts P to V's dtype.
//  * The scale (times log2 e) is folded into Q as its fragments are read
//    when Sq·(0.5 if causal else 1) ≥ D, and into the logits tile otherwise:
//    the reference's rule (flash_attention.py:238-243).
//  * Causal: tiles above the diagonal of a block's last row are not loaded.
//    The mask runs only on tiles that hold keys past Sk, cross the
//    diagonal of the warp's rows, or with segment ids.
//  * GQA reads KV head h·Hkv/Hq directly; [B, S, H, D] through strides.
//  * Head dims: multiples of 8 up to 256, computed at `padded_dp(D)`: D
//    rounded up to 16 up to 160, above it 192 or 256 (the reference pads D
//    to 256 there), one instantiation per width; the cp.async loads
//    zero-fill the columns past D, so the padded columns add nothing.
//    ops/flash_attention.py k1_f32_plan mirrors the shared memory and the
//    warps, and the wrapper hands its byte count in: a launch whose plan
//    differs from the kernel's is refused.
//  * Above 160: a block takes 157 KB at DP 192 and 205 KB at DP 256 (one
//    block an SM), and O is 16 × DP fp32 a warp, 128 accumulators a thread
//    at 256. The four warps keep the whole of O each: ptxas fits that in
//    the 255 registers a thread of `__launch_bounds__(128)` with no spill
//    (the registers below), so O's columns are not split between warps.
//
// Registers (ptxas, sm_90a, 128 threads): 64 to 168 a thread up to DP
// 192, 224 at 256; no spills.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // query rows a block
constexpr int BN = 32;          // keys a K/V tile
constexpr int WARPS = 4;        // 16 query rows each
constexpr int THREADS = WARPS * 32;
constexpr int PST = BN + 4;     // row stride of a warp's P patch
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;     // [B, Hq, Sq] or null
  const int* qseg;
  const int* kseg;
  int B, Sq, Sk, Hq, Hkv, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float q_mul;    // scale·log2 e folded into Q, or 1
  float s_mul;    // scale·log2 e on the logits tile, or 1
  int causal;
  int three;      // split TF32 (1) or one pass (0)
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

template <int DP>
constexpr int smem_floats() {
  return BM * (DP + 4) + 2 * BN * (DP + 4) + 2 * BN * (DP + 8) +
         WARPS * 16 * PST + 2 * BN;   // the last: two stages of kv ids
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_f32_kernel(const Params p) {
  constexpr int NC = DP / 8;            // 8-column chunks of the head dim
  constexpr int QST = DP + 4, KST = DP + 4, VST = DP + 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * QST;
  float* Vs = Ks + 2 * BN * KST;
  float* Ps = Vs + 2 * BN * VST;
  int* kid = reinterpret_cast<int*>(Ps + WARPS * 16 * PST);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h * p.Hkv / p.Hq;
  const int D = p.D;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const bool three = p.three != 0;

  for (int c = tid; c < BM * DP / 4; c += THREADS) {
    const int r = c / (DP / 4), col = c % (DP / 4) * 4;
    const bool ok = q0 + r < p.Sq && col < D;
    cp16(Qs + r * QST + col, ok ? qb + (q0 + r) * p.q_ss + col : p.q, ok);
  }
  auto load_kv = [&](int j, int s) {
    const int k0 = j * BN;
    for (int c = tid; c < BN * DP / 4; c += THREADS) {
      const int r = c / (DP / 4), col = c % (DP / 4) * 4;
      const bool ok = k0 + r < p.Sk && col < D;
      cp16(Ks + (s * BN + r) * KST + col,
           ok ? kb + (k0 + r) * p.k_ss + col : p.k, ok);
      cp16(Vs + (s * BN + r) * VST + col,
           ok ? vb + (k0 + r) * p.v_ss + col : p.v, ok);
    }
    if (p.kseg != nullptr && tid < BN)
      kid[s * BN + tid] =
          k0 + tid < p.Sk ? p.kseg[static_cast<long long>(b) * p.Sk + k0 + tid]
                          : 0;
  };

  int n_tiles = (p.Sk + BN - 1) / BN;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + BM, p.Sq) - 1) / BN + 1);
  load_kv(0, 0);
  cp_commit();

  const int wrow = q0 + warp * 16;      // the warp's first query row
  const int row[2] = {wrow + g, wrow + g + 8};
  int qid[2] = {0, 0};
  if (p.qseg != nullptr)
    for (int i = 0; i < 2; ++i)
      qid[i] = row[i] < p.Sq
                   ? p.qseg[static_cast<long long>(b) * p.Sq + row[i]]
                   : 0;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NC][4];
#pragma unroll
  for (int dn = 0; dn < NC; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float* Pw = Ps + warp * 16 * PST;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1, k0 = j * BN;
    cp_wait_all();
    __syncthreads();    // tile j landed for all; tile j - 1 is done with
    if (j + 1 < n_tiles) load_kv(j + 1, s ^ 1);
    cp_commit();

    // S = Q·Kᵀ, 16 × 32 per warp
    float sc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    const float* Kt = Ks + s * BN * KST;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) {
      const float* qr = Qs + (warp * 16 + g) * QST + kk * 8 + t4;
      const float a[4] = {qr[0], qr[8 * QST], qr[4], qr[8 * QST + 4]};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(a[i] * p.q_mul, ab[i], as[i]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* kr = Kt + (nt * 8 + g) * KST + kk * 8 + t4;
        uint32_t bb0, bs0, bb1, bs1;
        split(kr[0], bb0, bs0);
        split(kr[4], bb1, bs1);
        mma3(sc[nt], ab, as, bb0, bb1, bs0, bs1, three);
      }
    }

    // the scale in the tile (or 1), then the mask where the tile needs one
    const bool masked = k0 + BN > p.Sk ||
                        (p.causal && k0 + BN - 1 > wrow) || p.qseg != nullptr;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e] * p.s_mul;
        if (masked) {
          const int c = nt * 8 + 2 * t4 + (e & 1), col = k0 + c;
          const int ri = e >> 1;
          const bool vis = col < p.Sk && (!p.causal || col <= row[ri]) &&
                           (p.qseg == nullptr || qid[ri] == kid[s * BN + c]);
          if (!vis) x = -INFINITY;
        }
        sc[nt][e] = x;
      }

    // online softmax in base 2, one row per half of the accumulator
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mx = fmaxf(mx, fmaxf(sc[nt][2 * ri], sc[nt][2 * ri + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(m[ri], mx);
      const float base = mnew == -INFINITY ? 0.f : mnew;
      const float alpha = exp2f(m[ri] - base);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 2 * ri; e < 2 * ri + 2; ++e) {
          const float pv = exp2f(sc[nt][e] - base);
          sc[nt][e] = pv;
          sum += pv;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[ri] = l[ri] * alpha + sum;
      m[ri] = mnew;
#pragma unroll
      for (int dn = 0; dn < NC; ++dn) {
        o[dn][2 * ri] *= alpha;
        o[dn][2 * ri + 1] *= alpha;
      }
    }

    // P (C layout) → shared → A fragments; O += P·V
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = nt * 8 + 2 * t4;
      Pw[g * PST + c] = sc[nt][0];
      Pw[g * PST + c + 1] = sc[nt][1];
      Pw[(g + 8) * PST + c] = sc[nt][2];
      Pw[(g + 8) * PST + c + 1] = sc[nt][3];
    }
    __syncwarp();
    const float* Vt = Vs + s * BN * VST;
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      const float* pr = Pw + g * PST + kk * 8 + t4;
      const float a[4] = {pr[0], pr[8 * PST], pr[4], pr[8 * PST + 4]};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(a[i], ab[i], as[i]);
#pragma unroll
      for (int dn = 0; dn < NC; ++dn) {
        const float* vr = Vt + (kk * 8 + t4) * VST + dn * 8 + g;
        uint32_t bb0, bs0, bb1, bs1;
        split(vr[0], bb0, bs0);
        split(vr[4 * VST], bb1, bs1);
        mma3(o[dn], ab, as, bb0, bb1, bs0, bs1, three);
      }
    }
    __syncwarp();       // the patch is rewritten by the next tile
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row[ri] >= p.Sq) continue;
    if (p.lse != nullptr && t4 == 0)   // m is in base-2 units of the logits
      p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + row[ri]] =
          l[ri] > 0.f ? (m[ri] + log2f(l[ri])) * LN2 : 0.f;
    const float inv = l[ri] > 0.f ? 1.f / l[ri] : 0.f;
    float* orow = p.o + b * p.o_sb + row[ri] * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int dn = 0; dn < NC; ++dn) {
      const int col = dn * 8 + 2 * t4;     // D % 8 == 0: col + 1 < D too
      if (col < D) {
        orow[col] = o[dn][2 * ri] * inv;
        orow[col + 1] = o[dn][2 * ri + 1] * inv;
      }
    }
  }
}

// the head dim the kernel computes at for D (a multiple of 8 up to 256);
// the mirror of ops/flash_attention.py padded_head_dim
constexpr int padded_dp(int D) {
  return D <= 160 ? (D + 15) / 16 * 16 : D <= 192 ? 192 : 256;
}

template <int DP>
int launch(const Params& p, int smem, cudaStream_t stream) {
  const int bytes = smem_floats<DP>() * 4;
  if (smem != bytes) return cudaErrorInvalidValue;   // the plan differs
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BM - 1) / BM, p.Hq, p.B);
  flash_fwd_f32_kernel<DP><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, long long sb, long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 4 == 0 &&
         ss % 4 == 0 && sh % 4 == 0;
}

}  // namespace

// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], o [B, Sq, Hq, D], all fp32 with a
// unit last stride, strides multiples of 4 elements and 16-byte aligned
// bases; lse fp32 [B, Hq, Sq] contiguous, or null (no LSE written); q_seg
// [B, Sq] and kv_seg [B, Sk] int32 contiguous, or both null. passes: 3
// (split TF32) or 1 (one-pass TF32, the control). smem: the wrapper's plan
// of the block's shared memory in bytes, which must be the kernel's.
// Returns 0 on success, else a CUDA error code (cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* q_seg,
                             const void* kv_seg,
                             int B, int Sq, int Sk, int Hq, int Hkv, int D,
                             long long q_sb, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             long long o_sb, long long o_ss, long long o_sh,
                             float scale, int causal, int passes,
                             int smem, void* stream) {
  if ((q_seg == nullptr) != (kv_seg == nullptr) || D % 8 != 0 || D < 8 ||
      D > 256 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0 ||
      Hq > 65535 || B > 65535 || (passes != 1 && passes != 3) ||
      !aligned(q, q_sb, q_ss, q_sh) || !aligned(k, k_sb, k_ss, k_sh) ||
      !aligned(v, v_sb, v_ss, v_sh))
    return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.qseg = static_cast<const int*>(q_seg);
  p.kseg = static_cast<const int*>(kv_seg);
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.Hkv = Hkv; p.D = D;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  // the reference's rule: into q where the logits tiles outweigh q
  const bool fold_q = static_cast<double>(Sq) * (causal ? 0.5 : 1.0) >= D;
  p.q_mul = fold_q ? scale * LOG2E : 1.f;
  p.s_mul = fold_q ? 1.f : scale * LOG2E;
  p.causal = causal;
  p.three = passes == 3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded_dp(D)) {
    case 16: return launch<16>(p, smem, st);
    case 32: return launch<32>(p, smem, st);
    case 48: return launch<48>(p, smem, st);
    case 64: return launch<64>(p, smem, st);
    case 80: return launch<80>(p, smem, st);
    case 96: return launch<96>(p, smem, st);
    case 112: return launch<112>(p, smem, st);
    case 128: return launch<128>(p, smem, st);
    case 144: return launch<144>(p, smem, st);
    case 160: return launch<160>(p, smem, st);
    case 192: return launch<192>(p, smem, st);
    case 256: return launch<256>(p, smem, st);
    default: return cudaErrorInvalidValue;
  }
}
