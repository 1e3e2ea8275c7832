// The parts K2 f32 (flash_bwd_f32.cu) and K3 f32 (flash_bwd_dkv_f32.cu)
// share: the launch parameters, the split-TF32 products on mma.sync, the
// warps' patches, the cp.async loads, the padded head dim, the streamed
// tile's rows and each kernel's shared memory (mirrored by
// ops/flash_attention.py k23_f32_plan), and the checks of the C entries'
// arguments. Everything sits in an anonymous namespace: each .cu that
// includes it is its own library, so the two kernels build in two nvcc
// processes side by side. The design notes are at the top of
// flash_bwd_f32.cu.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // K2: query rows a block; K3: keys a block
constexpr float LOG2E = 1.4426950408889634f;

// the head dim the kernels compute at for D (a multiple of 8 up to 256);
// the mirror of ops/flash_attention.py padded_head_dim
constexpr int padded_dp(int D) {
  return D <= 160 ? (D + 15) / 16 * 16 : D <= 192 ? 192 : 256;
}

// rows of a streamed tile (K2: keys a K/V tile; K3: rows a Q/dO tile) at
// padded head dim DP; a warp's patch is 16 × T at row stride T + 4
template <int DP>
__host__ __device__ constexpr int tile_rows() {
  return DP > 192 ? 16 : 32;
}

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

// acc[dn] (16 × 8 each, dn < ND) += X · Y, X the warp's 16 × T patch
// (stride T + 4) and Y a row-major T-row tile (stride SY): dQ += dS·K
// (K2), dV += Pᵀ·dO and dK += dSᵀ·Q (K3)
template <int T, int ND, int SY>
__device__ __forceinline__ void patch_by_tile(float (&acc)[ND][4],
                                              const float* x, const float* y,
                                              int g, int t4, bool three) {
#pragma unroll
  for (int kk = 0; kk < T / 8; ++kk) {
    uint32_t ab[4], as[4];
    frag_a<T + 4>(ab, as, x, kk * 8, g, t4);
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

// a 16 × 8·NT accumulator (C layout) into the warp's patch (stride
// 8·NT + 4)
template <int NT>
__device__ __forceinline__ void to_patch(float* pw, const float (&c)[NT][4],
                                         int g, int t4) {
  constexpr int ST = NT * 8 + 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t4;
    pw[g * ST + col] = c[nt][0];
    pw[g * ST + col + 1] = c[nt][1];
    pw[(g + 8) * ST + col] = c[nt][2];
    pw[(g + 8) * ST + col + 1] = c[nt][3];
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
  constexpr int T = tile_rows<DP>();
  return 2 * BM * (DP + 4) + 4 * T * (DP + 4) + 4 * 16 * (T + 4) + 2 * T;
}

template <int DP, int WARPS>
constexpr int k3_smem_floats() {
  constexpr int T = tile_rows<DP>();
  return 2 * BM * (DP + 4) + 4 * T * (DP + 4) + WARPS * 16 * (T + 4) +
         3 * 2 * T;
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
      D > 256 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0 ||
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
