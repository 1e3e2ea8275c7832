// The parts K2 f32 (flash_bwd_f32.cu) and K3 f32 (flash_bwd_dkv_f32.cu)
// share: the launch parameters and the checks of the C entries' arguments,
// the padded head dim, and each route's building blocks and shared memory
// (mirrored by ops/flash_attention.py k23_f32_plan):
//  * the wgmma route (padded head dims up to 128): tf32 wgmma wrappers and
//    descriptors, the core-matrix layout of the split operands, the split
//    passes that write a tile's TF32 big and small parts once, and the
//    three-pass products;
//  * the mma.sync route (above 128): the split-TF32 products on mma.sync,
//    the warps' patches and the streamed tile's rows.
// Everything sits in an anonymous namespace: each .cu that includes it is
// its own library, so the two kernels build in two nvcc processes side by
// side. The design notes are at the top of flash_bwd_f32.cu.

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

template <int DP>
constexpr int k3_smem_floats() {    // eight warps
  constexpr int T = tile_rows<DP>();
  return 2 * BM * (DP + 4) + 4 * T * (DP + 4) + 8 * 16 * (T + 4) + 3 * 2 * T;
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


// ---------------------------------------------------------------------------
// The wgmma route (padded head dims up to WG_MAX_DP)
// ---------------------------------------------------------------------------

constexpr int WG_MAX_DP = 128;
constexpr int MAX_SMEM = 232448;   // a block's shared memory on the H100

// Shared memory, in floats, of a K2 block of G consumer warpgroups (64
// query rows each) streaming T-key tiles, and of a K3 block of G
// warpgroups (64 keys each) streaming T-row query tiles, at padded head dim
// DP. K2: Q and dO resident, split (4·64G·DP); K, V and the permuted Kᵀ of
// a tile, split (6·T·DP); the raw K and V tile (2·T·(DP + 4)); two stages
// of T key ids. K3: K and V resident, split; Q, dO, Qᵀ and dOᵀ of a tile,
// split (8·T·DP); the raw Q and dO tile; two stages of T LSEs, δs and
// query ids. The mirror: ops/flash_attention.py k23_f32_plan.
__host__ __device__ constexpr int k2w_floats(int DP, int G, int T) {
  return 4 * 64 * G * DP + 6 * T * DP + 2 * T * (DP + 4) + 2 * T;
}
__host__ __device__ constexpr int k3w_floats(int DP, int G, int T) {
  return 4 * 64 * G * DP + 8 * T * DP + 2 * T * (DP + 4) + 3 * 2 * T;
}
// the plan: two warpgroups and 32-row tiles where they fit, else one
// warpgroup, else 16-row tiles
template <int DP>
struct K2W {
  static constexpr int G = 4 * k2w_floats(DP, 2, 32) <= MAX_SMEM ? 2 : 1;
  static constexpr int T = 4 * k2w_floats(DP, G, 32) <= MAX_SMEM ? 32 : 16;
  static constexpr int BYTES = 4 * k2w_floats(DP, G, T);
  static_assert(BYTES <= MAX_SMEM, "K2 f32 (wgmma) does not fit");
};
template <int DP>
struct K3W {
  static constexpr int G = 4 * k3w_floats(DP, 2, 32) <= MAX_SMEM ? 2 : 1;
  static constexpr int T = 4 * k3w_floats(DP, G, 32) <= MAX_SMEM ? 32 : 16;
  static constexpr int BYTES = 4 * k3w_floats(DP, G, T);
  static_assert(BYTES <= MAX_SMEM, "K3 f32 (wgmma) does not fit");
};

// Element (r, k) of a K-major operand whose K extent is KD, in the
// core-matrix layout wgmma reads without a swizzle: 8 rows × 4 floats (16
// bytes) a core matrix, 128 contiguous bytes; the core matrices of 8 rows
// side by side along K (leading byte offset 128), the next 8 rows KD·32
// bytes on (stride byte offset).
template <int KD>
__device__ __forceinline__ int cm_off(int r, int k) {
  return ((r >> 3) * (KD >> 2) + (k >> 2)) * 32 + (r & 7) * 4 + (k & 3);
}

// the descriptor of a K-major operand in that layout (K extent KD) whose
// first row is at p; a k-step of 8 is +16 (256 bytes in 16-byte units)
template <int KD>
__device__ __forceinline__ uint64_t kdesc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(KD * 32 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still running (groups
// complete in order)
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared memory written by threads, read next by wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of registers an
// asynchronous wgmma owns across the wait that ends it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (m64 × N fp32) += A·B in TF32, A from shared memory (ss) or from
// registers (rs), B from shared memory, both K-major (the only layout
// wgmma takes for tf32): one instance a width the kernels use (ss: the
// streamed tile's rows; rs: a padded head dim up to 128).
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da,
                                              uint64_t db);
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<16>(float (&d)[8], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float (&d)[16], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<16>(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<48>(float (&d)[24],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<80>(float (&d)[40],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<96>(float (&d)[48],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<112>(float (&d)[56],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// x rounded to TF32 (10 mantissa bits, nearest, ties away from zero: what
// cvt.rna.tf32.f32 gives for a finite x) by two integer instructions, which
// issue at four times cvt's rate
__device__ __forceinline__ float rna_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// x's TF32 big and small parts; with !three (the one-pass control) the
// small part is 0, so the three-pass products add exact zeros to big·big
__device__ __forceinline__ void split1(float x, float& big, float& small,
                                       bool three) {
  big = rna_tf32(x);
  small = three ? rna_tf32(x - big) : 0.f;
}

__device__ __forceinline__ void split4(const float4& x, float4& big,
                                       float4& small, bool three) {
  split1(x.x, big.x, small.x, three);
  split1(x.y, big.y, small.y, three);
  split1(x.z, big.z, small.z, three);
  split1(x.w, big.w, small.w, three);
}

// the 16-byte unit u of a ROWS × DP operand: 8 consecutive units lie in 8
// rows of one core matrix, so 8 lanes' 16-byte stores fill its 128 bytes
template <int DP>
__device__ __forceinline__ void unit_rc(int u, int& r, int& c) {
  const int rest = u >> 3;
  r = rest / (DP / 4) * 8 + (u & 7);
  c = rest % (DP / 4) * 4;
}

// The split pass over rows: rows [0, R) of a raw tile (row stride DP + 4)
// into their K-major TF32 big and small parts (K extent DP)
template <int R, int DP, int NTH>
__device__ __forceinline__ void split_rows(const float* raw, float* big,
                                           float* small, int tid,
                                           bool three) {
  for (int u = tid; u < R * DP / 4; u += NTH) {
    int r, c;
    unit_rc<DP>(u, r, c);
    float4 b, s;
    split4(*reinterpret_cast<const float4*>(raw + r * (DP + 4) + c), b, s,
           three);
    const int o = cm_off<DP>(r, c);
    *reinterpret_cast<float4*>(big + o) = b;
    *reinterpret_cast<float4*>(small + o) = s;
  }
}

// The split pass over columns: the raw tile's R rows become the K dim of a
// DP × R K-major operand (its transpose), permuted within each group of 8:
// slot s < 4 holds row 2s, slot s >= 4 row 2(s − 4) + 1. A thread's
// accumulator columns 2t and 2t + 1 of an 8-wide chunk are then the TF32 A
// fragment's k = t and t + 4, so dS, Pᵀ and dSᵀ go from the accumulators
// straight into A fragments (a_frag). Lanes take consecutive columns d: the
// reads are one row's consecutive floats, and 8 lanes' stores fill a core
// matrix.
template <int R, int DP, int NTH>
__device__ __forceinline__ void split_cols(const float* raw, float* big,
                                           float* small, int tid,
                                           bool three) {
  for (int u = tid; u < R * DP / 4; u += NTH) {
    const int d = u % DP, s4 = u / DP;    // slots 4·s4 .. 4·s4 + 3
    const float* x = raw + ((s4 >> 1) * 8 + (s4 & 1)) * (DP + 4) + d;
    float4 b, s;
    split4(make_float4(x[0], x[2 * (DP + 4)], x[4 * (DP + 4)],
                       x[6 * (DP + 4)]),
           b, s, three);
    const int o = cm_off<R>(d, 4 * s4);
    *reinterpret_cast<float4*>(big + o) = b;
    *reinterpret_cast<float4*>(small + o) = s;
  }
}

// The split pass of a block's resident operand, read from device memory:
// rows [row0, row0 + ROWS) of a [S, D] slice (row stride ss), zero past S
// and past D, into K-major big and small parts (K extent DP)
template <int ROWS, int DP, int NTH>
__device__ __forceinline__ void split_resident(float* big, float* small,
                                               const float* src,
                                               long long ss, int row0, int S,
                                               int D, int tid, bool three) {
  for (int u = tid; u < ROWS * DP / 4; u += NTH) {
    int r, c;
    unit_rc<DP>(u, r, c);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S && c < D)
      x = __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * ss + c));
    float4 b, s;
    split4(x, b, s, three);
    const int o = cm_off<DP>(r, c);
    *reinterpret_cast<float4*>(big + o) = b;
    *reinterpret_cast<float4*>(small + o) = s;
  }
}

// 4 bytes by cp.async (zero-filled when !valid)
__device__ __forceinline__ void cp4(void* smem, const void* gmem,
                                    bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// acc (64 × N) += A·Bᵀ over NK k-steps of 8, A and B K-major in shared
// memory, each as big and small parts (their descriptors at step 0), in
// split TF32: small·big, big·small, then big·big at every step, into one
// accumulator. The sequence has no branch (one in it cost spills and
// warpgroup.arrive injections): the one-pass control zeroes the small
// parts instead.
template <int N, int NK>
__device__ __forceinline__ void mma3_ss(float (&acc)[N / 2], uint64_t ab,
                                        uint64_t as, uint64_t bb,
                                        uint64_t bs) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint64_t o = 16 * kk;
    wgmma_tf32_ss<N>(acc, as + o, bb + o);
    wgmma_tf32_ss<N>(acc, ab + o, bs + o);
    wgmma_tf32_ss<N>(acc, ab + o, bb + o);
  }
}

// the same with A from registers: fb / fs the big and small A fragments of
// each k-step
template <int N, int NK>
__device__ __forceinline__ void mma3_rs(float (&acc)[N / 2],
                                        const uint32_t (&fb)[NK][4],
                                        const uint32_t (&fs)[NK][4],
                                        uint64_t bb, uint64_t bs) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint64_t o = 16 * kk;
    wgmma_tf32_rs<N>(acc, fs[kk], bb + o);
    wgmma_tf32_rs<N>(acc, fb[kk], bs + o);
    wgmma_tf32_rs<N>(acc, fb[kk], bb + o);
  }
}

// An accumulator of 64 × 8·NK (its columns the next product's k, in the
// order split_cols permutes them) as split A fragments: c0 → a0, c2 → a1,
// c1 → a2, c3 → a3 of each 8-wide chunk
template <int NK>
__device__ __forceinline__ void a_frag(const float (&c)[4 * NK],
                                       uint32_t (&fb)[NK][4],
                                       uint32_t (&fs)[NK][4], bool three) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const float x[4] = {c[4 * kk], c[4 * kk + 2], c[4 * kk + 1],
                        c[4 * kk + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float b, sm;
      split1(x[i], b, sm, three);
      fb[kk][i] = __float_as_uint(b);
      fs[kk][i] = __float_as_uint(sm);
    }
  }
}

}  // namespace
