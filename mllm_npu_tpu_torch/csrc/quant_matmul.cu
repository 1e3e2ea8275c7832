// K4 and K5: weight-only int8 / int4 matrix products, bf16 activations.
//
// Replaces the Pallas TPU kernels mllm_npu_tpu/ops/quant.py:50
// `_matmul_kernel` (K4, launched by `int8_matmul` :82) and
// mllm_npu_tpu/ops/quant.py:330 `_matmul4_kernel` (K5, launched by
// `int4_matmul` :356). Python wrappers and plain PyTorch versions:
// mllm_npu_tpu_torch/ops/quant.py.
//
//   K4: Y[M,N] = (X[M,K] · W[N,K]ᵀ) ∘ scale[N]
//   K5: Y[M,N] = Σ_g (X_g,lo · lo_gᵀ + X_g,hi · hi_gᵀ) ∘ scale[g,N]
//
// X is bf16, W is stored as the torch Linear weight, [N, K] int8 (K4) or
// [N, K/2] packed int4 (K5), K contiguous. Int4 keeps the reference's
// group-half nibble layout along K: byte r of group g in row n holds
// W[n, gG+r] in its low nibble and W[n, gG+G/2+r] in its high nibble.
// Scales are fp32, [N] (K4) and [K/G, N] (K5). Accumulation is fp32; K4
// scales in the epilogue, K5 scales each group's partial sum in fp32
// before adding it (never a bf16-rounded W·s tile). Y is bf16.
//
// What bounds them on an H100. Decode (M = 1) reads every weight byte once
// for 2 flops per weight: bound by bytes, 3.35 TB/s (q_proj at int8: 16 MB,
// 5 µs). The image prefill (M ≈ 340) does 2·M flops per weight: above the
// card's ~295 flops per byte, so bound by the tensor cores (gate_proj:
// 39.8 GFLOP, 40 µs at 989 TFLOP/s).
//
// Design, simple first (wgmma, TMA and warp specialisation are later work):
//  * both regimes run on the tensor cores, mma.sync m16n8k16 bf16 → fp32.
//    Int8 values and int4 nibbles are exact in bf16 and are converted
//    on chip: int8 through the fp32 magic number 2^23 (byte_perm, one
//    fadd, upper halves), int4 through the bf16 magic number 128
//    (byte_perm, one bf16x2 subtract). The converted values are the
//    integers, unscaled, so no dequantized tile reaches device memory and
//    no W·s is rounded to bf16.
//  * K order inside a product is free as long as A and B agree, so in the
//    decode kernel each thread owns 16 contiguous k of a row: one 16-byte
//    load of weights feeds four MMA k-steps (eight for int4), with no
//    shuffles.
//  * M ≤ 16 (decode): no shared memory for W. Each warp streams its rows'
//    16-byte pieces straight from device memory, several loads in flight,
//    for one 8-column n-tile over a slice of K. A block has 8 warps; NT
//    n-tiles × (8 / NT) K-slices, NT chosen so the grid has ≥ 2 blocks per
//    SM (N = 1024 still makes 128 blocks). The K-slices are summed in
//    shared memory in a fixed order. A 16-row MMA at M = 1 wastes rows but
//    stays bound by bytes.
//  * M > 16 (prefill): 64×128 block tiles, 8 warps of 32×32, a 3-stage
//    cp.async ring of X and W tiles in shared memory. Each stage's W bytes
//    are converted once per block into a bf16 tile beside it, so the warps
//    read both operands with ldmatrix and the conversion is not repeated
//    by every warp row. Rows are padded by 16 bytes, so ldmatrix is
//    bank-conflict free.
//  * ragged edges: rows of W past N and of X past M are zero-filled and
//    never stored, so N = 128587 (lm_head) and any M run as they are. K
//    must be a multiple of 16 (int8; a ragged K tail is zero-filled) or of
//    the group, itself a multiple of 128 (int4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_DEVICES = 64;
constexpr int DECODE_MAX_M = 16;
constexpr int UNROLL = 4;  // decode: weight loads in flight per lane
// prefill tiles
constexpr int BM = 64;
constexpr int BN = 128;
constexpr int STAGES = 3;
constexpr int WB = 64;  // weight bytes per row per stage (int8 and int4)

struct Params {
  const __nv_bfloat16* x;  // [M, K], row stride ldx (elements)
  const int8_t* w;         // [N, K] int8 or [N, K/2] packed int4
  const float* scale;      // [N] (int8) or [K/G, N] (int4)
  __nv_bfloat16* y;        // [M, N]
  int M, N, K, G;
  long long ldx;
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

// weights are read once: do not keep them in L1
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 ld_x(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// d += a · b, one 16×8×16 bf16 product with fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four int8 (one word, lowest address first) → two bf16 pairs: b0 holds
// bytes 0, 1 and b1 bytes 2, 3. u = v + 128 goes into the mantissa of
// 2^23; subtracting 2^23 + 128 leaves v exactly, and a small integer's
// bf16 is its fp32's upper half.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& b0,
                                             uint32_t& b1) {
  const uint32_t u = w ^ 0x80808080u;
  const float m = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - m;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - m;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - m;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - m;
  b0 = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  b1 = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ uint32_t bf16x2_minus_136(uint32_t v) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Four packed int4 bytes → the low nibbles as bf16 pairs (lo0: bytes 0, 1;
// lo1: bytes 2, 3) and the high nibbles likewise. u = v + 8 goes into the
// mantissa of bf16 128.0 (0x4300); subtracting 136 leaves v exactly.
__device__ __forceinline__ void i4x8_to_bf16(uint32_t w, uint32_t& lo0,
                                             uint32_t& lo1, uint32_t& hi0,
                                             uint32_t& hi1) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t l = u & 0x0F0F0F0Fu, h = (u >> 4) & 0x0F0F0F0Fu;
  const uint32_t e = 0x43434343u;
  lo0 = bf16x2_minus_136(__byte_perm(l, e, 0x4140));
  lo1 = bf16x2_minus_136(__byte_perm(l, e, 0x4342));
  hi0 = bf16x2_minus_136(__byte_perm(h, e, 0x4140));
  hi1 = bf16x2_minus_136(__byte_perm(h, e, 0x4342));
}

__device__ __forceinline__ void unpack8(const uint4& a, const uint4& b,
                                        uint32_t (&r)[8]) {
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

// Four k-steps over one thread's 16 contiguous k: x0/x1 are rows g and
// g+8 (8 words = 16 bf16 each), wv the matching 16 int8 of column g.
__device__ __forceinline__ void mma_i8_16k(float (&d)[4],
                                           const uint32_t (&x0)[8],
                                           const uint32_t (&x1)[8],
                                           const uint4& wv) {
  const uint32_t ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t b0, b1;
    i8x4_to_bf16(ws[s], b0, b1);
    mma_bf16(d, x0[2 * s], x1[2 * s], x0[2 * s + 1], x1[2 * s + 1], b0, b1);
  }
}

// Eight k-steps over 16 packed bytes: the low nibbles pair with xl (the
// group's first half), the high nibbles with xh (its second half).
__device__ __forceinline__ void mma_i4_16b(float (&d)[4],
                                           const uint32_t (&xl0)[8],
                                           const uint32_t (&xl1)[8],
                                           const uint32_t (&xh0)[8],
                                           const uint32_t (&xh1)[8],
                                           const uint4& wv) {
  const uint32_t ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t lo0, lo1, hi0, hi1;
    i4x8_to_bf16(ws[s], lo0, lo1, hi0, hi1);
    mma_bf16(d, xl0[2 * s], xl1[2 * s], xl0[2 * s + 1], xl1[2 * s + 1], lo0,
             lo1);
    mma_bf16(d, xh0[2 * s], xh1[2 * s], xh0[2 * s + 1], xh1[2 * s + 1], hi0,
             hi1);
  }
}

// one lane's 16 bf16 of row x at k (zeros if !ok)
__device__ __forceinline__ void load_x16(const __nv_bfloat16* x, bool ok,
                                         uint32_t (&r)[8]) {
  const uint4 z = make_uint4(0, 0, 0, 0);
  unpack8(ok ? ld_x(x) : z, ok ? ld_x(x + 8) : z, r);
}

__device__ __forceinline__ void store_pair(const Params& p, int row, int col,
                                           float v0, float v1) {
  if (row >= p.M || col >= p.N) return;
  __nv_bfloat16* y = p.y + static_cast<long long>(row) * p.N + col;
  if (col + 1 < p.N && (p.N & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(v0, v1);
  } else {
    y[0] = __float2bfloat16(v0);
    if (col + 1 < p.N) y[1] = __float2bfloat16(v1);
  }
}

__device__ __forceinline__ float load_scale(const float* s, int col, int N) {
  return col < N ? __ldg(s + col) : 0.f;
}

// ---------------------------------------------------------------- decode
// M ≤ 16. Warp w owns n-tile (w % NT) and K-slice (w / NT) of the block.
template <int BITS, int NT>
__global__ void __launch_bounds__(THREADS) qmm_decode(const Params p) {
  constexpr int KS = WARPS / NT;
  __shared__ float red[WARPS][32][4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nt = warp % NT, ks = warp / NT;
  const int n0 = (blockIdx.x * NT + nt) * 8;
  const bool nok = n0 + g < p.N;
  const long long kw = BITS == 8 ? p.K : p.K / 2;
  const int8_t* wrow = p.w + (nok ? n0 + g : 0) * kw;
  const bool ok0 = g < p.M, ok1 = g + 8 < p.M;
  const __nv_bfloat16* x0 = p.x + (ok0 ? g : 0) * p.ldx;
  const __nv_bfloat16* x1 = p.x + (ok1 ? g + 8 : 0) * p.ldx;
  const uint4 z = make_uint4(0, 0, 0, 0);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  if (BITS == 8) {
    // 64-k chunks, dealt to the K-slices in turn
    const int nch = (p.K + 63) / 64;
    for (int c0 = ks; c0 < nch; c0 += KS * UNROLL) {
      uint4 wv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = c0 + u * KS, k = c * 64 + 16 * t;
        wv[u] = (c < nch && nok && k < p.K) ? ld_stream(wrow + k) : z;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = c0 + u * KS, k = c * 64 + 16 * t;
        if (c >= nch) break;  // warp-uniform
        uint32_t xa[8], xb[8];
        load_x16(x0 + k, ok0 && k < p.K, xa);
        load_x16(x1 + k, ok1 && k < p.K, xb);
        mma_i8_16k(acc, xa, xb, wv[u]);
      }
    }
  } else {
    // whole groups per K-slice; a group is G/128 chunks of 64 packed
    // bytes. The slice's chunks are walked as one list, so the loads in
    // flight run across group ends; a group's partial sum is scaled when
    // its last chunk is in.
    const int gch = p.G / 128, ngroups = p.K / p.G;
    const int nq = ngroups > ks ? (ngroups - ks + KS - 1) / KS * gch : 0;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q0 = 0; q0 < nq; q0 += UNROLL) {
      uint4 wv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int q = q0 + u, grp = ks + q / gch * KS, c = q % gch;
        const long long b = static_cast<long long>(grp) * (p.G / 2) +
                            c * 64 + 16 * t;
        wv[u] = (q < nq && nok) ? ld_stream(wrow + b) : z;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int q = q0 + u, grp = ks + q / gch * KS, c = q % gch;
        if (q >= nq) break;  // warp-uniform
        const int kl = grp * p.G + c * 64 + 16 * t, kh = kl + p.G / 2;
        uint32_t xl0[8], xl1[8], xh0[8], xh1[8];
        load_x16(x0 + kl, ok0, xl0);
        load_x16(x1 + kl, ok1, xl1);
        load_x16(x0 + kh, ok0, xh0);
        load_x16(x1 + kh, ok1, xh1);
        mma_i4_16b(part, xl0, xl1, xh0, xh1, wv[u]);
        if (c == gch - 1) {
          const float* s = p.scale + static_cast<long long>(grp) * p.N;
          const float s0 = load_scale(s, n0 + 2 * t, p.N);
          const float s1 = load_scale(s, n0 + 2 * t + 1, p.N);
          acc[0] += part[0] * s0;
          acc[1] += part[1] * s1;
          acc[2] += part[2] * s0;
          acc[3] += part[3] * s1;
          part[0] = part[1] = part[2] = part[3] = 0.f;
        }
      }
    }
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) red[warp][lane][e] = acc[e];
  __syncthreads();
  if (ks != 0) return;
  for (int j = 1; j < KS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += red[j * NT + nt][lane][e];
  }
  const int col = n0 + 2 * t;
  float s0 = 1.f, s1 = 1.f;
  if (BITS == 8) {
    s0 = load_scale(p.scale, col, p.N);
    s1 = load_scale(p.scale, col + 1, p.N);
  }
  store_pair(p, g, col, acc[0] * s0, acc[1] * s1);
  store_pair(p, g + 8, col, acc[2] * s0, acc[3] * s1);
}

// --------------------------------------------------------------- prefill
// M > 16. A stage holds, for int8, 64 k of X and W; for int4, 64 packed
// bytes of W (128 k) and the two 64-k runs of X they pair with (the low
// nibbles' run in columns 0-63, the high nibbles' in 64-127). Once a stage
// has landed, the block converts its W bytes once into a bf16 tile laid
// out like the X tile, so the product is a plain bf16 tile product:
// ldmatrix fragments and mma.sync.
template <int BITS>
struct Tile {
  static constexpr int KX = BITS == 8 ? 64 : 128;  // k per stage
  static constexpr int LD = KX + 8;  // padded row (bf16) of the X and W tiles
  static constexpr int X_ELEMS = BM * LD;
  static constexpr int STAGE_BYTES = X_ELEMS * 2 + BN * WB;
  static constexpr int SMEM = STAGES * STAGE_BYTES + BN * LD * 2;
};

template <int BITS>
__device__ __forceinline__ void load_stage(const Params& p,
                                           unsigned char* buf, int c, int m0,
                                           int n0, int tid) {
  using T = Tile<BITS>;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(buf);
  int8_t* ws = reinterpret_cast<int8_t*>(buf + T::X_ELEMS * 2);
  const long long kw = BITS == 8 ? p.K : p.K / 2;
  // W: 128 rows × 4 pieces of 16 bytes
#pragma unroll
  for (int j = 0; j < BN * 4 / THREADS; ++j) {
    const int i = tid + j * THREADS, r = i >> 2, q = i & 3;
    const int n = n0 + r;
    const long long b = static_cast<long long>(c) * WB + 16 * q;
    const bool ok = n < p.N && b < kw;
    cp_async16(ws + r * WB + 16 * q, ok ? p.w + n * kw + b : p.w, ok);
  }
  // X: 64 rows × KX/8 pieces of 8 bf16
  constexpr int PR = T::KX / 8;
#pragma unroll
  for (int j = 0; j < BM * PR / THREADS; ++j) {
    const int i = tid + j * THREADS, r = i / PR, q = i % PR;
    const int m = m0 + r;
    int k;
    if (BITS == 8) {
      k = c * 64 + 8 * q;
    } else {
      // chunk c: group c / (G/128), packed offset 64·(c mod G/128) in it
      const int gch = p.G / 128, grp = c / gch, j0 = (c - grp * gch) * 64;
      k = grp * p.G + j0 + (q < 8 ? 8 * q : p.G / 2 + 8 * (q - 8));
    }
    const bool ok = m < p.M && k < p.K;
    cp_async16(xs + r * T::LD + 8 * q, ok ? p.x + m * p.ldx + k : p.x, ok);
  }
}

// The stage's W bytes → the bf16 tile wb [BN][LD]: thread owns 32 bytes of
// one row. Int8 keeps its k order; int4 puts the low nibbles in columns
// 0-63 and the high nibbles in 64-127, beside the X runs they pair with.
template <int BITS>
__device__ __forceinline__ void convert_w(const int8_t* ws,
                                          __nv_bfloat16* wb, int tid) {
  const int r = tid >> 1, h = tid & 1;
  const uint4 a = *reinterpret_cast<const uint4*>(ws + r * WB + 32 * h);
  const uint4 b = *reinterpret_cast<const uint4*>(ws + r * WB + 32 * h + 16);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint4* d = reinterpret_cast<uint4*>(wb + r * Tile<BITS>::LD + 32 * h);
  if (BITS == 8) {
    uint32_t o[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) i8x4_to_bf16(w[i], o[2 * i], o[2 * i + 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d[i] = make_uint4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
  } else {
    uint32_t lo[16], hi[16];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      i4x8_to_bf16(w[i], lo[2 * i], lo[2 * i + 1], hi[2 * i], hi[2 * i + 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[i] = make_uint4(lo[4 * i], lo[4 * i + 1], lo[4 * i + 2], lo[4 * i + 3]);
      d[i + 8] =  // 64 bf16 further: the high nibbles' columns
          make_uint4(hi[4 * i], hi[4 * i + 1], hi[4 * i + 2], hi[4 * i + 3]);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

template <int BITS>
__global__ void __launch_bounds__(THREADS) qmm_gemm(const Params p) {
  using T = Tile<BITS>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wb =
      reinterpret_cast<__nv_bfloat16*>(smem + STAGES * T::STAGE_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int nch = BITS == 8 ? (p.K + 63) / 64 : p.K / 128;
  const int gch = BITS == 8 ? 1 : p.G / 128;
  // ldmatrix row addresses: A rows wm + 16i + (lane mod 16), column half
  // lane / 16; B rows (n) wn + 16jj + 8·(lane / 16) + (lane mod 8), column
  // half (lane / 8) mod 2
  const int a_row = wm + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = wn + ((lane >> 4) << 3) + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 8;

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch) load_stage<BITS>(p, smem + s * T::STAGE_BYTES, s, m0, n0, tid);
    cp_async_commit();
  }

  float sc[4][2] = {};  // int4: the current group's scales, fetched early
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage c is in; every warp is done with stage c-1
    const int nxt = c + STAGES - 1;
    if (nxt < nch)
      load_stage<BITS>(p, smem + (nxt % STAGES) * T::STAGE_BYTES, nxt, m0,
                       n0, tid);
    cp_async_commit();

    const unsigned char* buf = smem + (c % STAGES) * T::STAGE_BYTES;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(buf);
    convert_w<BITS>(reinterpret_cast<const int8_t*>(buf + T::X_ELEMS * 2),
                    wb, tid);
    if (BITS == 4 && c % gch == 0) {
      const float* s = p.scale + static_cast<long long>(c / gch) * p.N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + 8 * j + 2 * t;
        sc[j][0] = load_scale(s, col, p.N);
        sc[j][1] = load_scale(s, col + 1, p.N);
      }
    }
    __syncthreads();  // the bf16 W tile is complete

    float(*dst)[4][4] = BITS == 8 ? acc : part;
#pragma unroll
    for (int kk = 0; kk < T::KX / 16; ++kk) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], xs + (a_row + 16 * i) * T::LD + kk * 16 + a_col);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, wb + (b_row + 16 * jj) * T::LD + kk * 16 + b_col);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(dst[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j][0],
                   b[j][1]);
    }
    if (BITS == 4 && (c + 1) % gch == 0) {  // the group is in: scale, add
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j][0] += part[i][j][0] * sc[j][0];
          acc[i][j][1] += part[i][j][1] * sc[j][1];
          acc[i][j][2] += part[i][j][2] * sc[j][0];
          acc[i][j][3] += part[i][j][3] * sc[j][1];
          part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] =
              0.f;
        }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + 8 * j + 2 * t;
    float s0 = 1.f, s1 = 1.f;
    if (BITS == 8) {
      s0 = load_scale(p.scale, col, p.N);
      s1 = load_scale(p.scale, col + 1, p.N);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + wm + 16 * i + g;
      store_pair(p, row, col, acc[i][j][0] * s0, acc[i][j][1] * s1);
      store_pair(p, row + 8, col, acc[i][j][2] * s0, acc[i][j][3] * s1);
    }
  }
}

template <int BITS, int NT>
void launch_decode(const Params& p, cudaStream_t st) {
  const int grid = (p.N + 8 * NT - 1) / (8 * NT);
  qmm_decode<BITS, NT><<<grid, THREADS, 0, st>>>(p);
}

template <int BITS>
cudaError_t launch(const Params& p, cudaStream_t st) {
  if (p.M <= DECODE_MAX_M) {
    // the widest n-tiling that still gives 2 blocks per SM of 132
    const int blocks = 2 * 132;
    if ((p.N + 63) / 64 >= blocks) launch_decode<BITS, 8>(p, st);
    else if ((p.N + 31) / 32 >= blocks) launch_decode<BITS, 4>(p, st);
    else if ((p.N + 15) / 16 >= blocks) launch_decode<BITS, 2>(p, st);
    else launch_decode<BITS, 1>(p, st);
    return cudaGetLastError();
  }
  // the shared-memory limit is a per-device attribute: set it once each
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    e = cudaFuncSetAttribute(qmm_gemm<BITS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<BITS>::SMEM);
    if (e != cudaSuccess) return e;
    attr_set[dev] = true;
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  qmm_gemm<BITS><<<grid, THREADS, Tile<BITS>::SMEM, st>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* x, const void* w, const void* scale, void* y,
                   int M, int N, int K, int G, long long ldx) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.M = M; p.N = N; p.K = K; p.G = G; p.ldx = ldx;
  return p;
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success).
// Pointers are device pointers; x rows are ldx elements apart (a multiple
// of 8, base 16-byte aligned); w rows are contiguous and 16-byte aligned.

// K4: w [N, K] int8, scale [N] fp32; K % 16 == 0.
extern "C" int int8_matmul_bf16(const void* x, const void* w,
                                const void* scale, void* y, int M, int N,
                                int K, long long ldx, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || ldx % 8 != 0)
    return cudaErrorInvalidValue;
  return launch<8>(make_params(x, w, scale, y, M, N, K, 0, ldx),
                   static_cast<cudaStream_t>(stream));
}

// K5: w [N, K/2] packed int4, scale [K/G, N] fp32; G % 128 == 0, K % G == 0.
extern "C" int int4_matmul_bf16(const void* x, const void* w,
                                const void* scale, void* y, int M, int N,
                                int K, int G, long long ldx, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || G % 128 != 0 || K % G != 0 ||
      ldx % 8 != 0)
    return cudaErrorInvalidValue;
  return launch<4>(make_params(x, w, scale, y, M, N, K, G, ldx),
                   static_cast<cudaStream_t>(stream));
}
