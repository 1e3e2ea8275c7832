// K4 and K5: weight-only int8 / int4 matrix products, bf16 activations.
//
// Replaces the Pallas TPU kernels mllm_npu_tpu/ops/quant.py:50
// `_matmul_kernel` (K4, launched by `int8_matmul` :82) and
// mllm_npu_tpu/ops/quant.py:330 `_matmul4_kernel` (K5, launched by
// `int4_matmul` :356). Python wrappers, the prefill plan and plain PyTorch
// versions: mllm_npu_tpu_torch/ops/quant.py.
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
// before adding it (never a bf16-rounded W·s tile, never a quantized X).
// Y is bf16. The integers are converted on chip, exactly: int8 through the
// fp32 magic number 2^23 (byte_perm, one fadd, upper halves), int4 through
// the bf16 magic number 128 (byte_perm, one bf16x2 subtract), unscaled.
//
// What bounds them on an H100 (989 TFLOP/s bf16, 3.35 TB/s). Decode
// (M = 1) reads every weight byte once for 2 flops per weight: bound by
// bytes (q_proj at int8: 16 MB, 5 µs). The image prefill (M = 339) does
// 2·M flops per weight byte, above the card's ~295 flops per byte, so
// every one of its products is bound by the tensor cores: q/o (K 4096,
// N 4096) 11.5 µs, k/v (N 1024) 2.9 µs, gate/up (N 14336) and down
// (K 14336) 40.3 µs each; 4.79 ms over one prefill's 224 products.
//
// Two regimes, chosen by M:
//  * M ≤ 16 (decode, `qmm_decode`): mma.sync m16n8k16 with no shared
//    memory for W. Each warp streams its rows' 16-byte pieces straight from
//    device memory, several loads in flight, for one 8-column n-tile over a
//    slice of K; each thread owns 16 contiguous k of a row, so one 16-byte
//    load feeds four MMA k-steps (eight for int4). A block has 8 warps; NT
//    n-tiles × (8 / NT) K-slices, NT chosen so the grid has ≥ 2 blocks per
//    SM. The K-slices are summed in shared memory in a fixed order.
//  * M > 16 (prefill, `qmm_prefill`), a Hopper design, the product taken
//    transposed: Yᵀ = W · Xᵀ, so the converted weight is wgmma's A operand
//    from registers and X its B operand from shared memory. A bf16 weight
//    tile never goes through shared memory: the converter's writes and
//    the wgmmas' second read of it would take more of the SM's 128 bytes a
//    cycle of shared memory than the tensor cores leave (a 128 × 256 tile
//    fed by a converter warpgroup needs ~158 bytes a cycle at full rate;
//    this design ~130 at a 176-row X tile).
//     - Persistent blocks, one per SM, walk work units u, u + gridDim.x,
//       ...: (weight tile of 128 rows, split of K, X tile of bx rows), the
//       X tile fastest so the blocks reading one weight tile run together.
//       The plan (bx ∈ {64, 128, 176, 256} for int8, {64, 128} for int4,
//       the X tiles, the splits of K) is chosen in Python
//       (`prefill_plan`, a cost model fitted to this kernel's stage times)
//       and passed in.
//     - The producer warp issues TMA loads into a ring of 4-8 stages, each
//       with a "full" mbarrier (TMA bytes) and an "empty" one (one arrival
//       per consumer warp). A stage holds 64 bytes of each of the 128
//       weight rows (one [128 × 64] box under the 64-byte swizzle) and the
//       X columns they pair with: for int8 one [bx × 64] bf16 box under the
//       128-byte swizzle; for int4 (64 packed bytes, 128 k) two, the low
//       nibbles' run at gG + j0 and the high nibbles' at gG + G/2 + j0.
//       TMA zero-fills rows past M and N and columns past K, so ragged N
//       and int8's ragged K tail need no masks.
//     - Two consumer warpgroups, 64 weight rows each. Each thread reads,
//       per 16-k step, the 4 weight bytes its A fragment needs (k 2t, 2t+1,
//       2t+8, 2t+9 of rows g and g+8: two 32-bit shared loads and a
//       byte_perm per row, free of bank conflicts under the 64-byte
//       swizzle), converts them into bf16 pairs in registers and issues
//       wgmma m64n(bx)k16 with B = the X box (K-major, 128-byte swizzle).
//       The A registers are double-buffered: a warpgroup issues stage c's
//       products, converts stage c + 1 while they run, and waits for them
//       before it issues c + 1. Issuing c + 1 while c is still in flight
//       would put the conversion, which defines c + 1's A registers,
//       inside a wgmma pipeline stage, and ptxas then serializes every
//       wgmma (C7513, "non wgmma instructions defining input registers").
//       The two warpgroups keep the tensor cores busy while either
//       converts.
//     - K5 accumulates each group in `part` (the group's first product
//       overwrites it), waits for the group's last wgmma and fmas it into
//       `acc` with the group's fp32 scales, fetched at the group's start.
//     - Split-K where the output tiles are too few to fill the card: each
//       unit writes its fp32 partial (K4: already scaled) to a workspace
//       [splits, M, N] that the wrapper allocates, and `qmm_split_sum`
//       adds the splits in the order 0, 1, ...: two runs give the same
//       bits. Int4 splits fall on group boundaries.
//     - Tensor maps: 2-D maps over X [M, K] and W [N, K or K/2], encoded on
//       the host for every call through the runtime's driver entry point
//       (no -lcuda), passed as __grid_constant__ parameters.
//
// What keeps every wait matched (a lost arrival hangs the card): the
// producer and the consumers decode the same units in the same order and
// walk the same stages, so their ring positions agree; the producer
// expects the full box bytes of every load (TMA counts zero-filled
// elements too); every consumer warp arrives once on each stage's "empty"
// barrier, after the wgmma.wait_group that completes the stage's last
// product, on every path, the unit's last stage included. While changing
// the kernel, bound the spin in mbar_wait (trap after a few seconds of
// clock64) so a lost arrival faults instead of hanging.
//
// Registers: setmaxnreg gives the consumers 240 and the producer
// warpgroup 24 (384 threads, one block per SM). The accumulator takes
// bx/2 registers, K5's `part` as many again, the A double buffer 32 (K4)
// or 64 (K5, 128 k a stage): so K5's tile stops at 128 X rows.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_DEVICES = 64;
constexpr int DECODE_MAX_M = 16;
constexpr int UNROLL = 4;  // decode: weight loads in flight per lane

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
// M > 16: Yᵀ = W · Xᵀ with wgmma, A (the converted weight) from registers,
// B (X) from shared memory; TMA loads into an mbarrier ring (header).

constexpr int PF_BN = 128;           // weight rows per block
constexpr int PF_THREADS = 384;      // two consumer warpgroups + producer
constexpr int PF_CONSUMER_WARPS = 8;
constexpr uint32_t SW128 = 1;        // wgmma descriptor layout type

struct PrefillParams {
  CUtensorMap xmap;  // X [M, K] bf16: [bx rows × 64 columns], 128-byte swizzle
  CUtensorMap wmap;  // W [N, KW] bytes: [128 rows × 64 bytes], 64-byte swizzle
  const float* scale;  // [N] (int8) or [K/G, N] (int4)
  __nv_bfloat16* y;    // [M, N]
  float* ws;           // [splits, M, N] fp32 when splits > 1
  int M, N, K, G;
  int x_tiles, n_tiles, stages, splits, split_stages;
};

// one work unit: weight rows [n0, n0 + 128), X rows [m0, m0 + bx), ring
// stages [c0, c1) of K; the same decoding as PrefillPlan.unit
struct Unit {
  int n0, m0, split, c0, c1;
};
__device__ __forceinline__ Unit unit_of(const PrefillParams& p, int u,
                                        int bx) {
  const int x = u % p.x_tiles, r = u / p.x_tiles;
  const int s = r % p.splits, n = r / p.splits;
  const int c0 = s * p.split_stages;
  return {n * PF_BN, x * bx, s, c0, min(p.stages, c0 + p.split_stages)};
}

// Shared-memory plan of one instantiation: STAGES ring stages of [X boxes,
// W box], then the full and empty mbarriers.
template <int BITS, int BX>
struct PCfg {
  static constexpr int XBOX = BX * 128;  // [BX rows × 64 bf16]
  static constexpr int X_BYTES = (BITS == 8 ? 1 : 2) * XBOX;
  static constexpr int W_BYTES = PF_BN * 64;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int FIT = 200 * 1024 / STAGE;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + 16 * STAGES + 1024;
  static constexpr int KSTEPS = BITS == 8 ? 4 : 8;  // 16-k steps a stage
  static constexpr int NACC = BX / 2;
  static_assert(XBOX % 1024 == 0 && STAGE % 1024 == 0,
                "buffers stay 1024-byte aligned for the swizzles");
  static_assert(STAGES >= 4, "a ring of at least 4 stages");
};

// -- mbarriers, TMA, wgmma ----------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// one arrival that also expects `bytes` from the copies it guards
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::
          "r"(bar)
      : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of registers that an
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

// d (m64 × n fp32, the accumulator layout) += A · B: A (m64 × k16 bf16,
// the weight) from registers, B (the X box) from shared memory, K-major;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n176(float (&d)[88],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %93, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87"
      "}, {%88, %89, %90, %91}, %92, p, 1, 1, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


template <int BX>
__device__ __forceinline__ void mma_x(float (&d)[BX / 2],
                                      const uint32_t (&a)[4], uint64_t db,
                                      int scale_d) {
  static_assert(BX == 64 || BX == 128 || BX == 176 || BX == 256,
                "bx is 64, 128, 176 or 256");
  if constexpr (BX == 64) wgmma_rs_n64(d, a, db, scale_d);
  else if constexpr (BX == 128) wgmma_rs_n128(d, a, db, scale_d);
  else if constexpr (BX == 176) wgmma_rs_n176(d, a, db, scale_d);
  else wgmma_rs_n256(d, a, db, scale_d);
}

// One stage's weight bytes → this thread's A fragments, bf16 integers. wt
// is the stage's [128 rows × 64 bytes] box (64-byte swizzle: the 16-byte
// chunk c of row r sits at chunk c ^ ((r >> 1) & 3)). Per 16-k step s the
// fragment wants k 2t, 2t+1 (a[s][0] row g, a[s][1] row g+8) and k 2t+8,
// 2t+9 (a[s][2], a[s][3]); for int4 the low nibbles are steps 0-3 and the
// high nibbles, paired with the second X box, steps 4-7.
template <int BITS>
__device__ __forceinline__ void convert_a(const unsigned char* wt, int row0,
                                          int t,
                                          uint32_t (&a)[BITS == 8 ? 4 : 8][4]) {
  const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
  const int wo = 4 * (t >> 1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const unsigned char* rp = wt + row * 64 + wo;
    const int sw = (row >> 1) & 3;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const unsigned char* cp = rp + ((s ^ sw) << 4);
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(cp);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(cp + 8);
      const uint32_t q = __byte_perm(w0, w1, sel);
      if constexpr (BITS == 8) {
        i8x4_to_bf16(q, a[s][r], a[s][r + 2]);
      } else {
        i4x8_to_bf16(q, a[s][r], a[s][r + 2], a[s + 4][r], a[s + 4][r + 2]);
      }
    }
  }
}

template <int BITS, int BX>
__global__ void __launch_bounds__(PF_THREADS, 1)
    qmm_prefill(const __grid_constant__ PrefillParams p) {
  using C = PCfg<BITS, BX>;
  constexpr int S = C::STAGES, KS = C::KSTEPS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t bar_full = base + C::BAR_OFF, bar_empty = bar_full + 8 * S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int units = p.n_tiles * p.splits * p.x_tiles;
  const int gch = BITS == 8 ? 1 : p.G / 128;  // stages a group

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, PF_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= PF_CONSUMER_WARPS) {
    // ---- producer: one lane of the first warp issues every load ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp != PF_CONSUMER_WARPS || lane != 0) return;
    prefetch_map(&p.xmap);
    prefetch_map(&p.wmap);
    int it = 0;  // stages loaded so far: the ring position
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of(p, u, BX);
      for (int c = w.c0; c < w.c1; ++c, ++it) {
        const int s = it % S;
        mbar_wait(bar_empty + 8 * s, ((it / S) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s, st = base + s * C::STAGE;
        mbar_expect_tx(full, C::STAGE);
        tma_load_2d(st + C::X_BYTES, &p.wmap, full, 64 * c, w.n0);
        if constexpr (BITS == 8) {
          tma_load_2d(st, &p.xmap, full, 64 * c, w.m0);
        } else {
          // group c / gch, packed offset j0 in it: the low nibbles pair
          // with X columns gG + j0 .., the high ones with gG + G/2 + j0 ..
          const int grp = c / gch, j0 = (c - grp * gch) * 64;
          tma_load_2d(st, &p.xmap, full, grp * p.G + j0, w.m0);
          tma_load_2d(st + C::XBOX, &p.xmap, full, grp * p.G + p.G / 2 + j0,
                      w.m0);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 weight rows each, 16 per warp -----------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int row0 = 64 * wg + 16 * (warp % 4) + g;  // and row0 + 8
  float acc[C::NACC];
  float part[BITS == 8 ? 1 : C::NACC];
  uint32_t a0[KS][4], a1[KS][4];
  int it = 0;  // stages consumed so far: the ring position

  // a stage's buffers are no longer read: one arrival per warp
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  };

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_of(p, u, BX);
    const int na = w.n0 + row0, nb = na + 8;
    if constexpr (BITS == 4) {
#pragma unroll
      for (int i = 0; i < C::NACC; ++i) acc[i] = 0.f;
    }
    float sa = 0.f, sb = 0.f;  // int4: the current group's scales

    // wait for ring stage `it` to land and convert its weight into a
    auto load_a = [&](uint32_t(&a)[KS][4]) {
      const int s = it % S;
      mbar_wait(bar_full + 8 * s, (it / S) & 1);
      convert_a<BITS>(sbase + s * C::STAGE + C::X_BYTES, row0, t, a);
    };
    // stage c (ring position it, its weight already in a): issue its
    // products, convert stage c + 1 into next while they run, then wait
    // for them (the products never overlap a conversion that feeds a later
    // product still in flight), free the stage and, at an int4 group's
    // end, fold the group in
    auto step = [&](int c, uint32_t(&a)[KS][4], uint32_t(&next)[KS][4]) {
      const int s = it % S;
      const uint32_t xs = base + s * C::STAGE;
      if constexpr (BITS == 8) {
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_x<BX>(acc, a[kk], desc(xs + 32 * kk, 16, 1024, SW128),
                    c > w.c0 || kk > 0);
        wg_commit();
      } else {
        if (c % gch == 0) {
          const float* sc = p.scale + static_cast<long long>(c / gch) * p.N;
          sa = load_scale(sc, na, p.N);
          sb = load_scale(sc, nb, p.N);
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          mma_x<BX>(part, a[kk], desc(xs + 32 * kk, 16, 1024, SW128),
                    c % gch != 0 || kk > 0);
          mma_x<BX>(part, a[kk + 4],
                    desc(xs + C::XBOX + 32 * kk, 16, 1024, SW128), 1);
        }
        wg_commit();
      }
      ++it;
      if (c + 1 < w.c1) load_a(next);
      wg_wait<0>();
      fence_regs(a);
      fence_regs(acc);
      release(s);
      if constexpr (BITS == 4) {
        fence_regs(part);
        if (c % gch == gch - 1) {
#pragma unroll
          for (int j = 0; j < C::NACC / 4; ++j) {
            acc[4 * j] += part[4 * j] * sa;
            acc[4 * j + 1] += part[4 * j + 1] * sa;
            acc[4 * j + 2] += part[4 * j + 2] * sb;
            acc[4 * j + 3] += part[4 * j + 3] * sb;
          }
        }
      }
    };
    load_a(a0);
    for (int c = w.c0; c < w.c1; c += 2) {
      step(c, a0, a1);
      if (c + 1 < w.c1) step(c + 1, a1, a0);
    }

    // epilogue: thread holds, per 8 X rows j, Yᵀ[na][m], Yᵀ[na][m+1],
    // Yᵀ[nb][m], Yᵀ[nb][m+1] at m = m0 + 8j + 2t
    float s0 = 1.f, s1 = 1.f;
    if constexpr (BITS == 8) {
      s0 = load_scale(p.scale, na, p.N);
      s1 = load_scale(p.scale, nb, p.N);
    }
    const bool oka = na < p.N, okb = nb < p.N;
    if (p.splits == 1) {
#pragma unroll
      for (int j = 0; j < BX / 8; ++j) {
        const int m = w.m0 + 8 * j + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (m + e >= p.M) continue;
          __nv_bfloat16* yr = p.y + static_cast<long long>(m + e) * p.N;
          if (oka) yr[na] = __float2bfloat16(acc[4 * j + e] * s0);
          if (okb) yr[nb] = __float2bfloat16(acc[4 * j + 2 + e] * s1);
        }
      }
    } else {
      float* wsp = p.ws + static_cast<long long>(w.split) * p.M * p.N;
#pragma unroll
      for (int j = 0; j < BX / 8; ++j) {
        const int m = w.m0 + 8 * j + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (m + e >= p.M) continue;
          float* wr = wsp + static_cast<long long>(m + e) * p.N;
          if (oka) wr[na] = acc[4 * j + e] * s0;
          if (okb) wr[nb] = acc[4 * j + 2 + e] * s1;
        }
      }
    }
  }
}

// y = Σ_s ws[s], summed in the order s = 0, 1, ... (the same bits each run)
__global__ void qmm_split_sum(const float* __restrict__ ws,
                              __nv_bfloat16* __restrict__ y, long long mn,
                              int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < mn; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v += ws[s * mn + i];
    y[i] = __float2bfloat16(v);
  }
}

template <int BITS, int BX>
cudaError_t launch_prefill(const PrefillParams& p, cudaStream_t st) {
  using C = PCfg<BITS, BX>;
  // per device: the shared-memory limit (an attribute that must be set)
  // and the SM count, one persistent block on each
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(qmm_prefill<BITS, BX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return e;
    int n = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, qmm_prefill<BITS, BX>, PF_THREADS, C::SMEM);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    sms[dev] = n;
  }
  const int units = p.n_tiles * p.splits * p.x_tiles;
  const int grid = units < sms[dev] ? units : sms[dev];
  qmm_prefill<BITS, BX><<<grid, PF_THREADS, C::SMEM, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const long long mn = static_cast<long long>(p.M) * p.N;
  const long long want = (mn + 255) / 256;
  const int blocks = static_cast<int>(want < 8LL * sms[dev] ? want
                                                            : 8LL * sms[dev]);
  qmm_split_sum<<<blocks, 256, 0, st>>>(p.ws, p.y, mn, p.splits);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query, so the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a 2-D map over rows × cols elements, rows `pitch` bytes apart, boxes of
// box_rows × box_cols; what lies past the edges arrives as zeros
bool encode_2d(EncodeTiled fn, CUtensorMap* map, const void* ptr,
               CUtensorMapDataType type, long long rows, long long cols,
               long long pitch, int box_rows, int box_cols,
               CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The plan's checks (PrefillPlan in ops/quant.py makes plans that pass),
// the maps, and the launch of the instantiation for bx.
template <int BITS>
cudaError_t prefill(const void* x, const void* w, const void* scale, void* y,
                    void* ws, int M, int N, int K, int G, long long ldx,
                    int bx, int x_tiles, int splits, int split_stages,
                    cudaStream_t st) {
  const int stages = BITS == 8 ? (K + 63) / 64 : K / 128;
  const int step = BITS == 8 ? 1 : G / 128;
  const bool bx_ok = bx == 64 || bx == 128 ||
                     (BITS == 8 && (bx == 176 || bx == 256));
  if (!bx_ok || x_tiles <= 0 || static_cast<long long>(x_tiles) * bx < M ||
      (x_tiles - 1) * bx >= M || splits <= 0 || split_stages <= 0 ||
      split_stages % step != 0 ||
      static_cast<long long>(splits) * split_stages < stages ||
      (splits - 1) * split_stages >= stages || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorInvalidValue;
  PrefillParams p;
  const long long kw = BITS == 8 ? K : K / 2;
  if (!encode_2d(fn, &p.xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, M, K,
                 2 * ldx, bx, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(fn, &p.wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, N, kw, kw,
                 PF_BN, 64, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  p.scale = static_cast<const float*>(scale);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.ws = static_cast<float*>(ws);
  p.M = M; p.N = N; p.K = K; p.G = G;
  p.x_tiles = x_tiles;
  p.n_tiles = (N + PF_BN - 1) / PF_BN;
  p.stages = stages;
  p.splits = splits;
  p.split_stages = split_stages;
  if (static_cast<long long>(p.n_tiles) * splits * x_tiles > INT_MAX)
    return cudaErrorInvalidValue;
  switch (bx) {
    case 64: return launch_prefill<BITS, 64>(p, st);
    case 128: return launch_prefill<BITS, 128>(p, st);
    default: break;
  }
  if constexpr (BITS == 8) {
    if (bx == 176) return launch_prefill<8, 176>(p, st);
    return launch_prefill<8, 256>(p, st);
  }
  return cudaErrorInvalidValue;
}

template <int BITS, int NT>
void launch_decode(const Params& p, cudaStream_t st) {
  const int grid = (p.N + 8 * NT - 1) / (8 * NT);
  qmm_decode<BITS, NT><<<grid, THREADS, 0, st>>>(p);
}

// M ≤ 16: the decode kernel, the widest n-tiling that still gives 2 blocks
// per SM of 132
template <int BITS>
cudaError_t decode(const Params& p, cudaStream_t st) {
  const int blocks = 2 * 132;
  if ((p.N + 63) / 64 >= blocks) launch_decode<BITS, 8>(p, st);
  else if ((p.N + 31) / 32 >= blocks) launch_decode<BITS, 4>(p, st);
  else if ((p.N + 15) / 16 >= blocks) launch_decode<BITS, 2>(p, st);
  else launch_decode<BITS, 1>(p, st);
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

// Each returns 0 on success, else a CUDA error code (cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for arguments, a plan or a
// tensor map the kernel does not take). Pointers are device pointers; x
// rows are ldx elements apart (a multiple of 8, base 16-byte aligned); w
// rows are contiguous, 16-byte aligned and a multiple of 16 bytes. For
// M > 16 (the prefill) bx, x_tiles, splits and split_stages are the plan
// (ops/quant.py prefill_plan) and ws an fp32 workspace of splits·M·N
// (null when splits is 1); for M ≤ 16 they are not read.

// K4: w [N, K] int8, scale [N] fp32; K % 16 == 0.
extern "C" int int8_matmul_bf16(const void* x, const void* w,
                                const void* scale, void* y, void* ws, int M,
                                int N, int K, long long ldx, int bx,
                                int x_tiles, int splits, int split_stages,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || ldx % 8 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= DECODE_MAX_M)
    return decode<8>(make_params(x, w, scale, y, M, N, K, 0, ldx), st);
  return prefill<8>(x, w, scale, y, ws, M, N, K, 0, ldx, bx, x_tiles, splits,
                    split_stages, st);
}

// K5: w [N, K/2] packed int4, scale [K/G, N] fp32; G % 128 == 0, K % G == 0.
extern "C" int int4_matmul_bf16(const void* x, const void* w,
                                const void* scale, void* y, void* ws, int M,
                                int N, int K, int G, long long ldx, int bx,
                                int x_tiles, int splits, int split_stages,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || G % 128 != 0 || K % G != 0 ||
      ldx % 8 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= DECODE_MAX_M)
    return decode<4>(make_params(x, w, scale, y, M, N, K, G, ldx), st);
  return prefill<4>(x, w, scale, y, ws, M, N, K, G, ldx, bx, x_tiles, splits,
                    split_stages, st);
}
