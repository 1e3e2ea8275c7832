// K4 and K5's prefill kernel (`qmm_prefill`, with its split-K sum and
// launcher) templated on the X operand, and the helpers it shares with the
// decode kernels (the integer-to-bf16 conversions, mma.sync). Included by
// one source per operand:
//  * XBf16: bf16 x, one part, bf16 Y: quant_matmul.cu (K4, K5), whose
//    header holds the design notes, and whose decode kernel is its own.
//  * XF32: fp32 x as three bf16 parts x = h + m + l (h = bf16(x), m =
//    bf16(x − h), l = bf16(x − h − m), round to nearest even), fp32 Y:
//    quant_matmul_f32.cu (K4 f32, K5 f32), whose pre-split kernel writes
//    the parts to a workspace [3, M, K]. The weights are integers, exact
//    in bf16, so each part times a weight is exact in the fp32
//    accumulator. Each ring stage brings one [64 columns × bx rows × 3
//    parts] box a run through a 3-D tensor map, and each consumer
//    warpgroup issues three wgmmas (parts l, m, h, small before large) on
//    each A fragment it converts. The tensor cores' fp32 sums are not
//    IEEE-rounded, so the fp32 instantiation sums each ring stage (int4:
//    each group, as K5) in `part` and adds it to `acc` in fp32.
//
// While changing a kernel, define MBAR_TRAP_CYCLES (nvcc
// -DMBAR_TRAP_CYCLES=...) to make mbar_wait trap after that many clock64
// cycles instead of spinning forever (a fault, not a hung card).

#pragma once

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

// The X operand of an instantiation: Y's element type, the bf16 parts x is
// carried in, and the prefill ring's shared-memory budget.
struct XBf16 {
  using Out = __nv_bfloat16;
  static constexpr int PARTS = 1;
  static constexpr int SMEM_BUDGET = 200 * 1024;
};
struct XF32 {
  using Out = float;
  static constexpr int PARTS = 3;
  // the card's 227 KB for one block, less the barriers and the alignment
  static constexpr int SMEM_BUDGET = 232448 - 1024 - 16 * 8;
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

// one lane's 16 bf16 of row x at k (zeros if !ok)
__device__ __forceinline__ void load_x16(const __nv_bfloat16* x, bool ok,
                                         uint32_t (&r)[8]) {
  const uint4 z = make_uint4(0, 0, 0, 0);
  unpack8(ok ? ld_x(x) : z, ok ? ld_x(x + 8) : z, r);
}

__device__ __forceinline__ float load_scale(const float* s, int col, int N) {
  return col < N ? __ldg(s + col) : 0.f;
}

// an fp32 result in the instantiation's Y type
template <class XT>
__device__ __forceinline__ typename XT::Out out_of(float v) {
  if constexpr (XT::PARTS == 1) return __float2bfloat16(v);
  else return v;
}

// --------------------------------------------------------------- prefill
// M > 16: Yᵀ = W · Xᵀ with wgmma, A (the converted weight) from registers,
// B (X) from shared memory; TMA loads into an mbarrier ring (header).

constexpr int PF_BN = 128;           // weight rows per block
constexpr int PF_THREADS = 384;      // two consumer warpgroups + producer
constexpr int PF_CONSUMER_WARPS = 8;
constexpr uint32_t SW128 = 1;        // wgmma descriptor layout type

template <class XT>
struct PrefillParams {
  // X [M, K] bf16, or its parts [3, M, K]: boxes of [bx rows × 64 columns]
  // (× 3 parts), 128-byte swizzle
  CUtensorMap xmap;
  CUtensorMap wmap;  // W [N, KW] bytes: [128 rows × 64 bytes], 64-byte swizzle
  const float* scale;  // [N] (int8) or [K/G, N] (int4)
  typename XT::Out* y;  // [M, N]
  float* ws;           // [splits, M, N] fp32 when splits > 1
  int M, N, K, G;
  int x_tiles, n_tiles, stages, splits, split_stages;
};

// one work unit: weight rows [n0, n0 + 128), X rows [m0, m0 + bx), ring
// stages [c0, c1) of K; the same decoding as PrefillPlan.unit
struct Unit {
  int n0, m0, split, c0, c1;
};
template <class XT>
__device__ __forceinline__ Unit unit_of(const PrefillParams<XT>& p, int u,
                                        int bx) {
  const int x = u % p.x_tiles, r = u / p.x_tiles;
  const int s = r % p.splits, n = r / p.splits;
  const int c0 = s * p.split_stages;
  return {n * PF_BN, x * bx, s, c0, min(p.stages, c0 + p.split_stages)};
}

// Shared-memory plan of one instantiation: STAGES ring stages of [X boxes,
// W box], then the full and empty mbarriers. A stage's X is one run (int8)
// or two (int4: the low nibbles' and the high nibbles'), each of PARTS
// boxes, part-major.
template <class XT, int BITS, int BX>
struct PCfg {
  static constexpr int XBOX = BX * 128;  // [BX rows × 64 bf16]
  static constexpr int XRUN = XT::PARTS * XBOX;
  static constexpr int X_BYTES = (BITS == 8 ? 1 : 2) * XRUN;
  static constexpr int W_BYTES = PF_BN * 64;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int FIT = XT::SMEM_BUDGET / STAGE;
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
#ifdef MBAR_TRAP_CYCLES
  const long long t0 = clock64();
#endif
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
#ifdef MBAR_TRAP_CYCLES
    if (!done && clock64() - t0 > (long long)(MBAR_TRAP_CYCLES)) __trap();
#endif
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
// a [64 columns × bx rows × 3 parts] box of the parts' 3-D map
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(0)
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

template <class XT, int BITS, int BX>
__global__ void __launch_bounds__(PF_THREADS, 1)
    qmm_prefill(const __grid_constant__ PrefillParams<XT> p) {
  using C = PCfg<XT, BITS, BX>;
  constexpr int S = C::STAGES, KS = C::KSTEPS, PARTS = XT::PARTS;
  // K4 f32 sums each stage in `part` and adds it to acc in fp32 (header)
  constexpr bool STAGED = BITS == 4 || PARTS > 1;
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
    // one run of X columns from col: a 2-D box, or the three parts' 3-D box
    auto load_x = [&](uint32_t dst, uint32_t full, int col, int row) {
      if constexpr (PARTS == 1) tma_load_2d(dst, &p.xmap, full, col, row);
      else tma_load_3d(dst, &p.xmap, full, col, row);
    };
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
          load_x(st, full, 64 * c, w.m0);
        } else {
          // group c / gch, packed offset j0 in it: the low nibbles pair
          // with X columns gG + j0 .., the high ones with gG + G/2 + j0 ..
          const int grp = c / gch, j0 = (c - grp * gch) * 64;
          load_x(st, full, grp * p.G + j0, w.m0);
          load_x(st + C::XRUN, full, grp * p.G + p.G / 2 + j0, w.m0);
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
  float part[STAGED ? C::NACC : 1];
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
    if constexpr (STAGED) {
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
    // end (K4 f32: every stage's), fold the group in. The parts go l, m,
    // h (q = 0 is the smallest, p = PARTS - 1 - q); one part is x itself.
    auto step = [&](int c, uint32_t(&a)[KS][4], uint32_t(&next)[KS][4]) {
      const int s = it % S;
      const uint32_t xs = base + s * C::STAGE;
      if constexpr (BITS == 8 && PARTS == 1) {
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_x<BX>(acc, a[kk], desc(xs + 32 * kk, 16, 1024, SW128),
                    c > w.c0 || kk > 0);
        wg_commit();
      } else if constexpr (BITS == 8) {
        wg_fence();
#pragma unroll
        for (int q = 0; q < PARTS; ++q)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma_x<BX>(part, a[kk],
                      desc(xs + (PARTS - 1 - q) * C::XBOX + 32 * kk, 16,
                           1024, SW128),
                      q > 0 || kk > 0);
        wg_commit();
      } else {
        if (c % gch == 0) {
          const float* sc = p.scale + static_cast<long long>(c / gch) * p.N;
          sa = load_scale(sc, na, p.N);
          sb = load_scale(sc, nb, p.N);
        }
        wg_fence();
#pragma unroll
        for (int q = 0; q < PARTS; ++q) {
          const uint32_t xp = xs + (PARTS - 1 - q) * C::XBOX;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            mma_x<BX>(part, a[kk], desc(xp + 32 * kk, 16, 1024, SW128),
                      c % gch != 0 || q > 0 || kk > 0);
            mma_x<BX>(part, a[kk + 4],
                      desc(xp + C::XRUN + 32 * kk, 16, 1024, SW128), 1);
          }
        }
        wg_commit();
      }
      ++it;
      if (c + 1 < w.c1) load_a(next);
      wg_wait<0>();
      fence_regs(a);
      fence_regs(acc);
      release(s);
      if constexpr (STAGED) {
        fence_regs(part);
        if constexpr (BITS == 8) {
#pragma unroll
          for (int i = 0; i < C::NACC; ++i) acc[i] += part[i];
        } else if (c % gch == gch - 1) {
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
          typename XT::Out* yr = p.y + static_cast<long long>(m + e) * p.N;
          if (oka) yr[na] = out_of<XT>(acc[4 * j + e] * s0);
          if (okb) yr[nb] = out_of<XT>(acc[4 * j + 2 + e] * s1);
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
template <class XT>
__global__ void qmm_split_sum(const float* __restrict__ ws,
                              typename XT::Out* __restrict__ y, long long mn,
                              int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < mn; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v += ws[s * mn + i];
    y[i] = out_of<XT>(v);
  }
}

template <class XT, int BITS, int BX>
cudaError_t launch_prefill(const PrefillParams<XT>& p, cudaStream_t st) {
  using C = PCfg<XT, BITS, BX>;
  // per device: the shared-memory limit (an attribute that must be set)
  // and the SM count, one persistent block on each
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(qmm_prefill<XT, BITS, BX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return e;
    int n = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, qmm_prefill<XT, BITS, BX>, PF_THREADS, C::SMEM);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    sms[dev] = n;
  }
  const int units = p.n_tiles * p.splits * p.x_tiles;
  const int grid = units < sms[dev] ? units : sms[dev];
  qmm_prefill<XT, BITS, BX><<<grid, PF_THREADS, C::SMEM, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const long long mn = static_cast<long long>(p.M) * p.N;
  const long long want = (mn + 255) / 256;
  const int blocks = static_cast<int>(want < 8LL * sms[dev] ? want
                                                            : 8LL * sms[dev]);
  qmm_split_sum<XT><<<blocks, 256, 0, st>>>(p.ws, p.y, mn, p.splits);
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

// a map over `parts` (1: 2-D, else 3-D) stacked [rows × cols] matrices,
// rows `pitch` bytes apart and parts `part_pitch`, boxes of box_rows ×
// box_cols (× parts); what lies past the edges arrives as zeros
bool encode_map(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                CUtensorMapDataType type, long long rows, long long cols,
                long long pitch, int box_rows, int box_cols,
                CUtensorMapSwizzle swizzle, int parts = 1,
                long long part_pitch = 0) {
  const cuuint32_t rank = parts == 1 ? 2 : 3;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(parts)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pitch),
                                 static_cast<cuuint64_t>(part_pitch)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(parts)};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the prefill tile widths an instantiation has (PREFILL_BX in
// ops/quant.py): fp32 x carries three parts a stage, so only the widths
// whose ring keeps 4 stages
template <class XT, int BITS>
bool bx_ok(int bx) {
  if (XT::PARTS == 1)
    return bx == 64 || bx == 128 || (BITS == 8 && (bx == 176 || bx == 256));
  return bx == 64 || (BITS == 8 && bx == 128);
}

// The plan's checks (PrefillPlan in ops/quant.py makes plans that pass),
// the maps, and the launch of the instantiation for bx. x is bf16 [M, K]
// rows ldx apart, or (fp32 x) its parts [3, M, K], contiguous (ldx = K).
template <class XT, int BITS>
cudaError_t prefill(const void* x, const void* w, const void* scale, void* y,
                    void* ws, int M, int N, int K, int G, long long ldx,
                    int bx, int x_tiles, int splits, int split_stages,
                    cudaStream_t st) {
  const int stages = BITS == 8 ? (K + 63) / 64 : K / 128;
  const int step = BITS == 8 ? 1 : G / 128;
  if (!bx_ok<XT, BITS>(bx) || x_tiles <= 0 ||
      static_cast<long long>(x_tiles) * bx < M ||
      (x_tiles - 1) * bx >= M || splits <= 0 || split_stages <= 0 ||
      split_stages % step != 0 ||
      static_cast<long long>(splits) * split_stages < stages ||
      (splits - 1) * split_stages >= stages || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorInvalidValue;
  PrefillParams<XT> p;
  const long long kw = BITS == 8 ? K : K / 2;
  if (!encode_map(fn, &p.xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, M, K,
                  2 * ldx, bx, 64, CU_TENSOR_MAP_SWIZZLE_128B, XT::PARTS,
                  2 * ldx * M) ||
      !encode_map(fn, &p.wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, N, kw, kw,
                  PF_BN, 64, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  p.scale = static_cast<const float*>(scale);
  p.y = static_cast<typename XT::Out*>(y);
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
    case 64: return launch_prefill<XT, BITS, 64>(p, st);
    case 128: if constexpr (XT::PARTS == 1 || BITS == 8)
                return launch_prefill<XT, BITS, 128>(p, st);
              break;
    default: break;
  }
  if constexpr (XT::PARTS == 1 && BITS == 8) {
    if (bx == 176) return launch_prefill<XT, 8, 176>(p, st);
    return launch_prefill<XT, 8, 256>(p, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
