// K4 f32 and K5 f32: weight-only int8 / int4 matrix products on fp32
// activations (fp32 in, fp32 out), on the bf16 tensor cores.
//
// Replace the Pallas TPU kernels mllm_npu_tpu/ops/quant.py:50
// `_matmul_kernel` (K4) and mllm_npu_tpu/ops/quant.py:330 `_matmul4_kernel`
// (K5) for fp32 x: the reference casts the integers to x's dtype and sums
// in fp32 (quant.py:57-59, :337-345), so fp32 serving with a quantized
// Llama (`cast_params_bf16=False` with `quantize_int8` / `quantize_int4`)
// reaches them with fp32 activations. The bf16 variants are
// quant_matmul.cu. Python wrappers and plain PyTorch versions:
// mllm_npu_tpu_torch/ops/quant.py (`int8_matmul`, `int4_matmul`,
// `split_bf16x3`).
//
//   K4: Y[M,N] = (X[M,K] · W[N,K]ᵀ) ∘ scale[N]
//   K5: Y[M,N] = Σ_g (X_g,lo · lo_gᵀ + X_g,hi · hi_gᵀ) ∘ scale[g,N]
//
// Storage as quant_matmul.cu: W [N, K] int8 or [N, K/2] packed int4 in the
// reference's group-half nibble layout, scales fp32 [N] or [K/G, N].
//
// What bounds them on an H100 (989 TFLOP/s bf16, 3.35 TB/s). The tensor
// cores take fp32 only as TF32 (about three decimal digits), and fp32 FMA
// peaks at 67 TFLOP/s: an FMA kernel needs 70.6 ms for the 8B's image
// prefill (M = 339, 224 products, 4.73 TFLOP). But the weights are
// integers, exact in bf16, so x = h + m + l in three bf16 parts (h =
// bf16(x), m = bf16(x − h), l = bf16(x − h − m), round to nearest even;
// together x's 24 significant bits) gives the fp32 product as three bf16
// products, each exact in the fp32 accumulator: 14.35 ms for that prefill
// at the bf16 rate. Decode (M ≤ 16) stays bound by the weight bytes.
//
// Design: x split once per call into its parts, then the products on the
// bf16 tensor cores, each converted weight fragment feeding three:
//  * `split_x3` writes X's parts to a workspace [3, M, K] bf16 (10 bytes
//    an element, 1.45 ms over an 8B prefill's 224 products on an H100
//    80GB HBM3 at 700 W). `split_bf16x3` (ops/quant.py) is its plain twin,
//    bit for bit.
//  * M ≤ F32_DECODE_MAX_M (ops/quant.py): `qmm_decode_parts`, quant_
//    matmul.cu's decode design with the product taken transposed per
//    warp, Yᵀ = W · Xᵀ: the converted weight is mma.sync's A operand (16
//    weight rows, streamed from memory as 16-byte pieces) and each part of
//    x its B operand (8 x rows; a second tile for rows 8-15), so one
//    conversion feeds three m16n8k16 and each covers 16 weight rows.
//    Splitting x in registers instead (quant_matmul.cu's decode as it is,
//    three A fragments a k-step) measured 25.5% of the byte bound at M = 1
//    (K4 f32 over the 8B's products, H100 80GB HBM3 at 700 W), bound by
//    the split's instructions.
//  * Otherwise `qmm_prefill` (quant_matmul.cuh) instantiated for `XF32`:
//    each ring stage brings the weight box and a [64 columns × bx rows ×
//    3 parts] box of each X run through one 3-D tensor map (TMA zero-fills
//    rows past M in every part), and each consumer warpgroup converts its A
//    fragment once for three wgmmas. Three parts a stage leave room for 4
//    stages (of the card's 227 KB) at bx 64 and 128 for int8 and at bx 64
//    for int4; the plan picks among them (`prefill_plan(dtype=
//    torch.float32)`).
//  * Sums: the tensor cores' fp32 accumulation is not IEEE-rounded, so the
//    decode adds each 16-k lane chunk (int4: each group), the prefill each
//    ring stage (int4: each group) to its accumulator in fp32, and the
//    parts go l, m, h, small before large.

#include "quant_matmul.cuh"

namespace {

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two fp32 values a (lower k) and b → their three bf16 parts as pairs (a in
// the low half): h = bf16(x), m = bf16(x − h), l = bf16(x − h − m), each
// rounded to nearest even; the differences are exact in fp32.
__device__ __forceinline__ void split3(float a, float b, uint32_t& h,
                                       uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(a, b);
  a -= __low2float(hb);
  b -= __high2float(hb);
  const __nv_bfloat162 mb = __floats2bfloat162_rn(a, b);
  a -= __low2float(mb);
  b -= __high2float(mb);
  h = bf16x2_bits(hb);
  m = bf16x2_bits(mb);
  l = bf16x2_bits(__floats2bfloat162_rn(a, b));
}

__device__ __forceinline__ float4 ld_x4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// X [M, K] fp32 (rows ldx apart) → xs [3, M, K] bf16: h, m, l (split3),
// eight values a thread per step. It lets the kernel launched after it
// with programmatic serialization (the decode) start at once; that kernel
// waits (griddepcontrol.wait) for this grid's writes before reading xs.
__global__ void split_x3(const float* __restrict__ x,
                         __nv_bfloat16* __restrict__ xs, int M, int K,
                         long long ldx) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const long long per_row = K / 8, total = per_row * M;
  const long long mk = static_cast<long long>(M) * K;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long m = i / per_row, k = (i - m * per_row) * 8;
    const float4 a = ld_x4(x + m * ldx + k);
    const float4 b = ld_x4(x + m * ldx + k + 4);
    uint4 h, md, l;
    split3(a.x, a.y, h.x, md.x, l.x);
    split3(a.z, a.w, h.y, md.y, l.y);
    split3(b.x, b.y, h.z, md.z, l.z);
    split3(b.z, b.w, h.w, md.w, l.w);
    uint4* o = reinterpret_cast<uint4*>(xs + m * K + k);
    o[0] = h;
    o[mk / 8] = md;
    o[mk / 4] = l;
  }
}

int sm_count(cudaError_t& e) {
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return 0;
  if (dev >= MAX_DEVICES) {
    e = cudaErrorInvalidDevice;
    return 0;
  }
  if (sms[dev] == 0)
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
  return sms[dev];
}

cudaError_t launch_split(const float* x, __nv_bfloat16* xs, int M, int K,
                         long long ldx, cudaStream_t st) {
  cudaError_t e = cudaSuccess;
  const int sms = sm_count(e);
  if (e != cudaSuccess) return e;
  const long long want = (static_cast<long long>(M) * (K / 8) + 255) / 256;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  split_x3<<<blocks, 256, 0, st>>>(x, xs, M, K, ldx);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- decode
struct PartsParams {
  const __nv_bfloat16* xs;  // [3, M, K]: x's parts h, m, l, contiguous
  const int8_t* w;          // [N, K] int8 or [N, K/2] packed int4
  const float* scale;       // [N] (int8) or [K/G, N] (int4)
  float* y;                 // [M, N]
  int M, N, K, G;
};

// 16 bytes of the parts. Not through the read-only path (__ldg):
// `split_x3` may still be writing the parts when the decode starts, and
// the compiler may hoist a read-only load above griddepcontrol.wait; a
// volatile load with a "memory" clobber stays below it. Cached in L1: no
// load of the parts comes before the wait.
__device__ __forceinline__ uint4 ld_part(const __nv_bfloat16* p) {
  uint4 v;
  asm volatile("ld.global.ca.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

// one lane's 16 bf16 of x row r at k in each part (zeros if !ok)
__device__ __forceinline__ void load_parts(const __nv_bfloat16* xr,
                                           long long mk, bool ok,
                                           uint32_t (&r)[3][8]) {
  const uint4 z = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const __nv_bfloat16* p = xr + q * mk;
    unpack8(ok ? ld_part(p) : z, ok ? ld_part(p + 8) : z, r[q]);
  }
}

// d += W · (l + m + h) over k-step s of the lane's 16 k: A the weight rows
// g and g + 8 (a0 .. a3), B one part's x pairs at k 4s (words 2s, 2s + 1)
__device__ __forceinline__ void mma_parts(float (&d)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3,
                                          const uint32_t (&x)[3][8], int s) {
#pragma unroll
  for (int q = 2; q >= 0; --q)
    mma_bf16(d, a0, a1, a2, a3, x[q][2 * s], x[q][2 * s + 1]);
}

__device__ __forceinline__ void store_f32(const PartsParams& p, int m, int n,
                                          float v) {
  if (m < p.M && n < p.N) p.y[static_cast<long long>(m) * p.N + n] = v;
}

// The decode kernel's shape: warps a block, weight loads in flight per lane
// and row (int8, int4), the blocks an SM its registers are held to (launch
// bounds), the blocks an SM of 132 the n-tiling aims for, and whether it
// is launched to overlap the pre-split (bench_quant_decode.py times the
// choices).
constexpr int DP_WARPS = 8;
constexpr int DP_UNROLL_INT8 = 2;
constexpr int DP_UNROLL_INT4 = 1;
constexpr int DP_MIN_BLOCKS = 2;
constexpr int DP_BLOCKS = 4;
constexpr int DP_OVERLAP = 1;

// M ≤ 16. Warp w owns n-tile (w % NT) of 16 weight rows and K-slice
// (w / NT). Lane (g, t) streams 16 contiguous k (int4: 16 packed bytes)
// of weight rows n0 + g and n0 + g + 8 a chunk, and reads the same k of x
// row g (with TWO, M > 8, also of row g + 8) in each part. The
// accumulator (mma.sync's C, Yᵀ) holds Y[2t][n], Y[2t + 1][n] for n =
// n0 + g and n0 + g + 8 (tile 1: rows 8 + 2t, 9 + 2t). Launched with
// programmatic serialization behind `split_x3`: its first weight loads are
// in flight before it waits for the parts.
template <int BITS, int NT, bool TWO>
__global__ void __launch_bounds__(DP_WARPS * 32, DP_MIN_BLOCKS)
    qmm_decode_parts(const PartsParams p) {
  constexpr int KS = DP_WARPS / NT, J = TWO ? 2 : 1;
  constexpr int U = BITS == 8 ? DP_UNROLL_INT8 : DP_UNROLL_INT4;
  bool waiting = true;  // for split_x3's writes
  auto wait_parts = [&] {
    if (waiting) asm volatile("griddepcontrol.wait;\n" ::: "memory");
    waiting = false;
  };
  __shared__ float red[DP_WARPS][32][4 * J];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nt = warp % NT, ks = warp / NT;
  const int na = (blockIdx.x * NT + nt) * 16 + g, nb = na + 8;
  const bool oka = na < p.N, okb = nb < p.N;
  const long long kw = BITS == 8 ? p.K : p.K / 2;
  const int8_t* wa = p.w + (oka ? na : 0) * kw;
  const int8_t* wb = p.w + (okb ? nb : 0) * kw;
  const long long mk = static_cast<long long>(p.M) * p.K;
  const bool ok[2] = {g < p.M, g + 8 < p.M};
  const __nv_bfloat16* xr[2] = {
      p.xs + static_cast<long long>(ok[0] ? g : 0) * p.K,
      p.xs + static_cast<long long>(ok[1] ? g + 8 : 0) * p.K};
  const uint4 z = make_uint4(0, 0, 0, 0);
  float acc[J][4] = {};

  if constexpr (BITS == 8) {
    // 64-k chunks, dealt to the K-slices in turn; each chunk's sum apart,
    // then added in fp32
    const int nch = (p.K + 63) / 64;
    for (int c0 = ks; c0 < nch; c0 += KS * U) {
      uint4 va[U], vb[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + u * KS, k = c * 64 + 16 * t;
        const bool in = c < nch && k < p.K;
        va[u] = in && oka ? ld_stream(wa + k) : z;
        vb[u] = in && okb ? ld_stream(wb + k) : z;
      }
      wait_parts();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + u * KS, k = c * 64 + 16 * t;
        if (c >= nch) break;  // warp-uniform
        uint32_t x[J][3][8];
#pragma unroll
        for (int j = 0; j < J; ++j)
          load_parts(xr[j] + k, mk, ok[j] && k < p.K, x[j]);
        const uint32_t wsa[4] = {va[u].x, va[u].y, va[u].z, va[u].w};
        const uint32_t wsb[4] = {vb[u].x, vb[u].y, vb[u].z, vb[u].w};
        float part[J][4] = {};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          uint32_t a0, a1, a2, a3;
          i8x4_to_bf16(wsa[s], a0, a2);
          i8x4_to_bf16(wsb[s], a1, a3);
#pragma unroll
          for (int j = 0; j < J; ++j) mma_parts(part[j], a0, a1, a2, a3, x[j], s);
        }
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
      }
    }
  } else {
    // whole groups per K-slice, walked as one list of 64-byte chunks (the
    // loads in flight run across group ends); a group's sum is scaled
    // when its last chunk is in
    const int gch = p.G / 128, ngroups = p.K / p.G;
    const int nq = ngroups > ks ? (ngroups - ks + KS - 1) / KS * gch : 0;
    float part[J][4] = {};
    for (int q0 = 0; q0 < nq; q0 += U) {
      uint4 va[U], vb[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + u, grp = ks + q / gch * KS, c = q % gch;
        const long long b = static_cast<long long>(grp) * (p.G / 2) +
                            c * 64 + 16 * t;
        va[u] = (q < nq && oka) ? ld_stream(wa + b) : z;
        vb[u] = (q < nq && okb) ? ld_stream(wb + b) : z;
      }
      wait_parts();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + u, grp = ks + q / gch * KS, c = q % gch;
        if (q >= nq) break;  // warp-uniform
        const int kl = grp * p.G + c * 64 + 16 * t, kh = kl + p.G / 2;
        const uint32_t wsa[4] = {va[u].x, va[u].y, va[u].z, va[u].w};
        const uint32_t wsb[4] = {vb[u].x, vb[u].y, vb[u].z, vb[u].w};
#pragma unroll
        for (int j = 0; j < J; ++j) {
          uint32_t xl[3][8], xh[3][8];
          load_parts(xr[j] + kl, mk, ok[j], xl);
          load_parts(xr[j] + kh, mk, ok[j], xh);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            uint32_t la0, la1, ha0, ha1, lb0, lb1, hb0, hb1;
            i4x8_to_bf16(wsa[s], la0, la1, ha0, ha1);
            i4x8_to_bf16(wsb[s], lb0, lb1, hb0, hb1);
            mma_parts(part[j], la0, lb0, la1, lb1, xl, s);
            mma_parts(part[j], ha0, hb0, ha1, hb1, xh, s);
          }
        }
        if (c == gch - 1) {
          const float* sc = p.scale + static_cast<long long>(grp) * p.N;
          const float sa = load_scale(sc, na, p.N);
          const float sb = load_scale(sc, nb, p.N);
#pragma unroll
          for (int j = 0; j < J; ++j) {
            acc[j][0] += part[j][0] * sa;
            acc[j][1] += part[j][1] * sa;
            acc[j][2] += part[j][2] * sb;
            acc[j][3] += part[j][3] * sb;
#pragma unroll
            for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
          }
        }
      }
    }
  }

#pragma unroll
  for (int e = 0; e < 4 * J; ++e) red[warp][lane][e] = acc[e / 4][e % 4];
  __syncthreads();
  if (ks != 0) return;
  for (int i = 1; i < KS; ++i) {
#pragma unroll
    for (int e = 0; e < 4 * J; ++e)
      acc[e / 4][e % 4] += red[i * NT + nt][lane][e];
  }
  float sa = 1.f, sb = 1.f;
  if constexpr (BITS == 8) {
    sa = load_scale(p.scale, na, p.N);
    sb = load_scale(p.scale, nb, p.N);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int m = 8 * j + 2 * t;
    store_f32(p, m, na, acc[j][0] * sa);
    store_f32(p, m + 1, na, acc[j][1] * sa);
    store_f32(p, m, nb, acc[j][2] * sb);
    store_f32(p, m + 1, nb, acc[j][3] * sb);
  }
}

// launched to overlap the end of the split launched before it on `st`
template <int BITS, int NT>
cudaError_t launch_decode_parts(const PartsParams& p, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + 16 * NT - 1) / (16 * NT));
  cfg.blockDim = dim3(DP_WARPS * 32);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = DP_OVERLAP ? 1 : 0;
  if (p.M > 8)
    return cudaLaunchKernelEx(&cfg, qmm_decode_parts<BITS, NT, true>, p);
  return cudaLaunchKernelEx(&cfg, qmm_decode_parts<BITS, NT, false>, p);
}

// the widest n-tiling (NT ≤ DP_WARPS) that still gives DP_BLOCKS blocks an
// SM of 132
template <int BITS, int NT = DP_WARPS>
cudaError_t decode_parts(const PartsParams& p, cudaStream_t st) {
  if constexpr (NT > 1) {
    if ((p.N + 16 * NT - 1) / (16 * NT) < DP_BLOCKS * 132)
      return decode_parts<BITS, NT / 2>(p, st);
  }
  const cudaError_t e = launch_decode_parts<BITS, NT>(p, st);
  return e != cudaSuccess ? e : cudaGetLastError();
}

bool aligned16(const void* a, const void* b) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// The split (into xs, 16-byte aligned, [3, M, K]), then the decode kernel
// or (`prefill`) the prefill kernel on the parts.
template <int BITS>
cudaError_t run_f32(const void* x, const void* w, const void* scale, void* y,
                    void* xs, void* ws, int M, int N, int K, int G,
                    long long ldx, int prefill_route, int bx, int x_tiles,
                    int splits, int split_stages, cudaStream_t st) {
  if (xs == nullptr || reinterpret_cast<uintptr_t>(xs) % 16 != 0 ||
      (!prefill_route && M > DECODE_MAX_M))
    return cudaErrorInvalidValue;
  __nv_bfloat16* parts = static_cast<__nv_bfloat16*>(xs);
  cudaError_t e = launch_split(static_cast<const float*>(x), parts, M, K,
                               ldx, st);
  if (e != cudaSuccess) return e;
  if (!prefill_route)
    return decode_parts<BITS>({parts, static_cast<const int8_t*>(w),
                               static_cast<const float*>(scale),
                               static_cast<float*>(y), M, N, K, G},
                              st);
  return prefill<XF32, BITS>(parts, w, scale, y, ws, M, N, K, G, K, bx,
                             x_tiles, splits, split_stages, st);
}

}  // namespace

// Each returns 0 on success, else a CUDA error code (cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for arguments, a plan or a
// tensor map the kernels do not take). Pointers are device pointers; x
// rows are ldx elements apart (a multiple of 4, base 16-byte aligned); w
// rows are contiguous, 16-byte aligned and a multiple of 16 bytes; y is
// [M, N] fp32; xs is a bf16 workspace of 3·M·K (x's parts). `prefill` 0
// runs the decode kernel (M ≤ 16); 1 the prefill kernel on the plan (bx,
// x_tiles, splits, split_stages: ops/quant.py prefill_plan with dtype fp32)
// with ws an fp32 workspace of splits·M·N (null when splits is 1); the
// decode reads neither.

// The pre-split alone (ops/quant.py `split_x3`, held bit for bit against
// `split_bf16x3`): x [M, K] fp32 rows ldx apart → xs [3, M, K] bf16;
// K % 8 == 0.
extern "C" int split_bf16x3_f32(const void* x, void* xs, int M, int K,
                                long long ldx, void* stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0 || ldx % 4 != 0 || !aligned16(x, xs))
    return cudaErrorInvalidValue;
  return launch_split(static_cast<const float*>(x),
                      static_cast<__nv_bfloat16*>(xs), M, K, ldx,
                      static_cast<cudaStream_t>(stream));
}

// K4 f32: w [N, K] int8, scale [N] fp32; K % 16 == 0.
extern "C" int int8_matmul_f32(const void* x, const void* w,
                               const void* scale, void* y, void* xs, void* ws,
                               int M, int N, int K, long long ldx,
                               int prefill, int bx, int x_tiles, int splits,
                               int split_stages, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || ldx % 4 != 0 ||
      !aligned16(x, w))
    return cudaErrorInvalidValue;
  return run_f32<8>(x, w, scale, y, xs, ws, M, N, K, 0, ldx, prefill, bx,
                    x_tiles, splits, split_stages,
                    static_cast<cudaStream_t>(stream));
}

// K5 f32: w [N, K/2] packed int4, scale [K/G, N] fp32; G % 128 == 0,
// K % G == 0.
extern "C" int int4_matmul_f32(const void* x, const void* w,
                               const void* scale, void* y, void* xs, void* ws,
                               int M, int N, int K, int G, long long ldx,
                               int prefill, int bx, int x_tiles, int splits,
                               int split_stages, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || G % 128 != 0 || K % G != 0 ||
      ldx % 4 != 0 || !aligned16(x, w))
    return cudaErrorInvalidValue;
  return run_f32<4>(x, w, scale, y, xs, ws, M, N, K, G, ldx, prefill, bx,
                    x_tiles, splits, split_stages,
                    static_cast<cudaStream_t>(stream));
}
