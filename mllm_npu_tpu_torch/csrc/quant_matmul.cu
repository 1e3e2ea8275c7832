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
// the kernel, bound the spin in mbar_wait (MBAR_TRAP_CYCLES, see
// quant_matmul.cuh) so a lost arrival faults instead of hanging.
//
// Registers: setmaxnreg gives the consumers 240 and the producer
// warpgroup 24 (384 threads, one block per SM). The accumulator takes
// bx/2 registers, K5's `part` as many again, the A double buffer 32 (K4)
// or 64 (K5, 128 k a stage): so K5's tile stops at 128 X rows.
//
// The decode kernel is here; the prefill kernel's body and the helpers the
// two share are in quant_matmul.cuh, the prefill templated on the X
// operand: this file instantiates it for bf16 x (`XBf16`),
// quant_matmul_f32.cu for fp32 x (K4 f32, K5 f32).

#include "quant_matmul.cuh"

namespace {

struct Params {
  const __nv_bfloat16* x;  // [M, K], row stride ldx (elements)
  const int8_t* w;         // [N, K] int8 or [N, K/2] packed int4
  const float* scale;      // [N] (int8) or [K/G, N] (int4)
  __nv_bfloat16* y;        // [M, N]
  int M, N, K, G;
  long long ldx;
};

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
  return prefill<XBf16, 8>(x, w, scale, y, ws, M, N, K, 0, ldx, bx,
                           x_tiles, splits, split_stages, st);
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
  return prefill<XBf16, 4>(x, w, scale, y, ws, M, N, K, G, ldx, bx,
                           x_tiles, splits, split_stages, st);
}
