// K4 f32 and K5 f32: weight-only int8 / int4 matrix products on fp32
// activations (fp32 in, fp32 out), in fp32 FMA.
//
// Replace the Pallas TPU kernels mllm_npu_tpu/ops/quant.py:50
// `_matmul_kernel` (K4) and mllm_npu_tpu/ops/quant.py:330 `_matmul4_kernel`
// (K5) for fp32 x: the reference casts the integers to x's dtype and sums
// in fp32 (quant.py:57-59, :337-345), so fp32 serving with a quantized
// Llama (`cast_params_bf16=False` with `quantize_int8` / `quantize_int4`)
// reaches them with fp32 activations. The bf16 variants are
// quant_matmul.cu. Python wrappers and plain PyTorch versions:
// mllm_npu_tpu_torch/ops/quant.py (`int8_matmul`, `int4_matmul`).
//
//   K4: Y[M,N] = (X[M,K] · W[N,K]ᵀ) ∘ scale[N]
//   K5: Y[M,N] = Σ_g (X_g,lo · lo_gᵀ + X_g,hi · hi_gᵀ) ∘ scale[g,N]
//
// Storage as quant_matmul.cu: W [N, K] int8 or [N, K/2] packed int4 in the
// reference's group-half nibble layout (byte r of group g holds W[n, gG+r]
// low and W[n, gG+G/2+r] high), scales fp32 [N] or [K/G, N]. The integers
// are exact in fp32; every product and sum is an fp32 FMA (the tensor cores
// take fp32 only as TF32, which keeps about three decimal digits).
//
// What bounds them on an H100 (67 TFLOP/s fp32 FMA, 3.35 TB/s). Decode
// (M ≤ 16) reads each weight byte once for 2·M flops: bound by the bytes
// (q_proj at int8, 16 MB: 5 µs). The image prefill (M = 339) does 2·M
// flops a weight byte in fp32: bound by the operations (gate_proj at 8B,
// 39.8 GFLOP: 0.59 ms at the FMA rate).
//
// Design (simple first):
//  * Decode, M ≤ 16 (rounded up to 1, 2, 4, 8 or 16 rows in registers): a
//    block of 8 warps owns 16 weight rows, 2 a warp; each chunk of 512
//    (int8) or 256 (int4) weight bytes a row is read as 4-byte words, 128
//    bytes a warp-load, all of a lane's words issued before any is used.
//    The block stages the chunk's X in shared memory (for int4 by nibble
//    position: the X value under each byte's low and high nibble), read as
//    conflict-free float4s. Warp-shuffle sums at the end. K5 scales each
//    word's partial sum by its group's scale (a word never crosses a
//    group: G % 128 == 0).
//  * Prefill, M > 16: 64 × 64 output tiles, 256 threads of 4 × 4 outputs,
//    32-deep K steps through shared memory, X stored k-major and the
//    weight converted to fp32 on the way in, both read as float4s. K5 keeps
//    a group's partial sums apart and adds them scaled at the group's end
//    (a 32-deep step never crosses a group half).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DEC_WARPS = 8, DEC_ROWS = 2;
constexpr int DEC_BN = DEC_WARPS * DEC_ROWS;     // weight rows a block

struct P {
  const float* x;
  const int8_t* w;
  const float* scale;
  float* y;
  int M, N, K, G;
  long long ldx;
};

__device__ __forceinline__ int nib_lo(uint32_t byte) {
  return static_cast<int>((byte & 0xFu) ^ 8u) - 8;
}

__device__ __forceinline__ int nib_hi(uint32_t byte) {
  return static_cast<int>(static_cast<int8_t>(byte & 0xFFu)) >> 4;
}

template <int BITS, int MT>
__global__ void __launch_bounds__(DEC_WARPS * 32) decode_f32(const P p) {
  constexpr int CB = BITS == 8 ? 512 : 256;     // weight bytes a row a chunk
  constexpr int WPL = CB / 128;                 // words a lane a row
  constexpr int XN = BITS == 8 ? 1 : 2;         // X values a byte
  __shared__ __align__(16) float xs[XN][MT][CB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * DEC_BN + warp * DEC_ROWS;
  const int KB = BITS == 8 ? p.K : p.K / 2;     // bytes a row
  const int half = p.G / 2;
  float acc[MT][DEC_ROWS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < DEC_ROWS; ++r) acc[m][r] = 0.f;

  for (int c0 = 0; c0 < KB; c0 += CB) {
    __syncthreads();
    for (int i = tid; i < MT * CB; i += DEC_WARPS * 32) {
      const int m = i / CB, o = i % CB, ob = c0 + o;
      const bool ok = m < p.M && ob < KB;
      const float* xr = p.x + m * p.ldx;
      if (BITS == 8) {
        xs[0][m][o] = ok ? xr[ob] : 0.f;
      } else {
        const int kl = ob / half * p.G + ob % half;
        xs[0][m][o] = ok ? xr[kl] : 0.f;
        xs[XN - 1][m][o] = ok ? xr[kl + half] : 0.f;
      }
    }
    __syncthreads();
    uint32_t wv[DEC_ROWS][WPL];
#pragma unroll
    for (int r = 0; r < DEC_ROWS; ++r)
#pragma unroll
      for (int c = 0; c < WPL; ++c) {
        const int o = 4 * lane + 128 * c;
        wv[r][c] = n0 + r < p.N && c0 + o < KB
                       ? __ldg(reinterpret_cast<const uint32_t*>(
                             p.w + static_cast<long long>(n0 + r) * KB + c0 +
                             o))
                       : 0u;
      }
#pragma unroll
    for (int c = 0; c < WPL; ++c) {
      const int o = 4 * lane + 128 * c;
#pragma unroll
      for (int r = 0; r < DEC_ROWS; ++r) {
        const uint32_t word = wv[r][c];
        if (BITS == 8) {
          const float w0 = static_cast<float>(static_cast<int8_t>(word));
          const float w1 = static_cast<float>(static_cast<int8_t>(word >> 8));
          const float w2 = static_cast<float>(static_cast<int8_t>(word >> 16));
          const float w3 = static_cast<float>(static_cast<int8_t>(word >> 24));
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float4 xv = *reinterpret_cast<const float4*>(&xs[0][m][o]);
            acc[m][r] += xv.x * w0 + xv.y * w1 + xv.z * w2 + xv.w * w3;
          }
        } else {
          float lo[4], hi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t byte = (word >> (8 * i)) & 0xFFu;
            lo[i] = static_cast<float>(nib_lo(byte));
            hi[i] = static_cast<float>(nib_hi(byte));
          }
          const int n = min(n0 + r, p.N - 1);
          const float s = p.scale[static_cast<long long>((c0 + o) / half) *
                                      p.N + n];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float4 xl = *reinterpret_cast<const float4*>(&xs[0][m][o]);
            const float4 xh =
                *reinterpret_cast<const float4*>(&xs[XN - 1][m][o]);
            const float part = xl.x * lo[0] + xl.y * lo[1] + xl.z * lo[2] +
                               xl.w * lo[3] + xh.x * hi[0] + xh.y * hi[1] +
                               xh.z * hi[2] + xh.w * hi[3];
            acc[m][r] += part * s;
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < DEC_ROWS; ++r) {
      float v = acc[m][r];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, d);
      acc[m][r] = v;
    }
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < DEC_ROWS; ++r) {
      const int n = n0 + r;
      if (n >= p.N) continue;
      const float s = BITS == 8 ? p.scale[n] : 1.f;
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m < p.M) p.y[static_cast<long long>(m) * p.N + n] = acc[m][r] * s;
    }
}

constexpr int PF_BM = 64, PF_BN = 64, PF_BK = 32, PF_THREADS = 256;

template <int BITS>
__global__ void __launch_bounds__(PF_THREADS) prefill_f32(const P p) {
  __shared__ __align__(16) float As[PF_BK][PF_BM];   // X tile, k-major
  __shared__ __align__(16) float Bs[PF_BK][PF_BN];   // W tile, k-major
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * PF_BM, n0 = blockIdx.x * PF_BN;
  const int KB = BITS == 8 ? p.K : p.K / 2;
  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += PF_BK) {
    // X: 64 rows × 32 k, two float4s a thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + PF_THREADS * i, r = idx / 8, kq = idx % 8 * 4;
      const int m = m0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < p.M && k0 + kq < p.K)
        v = *reinterpret_cast<const float4*>(p.x + m * p.ldx + k0 + kq);
      As[kq][r] = v.x;
      As[kq + 1][r] = v.y;
      As[kq + 2][r] = v.z;
      As[kq + 3][r] = v.w;
    }
    // W: 64 rows × 32 k, 8 bytes a thread
    {
      const int r = tid / 4, kb = tid % 4 * 8, n = n0 + r;
      long long byte0;
      bool high = false;
      if (BITS == 8) {
        byte0 = k0 + kb;
      } else {
        const int g = k0 / p.G, within = k0 % p.G, half = p.G / 2;
        high = within >= half;
        byte0 = static_cast<long long>(g) * half + within - (high ? half : 0)
                + kb;
      }
      uint2 wv = make_uint2(0u, 0u);
      if (n < p.N && k0 + kb < p.K)
        wv = *reinterpret_cast<const uint2*>(
            p.w + static_cast<long long>(n) * KB + byte0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t byte = ((i < 4 ? wv.x : wv.y) >> (8 * (i % 4))) & 0xFFu;
        int q;
        if (BITS == 8) q = static_cast<int8_t>(byte);
        else q = high ? nib_hi(byte) : nib_lo(byte);
        Bs[kb + i][r] = static_cast<float>(q);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < PF_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (BITS == 8) acc[i][j] += av[i] * bv[j];
          else part[i][j] += av[i] * bv[j];
        }
    }
    __syncthreads();
    if (BITS == 4 && ((k0 + PF_BK) % p.G == 0 || k0 + PF_BK >= p.K)) {
      const int g = k0 / p.G;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = min(n0 + tx * 4 + j, p.N - 1);
        const float s = p.scale[static_cast<long long>(g) * p.N + n];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] += part[i][j] * s;
          part[i][j] = 0.f;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < p.N)
        p.y[static_cast<long long>(m) * p.N + n] =
            BITS == 8 ? acc[i][j] * p.scale[n] : acc[i][j];
    }
  }
}

template <int BITS>
int run(const P& p, cudaStream_t st) {
  if (p.M > 16) {
    const dim3 grid((p.N + PF_BN - 1) / PF_BN, (p.M + PF_BM - 1) / PF_BM);
    prefill_f32<BITS><<<grid, PF_THREADS, 0, st>>>(p);
    return cudaGetLastError();
  }
  const dim3 grid((p.N + DEC_BN - 1) / DEC_BN);
  const int threads = DEC_WARPS * 32;
  if (p.M == 1) decode_f32<BITS, 1><<<grid, threads, 0, st>>>(p);
  else if (p.M <= 2) decode_f32<BITS, 2><<<grid, threads, 0, st>>>(p);
  else if (p.M <= 4) decode_f32<BITS, 4><<<grid, threads, 0, st>>>(p);
  else if (p.M <= 8) decode_f32<BITS, 8><<<grid, threads, 0, st>>>(p);
  else decode_f32<BITS, 16><<<grid, threads, 0, st>>>(p);
  return cudaGetLastError();
}

P make(const void* x, const void* w, const void* scale, void* y, int M,
       int N, int K, int G, long long ldx) {
  P p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.y = static_cast<float*>(y);
  p.M = M; p.N = N; p.K = K; p.G = G; p.ldx = ldx;
  return p;
}

bool aligned16(const void* a, const void* b) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace

// K4 f32: x [M, K] fp32 rows ldx apart, w [N, K] int8, scale [N] fp32,
// y [M, N] fp32; K % 16 == 0, ldx % 4 == 0.
extern "C" int int8_matmul_f32(const void* x, const void* w,
                               const void* scale, void* y, int M, int N,
                               int K, long long ldx, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || ldx % 4 != 0 ||
      !aligned16(x, w))
    return cudaErrorInvalidValue;
  return run<8>(make(x, w, scale, y, M, N, K, 0, ldx),
                static_cast<cudaStream_t>(stream));
}

// K5 f32: w [N, K/2] packed int4, scale [K/G, N] fp32; G % 128 == 0,
// K % G == 0, ldx % 4 == 0.
extern "C" int int4_matmul_f32(const void* x, const void* w,
                               const void* scale, void* y, int M, int N,
                               int K, int G, long long ldx, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || G % 128 != 0 || K % G != 0 ||
      ldx % 4 != 0 || !aligned16(x, w))
    return cudaErrorInvalidValue;
  return run<4>(make(x, w, scale, y, M, N, K, G, ldx),
                static_cast<cudaStream_t>(stream));
}
