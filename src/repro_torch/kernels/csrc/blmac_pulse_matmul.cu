// blmac_pulse_matmul_kernel: the CSD-P pulse-code matmul for Hopper.
//
// Replaces the TPU kernel `_pulse_matmul_kernel`
// (src/repro/kernels/blmac_matmul.py), launched there by `pulse_matmul`.
// It computes the same function: float32 y (M, N) = x (M, K) @ W, where W is
// rebuilt from P uint8 pulse codes per weight (bit 7 valid, bit 6 sign, bits
// 3..0 position; codes laid out (P, K, N)) and one int8 exponent per `group`
// rows of K (group_exp (K / group, N)):
//
//     W[k, n] = sum_p valid * (sign ? -1 : 1) * 2^(e[k / group, n] - 14 + pos)
//
// The decode is exact: every pulse is a power of two from 2^-141 to 2^127, and
// the <= 16 pulses of one weight span at most 16 bits, so their float32 sum
// equals the reference decode bit for bit as long as denormals survive (the
// build uses neither --use_fast_math nor -ftz=true).  `exp2_int` builds 2^n
// from the exponent field only where the result is normal and takes ldexpf
// (exact, denormal results included) below 2^-126.  A null slot's value may
// be +inf (2^128 at e >= 114); it is selected away, never multiplied by 0.
//
// What bounds it on the H100: at decode (M of a few rows) the bytes of the
// codes, P per weight, against 2 * M FLOPs per weight; at prefill (M = 128)
// the FLOPs.  This first kernel runs on the CUDA cores in float32 (FFMA), so
// at prefill it sits above the tensor-core bound that the smoke script
// states; tensor cores (3xTF32 or a 2xbf16 split, TMA staging) are later
// work: one TF32 or bf16 pass would miss the reference's 1e-5 bound.
//
// Design: one block owns BM x 128 outputs and a range of K (split-K: the
// grid's z dimension, so that a decode-sized M still puts several blocks on
// every SM).  It walks its K range 32 rows at a time.  For each step it
// decodes the (P, 32, 128) codes into a float32 weight tile in shared memory
// once (16 weights a thread, one 16-byte load per plane), stages the matching
// x tile transposed, and accumulates TM x 8 outputs a thread with FMA.  A
// block with a split of K writes its partial sums to a workspace (splits, M,
// N); a second kernel adds them in split order, so the result does not
// depend on the order blocks finish.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 32;   // rows of K per step
constexpr int kTN = 8;    // output columns per thread: two runs of 4, 64 apart

// 2^n exactly, for n in [-149, 128] (n = 128 gives +inf).
__device__ __forceinline__ float exp2_int(int n) {
  return n >= -126 ? __int_as_float((n + 127) << 23) : ldexpf(1.0f, n);
}

// The value of one pulse code under group exponent e: a select, no multiply.
__device__ __forceinline__ float pulse_value(uint32_t code, int e) {
  const float v = exp2_int(e - 14 + static_cast<int>(code & 0xFu));
  return (code & 0x80u) ? ((code & 0x40u) ? -v : v) : 0.0f;
}

__device__ __forceinline__ uint32_t byte_of(const uint4& v, int j) {
  const uint32_t w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xFFu;
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
blmac_pulse_matmul_kernel(const float* __restrict__ x,
                          const uint8_t* __restrict__ codes,
                          const int8_t* __restrict__ gexp,
                          float* __restrict__ out, int m, int n, int k,
                          int planes, int group, int ktiles_per_split,
                          bool vec) {
  constexpr int TM = BM / 16;
  __shared__ __align__(16) float ws[kBK][kBN];     // decoded weight tile
  __shared__ float xs[kBK][BM + 1];                // x tile, k-major, padded

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int k_tiles = (k + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * ktiles_per_split;
  const int kt1 = min(kt0 + ktiles_per_split, k_tiles);
  const long long plane_stride = static_cast<long long>(k) * n;

  // decode assignment: one row of the step, 16 consecutive columns
  const int dr = threadIdx.x / 8;
  const int dc = (threadIdx.x % 8) * 16;

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int kb = kt * kBK;
    {
      const int kr = kb + dr;
      const int col = n0 + dc;
      float w[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = 0.0f;
      if (kr < k && col < n) {
        const long long off = static_cast<long long>(kr) * n + col;
        const int8_t* erow = gexp + static_cast<long long>(kr / group) * n + col;
        if (vec) {  // n % 16 == 0 and 16-byte aligned operands
          const uint4 ev = *reinterpret_cast<const uint4*>(erow);
          for (int p = 0; p < planes; ++p) {
            const uint4 cv = __ldg(reinterpret_cast<const uint4*>(
                codes + p * plane_stride + off));
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int e = static_cast<int8_t>(byte_of(ev, j));
              w[j] += pulse_value(byte_of(cv, j), e);
            }
          }
        } else {
          for (int p = 0; p < planes; ++p) {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              if (col + j < n) {
                w[j] += pulse_value(codes[p * plane_stride + off + j], erow[j]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<float4*>(&ws[dr][dc + 4 * q]) =
            make_float4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
      }
    }
    for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
      const int mm = i / kBK;
      const int kk = i % kBK;
      const int gm = m0 + mm;
      const int gk = kb + kk;
      xs[kk][mm] = (gm < m && gk < k) ? x[static_cast<long long>(gm) * k + gk]
                                      : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      const float b[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* o = out + static_cast<long long>(blockIdx.z) * m * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gn < n) o[static_cast<long long>(gm) * n + gn] = acc[i][j];
    }
  }
}

// out[i] = sum over splits of part[s][i], in split order.
__global__ void blmac_splitk_reduce_kernel(const float* __restrict__ part,
                                           float* __restrict__ out,
                                           long long mn, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < mn; i += stride) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += part[z * mn + i];
    out[i] = s;
  }
}

template <int BM>
void launch(dim3 grid, cudaStream_t stream, const float* x,
            const uint8_t* codes, const int8_t* gexp, float* dst, int m,
            int n, int k, int planes, int group, int per, bool vec) {
  blmac_pulse_matmul_kernel<BM><<<grid, kThreads, 0, stream>>>(
      x, codes, gexp, dst, m, n, k, planes, group, per, vec);
}

}  // namespace

// Launch y = x @ decode(codes, gexp) on `stream`.  `x` float32 (m, k)
// contiguous; `codes` uint8 (>= planes, k, n) contiguous, of which the first
// `planes` planes are read; `gexp` int8 (k / group, n) contiguous; `out`
// float32 (m, n) contiguous.  `bm` (16, 64 or 128) is the block's row count;
// each block walks `ktiles_per_split` steps of 32 rows of K, so the grid has
// splits = ceil(ceil(k / 32) / ktiles_per_split) blocks along K.  With more
// than one split, `workspace` is float32 (splits, m, n) and a second kernel
// sums it into `out`.  Returns cudaGetLastError() after the launches.
extern "C" int blmac_pulse_matmul_launch(const void* x, const void* codes,
                                         const void* gexp, void* workspace,
                                         void* out, int m, int n, int k,
                                         int planes, int group, int bm,
                                         int ktiles_per_split, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || planes < 1 || planes > 16 || group <= 0 ||
      k % group != 0 || ktiles_per_split <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k_tiles = (k + kBK - 1) / kBK;
  const int splits = (k_tiles + ktiles_per_split - 1) / ktiles_per_split;
  const bool vec = n % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gexp) % 16 == 0;
  auto* s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits > 1 ? workspace : out);
  const auto* xf = static_cast<const float*>(x);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* g = static_cast<const int8_t*>(gexp);
  const dim3 grid((n + kBN - 1) / kBN, (m + bm - 1) / bm, splits);
  switch (bm) {
    case 16:
      launch<16>(grid, s, xf, c, g, dst, m, n, k, planes, group,
                 ktiles_per_split, vec);
      break;
    case 64:
      launch<64>(grid, s, xf, c, g, dst, m, n, k, planes, group,
                 ktiles_per_split, vec);
      break;
    case 128:
      launch<128>(grid, s, xf, c, g, dst, m, n, k, planes, group,
                  ktiles_per_split, vec);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long mn = static_cast<long long>(m) * n;
  const long long blocks = (mn + kThreads - 1) / kThreads;
  blmac_splitk_reduce_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                               kThreads, 0, s>>>(dst, static_cast<float*>(out),
                                                 mn, splits);
  return static_cast<int>(cudaGetLastError());
}
