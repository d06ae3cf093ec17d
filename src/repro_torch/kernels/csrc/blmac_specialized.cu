// blmac_specialized_kernel: one pulse-specialized BLMAC filter for Hopper.
//
// Replaces the TPU kernel `_fir_kernel_specialized`
// (src/repro/kernels/blmac_fir.py), launched there by `specialized_program`.
// It computes the same function: one filter over one output tile, walking the
// filter's MSB-first CSD pulse list (layer, j, sign): the accumulator shifts
// left at each layer boundary and adds or subtracts the folded sample pair
// x[t+j] + x[t+taps-1-j] (the centre tap j = taps/2 alone), then shifts down
// to layer 0.  Adds and shifts only, in int32 modulo 2^32: every operation is
// taken in uint32_t (signed overflow and shifts of negative values are
// undefined in C++) and reinterpreted at the store.
//
// The TPU kernel bakes the pulse list into the program at trace time.  Here
// the list is a small device table, one int4 per pulse
// (shift_before, j, j_mirror or -1 for the centre, sign), built once per
// distinct filter and cached by the host-side LRU, so one build serves every
// filter; every thread reads the same entry, so the loads are broadcasts and
// the branches uniform.
//
// What bounds it on the H100: integer operations — two adds and two shared
// loads per pulse per output against 8 bytes of input and output, far above
// the memory roofline.  Design: one block per kCols outputs of one tile; the
// kCols + taps - 1 samples it reads are staged in shared memory once, read
// straight from the strided frame view; each thread keeps kColsPerThread
// accumulators in registers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 2;
constexpr int kCols = kThreads * kColsPerThread;  // 512 outputs / block

__global__ void __launch_bounds__(kThreads)
blmac_specialized_kernel(const int32_t* __restrict__ frames,
                         long long stride_tile, const int4* __restrict__ pulses,
                         int n_pulses, int final_shift, int32_t* __restrict__ out,
                         int tile, int taps, int col_blocks) {
  extern __shared__ int32_t xs[];
  const int n_x = kCols + taps - 1;
  const int s = blockIdx.x / col_blocks;
  const int col0 = (blockIdx.x % col_blocks) * kCols;
  const int32_t* frame = frames + s * stride_tile + col0;
  const int avail = tile + taps - 1 - col0;
  for (int i = threadIdx.x; i < n_x; i += kThreads) {
    xs[i] = i < avail ? frame[i] : 0;
  }
  __syncthreads();

  uint32_t acc[kColsPerThread];
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) acc[k] = 0u;
  for (int p = 0; p < n_pulses; ++p) {
    const int4 op = __ldg(&pulses[p]);
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) {
      const int t = threadIdx.x + k * kThreads;
      uint32_t u = static_cast<uint32_t>(xs[t + op.y]);
      if (op.z >= 0) u += static_cast<uint32_t>(xs[t + op.z]);
      const uint32_t a = acc[k] << op.x;
      acc[k] = op.w > 0 ? a + u : a - u;
    }
  }
  int32_t* o = out + static_cast<long long>(s) * tile;
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) {
    const int t = col0 + threadIdx.x + k * kThreads;
    if (t < tile) o[t] = static_cast<int32_t>(acc[k] << final_shift);
  }
}

// Dynamic shared memory of one block: the samples its outputs read.
size_t smem_bytes(int taps) { return sizeof(int32_t) * (kCols + taps - 1); }

}  // namespace

extern "C" int blmac_specialized_smem_bytes(int taps) {
  return static_cast<int>(smem_bytes(taps));
}

// Launch one filter over `n_tiles` frames on `stream`.  `frames` is int32
// (n_tiles, >= tile + taps - 1) with unit stride along the frame; `pulses`
// int32 (n_pulses, 4) contiguous on the device; `out` int32 (n_tiles, tile)
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int blmac_specialized_launch(const void* frames,
                                        long long stride_tile,
                                        const void* pulses, int n_pulses,
                                        int final_shift, void* out,
                                        int n_tiles, int tile, int taps,
                                        void* stream) {
  if (n_tiles <= 0 || tile <= 0 || taps <= 0 || n_pulses < 0 ||
      final_shift < 0 || final_shift > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(taps);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blmac_specialized_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int col_blocks = (tile + kCols - 1) / kCols;
  blmac_specialized_kernel<<<n_tiles * col_blocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(frames), stride_tile,
      static_cast<const int4*>(pulses), n_pulses, final_shift,
      static_cast<int32_t*>(out), tile, taps, col_blocks);
  return static_cast<int>(cudaGetLastError());
}
