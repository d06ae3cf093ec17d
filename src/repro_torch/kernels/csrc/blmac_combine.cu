// blmac_combine_kernel: the combine fold of a CSE-optimized bank, on Hopper.
//
// Replaces `_combine_shared` (src/repro/kernels/blmac_fir.py:633), which
// the reference runs as an XLA int32 GEMM (no Pallas kernel), and the host
// fold `_host_combine_i32` (src/repro/compiler/lowering.py:51) its engine
// takes in specialized mode.  It computes, for every real row r < n_real,
// channel c and output sample t, in int32 modulo 2^32 (uint32_t here,
// reinterpreted at the store):
//
//   y[r, c, t] += sum over s of combine[r, s] * y[n_real + s, c, t]
//
// in place, on the output buffer of the bank kernel (K1) or the
// specialized kernel (K2): rows past n_real are the shared partial sums,
// read and never written.  Torch has no integer matmul on CUDA, and the
// combine matrix is sparse (the serve bank's 256 x 434 has 11,563
// nonzeros, at most 60 a row), so the kernel reads it as a per-row table
// (CSR: row_ptr, shared-row index, int32 coefficient), built on the host
// once per program and device (`CombineTable` in blmac_fir.py).
//
// What bounds it on the H100.  The bytes it must move are the real rows
// read and written and the shared rows read, once each; the operations
// one multiply-add a nonzero an output (an IMAD).  At the serve shape
// (256 real rows, 434 shared, 4,158 samples) that is 15.7 MB against 48 M
// IMADs, about 4.7 us of memory against 2.9 us of the int32 rate.  What it
// does about the shared rows: every nonzero reads one shared-row sample,
// so each shared sample is read about nnz / n_shared (27) times; those
// reads must come from the caches, not from device memory.
//
// The design, simple first: one thread an output sample, a block of 256
// samples (a span) times kRowsPerBlock real rows of one channel (few rows
// a block, so that enough blocks are resident to hide the latency of the
// shared-row reads, most of which come from L2).  The block walks its
// rows; for each it keeps the sum in a register and reads the row's table
// entries (the same word across the warp: a broadcast) and, for each, the
// shared row's sample (256 consecutive words a block, coalesced).
// blockIdx.x (the row chunk) varies fastest, so the blocks resident at one
// time cover the same one or two spans of every shared row: one span of
// the 1,424 shared rows of the sweep bank is 1.5 MB, well inside the 50 MB
// L2 (all of them, 93 MB, are not).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // output samples a block (one a thread)
constexpr int kRowsPerBlock = 4;   // real rows a block walks

__global__ void __launch_bounds__(kThreads) blmac_combine_kernel(
    uint32_t* __restrict__ y, long long stride_row, long long stride_chan,
    int n_real, int n_out, const int32_t* __restrict__ row_ptr,
    const int32_t* __restrict__ cols, const uint32_t* __restrict__ coeffs) {
  const int t = blockIdx.y * kThreads + threadIdx.x;
  if (t >= n_out) return;
  uint32_t* base = y + static_cast<long long>(blockIdx.z) * stride_chan + t;
  const uint32_t* shared = base + static_cast<long long>(n_real) * stride_row;
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(r0 + kRowsPerBlock, n_real);
  for (int r = r0; r < r1; ++r) {
    const int p0 = __ldg(row_ptr + r);
    const int p1 = __ldg(row_ptr + r + 1);
    if (p0 == p1) continue;
    uint32_t* row = base + static_cast<long long>(r) * stride_row;
    uint32_t acc = *row;
#pragma unroll 8
    for (int p = p0; p < p1; ++p) {
      // the shared rows are never written by this kernel: the read-only
      // path is safe for them
      acc += __ldg(coeffs + p) *
             __ldg(shared + static_cast<long long>(__ldg(cols + p)) *
                                stride_row);
    }
    *row = acc;
  }
}

}  // namespace

// Fold the shared rows of `y` into its first `n_real` rows, in place, on
// `stream` (the current device's), in one launch.  `y` is int32 (n_real +
// n_shared, n_chan, >= n_out) with strides (stride_row, stride_chan, 1);
// `row_ptr` (n_real + 1), `cols` and `coeffs` (row_ptr[n_real] entries)
// int32 on the device, `cols` indexing the shared rows (0 .. n_shared - 1)
// and `coeffs` the coefficients modulo 2^32.  Returns cudaGetLastError()
// after the launch.
extern "C" int blmac_combine_launch(void* y, long long stride_row,
                                    long long stride_chan, int n_real,
                                    int n_chan, int n_out,
                                    const void* row_ptr, const void* cols,
                                    const void* coeffs, void* stream) {
  if (n_real <= 0 || n_chan <= 0 || n_out <= 0 || stride_row < n_out ||
      n_chan > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long spans = (n_out + kThreads - 1) / kThreads;
  const long long chunks = (n_real + kRowsPerBlock - 1) / kRowsPerBlock;
  if (spans > 65535 || chunks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(spans),
                  n_chan);
  blmac_combine_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(y), stride_row, stride_chan, n_real, n_out,
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(cols),
      static_cast<const uint32_t*>(coeffs));
  return static_cast<int>(cudaGetLastError());
}
