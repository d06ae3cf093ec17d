// blmac_bank_kernel: the scheduled BLMAC filter-bank kernel for Hopper.
//
// Replaces the TPU kernel `_fir_kernel_bank` (src/repro/kernels/blmac_fir.py),
// launched there by `_bank_call`.  It computes the same function: for every
// bank row b of one tile group, channel c and output sample t of one signal
// tile,
//
//   u_j[t] = x[t+j] + x[t+taps-1-j]   (j < taps/2; the centre row j = taps/2
//                                       is x[t+j] alone)
//   acc    = 0
//   for each superlayer, MSB first:  acc <<= shift_in;  acc += sum_j d_j * u_j
//                                     with d = sum_parts trit(sel) << rel
//   acc  <<= tail_shift
//
// in int32 modulo 2^32.  Signed overflow and left shifts of negative values
// are undefined in C++, so every sum, product and shift is taken in uint32_t
// and reinterpreted as int32 at the store.  Trits are read from the packed
// words as (w >> 2k) & 3: 0b01 = +1, 0b11 = -1.
//
// What bounds it on the H100: integer operations.  Each output of each row
// costs one multiply-add per folded tap per superlayer (the digit matrix is
// dense after merging), against 4 bytes written, so the kernel sits far above
// the memory roofline and the INT32 pipes are the limit.  Design:
//   * one block per (signal tile slice of kCols outputs, channel, kRows bank
//     rows); the block reads its frame straight from `frames` through the
//     strides it is given (frames are an overlapping strided view, never
//     materialized);
//   * the kCols + taps - 1 samples the block needs are staged in shared memory
//     once and the symmetric fold is done on the fly, shared by the
//     kRowsPerThread rows each thread owns;
//   * each superlayer's digit matrix for the block's rows is decoded into
//     shared memory once (j-major, so a thread's rows load as two 16-byte
//     broadcasts) and reused by every output of the block;
//   * the schedule is a small runtime table passed by value, so one build
//     serves every schedule; superlayers empty across the group are absent
//     from the table (layer skipping), and all-zero groups are never
//     launched.
// No tensor cores: Hopper has no int32 MMA, and a float route is exact only
// under a digit bound (a later, faster kernel's work).

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 64;                       // threads along t
constexpr int kRowGroups = kThreads / kColThreads;    // 4
constexpr int kRowsPerThread = 8;
constexpr int kRows = kRowGroups * kRowsPerThread;    // 32 bank rows / block
constexpr int kColsPerThread = 4;
constexpr int kCols = kColThreads * kColsPerThread;   // 256 outputs / block
constexpr int kMaxTable = 256;

// [n_super, tail_shift, (shift_in, n_parts, (sel_idx, rel) * n_parts) ...]
struct Table {
  int v[kMaxTable];
};

__global__ void __launch_bounds__(kThreads)
blmac_bank_kernel(const int32_t* __restrict__ frames, long long stride_c,
                  long long stride_tile, const int32_t* __restrict__ packed,
                  int32_t* __restrict__ out, int rows, int n_chan, int n_tiles,
                  int tile, int taps, int n_sel, int n_words, int col_blocks,
                  const Table table) {
  extern __shared__ __align__(16) int32_t smem[];
  const int half = taps / 2;
  const int m = half + 1;
  const int n_x = kCols + taps - 1;
  int32_t* xs = smem;
  uint32_t* ds = reinterpret_cast<uint32_t*>(smem + ((n_x + 3) & ~3));

  const int s = blockIdx.x / col_blocks;
  const int col0 = (blockIdx.x % col_blocks) * kCols;
  const int c = blockIdx.y;
  const int row0 = blockIdx.z * kRows;

  // stage the samples this block reads; outputs past the tile read zeros
  const int32_t* frame = frames + c * stride_c + s * stride_tile + col0;
  const int avail = tile + taps - 1 - col0;
  for (int i = threadIdx.x; i < n_x; i += kThreads) {
    xs[i] = i < avail ? frame[i] : 0;
  }

  const int tc = threadIdx.x % kColThreads;
  const int g = threadIdx.x / kColThreads;
  uint32_t acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) acc[r][k] = 0u;
  }

  const int n_super = table.v[0];
  const int tail_shift = table.v[1];
  int pos = 2;
  for (int sl = 0; sl < n_super; ++sl) {
    const int shift_in = table.v[pos];
    const int n_parts = table.v[pos + 1];
    const int parts = pos + 2;
    pos = parts + 2 * n_parts;

    __syncthreads();  // xs staged; the previous superlayer is done with ds
    for (int i = threadIdx.x; i < kRows * m; i += kThreads) {
      const int r = i % kRows;
      const int j = i / kRows;
      const int row = row0 + r;
      uint32_t d = 0u;
      if (row < rows) {
        const int32_t* w_row = packed + static_cast<long long>(row) * n_sel * n_words;
        for (int p = 0; p < n_parts; ++p) {
          const int sel = table.v[parts + 2 * p];
          const int rel = table.v[parts + 2 * p + 1];
          const uint32_t w = static_cast<uint32_t>(w_row[sel * n_words + (j >> 4)]);
          const uint32_t code = (w >> (2 * (j & 15))) & 3u;
          const uint32_t trit = code == 1u ? 1u : (code == 3u ? 0xFFFFFFFFu : 0u);
          d += trit << rel;
        }
      }
      ds[j * kRows + r] = d;
    }
    __syncthreads();

    if (shift_in) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
        for (int k = 0; k < kColsPerThread; ++k) acc[r][k] <<= shift_in;
      }
    }
    for (int j = 0; j <= half; ++j) {
      uint32_t u[kColsPerThread];
#pragma unroll
      for (int k = 0; k < kColsPerThread; ++k) {
        const int t = tc + k * kColThreads;
        u[k] = static_cast<uint32_t>(xs[t + j]);
        if (j < half) u[k] += static_cast<uint32_t>(xs[t + taps - 1 - j]);
      }
      const uint4 d0 = *reinterpret_cast<const uint4*>(&ds[j * kRows + g * kRowsPerThread]);
      const uint4 d1 = *reinterpret_cast<const uint4*>(&ds[j * kRows + g * kRowsPerThread + 4]);
      const uint32_t dv[kRowsPerThread] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
        for (int k = 0; k < kColsPerThread; ++k) acc[r][k] += dv[r] * u[k];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + g * kRowsPerThread + r;
    if (row >= rows) continue;
    int32_t* o = out + ((static_cast<long long>(row) * n_chan + c) * n_tiles + s) * tile;
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) {
      const int t = col0 + tc + k * kColThreads;
      if (t < tile) o[t] = static_cast<int32_t>(acc[r][k] << tail_shift);
    }
  }
}

// Dynamic shared memory of one block: the staged samples (rounded up to
// 16 bytes) and one superlayer's digit matrix for kRows rows.
size_t smem_bytes(int taps) {
  const int n_x = kCols + taps - 1;
  return sizeof(int32_t) *
         (((n_x + 3) & ~3) + static_cast<size_t>(kRows) * (taps / 2 + 1));
}

}  // namespace

extern "C" int blmac_bank_smem_bytes(int taps) {
  return static_cast<int>(smem_bytes(taps));
}

// Launch one tile group on `stream`.  `frames` is int32 (C, n_tiles, >= tile +
// taps - 1) with unit stride along the frame; `packed` int32 (rows, n_sel,
// n_words) contiguous; `out` int32 (rows, C, n_tiles, tile) contiguous.
// `table` is a host array of `table_len` ints, copied into the launch
// parameters.  Returns cudaGetLastError() after the launch.
extern "C" int blmac_bank_launch(const void* frames, long long stride_c,
                                 long long stride_tile, const void* packed,
                                 void* out, int rows, int n_chan, int n_tiles,
                                 int tile, int taps, int n_sel, int n_words,
                                 const int* table, int table_len, void* stream) {
  if (table_len < 2 || table_len > kMaxTable || rows <= 0 || n_chan <= 0 ||
      n_tiles <= 0 || tile <= 0 || taps <= 0 ||
      n_words * 16 < taps / 2 + 1 || (rows + kRows - 1) / kRows > 65535 ||
      n_chan > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t;
  std::memset(&t, 0, sizeof(t));
  std::memcpy(t.v, table, sizeof(int) * table_len);
  const size_t smem = smem_bytes(taps);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blmac_bank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int col_blocks = (tile + kCols - 1) / kCols;
  const dim3 grid(n_tiles * col_blocks, n_chan, (rows + kRows - 1) / kRows);
  blmac_bank_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(frames), stride_c, stride_tile,
      static_cast<const int32_t*>(packed), static_cast<int32_t*>(out), rows,
      n_chan, n_tiles, tile, taps, n_sel, n_words, col_blocks, t);
  return static_cast<int>(cudaGetLastError());
}
