// blmac_specialized_kernel: pulse-specialized BLMAC filters for Hopper.
//
// Replaces the TPU kernel `_fir_kernel_specialized`
// (src/repro/kernels/blmac_fir.py:112, launched there by
// `specialized_program`).  It computes the same function: a type-I filter
// given as its CSD pulse list (layer L, tap j, sign s), y[t] = sum over the
// pulses of s * 2^L * u_j[t], where u_j[t] = x[t+j] + x[t+taps-1-j] is the
// folded sample pair (the centre tap j = taps/2 alone).  Adds and shifts
// only, in int32 modulo 2^32: every operation is taken in uint32_t and
// reinterpreted at the store, and since the ring is commutative any order
// of the adds gives the same bits as the reference's Horner walk.
//
// What bounds it on the H100.  Per output, one add per pulse and one fold
// per tap that carries pulses (263 + 63 at the 127-tap sweep filter) against
// 8 bytes of device memory: integer instructions, far above the memory
// roofline.
// A walk of the pulse list one pulse at a time spends about six
// instructions and two shared loads a pulse an output (the pair re-read and
// re-folded, a shift, a sign select, a centre branch, a table load).  A
// layer-major walk
// over folded rows kept in shared memory would still read 4 bytes of shared
// memory a pulse an output, plus 12 bytes a fold to build the rows: 1.8 kB
// an output, 14 clocks an output an SM at 128 bytes a clock.
//
// The design, tap-major:
//   * one launch covers every (column block, channel, filter): blockIdx.x
//     the (tile, column block), blockIdx.y the channel, blockIdx.z the
//     filter, whose table is found through an offset array;
//   * the block copies its filter's table into shared memory, where every
//     thread reads the same word (a broadcast), and stages its window of
//     samples (columns + taps - 1 int32) once with `cp.async`, straight from
//     the strided frame view (one pad word every 32, so that the threads'
//     strided reads below fall in different banks);
//   * each thread keeps kOuts consecutive outputs in registers and walks
//     the taps j = 0, 1, ... in order with two register windows of kOuts
//     samples, x[t+j ..] forward and x[t+taps-1-j ..] backward: from one
//     tap to the next each window slides by one sample, so a thread reads
//     two words of shared memory a tap for its kOuts outputs.  The windows
//     are rings indexed by the sample's offset modulo kOuts, and the tap
//     loop is unrolled kOuts times, so the ring slots are registers named
//     at compile time;
//   * at a tap that carries pulses it folds the pair once per output (one
//     add; the centre tap, whose sample stands alone, comes after the walk)
//     and adds each pulse: acc += u * (±2^L), one IMAD per pulse per
//     output — the shift done as a multiply by the pulse's signed power of
//     two, never by the collapsed coefficient.  No per-pulse shift, select,
//     branch or global load is left in the loop;
//   * the outputs go back through shared memory, so the stores to device
//     memory are coalesced.
// What is left bounds it: the SM's integer pipe, to which the 263 IMADs, the
// 63 fold adds and the address and loop work of an output all go (the
// IMADs do not overlap with IADD3 or SHF there, so two pulses as two SHF
// and one IADD3 were slower, not faster).  chip_smoke.py measures about 32
// us for 2^20 outputs of the sweep filter on an H100 SXM, about 8 clocks an
// output an SM; the bound it prints counts the adds alone, two to an IADD3.
//
// Table of one filter (int32, built by `pulse_table` in blmac_fir.py):
//   [n_steps, (n_j, m_1 .. m_n_j) for j = 0 .. n_steps - 1,
//    n_c, m_1 .. m_n_c]
// the taps below the centre walked up to the last that carries pulses, then
// the centre tap (its sample alone, outside the walk: no fold and no branch
// in the walk), m_i = ±2^L modulo 2^32; filters are concatenated and
// offsets[f] .. offsets[f + 1] delimit filter f.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kOuts = 16;       // outputs a thread keeps in registers
constexpr int kMaxThreads = 256;

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// acc[r] += u[r] * m for each of a tap's n multipliers m = ±2^L: one IMAD a
// pulse an output.
__device__ __forceinline__ void add_pulses(uint32_t (&acc)[kOuts],
                                           const uint32_t (&u)[kOuts],
                                           const int32_t* m, int n) {
#pragma unroll 2
  for (int i = 0; i < n; ++i) {
    const uint32_t mi = static_cast<uint32_t>(m[i]);
#pragma unroll
    for (int r = 0; r < kOuts; ++r) acc[r] += u[r] * mi;
  }
}

// Shared-memory word of sample i: one pad word every 32 samples.
__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(kMaxThreads)
blmac_specialized_kernel(const int32_t* __restrict__ frames, long long stride_c,
                         long long stride_tile,
                         const int32_t* __restrict__ table,
                         const int32_t* __restrict__ offsets, int tab_pad,
                         int32_t* __restrict__ out, int n_chan, int n_tiles,
                         int tile, int taps, int col_blocks) {
  extern __shared__ int32_t smem[];
  int32_t* tab = smem;
  int32_t* xs = smem + tab_pad;
  const int cols = blockDim.x * kOuts;
  const int f = blockIdx.z;
  const int c = blockIdx.y;
  const int s = blockIdx.x / col_blocks;
  const int col0 = (blockIdx.x % col_blocks) * cols;

  const int t0 = offsets[f];
  const int tab_len = offsets[f + 1] - t0;
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tab[i] = table[t0 + i];
  const int32_t* frame = frames + c * stride_c + s * stride_tile + col0;
  const int n_x = cols + taps - 1;
  const int avail = tile + taps - 1 - col0;  // samples of the frame left
  for (int i = threadIdx.x; i < n_x; i += blockDim.x) {
    if (i < avail) {
      cp_async4(&xs[skew(i)], &frame[i]);
    } else {
      xs[skew(i)] = 0;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // this thread's outputs: columns tb .. tb + kOuts - 1 of the block.  Ring
  // slot of the sample at offset a from tb: a % kOuts (forward window) and
  // (a - (taps - 1)) % kOuts (backward window).
  const int tb = threadIdx.x * kOuts;
  uint32_t fw[kOuts], bw[kOuts], acc[kOuts];
#pragma unroll
  for (int r = 0; r < kOuts; ++r) {
    fw[r] = static_cast<uint32_t>(xs[skew(tb + r)]);
    bw[r] = static_cast<uint32_t>(xs[skew(tb + taps - 1 + r)]);
    acc[r] = 0u;
  }
  const int n_steps = tab[0];
  int p = 1;
#pragma unroll 1
  for (int jb = 0; jb < n_steps; jb += kOuts) {
#pragma unroll
    for (int q = 0; q < kOuts; ++q) {
      const int j = jb + q;
      if (j >= n_steps) break;
      const int n = tab[p++];
      if (n > 0) {
        uint32_t u[kOuts];
#pragma unroll
        for (int r = 0; r < kOuts; ++r) {
          u[r] = fw[(q + r) % kOuts] + bw[(r - q + kOuts) % kOuts];
        }
        add_pulses(acc, u, tab + p, n);
        p += n;
      }
      if (j + 1 < n_steps) {  // slide both windows to tap j + 1
        fw[q] = static_cast<uint32_t>(xs[skew(tb + j + kOuts)]);
        bw[kOuts - 1 - q] = static_cast<uint32_t>(xs[skew(tb + taps - 2 - j)]);
      }
    }
  }
  const int n_centre = tab[p++];  // the centre tap, alone: no fold
  if (n_centre > 0) {
    uint32_t u[kOuts];
#pragma unroll
    for (int r = 0; r < kOuts; ++r) {
      u[r] = static_cast<uint32_t>(xs[skew(tb + taps / 2 + r)]);
    }
    add_pulses(acc, u, tab + p, n_centre);
  }

  __syncthreads();  // every window read: the samples' space takes the outputs
#pragma unroll
  for (int r = 0; r < kOuts; ++r) xs[skew(tb + r)] = static_cast<int32_t>(acc[r]);
  __syncthreads();
  int32_t* o = out + ((static_cast<long long>(f) * n_chan + c) * n_tiles + s) *
                         static_cast<long long>(tile) + col0;
  const int n_out = min(cols, tile - col0);
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) o[i] = xs[skew(i)];
}

// Dynamic shared memory of one block: its filter's table (padded to
// `tab_pad` words) and the samples its outputs read, one pad word every 32.
size_t smem_bytes(int tab_pad, int threads, int taps) {
  const int n_x = threads * kOuts + taps - 1;
  return sizeof(int32_t) * (static_cast<size_t>(tab_pad) + n_x + n_x / 32 + 1);
}

}  // namespace

extern "C" int blmac_specialized_smem_bytes(int tab_pad, int threads,
                                            int taps) {
  return static_cast<int>(smem_bytes(tab_pad, threads, taps));
}

// Launch `n_filters` filters over `n_chan` channels of `n_tiles` frames on
// `stream`, in one launch.  `frames` is int32 (n_chan, n_tiles,
// >= tile + taps - 1) with strides (stride_c, stride_tile, 1); `table` and
// `offsets` (n_filters + 1) int32 on the device, no filter's table longer
// than `tab_pad` words; `out` int32 (n_filters, n_chan, n_tiles, tile)
// contiguous; `threads` a multiple of 32, each thread computing kOuts
// columns of a tile; every pointer on CUDA device `device`, which is made
// current for the launch.  Returns cudaGetLastError() after the launch.
extern "C" int blmac_specialized_launch(const void* frames, long long stride_c,
                                        long long stride_tile,
                                        const void* table, const void* offsets,
                                        int tab_pad, void* out, int n_filters,
                                        int n_chan, int n_tiles, int tile,
                                        int taps, int threads, void* stream,
                                        int device) {
  if (n_filters <= 0 || n_chan <= 0 || n_tiles <= 0 || tile <= 0 ||
      taps <= 0 || tab_pad < 0 || threads <= 0 || threads > kMaxThreads ||
      threads % 32 != 0 || n_chan > 65535 || n_filters > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cols = threads * kOuts;
  const long long col_blocks = (tile + cols - 1) / cols;
  const long long blocks = col_blocks * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = smem_bytes(tab_pad, threads, taps);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(blmac_specialized_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  }
  if (e == cudaSuccess) {
    const dim3 grid(static_cast<unsigned>(blocks), n_chan, n_filters);
    blmac_specialized_kernel<<<grid, threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(frames), stride_c, stride_tile,
        static_cast<const int32_t*>(table),
        static_cast<const int32_t*>(offsets), tab_pad,
        static_cast<int32_t*>(out), n_chan, n_tiles, tile, taps,
        static_cast<int>(col_blocks));
    e = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(e);
}
