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
//     memory are coalesced;
//   * kOuts is 16, or 4 where a launch at 16 would give the card fewer than
//     four warps an SM (a few filters over a short push: one filter of 2 x
//     2,048 outputs is 8 warps).  There a thread's walk over the taps and
//     pulses, not the card's integer pipe, sets the time, and four outputs
//     a thread make it a quarter as long; the wrapper chooses
//     (`specialized_outs` in blmac_fir.py).  The filter's table is copied
//     with `cp.async` beside the samples, so its words arrive together;
//   * on such a grid the walk is also split into n_segs segments of taps
//     (`pulse_segments` in blmac_fir.py: balanced by folds and pulses, each
//     starting at a multiple of kOuts, so the rings start in the same
//     slots), one group of threads each over the same outputs, and the
//     partial sums are added in shared memory (integer atomics, modulo
//     2^32, in any order).  Each thread's chain of dependent table reads is
//     then a segment long, not the filter's length.
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
// offsets[f] .. offsets[f + 1] delimit filter f.  Segments of filter f:
// segs[(f * n_segs + s) * 2 + {0, 1}] = the first tap of segment s and the
// index, in the filter's table, of that tap's n_j (of n_c past the walk).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// threads a block at most: 256 at 16 outputs a thread, 512 at 4 (the
// segments of a small grid's walk share a block)
constexpr int max_threads(int outs) { return outs == 16 ? 256 : 512; }

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// acc[r] += u[r] * m for each of a tap's n multipliers m = ±2^L: one IMAD a
// pulse an output.
template <int kOuts>
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

// kOuts: the outputs a thread keeps in registers (16; 4 for small grids,
// where 16 leaves most SMs idle and each thread's walk sets the time)
template <int kOuts>
__global__ void __launch_bounds__(kOuts == 16 ? 256 : 512)
blmac_specialized_kernel(const int32_t* __restrict__ frames, long long stride_c,
                         long long stride_tile,
                         const int32_t* __restrict__ table,
                         const int32_t* __restrict__ offsets,
                         const int32_t* __restrict__ segs, int tab_pad,
                         int32_t* __restrict__ out, int n_chan, int n_tiles,
                         int tile, int taps, int col_blocks) {
  extern __shared__ int32_t smem[];
  int32_t* tab = smem;
  int32_t* xs = smem + tab_pad;
  // threadIdx.x: the thread's outputs; threadIdx.y: its segment of taps
  // (at 16 outputs a thread one segment, fixed here so that the compiler
  // folds the segments away)
  constexpr bool kSegmented = kOuts != 16;
  const int seg = kSegmented ? threadIdx.y : 0;
  const int n_segs = kSegmented ? blockDim.y : 1;
  const int tid = kSegmented ? threadIdx.y * blockDim.x + threadIdx.x
                             : threadIdx.x;
  const int n_threads = kSegmented ? blockDim.x * blockDim.y : blockDim.x;
  const int cols = blockDim.x * kOuts;
  const int f = blockIdx.z;
  const int c = blockIdx.y;
  const int s = blockIdx.x / col_blocks;
  const int col0 = (blockIdx.x % col_blocks) * cols;

  // the segment's first tap, its table index and the next segment's first
  // tap (-1: the walk's end), read while the table and samples arrive
  int j0 = 0, p = 1, j1_next = -1;
  if (n_segs > 1) {
    const int32_t* sg = segs + (static_cast<long long>(f) * n_segs + seg) * 2;
    j0 = sg[0];
    p = sg[1];
    if (seg + 1 < n_segs) j1_next = sg[2];
  }
  const int t0 = offsets[f];
  const int tab_len = offsets[f + 1] - t0;
  for (int i = tid; i < tab_len; i += n_threads) {
    cp_async4(&tab[i], &table[t0 + i]);  // in flight with the samples'
  }
  const int32_t* frame = frames + c * stride_c + s * stride_tile + col0;
  const int n_x = cols + taps - 1;
  const int avail = tile + taps - 1 - col0;  // samples of the frame left
  for (int i = tid; i < n_x; i += n_threads) {
    if (i < avail) {
      cp_async4(&xs[skew(i)], &frame[i]);
    } else {
      xs[skew(i)] = 0;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // this thread's outputs: columns tb .. tb + kOuts - 1 of the block, its
  // taps j0 .. j1 - 1 (its segment's).  Ring slot of the sample at offset a
  // from tb + j0: a % kOuts (forward window) and (a - (taps - 1)) % kOuts
  // (backward window); j0 is a multiple of kOuts.
  const int tb = threadIdx.x * kOuts;
  const int n_steps = tab[0];
  const int j1 = j1_next >= 0 ? j1_next : n_steps;
  uint32_t fw[kOuts], bw[kOuts], acc[kOuts];
#pragma unroll
  for (int r = 0; r < kOuts; ++r) {
    fw[r] = static_cast<uint32_t>(xs[skew(tb + j0 + r)]);
    bw[r] = static_cast<uint32_t>(xs[skew(tb + taps - 1 - j0 + r)]);
    acc[r] = 0u;
  }
#pragma unroll 1
  for (int jb = j0; jb < j1; jb += kOuts) {
#pragma unroll
    for (int q = 0; q < kOuts; ++q) {
      const int j = jb + q;
      if (j >= j1) break;
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
      if (j + 1 < j1) {  // slide both windows to tap j + 1
        fw[q] = static_cast<uint32_t>(xs[skew(tb + j + kOuts)]);
        bw[kOuts - 1 - q] = static_cast<uint32_t>(xs[skew(tb + taps - 2 - j)]);
      }
    }
  }
  if (seg == n_segs - 1) {  // the centre tap, alone: no fold
    const int n_centre = tab[p++];
    if (n_centre > 0) {
      uint32_t u[kOuts];
#pragma unroll
      for (int r = 0; r < kOuts; ++r) {
        u[r] = static_cast<uint32_t>(xs[skew(tb + taps / 2 + r)]);
      }
      add_pulses(acc, u, tab + p, n_centre);
    }
  }

  __syncthreads();  // every window read: the samples' space takes the outputs
  if (seg == 0) {
#pragma unroll
    for (int r = 0; r < kOuts; ++r) {
      xs[skew(tb + r)] = static_cast<int32_t>(acc[r]);
    }
  }
  if (n_segs > 1) {  // the other segments' partial sums, modulo 2^32
    __syncthreads();
    if (seg > 0) {
#pragma unroll
      for (int r = 0; r < kOuts; ++r) {
        atomicAdd(reinterpret_cast<unsigned*>(&xs[skew(tb + r)]), acc[r]);
      }
    }
  }
  __syncthreads();
  int32_t* o = out + ((static_cast<long long>(f) * n_chan + c) * n_tiles + s) *
                         static_cast<long long>(tile) + col0;
  const int n_out = min(cols, tile - col0);
  for (int i = tid; i < n_out; i += n_threads) o[i] = xs[skew(i)];
}

// Dynamic shared memory of one block: its filter's table (padded to
// `tab_pad` words) and the samples its outputs read, one pad word every 32.
size_t smem_bytes(int tab_pad, int threads, int taps, int outs) {
  const int n_x = threads * outs + taps - 1;
  return sizeof(int32_t) * (static_cast<size_t>(tab_pad) + n_x + n_x / 32 + 1);
}

template <int kOuts>
cudaError_t launch(const dim3& grid, const dim3& block, size_t smem,
                   cudaStream_t stream, const int32_t* frames,
                   long long stride_c, long long stride_tile,
                   const int32_t* table, const int32_t* offsets,
                   const int32_t* segs, int tab_pad, int32_t* out, int n_chan,
                   int n_tiles, int tile, int taps, int col_blocks) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(blmac_specialized_kernel<kOuts>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  }
  if (e != cudaSuccess) return e;
  blmac_specialized_kernel<kOuts><<<grid, block, smem, stream>>>(
      frames, stride_c, stride_tile, table, offsets, segs, tab_pad, out,
      n_chan, n_tiles, tile, taps, col_blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" int blmac_specialized_smem_bytes(int tab_pad, int threads,
                                            int taps, int outs) {
  return static_cast<int>(smem_bytes(tab_pad, threads, taps, outs));
}

// Launch `n_filters` filters over `n_chan` channels of `n_tiles` frames on
// `stream`, in one launch.  `frames` is int32 (n_chan, n_tiles,
// >= tile + taps - 1) with strides (stride_c, stride_tile, 1); `table` and
// `offsets` (n_filters + 1) int32 on the device, no filter's table longer
// than `tab_pad` words; `segs` int32 (n_filters, n_segs, 2), each filter's
// segments of taps (see the table's layout above; read only where n_segs >
// 1, which needs 4 outputs a thread); `out` int32 (n_filters, n_chan,
// n_tiles, tile) contiguous; `threads` a multiple of 32, each thread
// computing `outs` (16 or 4) columns of a tile for one segment, so a block
// is threads x n_segs; every pointer on CUDA device `device`, which is
// made current for the launch.  Returns cudaGetLastError() after the
// launch.
extern "C" int blmac_specialized_launch(const void* frames, long long stride_c,
                                        long long stride_tile,
                                        const void* table, const void* offsets,
                                        const void* segs, int n_segs,
                                        int tab_pad, void* out, int n_filters,
                                        int n_chan, int n_tiles, int tile,
                                        int taps, int threads, int outs,
                                        void* stream, int device) {
  if (n_filters <= 0 || n_chan <= 0 || n_tiles <= 0 || tile <= 0 ||
      taps <= 0 || tab_pad < 0 || threads <= 0 || threads % 32 != 0 ||
      n_chan > 65535 || n_filters > 65535 || (outs != 16 && outs != 4) ||
      n_segs < 1 || (outs == 16 && n_segs != 1) ||
      threads * n_segs > max_threads(outs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cols = threads * outs;
  const long long col_blocks = (tile + cols - 1) / cols;
  const long long blocks = col_blocks * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = smem_bytes(tab_pad, threads, taps, outs);
  const dim3 grid(static_cast<unsigned>(blocks), n_chan, n_filters);
  e = (outs == 16 ? launch<16> : launch<4>)(
      grid, dim3(threads, n_segs), smem, static_cast<cudaStream_t>(stream),
      static_cast<const int32_t*>(frames), stride_c, stride_tile,
      static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(segs), tab_pad,
      static_cast<int32_t*>(out), n_chan, n_tiles, tile, taps,
      static_cast<int>(col_blocks));
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(e);
}
