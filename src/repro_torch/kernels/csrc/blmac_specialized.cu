// blmac_specialized_kernel: pulse-specialized BLMAC filters for Hopper.
//
// Two designs of K2 live here, chosen per launch by the shape alone
// (`specialized_route` in blmac_fir.py): this one, on the CUDA cores, for
// short pushes and filters of more than 255 taps, and
// blmac_specialized_kernel_wgmma (further down), on the int8 tensor cores,
// for a grid that fills the card.
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

// ---------------------------------------------------------------------------
// blmac_specialized_kernel_wgmma: K2 on the int8 tensor cores.
//
// Replaces the same TPU kernel, `_fir_kernel_specialized`
// (src/repro/kernels/blmac_fir.py:112), where a launch fills the card.  It
// computes the same function, exact in int32 modulo 2^32 for every int32
// input: y[t] = sum_k q[k] x[t+k] over the filter's unfolded taps k = 0 ..
// taps - 1 (q[j] = q[taps-1-j] = the pulses of folded tap j).
//
// What bounds the CUDA-core walk above: the SM's integer pipe.  Each output
// of the 127-tap sweep filter costs it 263 IMADs and 63 fold adds; at 64
// INT32 lanes a clock on 132 SMs that is 1.31 ms for 2^26 outputs, against
// 0.16 ms to read and write their 8 bytes at 3.35 TB/s.  Only the tensor
// cores can bring K2 down to its bytes.
//
// The arithmetic (the host builds the tables: `toeplitz_tables` in
// blmac_fir.py; `specialized_toeplitz_walk` there is this loop in numpy):
//   * the filter's coefficients, reduced modulo 2^32, are recoded in CSD and
//     their layers split MSB first into runs of span <= 7 (K1's
//     `digit_runs`): q = sum_r 2^lo_r d_r with |d_r[k]| <= 127, an s8;
//   * the samples are split into balanced s8 planes as K1 splits its folded
//     samples (x = sum_p s_p 2^(8p) modulo 2^32); an 8-bit sample is its own
//     plane 0 and planes 1..3 are zero;
//   * outputs are cut into windows of 64: Y[n, i] = y[64n + i].  For one
//     run and plane, Y = S B with S[n, m] = s_p[64n + m] (a Hankel matrix
//     of the plane) and B[m, i] = d_r[m - i] for 0 <= m - i < taps, else 0
//     (a Toeplitz matrix of the run), m < K = 64 + taps - 1 padded to a
//     multiple of 64: one wgmma m64n64k32 chain, the windows on M and the
//     64 phases on N;
//   * y = sum over (run, plane) of (S_p B_r) << (lo_r + 8p); a term whose
//     shift is 32 or more vanishes and is not in the table.  The terms of
//     the planes below the unit's highest live one, sorted by shift, high
//     first (one list a plane count), are walked as one s32 Horner chain:
//     acc <<= (previous shift - shift); acc += S_p B_r (no .satfinite: the
//     accumulator wraps modulo 2^32).  One product's partial sums stay
//     under 320 * 127 * 128 < 2^23.
//
// The design:
//   * one warpgroup a block, as many blocks as fit on the card (two an SM up
//     to 127 taps: shared memory sets the count), each walking a
//     contiguous range of jobs.  A job is one unit of 8,192 consecutive
//     outputs (128 windows, two chains of 64) of one filter and one stream:
//     a channel where the frames are a view of one signal (stride `tile`),
//     else one frame;
//   * the filter's B tiles are built once per program on the host (64
//     phase rows of K bytes a run, K-major, 128-byte swizzle, the runs side
//     by side along K) and brought into shared memory by one bulk copy at
//     the block's first job of each filter;
//   * a unit's 8,192 + taps - 1 samples arrive by one bulk copy (the TMA
//     engine, completing on an mbarrier), issued as soon as the previous
//     unit's samples are split, so it flies while that unit's products run
//     and its outputs leave; the block then splits them into s8 planes in
//     shared memory, a plane only where some sample needs it (8-bit samples
//     fill plane 0 alone);
//   * S never exists as a matrix: a window's row is 64 bytes further along
//     the plane than the one before, so `ldmatrix` reads each warp's A
//     fragments straight from the plane by row addresses (the plane's
//     16-byte chunks are swizzled so that the eight rows of a fragment fall
//     in different banks);
//   * two chains of windows (64 each) walk the terms, each chain's shift
//     issued behind the other's products.  The walk has no branch around
//     its products: a walk that skipped each dead plane's terms (`continue`)
//     made ptxas serialise every wgmma (its C7518 remark) and took 0.229
//     ms at 8-bit samples, 0.521 at full-range ones (0.211 and 0.470
//     here);
//   * the outputs leave as K1's do: each window's row is staged in shared
//     memory (the planes' space, rows padded by 8 words so that the
//     accumulators' stores fall in different banks) and sent by one bulk
//     copy, which frees the threads for the next unit.
// On an H100 at the sweep filter, 8-bit samples and 64 x 2^20 outputs it
// runs in about 0.213 ms against the bytes' 0.160 ms (0.478 ms at
// full-range samples: four planes, 11 terms).  Designs tried on the way,
// each with the serialised walk: thread stores from the stage 0.257 ms,
// straight from the accumulators 0.354; 16-byte cp.async in place of the
// bulk copies 0.273; this one 0.233.

namespace {

constexpr int kTzThreads = 128;       // one warpgroup
constexpr int kPhases = 64;           // wgmma N: the outputs of a window
constexpr int kWindows = 128;         // windows a unit: two chains of 64
constexpr int kUnit = kPhases * kWindows;  // outputs a unit
constexpr int kChunk = kPhases * 128;  // one 128-byte column block of B
constexpr int kTzPlanes = 4;           // s8 planes of an int32 sample
constexpr int kTzMaxRuns = 5;  // runs of span <= 7 layers over 32 layers
constexpr int kTzAcc = kPhases / 2;    // s32 accumulators a thread a chain

struct TzArgs {
  const int32_t* frames;
  long long stride_c, stride_tile;
  int zt;        // streams a channel: 1 (its frames are one signal) or n_tiles
  long long len;  // outputs a stream
  long long n_streams;  // streams a filter
  long long ups;        // units a stream
  int taps;
  int32_t* out;  // (filter, stream, len) contiguous
  const uint4* image;   // B tiles of every filter
  const int4* index;    // a filter's (offset, size) in 16 bytes, first term,
                        // and its lists' lengths: (n1, n2, n3, n4, 0, ...)
  const int4* terms;    // (run, plane, shift, 0), shift high first: a
                        // filter's terms of plane < P, for P = 1 .. 4
  long long n_jobs;
  int b_bytes;      // the B tiles' space in shared memory
  int raw_words;    // the staged samples' space, int32
  int plane_bytes;  // one plane's space
};

__device__ __forceinline__ uint32_t tz_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// keeps the compiler from moving a register across the asynchronous
// product that reads or writes it
__device__ __forceinline__ void tz_pin(uint32_t& v) {
  asm volatile("" : "+r"(v));
}

// Byte offset in a plane of its logical byte b: the 16-byte chunks of each
// 128-byte line are permuted by the line's index, so that the eight rows of
// an ldmatrix (64 bytes apart) read eight different banks.
__device__ __forceinline__ int plane_at(int b) {
  const int c = b >> 4;
  return ((c ^ ((c >> 3) & 7)) << 4) | (b & 15);
}

// d (+)= A B for one k32 step: A (64 x 32 s8) from registers in wgmma's
// fragment order, B (32 x 64 s8) the shared-memory tile at `desc`.
__device__ __forceinline__ void tz_wgmma(uint32_t* d, const uint32_t* a,
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void tz_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void tz_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void tz_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The descriptor of B at byte `koff` of the runs' K axis: K-major, 128-byte
// swizzle, 8-row groups 1024 bytes apart, column blocks of 128 bytes kChunk
// apart.
__device__ __forceinline__ uint64_t tz_desc(uint32_t bs, int koff) {
  const uint32_t addr = bs + (koff >> 7) * kChunk + (koff & 127);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// A job's filter, stream and unit.
struct Job {
  int f;
  long long z, k;
};
__device__ __forceinline__ Job tz_job(const TzArgs& a, long long j) {
  const long long per_f = a.n_streams * a.ups;
  Job o;
  o.f = static_cast<int>(j / per_f);
  const long long r = j - o.f * per_f;
  o.z = r / a.ups;
  o.k = r - o.z * a.ups;
  return o;
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
// wait until the barrier's phase of parity `ph` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t ph) {
  asm volatile(
      "{\n.reg .pred P;\nTZ_WAIT%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra TZ_WAIT%=;\n}\n" ::"r"(bar),
      "r"(ph)
      : "memory");
}
// One bulk copy of `bytes` (a multiple of 16, both ends on 16 bytes) into
// shared memory, completing on `bar` (one thread).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(tz_smem(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_store(int32_t* dst, const int32_t* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(tz_smem(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Stage a job's samples (its outputs' + taps - 1) in `raw`: one bulk copy
// (thread 0) from the 16-byte boundary at or below the first, to the one at
// or above the last, so it reads only granules that hold samples of the
// stream; returns the first sample's word in `raw`.
__device__ __forceinline__ int stage_samples(const TzArgs& a, int32_t* raw,
                                             const Job& jb, uint32_t bar) {
  const long long c = jb.z / a.zt, s = jb.z - c * a.zt;
  const int32_t* src = a.frames + c * a.stride_c + s * a.stride_tile +
                       jb.k * kUnit;
  const int nx = static_cast<int>(
                     min(static_cast<long long>(kUnit), a.len - jb.k * kUnit)) +
                 a.taps - 1;
  const int d = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15u) >> 2);
  if (threadIdx.x == 0) {
    bulk_load(raw, src - d, 16u * ((d + nx + 3) >> 2), bar);
  }
  return d;
}

// Four samples s0 .. s0 + 3 of the unit (zero past its nx).
__device__ __forceinline__ void load4(const int32_t* raw, int d, int s0,
                                      int nx, int32_t (&x)[4]) {
  if (d == 0 && s0 + 4 <= nx) {
    const int4 v = *reinterpret_cast<const int4*>(raw + s0);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = s0 + e < nx ? raw[d + s0 + e] : 0;
  }
}

// Split the staged samples into s8 planes; returns the planes that are not
// zero across the unit (block-uniform).  Plane 0 first, with a check that
// every sample fits s8; only if one does not, planes 1 .. 3.
__device__ __forceinline__ uint32_t split_planes(const TzArgs& a,
                                                 const int32_t* raw, int d,
                                                 int nx, uint8_t* planes) {
  const int n_words = a.plane_bytes >> 2;
  uint32_t nz0 = 0u;
  bool fits = true;
  for (int w = threadIdx.x; w < n_words; w += kTzThreads) {
    int32_t x[4];
    load4(raw, d, 4 * w, nx, x);
    uint32_t b = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      b |= (static_cast<uint32_t>(x[e]) & 0xFFu) << (8 * e);
      fits = fits && x[e] == static_cast<int32_t>(static_cast<int8_t>(x[e]));
    }
    nz0 |= b;
    *reinterpret_cast<uint32_t*>(planes + plane_at(4 * w)) = b;
  }
  uint32_t live = __syncthreads_or(nz0 != 0u) ? 1u : 0u;
  if (!__syncthreads_or(!fits)) return live;
  uint32_t nz[kTzPlanes] = {nz0, 0u, 0u, 0u};
  for (int w = threadIdx.x; w < n_words; w += kTzThreads) {
    int32_t x[4];
    load4(raw, d, 4 * w, nx, x);
    uint32_t b[kTzPlanes] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t u = static_cast<uint32_t>(x[e]);
#pragma unroll
      for (int p = 0; p < kTzPlanes; ++p) {
        const uint32_t sp = static_cast<uint32_t>(
            static_cast<int32_t>(static_cast<int8_t>(u & 0xFFu)));
        b[p] |= (u & 0xFFu) << (8 * e);
        u = static_cast<uint32_t>(static_cast<int32_t>(u - sp) >> 8);
      }
    }
#pragma unroll
    for (int p = 1; p < kTzPlanes; ++p) {
      nz[p] |= b[p];
      *reinterpret_cast<uint32_t*>(planes + p * a.plane_bytes +
                                   plane_at(4 * w)) = b[p];
    }
  }
  live = 0u;
#pragma unroll
  for (int p = 0; p < kTzPlanes; ++p) {
    if (__syncthreads_or(nz[p] != 0u)) live |= 1u << p;
  }
  return live;
}

// The A fragments of chain `ch` (windows 64 ch .. 64 ch + 63) for every
// k-step, from plane `plane`: lane l gives the row address of row l & 7 of
// matrix l >> 3 (rows +8 for matrices 1 and 3, bytes +16 for 2 and 3).
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&f)[KS][4],
                                       const uint8_t* plane, int ch) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;
  const int n = 64 * ch + 16 * (threadIdx.x >> 5) + (lane & 7) + 8 * (mi & 1);
  const uint32_t base = tz_smem(plane);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t addr = base + plane_at(64 * n + 32 * ks + 16 * (mi >> 1));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(f[ks][0]), "=r"(f[ks][1]), "=r"(f[ks][2]), "=r"(f[ks][3])
        : "r"(addr));
  }
}

template <int KS>
__device__ __forceinline__ void tz_issue(uint32_t (&acc)[kTzAcc],
                                         uint32_t (&f)[KS][4], uint32_t bs,
                                         int run) {
#pragma unroll
  for (int r = 0; r < kTzAcc; ++r) tz_pin(acc[r]);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) tz_pin(f[ks][e]);
  }
  tz_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    tz_wgmma(acc, f[ks], tz_desc(bs, run * 32 * KS + 32 * ks));
  }
  tz_commit();
}

__device__ __forceinline__ void tz_shift(uint32_t (&acc)[kTzAcc], int sh) {
#pragma unroll
  for (int r = 0; r < kTzAcc; ++r) tz_pin(acc[r]);
  if (sh > 0) {
#pragma unroll
    for (int r = 0; r < kTzAcc; ++r) acc[r] <<= sh;
  }
}

// A window's row of outputs in the stage: 64 words and 8 of padding, so
// that the accumulators' stores of 8 rows fall in different banks.
constexpr int kStageRow = kPhases + 8;

// Two blocks an SM up to 127 taps (shared memory sets the count).
template <int KS>
__global__ void __launch_bounds__(kTzThreads)
blmac_specialized_kernel_wgmma(const TzArgs a) {
  extern __shared__ uint8_t tz_raw[];
  __shared__ __align__(8) uint64_t tz_bars[2];  // the samples; the B tiles
  __shared__ int walk[2];  // a unit's first term and number of terms
  // the B tiles need 1024-byte alignment (128-byte swizzle)
  uint8_t* bsm = tz_raw + ((1024u - (tz_smem(tz_raw) & 1023u)) & 1023u);
  int32_t* raw = reinterpret_cast<int32_t*>(bsm + a.b_bytes);
  uint8_t* planes = reinterpret_cast<uint8_t*>(raw + a.raw_words);
  int32_t* stage = reinterpret_cast<int32_t*>(planes);  // after the products
  const uint32_t bs = tz_smem(bsm);
  const uint32_t bar_x = tz_smem(&tz_bars[0]), bar_b = tz_smem(&tz_bars[1]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;

  const long long j0 = a.n_jobs * blockIdx.x / gridDim.x;
  const long long j1 = a.n_jobs * (blockIdx.x + 1) / gridDim.x;
  if (j0 >= j1) return;
  if (threadIdx.x == 0) {
    mbar_init(bar_x);
    mbar_init(bar_b);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t ph_x = 0u, ph_b = 0u;
  int cur_f = -1;
  int4 fi = make_int4(0, 0, 0, 0), fc = fi;
  Job jb = tz_job(a, j0);
  int d = stage_samples(a, raw, jb, bar_x);
#pragma unroll 1
  for (long long j = j0; j < j1; ++j) {
    if (jb.f != cur_f) {  // every product of the previous filter is done
      cur_f = jb.f;
      fi = __ldg(&a.index[2 * cur_f]);
      fc = __ldg(&a.index[2 * cur_f + 1]);
      if (threadIdx.x == 0 && fi.y > 0) {
        bulk_load(bsm, a.image + fi.x, 16u * fi.y, bar_b);
      }
      if (fi.y > 0) {
        mbar_wait(bar_b, ph_b);
        ph_b ^= 1u;
      }
    }
    mbar_wait(bar_x, ph_x);
    ph_x ^= 1u;
    // the previous unit's rows have left the stage
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();

    const long long left = a.len - jb.k * kUnit;
    const int vo = static_cast<int>(min(static_cast<long long>(kUnit), left));
    const uint32_t live = split_planes(a, raw, d, vo + a.taps - 1, planes);
    if (threadIdx.x == 0) {
      // the terms of the planes below the highest live one (a dead plane
      // below it is zero and adds nothing), handed to every thread through
      // shared memory: a count ptxas sees come from a load keeps the walk
      // free of branches around its products (with the count taken from
      // the planes' split it serialises every wgmma: its C7518 remark)
      const int n_planes = 32 - __clz(live);
      int first = fi.z, count = 0;
#pragma unroll
      for (int p = 0; p < kTzPlanes; ++p) {
        const int n_p = p == 0 ? fi.w : (p == 1 ? fc.x : (p == 2 ? fc.y : fc.z));
        if (p < n_planes) count = n_p;
        if (p < n_planes - 1) first += n_p;
      }
      walk[0] = first;
      walk[1] = count;
    }
    __syncthreads();  // every sample read: the next unit's may come in
    const Job cur = jb;
    if (j + 1 < j1) {
      jb = tz_job(a, j + 1);
      d = stage_samples(a, raw, jb, bar_x);
    }

    // -- the Horner chain over the filter's terms, two chains of windows ----
    uint32_t acc[2][kTzAcc];
    uint32_t fa[2][KS][4];
#pragma unroll
    for (int r = 0; r < kTzAcc; ++r) acc[0][r] = acc[1][r] = 0u;
    int pl0 = -1, pl1 = -1, prev = 0;
    const int t_first = walk[0], n_terms = walk[1];
#pragma unroll 1
    for (int i = t_first; i < t_first + n_terms; ++i) {
      const int4 t = __ldg(&a.terms[i]);
      const int sh = prev - t.z > 0 ? prev - t.z : 0;
      if (t.y != pl0) {  // chain 0's products so far are done
        load_a<KS>(fa[0], planes + t.y * a.plane_bytes, 0);
        pl0 = t.y;
      }
      tz_shift(acc[0], sh);
      tz_issue<KS>(acc[0], fa[0], bs, t.x);
      tz_wait<1>();  // chain 1's previous product is done
      if (t.y != pl1) {
        load_a<KS>(fa[1], planes + t.y * a.plane_bytes, 1);
        pl1 = t.y;
      }
      tz_shift(acc[1], sh);
      tz_issue<KS>(acc[1], fa[1], bs, t.x);
      tz_wait<1>();  // this term's chain 0 product is done
      prev = t.z;
    }
    tz_wait<0>();
    tz_shift(acc[0], prev);
    tz_shift(acc[1], prev);

    // -- the outputs: stage each window's row, then one bulk copy a row -----
    __syncthreads();  // every warp's fragments are read from the planes
    // chain ch's accumulator 4 jn + 2 h (+1): window 64 ch + 16 warp + g +
    // 8 h, phases 8 jn + 2 q (+1)
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
      for (int jn = 0; jn < kPhases / 8; ++jn) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 64 * ch + 16 * warp + g + 8 * h;
          *reinterpret_cast<uint2*>(stage + kStageRow * n + 8 * jn + 2 * q) =
              make_uint2(acc[ch][4 * jn + 2 * h], acc[ch][4 * jn + 2 * h + 1]);
        }
      }
    }
    // the rows are read by the bulk copies, through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // thread n sends window n's outputs: whole 16-byte groups by one bulk
    // copy where the row starts on 16 bytes, the rest by its own stores
    int32_t* dst = a.out + (static_cast<long long>(cur.f) * a.n_streams +
                            cur.z) * a.len + cur.k * kUnit +
                   kPhases * threadIdx.x;
    const int valid = min(kPhases, vo - kPhases * static_cast<int>(threadIdx.x));
    const int32_t* row = stage + kStageRow * threadIdx.x;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0u && valid >= 4) {
      done = valid & ~3;
      bulk_store(dst, row, 4 * done);
    }
    for (int e = done; e < valid; ++e) dst[e] = row[e];
  }
  // the copies must have read the stage before the block's memory goes
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

struct TzGeometry {
  int raw_words, plane_bytes;
  size_t smem;
};

TzGeometry tz_geometry(int taps, int b_bytes) {
  const int k = 64 * ((taps + 63 + 63) / 64);
  TzGeometry geo;
  geo.raw_words = (kUnit + taps - 1 + 3 + 3) & ~3;
  geo.plane_bytes = (kUnit - kPhases + k + 127) & ~127;
  const size_t stage = sizeof(int32_t) * kWindows * kStageRow;
  const size_t planes = static_cast<size_t>(kTzPlanes) * geo.plane_bytes;
  geo.smem = 1024 + static_cast<size_t>(b_bytes) + 4 * geo.raw_words +
             (planes > stage ? planes : stage);
  return geo;
}

template <int KS>
int tz_launch(TzArgs& a, size_t smem, cudaStream_t stream, int device) {
  // B of `kTzMaxRuns` runs at the most taps of this K: its shared memory is
  // granted once a device, so that no launch's grant can shrink another's;
  // the blocks an SM are found once a device and size of B
  constexpr int kMaxChunks = (kTzMaxRuns * 32 * KS + 127) / 128;
  constexpr int kMostTaps = 32 * KS - 63 < 255 ? 32 * KS - 63 : 255;
  static bool granted[64] = {};
  static int slots[64][kMaxChunks + 1] = {};
  const int chunks = a.b_bytes / kChunk;
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (chunks > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSuccess;
  if (!granted[device]) {
    e = cudaFuncSetAttribute(
        blmac_specialized_kernel_wgmma<KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tz_geometry(kMostTaps, kMaxChunks * kChunk).smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    granted[device] = true;
  }
  if (slots[device][chunks] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, blmac_specialized_kernel_wgmma<KS>, kTzThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    slots[device][chunks] = sms * per_sm;
  }
  const long long grid =
      min(a.n_jobs, static_cast<long long>(slots[device][chunks]));
  blmac_specialized_kernel_wgmma<KS>
      <<<static_cast<int>(grid), kTzThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch `n_filters` filters over `n_chan` channels of `n_tiles` frames on
// `stream` on the tensor cores, in one launch.  `frames` is int32 (n_chan,
// n_tiles, >= tile + taps - 1) with strides (stride_c, stride_tile, 1);
// `image`, `index` (int32 (n_filters, 8)) and `terms` (int32 (n, 4)) as
// `toeplitz_tables` builds them, on the device, no filter's tiles larger
// than `b_bytes` (a multiple of 8,192, at most `kTzMaxRuns` runs); `out` int32 (n_filters, n_chan,
// n_tiles, tile) contiguous; every pointer on CUDA device `device`, which
// is made current for the launch.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int blmac_specialized_wgmma_launch(
    const void* frames, long long stride_c, long long stride_tile,
    const void* image, const void* index, const void* terms, int b_bytes,
    void* out, int n_filters, int n_chan, int n_tiles, int tile, int taps,
    void* stream, int device) {
  if (n_filters <= 0 || n_chan <= 0 || n_tiles <= 0 || tile <= 0 ||
      taps < 1 || taps > 255 || b_bytes <= 0 || b_bytes % kChunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TzArgs a;
  a.frames = static_cast<const int32_t*>(frames);
  a.stride_c = stride_c;
  a.stride_tile = stride_tile;
  // frames `tile` apart are one signal a channel: its outputs are one
  // stream, and the result's (n_tiles, tile) rows are that stream in order
  const bool one_signal = n_tiles == 1 || stride_tile == tile;
  a.zt = one_signal ? 1 : n_tiles;
  a.len = one_signal ? static_cast<long long>(n_tiles) * tile : tile;
  a.n_streams = static_cast<long long>(n_chan) * a.zt;
  a.ups = (a.len + kUnit - 1) / kUnit;
  a.taps = taps;
  a.out = static_cast<int32_t*>(out);
  a.image = static_cast<const uint4*>(image);
  a.index = static_cast<const int4*>(index);
  a.terms = static_cast<const int4*>(terms);
  a.n_jobs = static_cast<long long>(n_filters) * a.n_streams * a.ups;
  a.b_bytes = b_bytes;
  const TzGeometry geo = tz_geometry(taps, b_bytes);
  a.raw_words = geo.raw_words;
  a.plane_bytes = geo.plane_bytes;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch ((taps + 63 + 63) / 64) {
    case 1: err = tz_launch<2>(a, geo.smem, st, device); break;
    case 2: err = tz_launch<4>(a, geo.smem, st, device); break;
    case 3: err = tz_launch<6>(a, geo.smem, st, device); break;
    case 4: err = tz_launch<8>(a, geo.smem, st, device); break;
    default: err = tz_launch<10>(a, geo.smem, st, device); break;
  }
  if (current != device) cudaSetDevice(current);
  return err;
}
