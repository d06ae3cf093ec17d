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
// nonzeros, the sweep bank's 9,900 x 1,424 has 828,212: 45 and 84 a row).
//
// What bounds it on the H100.  Its bytes (real rows read and written,
// shared rows read, once each) against one multiply-add a nonzero an
// output (an IMAD, 64 an SM a clock): at the sweep shape 0.41 ms of bytes
// against 0.81 ms of IMADs, at a serve push 4.7 us of bytes against 2.8 us.
// Every nonzero reads one shared-row sample; read from the caches (the
// first design) those reads ran at L2's rate, 7.5 ms at the sweep.
//
// The design.  A block owns a span of kSpan = 32 samples of one channel
// and a group of real rows (the host's table, `CombineTable` in
// blmac_fir.py, balances the groups by nonzeros and picks how many from
// the grid: one at both main-path shapes, so every shared row is read
// from device memory once a span).
//   1. It stages the span of every shared row its group uses (the group's
//      union list, built on the host) in shared memory: 128 bytes a row,
//      with 16-byte cp.async where the rows start on 16 bytes and 4-byte
//      ones where they do not, zero-filled past n_out.  All 1,424 shared
//      rows of the sweep bank take 178 KiB, the 434 of the serve bank 54 KiB.
//   2. A staged sample serves two real rows from registers.  The host
//      pairs the group's rows by the shared rows they have in common
//      (`pair_rows`), and a pair's entries are the union of its two rows'
//      shared rows, each with both coefficients (0 where a row does not
//      use it): 0.60 entries a nonzero in the sweep bank, 0.67 in the
//      serve bank (padding included), so as many fewer staged reads.
//   3. Each warp walks four pairs at a time (a quad: 8 lanes a pair, 4
//      consecutive samples a lane).  A lane's entries are the same for its
//      8 lanes; the host interleaves the quad's four pairs 16 bytes apart,
//      so one 64-byte warp load brings 2 entries of each pair (1 in the
//      wide layout), kBatch such loads at a time a batch ahead of their
//      use, across the end of one quad into the next.  An entry holds the
//      staged row's place in shared memory (premultiplied on the host) and
//      the two coefficients; the lane reads its 4 samples with one 128-bit
//      shared-memory load (8 lanes, 128 contiguous bytes: no bank
//      conflict) and adds 8 IMADs.  A zero entry (the padding of a quad's
//      shorter pairs) adds 0: cheaper than a branch an entry.
//   4. The real rows' old samples are loaded when their quad starts, so
//      the read-modify-write at its end does not wait; a row too wide to
//      stage at once is split by the host into pieces, each added with
//      atomics (exact: addition modulo 2^32 commutes).
// What then holds it, measured on the H100 (benchmarks/port_combine_fold.py,
// PERF.md): latency with 16 warps an SM, at about twice its three
// near-equal limits a step (a 128-bit shared load is 4 clocks an SM, 8
// IMADs a lane 4, about 15 instructions 4); the depth of the table's
// loads (kBatch) decides most of the rest.  Table layouts: compact (an entry in two words: the first
// row's coefficient in the high 16 bits of the first, signed, the place
// in its low 16; the second row's coefficient the second word) wherever
// every coefficient fits 16 bits, as every bank the CSE pass makes does;
// wide (four words an entry) for any other int32 coefficient.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSpan = 32;                       // samples a block folds
constexpr int kOuts = 4;                        // consecutive samples a lane
constexpr int kLanesPerRow = kSpan / kOuts;     // 8
constexpr int kRowsPerWarp = 32 / kLanesPerRow; // 4 pairs: a quad
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 6;  // 16-byte table chunks a lane loads at a time
constexpr int kAtomic = 1 << 30;     // row flag: a piece, added atomically
constexpr int kMaxSmem = 232448;     // bytes of shared memory a block may use

static_assert(kRowsPerWarp == 4, "a quad's table interleaves four rows");

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// a += c_a * v and b += c_b * v, v the lane's 4 samples of the staged
// row at `place` (in 16-byte words): one 128-bit shared-memory load, 8
// IMADs.  A zero (padding) entry reads staged row 0 and adds 0, cheaper
// than a branch on every entry; so does a coefficient of a row that does
// not use the shared row.
__device__ __forceinline__ void madd(uint32_t (&a)[kOuts],
                                     uint32_t (&b)[kOuts],
                                     const uint4* __restrict__ col,
                                     uint32_t place, uint32_t c_a,
                                     uint32_t c_b) {
  const uint4 v = col[place];
  a[0] += c_a * v.x;
  a[1] += c_a * v.y;
  a[2] += c_a * v.z;
  a[3] += c_a * v.w;
  b[0] += c_b * v.x;
  b[1] += c_b * v.y;
  b[2] += c_b * v.z;
  b[3] += c_b * v.w;
}

// A compact entry's first coefficient: its high 16 bits, sign-extended.
__device__ __forceinline__ uint32_t high_half(uint32_t e) {
  return static_cast<uint32_t>(static_cast<int32_t>(e) >> 16);
}

// The entries of one 16-byte chunk: two compact ones, or one wide one.
template <bool kWide>
__device__ __forceinline__ void walk(uint32_t (&a)[kOuts],
                                     uint32_t (&b)[kOuts],
                                     const uint4* __restrict__ col,
                                     const uint4 e) {
  if (kWide) {
    madd(a, b, col, e.x, e.y, e.z);
  } else {
    madd(a, b, col, e.x & 0xFFFFu, high_half(e.x), e.y);
    madd(a, b, col, e.z & 0xFFFFu, high_half(e.z), e.w);
  }
}

__device__ __forceinline__ int pick(const int4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One quad's header: its table chunks and its four pairs of rows.
struct Quad {
  int4 head;  // {first 16-byte word of the table, chunks, -, -}
  int4 a, b;  // each pair's rows: -1 none; | kAtomic a piece
};

__device__ __forceinline__ Quad quad_at(const int4* __restrict__ quads,
                                        int q, int q_end) {
  if (q >= q_end) {
    const int4 none = make_int4(-1, -1, -1, -1);
    return {make_int4(0, 0, 0, 0), none, none};
  }
  return {__ldg(quads + 3 * q), __ldg(quads + 3 * q + 1),
          __ldg(quads + 3 * q + 2)};
}

// A real row's part of the output: the lane's 4 samples of `row` (or
// nowhere for no row), and whether they are stored or added atomically.
struct Out {
  uint32_t* at;
  bool live, plain;
};

__device__ __forceinline__ Out out_at(uint32_t* ych, long long stride_row,
                                      int row, int t, int n_out) {
  const bool live = row >= 0 && t < n_out;
  return {ych + static_cast<long long>(live ? row & (kAtomic - 1) : 0) *
                    stride_row +
              t,
          live, live && !(row & kAtomic)};
}

template <bool kVec>
__device__ __forceinline__ void load_old(const Out& o, int t, int n_out,
                                         uint32_t (&old)[kOuts]) {
  if (!o.plain) return;
  if (kVec && t + kOuts <= n_out) {
    const uint4 v = *reinterpret_cast<const uint4*>(o.at);
    old[0] = v.x;
    old[1] = v.y;
    old[2] = v.z;
    old[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < kOuts; ++k) {
      if (t + k < n_out) old[k] = o.at[k];
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store(const Out& o, int t, int n_out,
                                      const uint32_t (&old)[kOuts],
                                      const uint32_t (&acc)[kOuts]) {
  if (!o.live) return;
  if (!o.plain) {
#pragma unroll
    for (int k = 0; k < kOuts; ++k) {
      if (t + k < n_out) atomicAdd(o.at + k, acc[k]);
    }
  } else if (kVec && t + kOuts <= n_out) {
    *reinterpret_cast<uint4*>(o.at) =
        make_uint4(old[0] + acc[0], old[1] + acc[1], old[2] + acc[2],
                   old[3] + acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kOuts; ++k) {
      if (t + k < n_out) o.at[k] = old[k] + acc[k];
    }
  }
}

// kBatch chunks of a pair's entries from `src`.  Chunks past its quad's
// end are read but never walked (the host pads the table's end), which
// costs less than a predicate on every load.
__device__ __forceinline__ void fetch(uint4 (&buf)[kBatch],
                                      const uint4* __restrict__ src) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) buf[i] = __ldg(src + kRowsPerWarp * i);
}

// kVec: y's base, row and channel strides are multiples of 16 bytes, so a
// lane's 4 samples are one 16-byte word everywhere.
template <bool kVec, bool kWide>
__global__ void __launch_bounds__(kThreads, 1) blmac_combine_kernel(
    uint32_t* y, long long stride_row, long long stride_chan, int n_real,
    int n_out, int n_groups, const int32_t* __restrict__ group_quads,
    const int32_t* __restrict__ group_union,
    const int32_t* __restrict__ ulist, const int4* __restrict__ quads,
    const uint4* __restrict__ table) {
  extern __shared__ uint4 staged[];  // [union row][lane of the row]
  const int g = blockIdx.x % n_groups;
  const int s0 = (blockIdx.x / n_groups) * kSpan;
  uint32_t* ych = y + static_cast<long long>(blockIdx.y) * stride_chan;
  const uint32_t* shared = ych + static_cast<long long>(n_real) * stride_row;

  // 1. the span of the group's shared rows, into shared memory
  const int u0 = __ldg(group_union + g);
  const int n_words = (__ldg(group_union + g + 1) - u0) * kLanesPerRow;
  for (int i = threadIdx.x; i < n_words; i += kThreads) {
    const int t = s0 + (i % kLanesPerRow) * kOuts;
    const int valid = min(max(n_out - t, 0), kOuts);
    const uint32_t* src =
        shared +
        static_cast<long long>(__ldg(ulist + u0 + i / kLanesPerRow)) *
            stride_row +
        t;
    if (kVec) {
      cp_async16(&staged[i], valid > 0 ? src : shared, 4 * valid);
    } else {
      uint32_t* dst = reinterpret_cast<uint32_t*>(&staged[i]);
#pragma unroll
      for (int k = 0; k < kOuts; ++k) {
        cp_async4(dst + k, k < valid ? src + k : shared, k < valid ? 4 : 0);
      }
    }
  }

  // 2. each warp walks its quads of the group's pairs, q, q + kWarps, ...;
  // the table's chunks come kBatch at a time, a batch ahead of their use,
  // the next quad's first during this quad's last (its first quad's while
  // the staging copies land)
  const int lane = threadIdx.x % 32;
  const int sub = lane / kLanesPerRow;  // the quad's pair this lane adds to
  const int l8 = lane % kLanesPerRow;
  const int t = s0 + l8 * kOuts;        // the lane's first sample
  const uint4* col = staged + l8;
  const int q_end = __ldg(group_quads + g + 1);
  int q = __ldg(group_quads + g) + threadIdx.x / 32;
  Quad cur = quad_at(quads, q, q_end);
  uint4 buf[kBatch];
  fetch(buf, table + cur.head.x + sub);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (; q < q_end; q += kWarps) {
    const Quad next = quad_at(quads, q + kWarps, q_end);
    const Out out_a = out_at(ych, stride_row, pick(cur.a, sub), t, n_out);
    const Out out_b = out_at(ych, stride_row, pick(cur.b, sub), t, n_out);
    uint32_t old_a[kOuts] = {0, 0, 0, 0}, old_b[kOuts] = {0, 0, 0, 0};
    load_old<kVec>(out_a, t, n_out, old_a);  // in flight with the walk
    load_old<kVec>(out_b, t, n_out, old_b);

    uint32_t acc_a[kOuts] = {0, 0, 0, 0}, acc_b[kOuts] = {0, 0, 0, 0};
    const uint4* p = table + cur.head.x + sub;  // chunk k at p[4k]
    const int n = cur.head.y;
#pragma unroll 2
    for (int c = 0; c < n; c += kBatch) {
      const bool more = c + kBatch < n;
      uint4 nxt[kBatch];
      fetch(nxt, more ? p + kRowsPerWarp * (c + kBatch)
                      : table + next.head.x + sub);
      if (c + kBatch <= n) {  // the same for the whole warp
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          walk<kWide>(acc_a, acc_b, col, buf[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBatch - 1; ++i) {
          if (c + i < n) walk<kWide>(acc_a, acc_b, col, buf[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) buf[i] = nxt[i];
    }
    store<kVec>(out_a, t, n_out, old_a, acc_a);
    store<kVec>(out_b, t, n_out, old_b, acc_b);
    cur = next;
  }
}

template <bool kVec, bool kWide>
cudaError_t launch(const dim3& grid, size_t smem, cudaStream_t stream,
                   uint32_t* y, long long stride_row, long long stride_chan,
                   int n_real, int n_out, int n_groups,
                   const int32_t* group_quads, const int32_t* group_union,
                   const int32_t* ulist, const int4* quads,
                   const uint4* table) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(blmac_combine_kernel<kVec, kWide>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  }
  if (e != cudaSuccess) return e;
  blmac_combine_kernel<kVec, kWide><<<grid, kThreads, smem, stream>>>(
      y, stride_row, stride_chan, n_real, n_out, n_groups, group_quads,
      group_union, ulist, quads, table);
  return cudaGetLastError();
}

}  // namespace

// Fold the shared rows of `y` into its first `n_real` rows, in place, on
// `stream` (the current device's), in one launch.  `y` is int32 (n_real +
// n_shared, n_chan, >= n_out) with strides (stride_row, stride_chan, 1).
// The table (built by `CombineLayout` in blmac_fir.py, int32 on the
// device) holds `n_groups` groups: group g's staged shared rows are
// ulist[group_union[g] .. group_union[g + 1]] (at most `max_union` of
// them), its quads group_quads[g] .. group_quads[g + 1]; quad q is
// quads[12q .. 12q + 12] = {first 16-byte word of its entries, chunks, -,
// -, the first rows of its four pairs, their second rows} (-1 for none,
// | 2^30 for a piece added atomically), and its entries `table` from that
// word on, the four pairs' chunks in turn, padded at the end by kBatch
// chunks.  `wide` selects the four-word entries.  Returns
// cudaGetLastError() after the launch.
extern "C" int blmac_combine_launch(void* y, long long stride_row,
                                    long long stride_chan, int n_real,
                                    int n_chan, int n_out, int n_groups,
                                    int max_union, const void* group_quads,
                                    const void* group_union,
                                    const void* ulist, const void* quads,
                                    const void* table, int wide,
                                    void* stream) {
  const size_t smem = sizeof(uint4) * kLanesPerRow *
                      static_cast<size_t>(max_union > 0 ? max_union : 1);
  if (n_real <= 0 || n_chan <= 0 || n_out <= 0 || stride_row < n_out ||
      n_chan > 65535 || n_groups <= 0 || max_union < 0 ||
      smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long spans = (n_out + kSpan - 1) / kSpan;
  if (spans * n_groups > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   stride_row % 4 == 0 && stride_chan % 4 == 0;
  const dim3 grid(static_cast<unsigned>(spans * n_groups), n_chan);
  const auto* gq = static_cast<const int32_t*>(group_quads);
  const auto* gu = static_cast<const int32_t*>(group_union);
  const auto* ul = static_cast<const int32_t*>(ulist);
  const auto* qs = static_cast<const int4*>(quads);
  const auto* tb = static_cast<const uint4*>(table);
  auto* yy = static_cast<uint32_t*>(y);
  auto* st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (vec) {
    e = (wide ? launch<true, true> : launch<true, false>)(
        grid, smem, st, yy, stride_row, stride_chan, n_real, n_out, n_groups,
        gq, gu, ul, qs, tb);
  } else {
    e = (wide ? launch<false, true> : launch<false, false>)(
        grid, smem, st, yy, stride_row, stride_chan, n_real, n_out, n_groups,
        gq, gu, ul, qs, tb);
  }
  return static_cast<int>(e);
}
