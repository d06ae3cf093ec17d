// blmac_bank_kernel: the scheduled BLMAC filter-bank kernel for Hopper's int8
// tensor cores.
//
// Replaces the TPU kernel `_fir_kernel_bank`
// (src/repro/kernels/blmac_fir.py:200), launched there by `_bank_call` once
// per tile group.  It computes the same function, for every bank row b,
// channel c and output sample t:
//
//   u_j[t] = x[t+j] + x[t+taps-1-j]   (j < taps/2; the centre row j = taps/2
//                                       is x[t+j] alone)
//   y[b, c, t] = sum_layers 2^layer * sum_j trit[b, layer, j] * u_j[t]
//
// in int32 modulo 2^32, for every int32 input.  One launch covers every tile
// group of a call and writes y straight into the caller's (B, C, n_out)
// result at row inv[b], dropping pad rows and outputs past n_out.
//
// The arithmetic, exact modulo 2^32 (the host builds the tables:
// `bank_terms` in blmac_fir.py; `bank_term_walk` there is this loop in
// numpy):
//   * digits: each group's populated layers are regrouped, MSB first, into
//     runs of span <= 7, and each run's digit matrix d = sum trit << (layer -
//     lo) is stored as s8 (|d| <= 2^7 - 1 for any trits, CSD or not), K =
//     taps/2 + 1 padded to a multiple of 32, zeros in the padding;
//   * samples: the block folds u (uint32) and splits it into balanced s8 byte
//     planes, u == sum_p s_p 2^(8p) (mod 2^32): s_p is the low byte of what
//     remains, read as s8, and the next plane takes (rest - s_p) >> 8.  A
//     plane that is zero across a unit's samples is skipped (8-bit
//     samples need 2 planes; full-range int32 samples 4);
//   * terms: y = sum over (run, plane) of (D_run U_p) << (lo_run + 8p); a term
//     whose shift is 32 or more vanishes and is not in the table.  The terms,
//     sorted by shift, high first, are walked as a Horner chain in one s32
//     accumulator: acc <<= (previous shift - shift); acc += D_run U_p on the
//     tensor cores (wgmma s8 x s8 -> s32, no .satfinite: the accumulator
//     wraps modulo 2^32, which the card tests check across 2^31).  One
//     product's partial sums stay below 128 * 127 * 128 < 2^31.
//
// What bounds it on the H100: the output bytes.  Per output, 6 terms of
// K = 64 at the 127-tap sweep bank are some 770 int8 operations against 4
// bytes written: 0.064 ms of tensor cores against 0.192 ms of HBM at the
// sweep shape.  The design keeps everything but the output out of device
// memory, leaves the stores to the copy engine, and keeps the SM's own
// work (the shifts of the Horner chain, the fold) under the stores:
//   * one warpgroup a block, as many blocks as fit on the card (four an SM
//     up to 127 taps), each walking a contiguous range of jobs: a job is
//     one 64-row tile of the bank (any group: a table of tiles gives its
//     group and fragment offset) over one unit of 128 outputs of one
//     (channel, frame).  At a new unit the block stages its 128 + taps - 1
//     samples in shared memory, folds and splits them into the U tile
//     (128 outputs x K bytes a plane, K-major, 128-byte swizzle, up to four
//     planes side by side in one 128-byte row); the jobs of a unit reuse it;
//   * wgmma m64n64k32 in two chains, outputs 0..63 and 64..127: the 64
//     bank rows on M, the outputs on N, each chain's shift issued behind
//     the other's product.  ptxas serialises these wgmmas (its C7518
//     remark): the walk ends on a data-dependent count, the tile's live
//     terms, and a walk of a count it can prove uniform (checked: a kernel
//     parameter) compiles without the remark but would run the dead
//     planes' terms as zero products.  The other blocks of the SM fill the
//     gaps.  The digits come from registers: the host stores each (tile,
//     run, k-step) in wgmma's A-fragment order, so a thread loads its 16
//     bytes with one coalesced load, two live terms ahead of the products
//     (a ring of three);
//   * the outputs leave through shared memory: each warp stages 8 of its
//     rows at a time, and each row goes to its destination by one bulk
//     asynchronous copy (cp.async.bulk) where it starts on 16 bytes.  The
//     default result's rows start on 32 bytes (a (B, C, n_out) view of a
//     buffer whose rows are padded to 8 elements), so every copy writes
//     whole 32-byte sectors, none shared with another block's copy.  Into
//     a contiguous result at the sweep shape (rows 8 bytes off 16, so
//     thread stores) the kernel takes 2.2x as long on an H100
//     (chip_smoke.py, `contiguous_out_ms`).  Thread stores write the rest (a
//     row's last outputs past a multiple of 4, or rows that do not start
//     on 16 bytes);
//   * all-zero groups have tiles with no terms: the same launch writes
//     their rows as zeros.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kBN = 128;       // outputs a block: wgmma N
constexpr int kRows = 64;      // bank rows a tile: wgmma M
constexpr int kPlanes = 4;     // byte planes of a uint32 sample
constexpr int kRowBytes = 128;  // one swizzled row of the U tile
constexpr int kHalfN = kBN / 2;  // outputs a chain: wgmma m64n64k32
constexpr int kAcc = kHalfN / 2;  // s32 accumulators a thread a chain
constexpr int kMaxTaps = 255;
constexpr int kStageRows = 8;        // rows a warp stages at once
constexpr int kStage = kBN + 8;      // words a staged row: 16-byte rows,
                                     // bank offset 8 from one to the next

struct Args {
  const int32_t* frames;
  long long stride_c, stride_tile;
  int n_chan, n_tiles, tile, taps, n_out;
  int32_t* out;
  long long ld;  // elements from one (filter, channel) row of out to the next
  const uint4* digits;  // A fragments: (tile, run, k-step, 128 threads)
  const int2* tiles;    // (group, fragment offset in 16-byte units)
  const int2* groups;   // (first term, number of terms)
  const int4* terms;    // (run, plane, shift, 0), shift high first
  const int* dest;      // output row of every tile row, -1 for padding
  int n_row_tiles, n_tb;
  long long n_jobs;  // (channel, frame, 128 outputs) units x row tiles
};

// Planes that share one 128-byte row of the U tile, and the rows' sets.
template <int KS>
struct Geo {
  static constexpr int K = 32 * KS;
  static constexpr int kPPR = KS == 1 ? 4 : (KS == 2 ? 2 : 1);
  static constexpr int kSets = kPlanes / kPPR;
  static constexpr int kUBytes = kSets * kBN * kRowBytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d (+)= A B for one k32 step: A (64 x 32 s8) from registers in wgmma's
// fragment order, B (32 x 64 s8) the U tile's rows at `desc`.  Asynchronous:
// d and a may be touched only after the wait for its group.
__device__ __forceinline__ void wgmma_s8_n64(uint32_t* d, const uint4& a,
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
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving a register across the asynchronous
// product that reads or writes it
__device__ __forceinline__ void pin(uint32_t& v) { asm volatile("" : "+r"(v)); }

// The descriptor of the U tile's plane `plane` at k-step 0: K-major,
// 128-byte swizzle, 8-row groups 1024 bytes apart; planes that share a row
// start `K` bytes apart in it.  A k-step adds 32 bytes (2 in the field).
template <int KS>
__device__ __forceinline__ uint64_t u_desc(uint32_t us, int plane) {
  using G = Geo<KS>;
  const uint32_t addr = us + (plane / G::kPPR) * (kBN * kRowBytes) +
                        (plane % G::kPPR) * G::K;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// The first term at or after `i` whose plane is live in this block.
__device__ __forceinline__ int next_live(const Args& a, int i, int end,
                                         uint32_t live, int4& term) {
  for (; i < end; ++i) {
    term = __ldg(&a.terms[i]);
    if ((live >> term.y) & 1u) break;
  }
  return i;
}

template <int KS>
__device__ __forceinline__ void load_frags(const Args& a, int off,
                                           int run, uint4 (&f)[KS]) {
  const uint4* src = a.digits + off + run * KS * kThreads + threadIdx.x;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) f[ks] = __ldg(src + ks * kThreads);
}

// The walk of one row tile: the accumulators of its two chains (outputs
// 0..63 and 64..127 of the block) and a ring of three live terms with
// their fragments, filled two terms ahead of the products.
template <int KS>
struct Walk {
  uint32_t acc[2][kAcc];
  uint4 f[3][KS];
  int4 term[3];
  int idx[3];
  int off, end, prev;
  uint32_t live;
};

template <int S, int KS>
__device__ __forceinline__ void fetch(const Args& a, Walk<KS>& w, int from) {
  w.idx[S] = next_live(a, from, w.end, w.live, w.term[S]);
  if (w.idx[S] < w.end) load_frags<KS>(a, w.off, w.term[S].x, w.f[S]);
}

template <int C, int KS>
__device__ __forceinline__ void issue(Walk<KS>& w, const uint4 (&f)[KS],
                                      uint64_t desc) {
#pragma unroll
  for (int r = 0; r < kAcc; ++r) pin(w.acc[C][r]);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) wgmma_s8_n64(w.acc[C], f[ks], desc + 2 * ks);
  wgmma_commit();
}

template <int C, int KS>
__device__ __forceinline__ void shift(Walk<KS>& w, int sh) {
#pragma unroll
  for (int r = 0; r < kAcc; ++r) pin(w.acc[C][r]);
  if (sh > 0) {
#pragma unroll
    for (int r = 0; r < kAcc; ++r) w.acc[C][r] <<= sh;
  }
}

// One term of the Horner chain, in ring slot S: chain 0's shift and
// product, then chain 1's while chain 0's product runs (and chain 0's next
// shift while chain 1's runs).  Returns false past the last live term.
template <int S, int KS>
__device__ __forceinline__ bool term_step(const Args& a, Walk<KS>& w,
                                          uint32_t us_addr) {
  if (w.idx[S] >= w.end) return false;
  const int4 t = w.term[S];
  const int sh = w.prev > t.z ? w.prev - t.z : 0;
  const uint64_t desc = u_desc<KS>(us_addr, t.y);
  shift<0>(w, sh);
  issue<0>(w, w.f[S], desc);
  wgmma_wait<1>();  // chain 1's previous product is done
  shift<1>(w, sh);
  // the slot two terms ahead held the previous term, done with now
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint4& f = w.f[(S + 2) % 3][ks];
    pin(f.x); pin(f.y); pin(f.z); pin(f.w);
  }
  fetch<(S + 2) % 3>(a, w, w.idx[(S + 1) % 3] + 1);
  issue<1>(w, w.f[S], desc + (kHalfN * kRowBytes >> 4));
  wgmma_wait<1>();  // this term's chain 0 product is done
  w.prev = t.z;
  return true;
}

// Stage the samples of one (channel, frame, 128 outputs) unit, fold them
// and split them into byte planes in the U tile; returns the planes that
// are not zero across the unit (block-uniform).  Thread t owns output t.
template <int KS>
__device__ __forceinline__ uint32_t build_u(const Args& a, uint8_t* us,
                                            int32_t* xs, int c, int s,
                                            int t0) {
  using G = Geo<KS>;
  const int n_x = kBN + a.taps - 1;
  const int32_t* frame = a.frames + c * a.stride_c + s * a.stride_tile + t0;
  const int avail = a.tile + a.taps - 1 - t0;  // outputs past the tile
  for (int i = threadIdx.x; i < n_x; i += kThreads) {  // read zeros
    xs[i] = i < avail ? __ldg(frame + i) : 0;
  }
  __syncthreads();
  const int half = a.taps / 2;
  const int t = threadIdx.x;
  uint32_t nz = 0u;
#pragma unroll 1
  for (int jc = 0; jc < G::K / 16; ++jc) {
    uint32_t w[kPlanes][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t b[kPlanes] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = jc * 16 + q * 4 + e;
        uint32_t u = 0u;
        if (j < half) {
          u = static_cast<uint32_t>(xs[t + j]) +
              static_cast<uint32_t>(xs[t + a.taps - 1 - j]);
        } else if (j == half) {
          u = static_cast<uint32_t>(xs[t + j]);
        }
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          const uint32_t sp = static_cast<uint32_t>(
              static_cast<int32_t>(static_cast<int8_t>(u & 0xFFu)));
          b[p] |= (sp & 0xFFu) << (8 * e);
          u = static_cast<uint32_t>(static_cast<int32_t>(u - sp) >> 8);
        }
      }
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) w[p][q] = b[p];
    }
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      if (w[p][0] | w[p][1] | w[p][2] | w[p][3]) nz |= 1u << p;
      const int chunk16 = (p % G::kPPR) * (G::K / 16) + jc;
      uint8_t* dst = us + (p / G::kPPR) * (kBN * kRowBytes) + t * kRowBytes +
                     ((chunk16 ^ (t & 7)) << 4);
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
    }
  }
  // the tile is read by wgmma, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  uint32_t live = 0u;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    if (__syncthreads_or((nz >> p) & 1u)) live |= 1u << p;
  }
  return live;
}

__device__ __forceinline__ void bulk_store(int32_t* dst, const int32_t* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Write a row tile's outputs at their rows of the result.  Each warp stages
// 8 of its 16 rows at a time in its part of `stage`; then lane r < 8 sends
// row r: one bulk copy (the copy engine, no thread stores) of its whole
// 16-byte groups where the row starts on 16 bytes, and the lane's own
// stores for the rest (a row's last outputs past a multiple of 4, or a
// whole row that does not start on 16 bytes: slow, and only for a result
// the caller lays out so).
template <int KS>
__device__ __forceinline__ void store_tile(const Args& a, const Walk<KS>& w,
                                           int32_t* stage, int rt, int c,
                                           long long tg0, int valid) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  int32_t* wst = stage + warp * kStageRows * kStage;
  const int dr = lane < 16 ? __ldg(&a.dest[rt * kRows + 16 * warp + lane]) : -1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the previous rows' copies have read the stage
    if (lane < kStageRows) bulk_wait_read();
    __syncwarp();
    // chain C's accumulator i: row 16 warp + g + 8 ((i >> 1) & 1), output
    // 64 C + 8 (i >> 2) + 2 tq + (i & 1)
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
      for (int n = 0; n < kHalfN / 8; ++n) {
        const int col = kHalfN * ch + 8 * n + 2 * tq;
        *reinterpret_cast<uint2*>(wst + g * kStage + col) =
            make_uint2(w.acc[ch][4 * n + 2 * h], w.acc[ch][4 * n + 2 * h + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    const int d = __shfl_sync(0xFFFFFFFFu, dr, 8 * h + (lane & 7));
    if (lane < kStageRows && d >= 0) {
      int32_t* row =
          a.out + (static_cast<long long>(d) * a.n_chan + c) * a.ld + tg0;
      const int32_t* src = wst + lane * kStage;
      int done = 0;
      if ((reinterpret_cast<uintptr_t>(row) & 15u) == 0u && valid >= 4) {
        done = valid & ~3;
        bulk_store(row, src, 4 * done);
        bulk_commit();
      }
      for (int e = done; e < valid; ++e) row[e] = src[e];
    }
  }
}

// Four blocks an SM up to 127 taps (K <= 64): 128 registers a thread.
template <int KS>
__global__ void __launch_bounds__(kThreads, KS <= 2 ? 4 : 3)
blmac_bank_kernel(const Args a) {
  using G = Geo<KS>;
  extern __shared__ uint8_t smem_raw[];
  // the U tile needs 1024-byte alignment (128-byte swizzle)
  uint8_t* us = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  int32_t* xs = reinterpret_cast<int32_t*>(us + G::kUBytes);
  int32_t* stage = xs + ((kBN + a.taps - 1 + 3) & ~3);
  const uint32_t us_addr = smem_addr(us);

  // a contiguous range of jobs (unit-major), a new U tile at each unit
  const long long j0 = a.n_jobs * blockIdx.x / gridDim.x;
  const long long j1 = a.n_jobs * (blockIdx.x + 1) / gridDim.x;
  long long unit = -1;
  int c = 0, valid = 0;
  long long tg0 = 0;
  Walk<KS> w;
#pragma unroll 1
  for (long long j = j0; j < j1; ++j) {
    const long long ju = j / a.n_row_tiles;
    const int rt = static_cast<int>(j - ju * a.n_row_tiles);
    if (ju != unit) {
      unit = ju;
      const int tb = static_cast<int>(unit % a.n_tb);
      const int s = static_cast<int>((unit / a.n_tb) % a.n_tiles);
      c = static_cast<int>(unit / (static_cast<long long>(a.n_tb) * a.n_tiles));
      const int t0 = tb * kBN;
      tg0 = static_cast<long long>(s) * a.tile + t0;
      valid = static_cast<int>(min(static_cast<long long>(min(kBN, a.tile - t0)),
                                   a.n_out - tg0));
      if (valid <= 0) continue;  // past n_out: block-uniform
      __syncthreads();  // every warp is done with the previous unit's tile
      w.live = build_u<KS>(a, us, xs, c, s, t0);
    }
    if (valid <= 0) continue;

    // -- the Horner chain of the tile's group ------------------------------
    const int2 ti = __ldg(&a.tiles[rt]);
    const int2 gi = __ldg(&a.groups[ti.x]);
    w.off = ti.y;
    w.end = gi.x + gi.y;
    w.prev = -1;
#pragma unroll
    for (int r = 0; r < kAcc; ++r) w.acc[0][r] = w.acc[1][r] = 0u;
    fetch<0>(a, w, gi.x);
    fetch<1>(a, w, w.idx[0] + 1);
#pragma unroll 1
    for (;;) {
      if (!term_step<0>(a, w, us_addr)) break;
      if (!term_step<1>(a, w, us_addr)) break;
      if (!term_step<2>(a, w, us_addr)) break;
    }
    wgmma_wait<0>();
    shift<0>(w, w.prev);
    shift<1>(w, w.prev);
    store_tile<KS>(a, w, stage, rt, c, tg0, valid);
  }
  // the copies must have read the stage before the block's memory goes
  if ((threadIdx.x & 31) < kStageRows) bulk_wait_read();
}

int k_steps(int taps) { return (taps / 2 + 1 + 31) / 32; }

size_t smem_bytes_ks(int ks, int taps) {
  const int ppr = ks == 1 ? 4 : (ks == 2 ? 2 : 1);
  const size_t u = static_cast<size_t>(kPlanes / ppr) * kBN * kRowBytes;
  const size_t x = sizeof(int32_t) * ((kBN + taps - 1 + 3) & ~3);
  const size_t st = sizeof(int32_t) * (kThreads / 32) * kStageRows * kStage;
  return 1024 + u + x + st;  // 1024: room to align the U tile
}

// One block for each that fits on the card at once (at most one a job),
// each walking a contiguous range of the jobs.
template <int KS>
int launch(Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes_ks(KS, a.taps);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static int slots[64] = {};  // blocks the card holds at the largest taps
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (slots[dev] == 0) {
    const int most = static_cast<int>(smem_bytes_ks(KS, kMaxTaps));
    e = cudaFuncSetAttribute(blmac_bank_kernel<KS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return static_cast<int>(e);
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, blmac_bank_kernel<KS>, kThreads, most);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    slots[dev] = sms * per_sm;
  }
  const long long grid = min(a.n_jobs, static_cast<long long>(slots[dev]));
  blmac_bank_kernel<KS><<<static_cast<int>(grid), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block for `taps` taps (0 when the kernel
// does not take them).
extern "C" int blmac_bank_smem_bytes(int taps) {
  if (taps < 1 || taps > kMaxTaps) return 0;
  return static_cast<int>(smem_bytes_ks(k_steps(taps), taps));
}

// Launch the whole bank on `stream`.  `frames` is int32 (C, n_tiles, >= tile
// + taps - 1) with unit stride along the frame; `out` int32 (B, C, n_out)
// with unit stride along n_out and `ld` elements from one (filter, channel)
// row to the next (ld >= n_out; rows that start on 16 bytes leave by bulk
// copy); the tables as `bank_terms` builds them (device memory).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int blmac_bank_launch(const void* frames, long long stride_c,
                                 long long stride_tile, int n_chan,
                                 int n_tiles, int tile, int taps, int n_out,
                                 void* out, long long ld, const void* digits,
                                 const void* tiles, const void* groups,
                                 const void* terms, const void* dest,
                                 int n_row_tiles, void* stream) {
  if (taps < 1 || taps > kMaxTaps || n_chan <= 0 || n_tiles <= 0 ||
      tile <= 0 || n_out <= 0 || ld < n_out || n_row_tiles <= 0 ||
      static_cast<long long>(n_tiles) * tile < n_out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.frames = static_cast<const int32_t*>(frames);
  a.stride_c = stride_c;
  a.stride_tile = stride_tile;
  a.n_chan = n_chan;
  a.n_tiles = (n_out + tile - 1) / tile;  // frames past n_out write nothing
  a.tile = tile;
  a.taps = taps;
  a.n_out = n_out;
  a.out = static_cast<int32_t*>(out);
  a.ld = ld;
  a.digits = static_cast<const uint4*>(digits);
  a.tiles = static_cast<const int2*>(tiles);
  a.groups = static_cast<const int2*>(groups);
  a.terms = static_cast<const int4*>(terms);
  a.dest = static_cast<const int*>(dest);
  a.n_row_tiles = n_row_tiles;
  a.n_tb = (tile + kBN - 1) / kBN;
  a.n_jobs = static_cast<long long>(n_chan) * a.n_tiles * a.n_tb * n_row_tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k_steps(taps)) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 3: return launch<3>(a, st);
    default: return launch<4>(a, st);
  }
}
