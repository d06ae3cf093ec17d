// blmac_pulse_matmul_kernel: the CSD-P pulse-code matmul for Hopper.
//
// Replaces the TPU kernel `_pulse_matmul_kernel`
// (src/repro/kernels/blmac_matmul.py:95), launched there by `pulse_matmul`.
// It computes the same function: float32 y (M, N) = x (M, K) @ W, where W is
// rebuilt from P uint8 pulse codes per weight (bit 7 valid, bit 6 sign, bits
// 3..0 position; codes laid out (P, K, N)) and one int8 exponent per `group`
// rows of K (group_exp (K / group, N)):
//
//     W[k, n] = sum_p valid * (sign ? -1 : 1) * 2^(e[k / group, n] - 14 + pos)
//
// What bounds it on the H100 (SXM: 3.35 TB/s, 494.7 TFLOP/s dense TF32): at
// decode (M of a few rows) the bytes of the codes, P per weight (at P = 4 as
// many as float32 weights); at prefill (M = 128) the tensor-core operations
// of a 3xTF32 product, three TF32 products per weight and row.  Between the
// two sits the decode, about 3.5 instructions a pulse: the design does it
// once per weight per block, overlapped with the code stream and the MMAs.
// PERF.md has the kernel's times against these bounds.
//
// Design.  One launch per call.  A block owns BM rows of x by 128 columns
// of W and a range of K (a split: the grid's z dimension, so that a
// decode-sized M still fills the SMs), which it walks 32 rows a step.
//
//  * Code stream: a ring of 3 to 8 shared-memory stages (as many as fit;
//    the host's launch plan picks them), each holding the step's
//    (P, 32, 128) codes, its exponent rows and the (BM, 32) tile of x,
//    filled with cp.async.cg, 16 bytes a thread, zero-filled past the
//    edges.  While a step is decoded and multiplied, the next stages are in
//    flight.  The code rows' 16-byte chunks are XOR-swizzled (by
//    2 * (row % 4) at M <= 16, by row / 4 % 8 above) so that the decode's
//    word reads hit 32 banks.
//  * Decode, once per weight per block, exact: per 32-bit word (4 codes of
//    neighbouring columns) three instructions turn each code byte into a
//    byte offset into a 64-entry table of +-2^(pos - 14) or 0; the P table
//    values are added (every pulse is a multiple of 2^-14 and |sum| < 2^6,
//    so float32 holds the sum exactly) and multiplied once by 2^e from a
//    256-entry table indexed by the exponent's byte (exact: every bit of
//    the product lies at or above 2^(e - 14) >= 2^-142, subnormal results
//    included).  No exp2f, no fast-math, no flush-to-zero.
//  * Tensor cores: y += x_hi w_lo + x_lo w_hi + x_hi w_hi, with
//    v_hi = rna_tf32(v) and v_lo = v - v_hi (x_lo rounded to TF32 too).
//    A weight spans at most 16 bits, so w_hi + w_lo == w exactly; only x's
//    split and the dropped x_lo w_lo term err, near 2^-22 relative.  The
//    tensor cores add with truncation (Fasi, Higham, Mikaitis and Pranesh,
//    "Numerical behavior of NVIDIA tensor cores", 2021), which biases a
//    long sum, so each step sums its three products into a fresh
//    accumulator that is then added, rounded to nearest, to the running
//    one.
//      - M <= 16 (BM 8 or 16, 256 threads, up to four blocks an SM):
//        mma.sync.m16n8k8 with the operands swapped, y^T = W^T x^T, so that
//        the weights fill the MMA's 16-row side and x's few rows its
//        8-column side.  Each lane decodes the weights of its own A
//        fragments straight from the code words into registers: no decoded
//        tile, one barrier a step.  Warps: 4 along N x 2 halves of the
//        step, added in a fixed order at the end.
//      - M > 16 (BM 64 or 128, 256 threads, one block an SM): wgmma
//        m64nNk8 (N = 128 at BM 128, 64 at BM 64), x from registers (split
//        as its fragments are loaded), W from shared memory: each step's
//        weights are decoded once, 4 x 4 a thread, into hi and lo tiles of
//        W^T (K-major, 128-byte swizzle, as wgmma wants TF32).  Two tile
//        buffers: while a step's 12 wgmmas run on one, the next step is
//        decoded into the other.  One barrier a step.  The wgmmas are
//        issued on every step, outside any branch: ptxas serialises those
//        on a path it cannot prove uniform.
//  * Subnormal weights: TF32 keeps no bit below 2^-136, so a group with
//    e < -112 (pulses below 2^-126) cannot be split exactly.  Such a step
//    takes the CUDA cores instead, uniformly: per warp and 8-row chunk at
//    M <= 16 (__any_sync), per block and step above (__syncthreads_or; the
//    wgmmas' sum of that step is replaced).  FMA over the exact float32
//    weights, summed in a fixed order.  It is still this kernel; it never
//    falls back to the plain version.
//  * Split K in one launch: a block with a split writes its partial tile to
//    the workspace (splits, M, N), then takes a ticket from a per-tile
//    counter (atomicInc, which wraps the counter back to 0 as the last
//    ticket is drawn); the block that draws the last ticket adds the
//    partials in split order (float4 loads, up to 8 in flight a thread)
//    and writes y.  The sum does not depend on which block finishes first,
//    so two launches agree bit for bit.  The counters belong to one stream
//    (the wrapper keeps one buffer per stream), which orders the launches
//    that share them.
//  * Two instances of each tile: one for the standard operands (P = 4,
//    group 32, 16-byte aligned rows: the port's serving configuration),
//    whose plane loop, group arithmetic and load paths are constants to
//    the compiler, and one for any other operands.
//
// Resources (ptxas -v, sm_90a; chip_smoke.py's build phase prints them):
// registers <128> 237 / 244, <64> 178 / 188, <16> and <8> 64 (standard /
// general instance); the <8> instances spill 8 and 12 bytes.  Dynamic
// shared memory at P = 4, group 32: 54,656 bytes at BM 8 (3 stages, four
// blocks an SM), 208,128 at BM 128 (4 stages, one block an SM).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBK = 32;           // rows of K per step (one ring stage)
constexpr int kBN = 128;          // output columns per block
constexpr int kXS = kBK + 4;      // row stride of the x tiles, floats
// one decoded weight tile, W^T (BN rows of BK floats, 128 bytes a row,
// swizzled in 1024-byte atoms), and the slack that aligns the tiles to 1024
constexpr int kWTileBytes = kBN * kBK * 4;
constexpr int kAlignSlack = 1024;
constexpr int kTableBytes = (64 + 256) * 4;  // pulse and 2^e tables
constexpr int kMinTensorExp = -112;  // group exponents below: CUDA cores
constexpr int kMaxStages = 8;

// BM 8, 16: y^T = W^T x^T; 8 warps, 4 along N (32 columns each) x 2 halves
// of the step, up to four blocks an SM; each weight feeds one warp, which
// decodes it into its fragments.
// BM 64, 128: y = x W; 8 warps, two warpgroups, each a 64-row wgmma over
// WN columns (BM 128: the two 64-row halves by 128 columns; BM 64: 64 rows
// by two 64-column halves); every thread decodes 4 x 4 weights a step.
template <int BM>
struct Tile {
  static constexpr bool kSmall = BM <= 16;
  static constexpr int kThreads = 256;
  static constexpr int kMT = kSmall ? BM / 8 : 1;   // n8 tiles of x^T
  static constexpr int kWGN = kSmall ? 1 : 128 / BM;  // warpgroups along N
  static constexpr int kWN = kBN / kWGN;            // a warpgroup's columns
  static constexpr int kAcc = kWN / 2;              // its floats a thread
};

__host__ __device__ constexpr int exp_rows(int group) {
  return (kBK - 1) / group + 2 < kBK ? (kBK - 1) / group + 2 : kBK;
}

__host__ __device__ constexpr int stage_bytes(int bm, int planes, int group) {
  return planes * kBK * kBN + exp_rows(group) * kBN + bm * kXS * 4;
}

__host__ __device__ constexpr int smem_bytes(int bm, int planes, int group,
                                             int stages) {
  return (bm <= 16 ? 0 : kAlignSlack + 4 * kWTileBytes) + kTableBytes +
         stages * stage_bytes(bm, planes, group);
}

// The XOR applied to the 16-byte chunk index of code row `row` (plane * BK
// + k) of a stage: 2 * (row % 4) for the small tiles, so that their
// decode's reads of rows t and t + 4 by lanes (g, t) hit 32 banks; row / 4
// % 8 for the large ones, whose lanes read rows 4i .. 4i + 3 for i = 0..7.
template <int BM>
__device__ __forceinline__ int code_swizzle(int row) {
  return BM <= 16 ? (row & 3) << 1 : (row >> 2) & 7;
}

// Byte offset of the 32-bit word w (columns 4w .. 4w + 3) of code row `row`
// of a stage
template <int BM>
__device__ __forceinline__ int cidx(int row, int w) {
  return row * kBN + ((((w >> 2) ^ code_swizzle<BM>(row)) & 7) << 4) +
         ((w & 3) << 2);
}

// 2^n exactly, for n in [-149, 127]
__device__ __forceinline__ float exp2_int(int n) {
  return n >= -126 ? __int_as_float((n + 127) << 23)
                   : __int_as_float(0x00400000 >> (-127 - n));
}

// round to TF32 (10 mantissa bits), ties away from zero: cvt.rna.tf32.f32
__device__ __forceinline__ uint32_t rna_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// w = hi + lo exactly for a decoded weight of the tensor route
__device__ __forceinline__ void split_w(float w, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(w);
  lo = __float_as_uint(w - __uint_as_float(hi));
}

// x = hi + lo + (a residue near 2^-22 |x|)
__device__ __forceinline__ void split_x(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// wait until at most n (0 <= n <= 6) groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// d += A (16x8, row) B (8x8, col), TF32 operands, float32 accumulator
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A_hi B_lo + A_lo B_hi + A_hi B_hi, small terms first
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  mma_tf32(d, ah, bl);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bh);
}

struct Args {
  const float* x;
  const uint8_t* codes;
  const int8_t* gexp;
  float* work;
  unsigned* counters;
  float* out;
  int m, n, k, planes, group, per, splits, stages;
  int gshift;       // log2(group) when group is a power of two, else -1
  bool xvec, cvec;  // 16-byte cp.async legal for x rows / code and exp rows
  bool ovec;        // float4 access legal for rows of y and the workspace
};

__device__ __forceinline__ int group_of(const Args& a, int row) {
  return a.gshift >= 0 ? row >> a.gshift : row / a.group;
}

// Shared memory: at BM > 16 first two buffers of the decoded weight tiles
// (hi and lo, W^T, kWTileBytes each, 1024-aligned for wgmma's 128-byte
// swizzle); the pulse table (64 floats) and the 2^e table (256 floats, by
// the exponent's byte); then the ring of stages, each (codes P x BK x BN
// bytes, exponent rows x BN bytes, x BM x kXS floats).
template <int BM>
struct Smem {
  float* table;
  float* etab;
  unsigned char* w0;
  unsigned char* ring;
  int stage, exps_off, x_off;

  __device__ Smem(unsigned char* base, int planes, int group) {
    if (BM > 16) {
      const uint32_t addr =
          static_cast<uint32_t>(__cvta_generic_to_shared(base));
      w0 = base + ((kAlignSlack - addr % kAlignSlack) % kAlignSlack);
      base += kAlignSlack + 4 * kWTileBytes;
    }
    table = reinterpret_cast<float*>(base);
    etab = table + 64;
    ring = base + kTableBytes;
    exps_off = planes * kBK * kBN;
    x_off = exps_off + exp_rows(group) * kBN;
    stage = stage_bytes(BM, planes, group);
  }
  // the hi and lo tiles of W^T buffer b (0 or 1)
  __device__ float* whi(int b) const {
    return reinterpret_cast<float*>(w0 + 2 * b * kWTileBytes);
  }
  __device__ float* wlo(int b) const {
    return reinterpret_cast<float*>(w0 + (2 * b + 1) * kWTileBytes);
  }
  __device__ uint8_t* codes(int s) const { return ring + s * stage; }
  __device__ uint8_t* exps(int s) const { return ring + s * stage + exps_off; }
  __device__ float* x(int s) const {
    return reinterpret_cast<float*>(ring + s * stage + x_off);
  }
};

// Issue the loads of step `kt` (rows kt * 32 ...) into ring slot `s`:
// cp.async of 16 bytes a thread, zero-filled past the edges; bytewise
// loads where rows are not 16-byte aligned.  A thread's code chunks keep
// their row and column from plane to plane and step to step (the block
// covers kT / 8 code rows, one or two planes, a pass), so their addresses
// advance by a stride: a few instructions a chunk.
template <int BM>
__device__ __forceinline__ void load_stage(const Args& a, const Smem<BM>& sm,
                                           int kt, int s, int n0, int m0) {
  constexpr int kT = Tile<BM>::kThreads;
  constexpr int kChunks = kBN / 16;
  constexpr int kPStep = kT / kChunks / kBK;  // planes a pass
  static_assert(kPStep * kBK * kChunks == kT, "a pass covers whole planes");
  const int kb = kt * kBK;
  uint8_t* cs = sm.codes(s);
  if (a.cvec) {
    const int c = threadIdx.x % kChunks;
    const int r = threadIdx.x / kChunks % kBK;
    const int p0 = threadIdx.x / (kChunks * kBK) % kPStep;  // 0 at kPStep 1
    const int col = n0 + 16 * c;
    const bool in = kb + r < a.k && col < a.n;
    const long long stride = static_cast<long long>(kPStep) * a.k * a.n;
    const uint8_t* src =
        a.codes + (static_cast<long long>(p0) * a.k + kb + r) * a.n + col;
    uint8_t* dst =
        cs + (p0 * kBK + r) * kBN + ((c ^ code_swizzle<BM>(r)) << 4);
    for (int p = p0; p < a.planes; p += kPStep) {
      cp_async16(dst, in ? src : a.codes, in ? 16 : 0);
      src += stride;
      dst += kPStep * kBK * kBN;
    }
  }
  for (int i = threadIdx.x; !a.cvec && i < a.planes * kBK * kChunks;
       i += kT) {
    const int c = i % kChunks;
    const int pr = i / kChunks;
    const int p = pr / kBK;
    const int kr = kb + pr % kBK;
    const int col = n0 + 16 * c;
    const long long src = (static_cast<long long>(p) * a.k + kr) * a.n + col;
    uint8_t* dst = cs + pr * kBN + ((c ^ code_swizzle<BM>(pr)) << 4);
    for (int j = 0; j < 16; ++j) {
      dst[j] = (kr < a.k && col + j < a.n) ? a.codes[src + j] : 0;
    }
  }
  const int e_first = group_of(a, kb);
  const int e_rows = group_of(a, min(kb + kBK, a.k) - 1) - e_first + 1;
  uint8_t* es = sm.exps(s);
  for (int i = threadIdx.x; i < e_rows * kChunks; i += kT) {
    const int c = i % kChunks;
    const int er = i / kChunks;
    const int col = n0 + 16 * c;
    const long long src = static_cast<long long>(e_first + er) * a.n + col;
    uint8_t* dst = es + er * kBN + 16 * c;
    if (a.cvec) {
      const bool in = col < a.n;
      cp_async16(dst, a.gexp + (in ? src : 0), in ? 16 : 0);
    } else {
      for (int j = 0; j < 16; ++j) {
        dst[j] = col + j < a.n ? static_cast<uint8_t>(a.gexp[src + j]) : 0;
      }
    }
  }
  // x: rows of 8 chunks; a thread keeps its chunk column
  constexpr int kXRows = kT / (kBK / 4);  // x rows a pass
  float* xs = sm.x(s);
  if (a.xvec) {
    const int c = threadIdx.x % (kBK / 4);
    const int gk = kb + 4 * c;
    for (int r = threadIdx.x / (kBK / 4); r < BM; r += kXRows) {
      const bool in = m0 + r < a.m && gk < a.k;
      const float* src = a.x + static_cast<long long>(m0 + r) * a.k + gk;
      cp_async16(xs + r * kXS + 4 * c, in ? src : a.x, in ? 16 : 0);
    }
  }
  for (int i = threadIdx.x; !a.xvec && i < BM * (kBK / 4); i += kT) {
    const int c = i % (kBK / 4);
    const int r = i / (kBK / 4);
    const int gm = m0 + r;
    const int gk = kb + 4 * c;
    const long long src = static_cast<long long>(gm) * a.k + gk;
    for (int j = 0; j < 4; ++j) {
      xs[r * kXS + 4 * c + j] =
          (gm < a.m && gk + j < a.k) ? a.x[src + j] : 0.0f;
    }
  }
}

// s[j] += the pulse of byte j of the code word c (columns 4w + j), from
// table[valid * 32 + sign * 16 + pos]: per byte, (valid, sign) stay in bits
// 7..6 and pos goes to bits 5..2, which makes the byte offset of the entry.
__device__ __forceinline__ void add_pulses(float (&s)[4], uint32_t c,
                                           const float* table) {
  const uint32_t o = (c & 0xC0C0C0C0u) | ((c << 2) & 0x3C3C3C3Cu);
  const char* t = reinterpret_cast<const char*>(table);
  s[0] += *reinterpret_cast<const float*>(t + (o & 0xFFu));
  s[1] += *reinterpret_cast<const float*>(t + __byte_perm(o, 0, 0x4441));
  s[2] += *reinterpret_cast<const float*>(t + __byte_perm(o, 0, 0x4442));
  s[3] += *reinterpret_cast<const float*>(t + (o >> 24));
}

// v[j] *= 2^e, e the int8 in byte j of ew, from etab[byte] (exact,
// subnormal scales included)
__device__ __forceinline__ void scale(float (&v)[4], uint32_t ew,
                                      const float* etab) {
  v[0] *= etab[ew & 0xFFu];
  v[1] *= etab[__byte_perm(ew, 0, 0x4441)];
  v[2] *= etab[__byte_perm(ew, 0, 0x4442)];
  v[3] *= etab[ew >> 24];
}

// whether a byte of ew is 0x80..0x8F, an exponent -128..-113
static_assert(kMinTensorExp == -112, "has_tiny_exp tests the bytes 0x8?");
__device__ __forceinline__ bool has_tiny_exp(uint32_t ew) {
  return __vcmpeq4(ew & 0xF0F0F0F0u, 0x80808080u) != 0;
}

// M > 16: decode step `kt` (ring slot `s`) into registers: thread (i, q) =
// (tid % 8, tid / 8) decodes rows 4i .. 4i + 3 of columns 4q .. 4q + 3, 4
// planes at a time (16 independent table loads for each).  Returns whether
// it saw a group exponent below kMinTensorExp.
struct Decoded {
  float v[4][4];  // v[i][j]: row 4i + i', column 4q + j
};

template <int BM>
__device__ __forceinline__ bool decode_wt(const Args& a, const Smem<BM>& sm,
                                          int kt, int s, Decoded& d) {
  static_assert(!Tile<BM>::kSmall, "the small tiles decode into fragments");
  const int i4 = threadIdx.x & 7, q = threadIdx.x >> 3;
  const int kb = kt * kBK;
  const uint8_t* cs = sm.codes(s);
  const int e_first = group_of(a, kb);
  uint32_t ew[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // rows of a 4-aligned block share a group
    ew[i] = i > 0 && a.group % 4 == 0
                ? ew[0]
                : *reinterpret_cast<const uint32_t*>(
                      sm.exps(s) +
                      (group_of(a, min(kb + 4 * i4 + i, a.k - 1)) - e_first) *
                          kBN +
                      4 * q);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) d.v[i][j] = 0.0f;
  }
  for (int p0 = 0; p0 < a.planes; p0 += 4) {
    uint32_t c[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a missing plane reads as null codes
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[j][i] = p0 + j < a.planes
                      ? *reinterpret_cast<const uint32_t*>(
                            cs + cidx<BM>((p0 + j) * kBK + 4 * i4 + i, q))
                      : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) add_pulses(d.v[i], c[j][i], sm.table);
    }
  }
  bool tiny = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    scale(d.v[i], ew[i], sm.etab);
    tiny |= has_tiny_exp(ew[i]);
  }
  return tiny;
}

// Write a thread's decoded weights into the W^T tiles: row n holds the
// step's 32 weights of column n, 128 bytes, its 16-byte chunk c stored at
// c ^ (n % 8) (the 128-byte swizzle); each column's 4 weights, hi and lo,
// go as one 16-byte chunk.
template <int BM>
__device__ __forceinline__ void store_wt(const Smem<BM>& sm, const Decoded& d,
                                         int b) {
  const int i4 = threadIdx.x & 7, q = threadIdx.x >> 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = 4 * q + j;
    const int off = n * kBK + ((i4 ^ (n & 7)) << 2);
    const float4 hi = make_float4(__uint_as_float(rna_tf32(d.v[0][j])),
                                  __uint_as_float(rna_tf32(d.v[1][j])),
                                  __uint_as_float(rna_tf32(d.v[2][j])),
                                  __uint_as_float(rna_tf32(d.v[3][j])));
    *reinterpret_cast<float4*>(sm.whi(b) + off) = hi;
    *reinterpret_cast<float4*>(sm.wlo(b) + off) =
        make_float4(d.v[0][j] - hi.x, d.v[1][j] - hi.y, d.v[2][j] - hi.z,
                    d.v[3][j] - hi.w);
  }
  // the tiles are read by wgmma, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// M <= 16: y^T (BN x BM) += W^T x^T.  Warp (wn, kh) owns columns
// wn * 32 .. + 31 and the step's rows kh * 16 .. + 15, two 8-row chunks.
// Each lane decodes the weights of its own MMA fragments straight from the
// code words, once per block: lane (g, t) reads the words of columns
// 4g .. 4g + 3 (of the warp's 32) in rows t and t + 4 of a chunk, which
// make the A fragments (W^T, 16 x 8) of two MMA tiles, tile 0 holding
// columns 4g and 4g + 1 as fragment rows g and g + 8, tile 1 columns
// 4g + 2 and 4g + 3.  A C fragment then holds, for x row mt * 8 + 2t (+ 1),
// those same columns.  `part` is the step's fresh accumulator, which the
// three products of both chunks go into.
template <int BM>
using SmallPart = float[2][Tile<BM>::kMT][4];

// Decode and multiply 8-row chunk `kc` (0..3) of slot `s` (step kt).
template <int BM>
__device__ __forceinline__ void small_chunk(const Args& a, const Smem<BM>& sm,
                                            int kt, int s, int kc,
                                            SmallPart<BM>& part) {
  constexpr int MT = Tile<BM>::kMT;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int word = ((threadIdx.x >> 5) & 3) * 8 + g;  // columns 4 word ..
  const int kb = kt * kBK;
  const int r0 = kc * 8 + t, r1 = r0 + 4;
  const int e_first = group_of(a, kb);
  const uint32_t ew0 = *reinterpret_cast<const uint32_t*>(
      sm.exps(s) + (group_of(a, min(kb + r0, a.k - 1)) - e_first) * kBN +
      4 * word);
  // rows r0 and r1 = r0 + 4 of an 8-row chunk (8-aligned in K) share their
  // group when group is a multiple of 8
  const uint32_t ew1 =
      a.group % 8 == 0
          ? ew0
          : *reinterpret_cast<const uint32_t*>(
                sm.exps(s) +
                (group_of(a, min(kb + r1, a.k - 1)) - e_first) * kBN +
                4 * word);
  const uint8_t* cs = sm.codes(s);
  float u[4] = {}, v[4] = {};  // rows r0, r1 of columns 4 word + j
  for (int p0 = 0; p0 < a.planes; p0 += 4) {
    uint32_t c0[4], c1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a missing plane reads as null codes
      const bool in = p0 + j < a.planes;
      c0[j] = in ? *reinterpret_cast<const uint32_t*>(
                       cs + cidx<BM>((p0 + j) * kBK + r0, word))
                 : 0u;
      c1[j] = in ? *reinterpret_cast<const uint32_t*>(
                       cs + cidx<BM>((p0 + j) * kBK + r1, word))
                 : 0u;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      add_pulses(u, c0[j], sm.table);
      add_pulses(v, c1[j], sm.table);
    }
  }
  scale(u, ew0, sm.etab);
  scale(v, ew1, sm.etab);
  const float* xs = sm.x(s);
  // an exponent below kMinTensorExp anywhere in the warp's chunk: the
  // warp takes the CUDA-core route for it
  const bool tiny =
      __any_sync(0xFFFFFFFFu, has_tiny_exp(ew0) || has_tiny_exp(ew1));
  if (!tiny) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int tile = 0; tile < 2; ++tile) {
      split_w(u[2 * tile], ah[tile][0], al[tile][0]);
      split_w(u[2 * tile + 1], ah[tile][1], al[tile][1]);
      split_w(v[2 * tile], ah[tile][2], al[tile][2]);
      split_w(v[2 * tile + 1], ah[tile][3], al[tile][3]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int xo = (mt * 8 + g) * kXS + kc * 8 + t;
      uint32_t bh[2], bl[2];
      split_x(xs[xo], bh[0], bl[0]);
      split_x(xs[xo + 4], bh[1], bl[1]);
#pragma unroll
      for (int tile = 0; tile < 2; ++tile) {
        mma_3xtf32(part[tile][mt], ah[tile], al[tile], bh, bl);
      }
    }
  } else {
    // FMA over the lane's two rows, then the sum over the four lanes of a
    // quad (rows t = 0..3 and t + 4) in a fixed order; lane t keeps x rows
    // mt * 8 + 2t and + 1
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int mm = 0; mm < 8; ++mm) {
        const int row = mt * 8 + mm;
        const float x0 = xs[row * kXS + kc * 8 + t];
        const float x1 = xs[row * kXS + kc * 8 + t + 4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p = fmaf(x1, v[j], x0 * u[j]);
          p += __shfl_xor_sync(0xFFFFFFFFu, p, 1);
          p += __shfl_xor_sync(0xFFFFFFFFu, p, 2);
          if ((mm >> 1) == t) part[j >> 1][mt][(j & 1) * 2 + (mm & 1)] += p;
        }
      }
    }
  }
}

// M > 16: y (BM x BN) += x W.  Warpgroup w = warp / 4 owns rows
// (w / kWGN) * 64 .. + 63 and columns (w % kWGN) * kWN .. + kWN - 1; its
// warp u = warp % 4 rows u * 16 .. + 15 of those.  A thread's accumulator
// (wgmma's layout) holds, for each n8 tile t8, rows g and g + 8 of its
// warp's 16 and columns 8 t8 + 2t, 8 t8 + 2t + 1: acc[4 t8 + 2 h + e] is
// row g + 8h, column 8 t8 + 2t + e.

// d (+)= A B: A (64 x 8, TF32) from registers (each warp's 16 rows as in
// mma.m16n8k8), B (8 x N) from the W^T tile that `desc` points at; the
// sum replaces d when scale_d is 0.  Asynchronous: d and a may be touched
// only after wgmma_wait.
__device__ __forceinline__ void wgmma_tf32_n128(float* d, const uint32_t* a,
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a,
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}


__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving a register across the asynchronous
// product that reads or writes it
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)); }
__device__ __forceinline__ void pin(uint32_t& v) {
  asm volatile("" : "+r"(v));
}

// The shared-memory descriptor of a W^T tile at `tile` (1024-aligned):
// K-major, 128-byte swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wt_desc(const float* tile) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

template <int BM>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t desc, int scale_d) {
  if constexpr (Tile<BM>::kWN == 128) {
    wgmma_tf32_n128(d, a, desc, scale_d);
  } else {
    wgmma_tf32_n64(d, a, desc, scale_d);
  }
}

// The A fragments of a step: x_hi and x_lo of each 8-row chunk.
struct XFrags {
  uint32_t hi[kBK / 8][4], lo[kBK / 8][4];
};

// Issue the step's product on the tensor cores into `part` (replaced):
// x_hi w_lo + x_lo w_hi + x_hi w_hi for each 8-row chunk of the step, x
// split into `xf` as its fragments are loaded from ring slot `s`, w from
// W^T tile buffer `b`.  `part` and `xf` belong to the product until
// wgmma_done.
template <int BM>
__device__ __forceinline__ void wgmma_issue(const Smem<BM>& sm, int s, int b,
                            float (&part)[Tile<BM>::kAcc], XFrags& xf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int row = (wg / Tile<BM>::kWGN) * 64 + (warp & 3) * 16 + g;
  const int col0 = (wg % Tile<BM>::kWGN) * Tile<BM>::kWN;
  const float* xs = sm.x(s);
#pragma unroll
  for (int kc = 0; kc < kBK / 8; ++kc) {
    const int x0 = row * kXS + kc * 8 + t;
    const int x1 = x0 + 8 * kXS;
    split_x(xs[x0], xf.hi[kc][0], xf.lo[kc][0]);
    split_x(xs[x1], xf.hi[kc][1], xf.lo[kc][1]);
    split_x(xs[x0 + 4], xf.hi[kc][2], xf.lo[kc][2]);
    split_x(xs[x1 + 4], xf.hi[kc][3], xf.lo[kc][3]);
  }
  // a chunk of 8 rows is 32 bytes of a W^T row: 2 in the address field
  const uint64_t dhi = wt_desc(sm.whi(b) + col0 * kBK);
  const uint64_t dlo = wt_desc(sm.wlo(b) + col0 * kBK);
#pragma unroll
  for (int i = 0; i < Tile<BM>::kAcc; ++i) pin(part[i]);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < kBK / 8; ++kc) {
    wgmma_tf32<BM>(part, xf.hi[kc], dlo + 2 * kc, kc > 0);
    wgmma_tf32<BM>(part, xf.lo[kc], dhi + 2 * kc, 1);
    wgmma_tf32<BM>(part, xf.hi[kc], dhi + 2 * kc, 1);
  }
  wgmma_commit();
}

// Wait for the product that wgmma_issue started.
template <int BM>
__device__ __forceinline__ void wgmma_done(float (&part)[Tile<BM>::kAcc],
                                           XFrags& xf) {
  wgmma_wait();
#pragma unroll
  for (int i = 0; i < Tile<BM>::kAcc; ++i) pin(part[i]);
#pragma unroll
  for (int kc = 0; kc < kBK / 8; ++kc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pin(xf.hi[kc][e]);
      pin(xf.lo[kc][e]);
    }
  }
}

// The CUDA-core route of a whole step into `part` (replaced): FMA over x
// (ring slot `s`) and w_hi + w_lo (== w, tile buffer `b`), in the
// accumulator's layout.
template <int BM>
__device__ __forceinline__ void large_fma(const Smem<BM>& sm, int s, int b,
                          float (&part)[Tile<BM>::kAcc]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int row = (wg / Tile<BM>::kWGN) * 64 + (warp & 3) * 16 + g;
  const int col0 = (wg % Tile<BM>::kWGN) * Tile<BM>::kWN;
  const float* whi = sm.whi(b);
  const float* wlo = sm.wlo(b);
  const float* xs = sm.x(s);
#pragma unroll
  for (int i = 0; i < Tile<BM>::kAcc; ++i) {
    const int r = row + 8 * ((i >> 1) & 1);
    const int n = col0 + 8 * (i >> 2) + 2 * t + (i & 1);
    float v = 0.0f;
#pragma unroll 1
    for (int kk = 0; kk < kBK; ++kk) {
      const int w = n * kBK + ((((kk >> 2) ^ (n & 7)) << 2) | (kk & 3));
      v = fmaf(xs[r * kXS + kk], whi[w] + wlo[w], v);
    }
    part[i] = v;
  }
}

// Write one output of this block: to y without a split, else to the
// block's plane of the workspace.
__device__ __forceinline__ void put(const Args& a, int row, int col, float v) {
  if (row >= a.m || col >= a.n) return;
  const long long i = static_cast<long long>(row) * a.n + col;
  if (a.splits == 1) {
    a.out[i] = v;
  } else {
    __stcg(a.work + static_cast<long long>(blockIdx.z) * a.m * a.n + i, v);
  }
}

// The last block of a tile: y = the sum of the splits' partial tiles, in
// split order.  With float4-aligned rows (N a multiple of 4) a thread owns
// kVec float4 of the tile and keeps kVec * kU loads in flight (kU splits at
// a time, at most 8 float4), so the sum takes about splits / kU round trips
// to L2, not one per split and output.
template <int BM>
__device__ __forceinline__ void sum_partials(const Args& a, int m0, int n0) {
  constexpr int kT = Tile<BM>::kThreads;
  constexpr int kVec = BM * kBN / 4 / kT;
  constexpr int kU = kVec >= 8 ? 1 : 8 / kVec;
  const int rows = min(BM, a.m - m0);
  const long long plane = static_cast<long long>(a.m) * a.n;
  if (!a.ovec) {  // rows not float4-aligned
    for (int i = threadIdx.x; i < rows * kBN; i += kT) {
      const int col = n0 + i % kBN;
      if (col >= a.n) continue;
      const long long o = static_cast<long long>(m0 + i / kBN) * a.n + col;
      float v = 0.0f;
      for (int z = 0; z < a.splits; ++z) v += __ldcg(a.work + z * plane + o);
      a.out[o] = v;
    }
    return;
  }
  long long o[kVec];
  bool in[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int f = threadIdx.x + j * kT;  // float4 f of the tile
    const int col = n0 + 4 * (f % (kBN / 4));
    in[j] = f / (kBN / 4) < rows && col < a.n;
    o[j] = static_cast<long long>(m0 + f / (kBN / 4)) * a.n + col;
  }
  float4 v[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int z0 = 0; z0 < a.splits; z0 += kU) {
    float4 t[kU][kVec];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (in[j] && z0 + u < a.splits) {
          t[u][j] = __ldcg(reinterpret_cast<const float4*>(
              a.work + (z0 + u) * plane + o[j]));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (in[j] && z0 + u < a.splits) {
          v[j].x += t[u][j].x;
          v[j].y += t[u][j].y;
          v[j].z += t[u][j].z;
          v[j].w += t[u][j].w;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (in[j]) *reinterpret_cast<float4*>(a.out + o[j]) = v[j];
  }
}

// kStd: the instance for the standard operands (P = 4, group 32, rows
// 16-byte aligned), whose loops and addresses the compiler fixes; the other
// instance takes any operands.
template <int BM, bool kStd>
__global__ void __launch_bounds__(Tile<BM>::kThreads,
                                  Tile<BM>::kSmall ? 4 : 1)
blmac_pulse_matmul_kernel(Args args) {
  using T = Tile<BM>;
  Args a = args;
  if constexpr (kStd) {
    a.planes = 4;
    a.group = 32;
    a.gshift = 5;
    a.xvec = a.cvec = a.ovec = true;
  }
  const int S = a.stages;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  const Smem<BM> sm(smem, a.planes, a.group);

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int k_tiles = (a.k + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * a.per;
  const int nk = min(kt0 + a.per, k_tiles) - kt0;

  if (threadIdx.x < 64) {  // table[valid * 32 + sign * 16 + pos]
    const int pos = threadIdx.x & 15;
    const float v = __int_as_float((pos - 14 + 127) << 23);
    sm.table[threadIdx.x] =
        threadIdx.x < 32 ? 0.0f : (threadIdx.x & 16 ? -v : v);
  }
  for (int i = threadIdx.x; i < 256; i += T::kThreads) {
    sm.etab[i] = exp2_int(static_cast<int8_t>(i));  // etab[byte] = 2^(int8)
  }
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load_stage<BM>(a, sm, kt0 + s, s, n0, m0);
    cp_async_commit();
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (T::kSmall) {
    // Step `it` decodes and multiplies ring slot it % S while steps
    // it + 1 .. it + S - 2 are in flight.  One barrier a step.
    float acc[2][T::kMT][4] = {};
    const int kh = warp >> 2;
    int slot = 0;  // it % S
    for (int it = 0; it < nk; ++it) {
      const int free = slot == 0 ? S - 1 : slot - 1;  // (it + S - 1) % S
      cp_async_wait(S - 2);
      __syncthreads();  // step it has landed, step it - 1 is consumed
      if (it + S - 1 < nk) {
        load_stage<BM>(a, sm, kt0 + it + S - 1, free, n0, m0);
      }
      cp_async_commit();
      float part[2][T::kMT][4] = {};
      small_chunk<BM>(a, sm, kt0 + it, slot, 2 * kh, part);
      small_chunk<BM>(a, sm, kt0 + it, slot, 2 * kh + 1, part);
#pragma unroll
      for (int tile = 0; tile < 2; ++tile) {
#pragma unroll
        for (int mt = 0; mt < T::kMT; ++mt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[tile][mt][c] += part[tile][mt][c];
          }
        }
      }
      slot = slot + 1 == S ? 0 : slot + 1;
    }
    cp_async_wait<0>();
    // add the K half of warps 4..7 to warps 0..3, in that order
    __syncthreads();
    constexpr int kAcc = 2 * T::kMT * 4;
    float* red = reinterpret_cast<float*>(sm.ring);
    if (kh == 1) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        red[((warp - 4) * kAcc + i) * 32 + lane] = (&acc[0][0][0])[i];
      }
    }
    __syncthreads();
    if (kh == 0) {
#pragma unroll
      for (int tile = 0; tile < 2; ++tile) {
#pragma unroll
        for (int mt = 0; mt < T::kMT; ++mt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = (tile * T::kMT + mt) * 4 + c;
            put(a, m0 + mt * 8 + 2 * t + (c & 1),
                n0 + warp * 32 + 4 * g + 2 * tile + (c >> 1),
                acc[tile][mt][c] + red[(warp * kAcc + i) * 32 + lane]);
          }
        }
      }
    }
  } else {
    float acc[T::kAcc] = {};
    float part[T::kAcc] = {};
    // Step `it` multiplies ring slot it % S through W^T tile buffer it % 2,
    // which the previous iteration wrote; while its wgmmas run, this
    // iteration decodes step it + 1 and writes it to the other buffer;
    // steps it + 2 .. it + S - 1 are in flight.  One barrier a step.
    cp_async_wait(S - 2);
    __syncthreads();  // step 0 and the tables are in shared memory
    Decoded d;
    bool tiny = decode_wt<BM>(a, sm, kt0, 0, d);
    store_wt<BM>(sm, d, 0);
    cp_async_wait(S - 3);
    // step 0 is in buffer 0 and step 1 has landed; whether step 0 takes
    // the CUDA cores, uniformly
    bool cuda_cores = __syncthreads_or(tiny);
    int slot = 0;  // it % S
    for (int it = 0; it < nk; ++it) {
      const int next = slot + 1 == S ? 0 : slot + 1;  // (it + 1) % S
      const int free = slot == 0 ? S - 1 : slot - 1;  // (it + S - 1) % S
      // The wgmmas are issued and awaited on every step, outside any
      // branch (ptxas serialises wgmmas on a path it cannot prove uniform);
      // a step on the CUDA cores then replaces their sum.
      XFrags xf;
      wgmma_issue<BM>(sm, slot, it & 1, part, xf);
      tiny = false;
      if (it + 1 < nk) {
        tiny = decode_wt<BM>(a, sm, kt0 + it + 1, next, d);
        store_wt<BM>(sm, d, (it + 1) & 1);
      }
      // the next stage's loads go out after store_wt and its proxy fence
      // (a memory barrier in the SASS)
      if (it + S - 1 < nk) {
        load_stage<BM>(a, sm, kt0 + it + S - 1, free, n0, m0);
      }
      cp_async_commit();
      wgmma_done<BM>(part, xf);
      if (cuda_cores) large_fma<BM>(sm, slot, it & 1, part);
#pragma unroll
      for (int i = 0; i < T::kAcc; ++i) acc[i] += part[i];
      cp_async_wait(S - 3);
      // step it + 1 is in the other buffer, step it + 2 has landed, and
      // every read of step it's slot and buffer is done
      cuda_cores = __syncthreads_or(tiny);
      slot = next;
    }
    cp_async_wait<0>();
    const int wg = warp >> 2;
    const int r0 = m0 + (wg / T::kWGN) * 64 + (warp & 3) * 16 + g;
    const int c0 = n0 + (wg % T::kWGN) * T::kWN + 2 * t;
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) {
      put(a, r0 + 8 * ((i >> 1) & 1), c0 + 8 * (i >> 2) + (i & 1), acc[i]);
    }
  }
  if (a.splits == 1) return;

  // the last block of this output tile adds the partials in split order
  __threadfence();
  __syncthreads();
  unsigned* ticket = a.counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) {
    // the tile's ticket wraps to 0 as the last block draws it: the counter
    // is zero again for the next launch before any partial is read
    last_block = atomicInc(ticket, a.splits - 1) == a.splits - 1u;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  sum_partials<BM>(a, m0, n0);
}

// The kernel's dynamic shared-memory limit, raised per device and instance
// to the most that a launch has asked for.
template <int BM, bool kStd>
cudaError_t configure(int smem) {
  static int granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && smem <= granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(blmac_pulse_matmul_kernel<BM, kStd>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < 64) granted[dev] = smem;
  return e;
}

template <int BM, bool kStd>
int launch_instance(const Args& a, cudaStream_t stream) {
  const int smem = smem_bytes(BM, a.planes, a.group, a.stages);
  const cudaError_t e = configure<BM, kStd>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.n + kBN - 1) / kBN, (a.m + BM - 1) / BM, a.splits);
  blmac_pulse_matmul_kernel<BM, kStd>
      <<<grid, Tile<BM>::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch(const Args& a, cudaStream_t stream) {
  const bool standard = a.planes == 4 && a.group == 32 && a.xvec && a.cvec &&
                        a.ovec;
  return standard ? launch_instance<BM, true>(a, stream)
                  : launch_instance<BM, false>(a, stream);
}

bool valid_bm(int bm) { return bm == 8 || bm == 16 || bm == 64 || bm == 128; }

}  // namespace

// Dynamic shared memory of one block of tile `bm` (8, 16, 64 or 128) at
// `planes` and `group` with a ring of `stages`.
extern "C" int blmac_pulse_matmul_smem_bytes(int bm, int planes, int group,
                                             int stages) {
  return smem_bytes(bm, planes, group, stages);
}

// CUDA's ID of `stream` into `*id`, unique among the process's streams
// (a handle's value may come back for a later stream; the ID does not):
// the wrapper keys a stream's split-K tickets by it.  Returns the error.
extern "C" int blmac_stream_id(void* stream, unsigned long long* id) {
  return static_cast<int>(
      cudaStreamGetId(static_cast<cudaStream_t>(stream), id));
}

// Launch y = x @ decode(codes[:planes], gexp) on `stream`, one kernel.
// `x` float32 (m, k) contiguous; `codes` uint8 (>= planes, k, n) contiguous;
// `gexp` int8 (k / group, n) contiguous; `out` float32 (m, n).  `bm` (8 or
// 16: swapped small-M tile; 64 or 128) is the block's row count; each block
// walks `per` steps of 32 rows of K, so the grid has splits = ceil(ceil(k /
// 32) / per) blocks along K; its ring has `stages` (3 to 8) stages.  With
// more than one split, `workspace` is float32 (splits, m, n) and `counters`
// int32, one per output tile (ceil(n / 128) * ceil(m / bm)), zero before the
// launch and zero after it; the launch must be ordered with every other
// that uses the same counters.  The launch runs on CUDA device `device`
// (that of the operands and of `stream`), made current for the call and
// restored after it.  Returns cudaGetLastError() after the launch.
extern "C" int blmac_pulse_matmul_launch(const void* x, const void* codes,
                                         const void* gexp, void* workspace,
                                         void* counters, void* out, int m,
                                         int n, int k, int planes, int group,
                                         int bm, int per, int stages,
                                         void* stream, int device) {
  if (m <= 0 || n <= 0 || k <= 0 || planes < 1 || planes > 16 || group <= 0 ||
      k % group != 0 || per <= 0 || !valid_bm(bm) || stages < 3 ||
      stages > kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = static_cast<const float*>(x);
  a.codes = static_cast<const uint8_t*>(codes);
  a.gexp = static_cast<const int8_t*>(gexp);
  a.work = static_cast<float*>(workspace);
  a.counters = static_cast<unsigned*>(counters);
  a.out = static_cast<float*>(out);
  a.m = m;
  a.n = n;
  a.k = k;
  a.planes = planes;
  a.group = group;
  a.per = per;
  a.stages = stages;
  a.gshift = (group & (group - 1)) == 0 ? __builtin_ctz(group) : -1;
  const int k_tiles = (k + kBK - 1) / kBK;
  a.splits = (k_tiles + per - 1) / per;
  a.xvec = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.cvec = n % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(gexp) % 16 == 0;
  a.ovec = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(workspace) % 16 == 0;
  if (a.splits > 1 && (workspace == nullptr || counters == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* s = static_cast<cudaStream_t>(stream);
  int err;
  switch (bm) {
    case 8: err = launch<8>(a, s); break;
    case 16: err = launch<16>(a, s); break;
    case 64: err = launch<64>(a, s); break;
    default: err = launch<128>(a, s); break;
  }
  if (current != device) cudaSetDevice(current);
  return err;
}
