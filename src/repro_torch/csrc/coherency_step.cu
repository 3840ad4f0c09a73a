// Coherency-step kernels for Hopper (sm_90a): the per-step inner plane of
// the N-remote engine (repro_torch.core.engine_mn, traffic.counters).
//
// Six integer kernels with a plain C interface (and an empty one, timed as
// a launch's floor), built by nvcc into a shared library and bound with
// ctypes (repro_torch/kernels/build.py,
// repro_torch/kernels/coherency_step.py).  Every entry point launches on
// the caller's stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// They replace the Pallas kernels of src/repro/kernels/coherency_step.py.
// Those were shaped for the TPU's matrix unit (a cumsum as two integer
// matmuls against iota masks, an argmin as encode/min/decode); here they
// are what the planes are: scans, per-line selects and histograms over
// small integer planes, and bitwise passes over the packed directory
// words.  All six move a few bytes per element and do a handful of
// integer operations on each, so each is bound by memory traffic — and
// at the engine's per-step sizes (at most [64, 4096]) by launch latency
// first.  The designs below read each input once at the engine's
// shapes, and each call is one device operation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// --------------------------------------------------------------------------
// Byte planes read 16 lanes at a time (credit_rank, count_fold).
//
// A plane of bool or int8 lanes is read as 16-byte vectors laid on the
// memory's 16-byte grid, not on the row's start: with h the lanes before
// the row's first 16-byte edge (0 for an aligned row), group k covers
// lanes [g0 + 16k, g0 + 16k + 16), g0 = h - 16 (0 when h = 0).  So a head
// [0, h) and a ragged tail are partial groups, read one lane at a time and
// zero outside the row.  Planes that do not share their alignment are
// read one lane at a time throughout.
// --------------------------------------------------------------------------

struct Groups {
  long long g0;      // the first lane of group 0, in (-16, 0]
  long long count;   // groups that cover [0, n)
  bool vec;          // the planes share their 16-byte alignment
};

__host__ __device__ inline Groups groups16(const void* p, bool vec,
                                           long long n) {
  const long long h = (16 - ((uintptr_t)p & 15)) & 15;
  Groups g;
  g.vec = vec;
  g.g0 = (vec && h != 0) ? h - 16 : 0;
  g.count = n > 0 ? (n - g.g0 + 15) / 16 : 0;
  return g;
}

__host__ __device__ inline bool same_align(const void* a, const void* b) {
  return (((uintptr_t)a ^ (uintptr_t)b) & 15) == 0;
}

__device__ __forceinline__ uint4 ld16(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Lanes [lo, lo + 16) of p one at a time, zero outside [0, n).
__device__ __forceinline__ uint4 lanes16(const uint8_t* __restrict__ p,
                                         long long lo, long long n) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const long long l = lo + e;
    if (l >= 0 && l < n) w[e >> 2] |= (uint32_t)p[l] << (8 * (e & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 16 lanes of a group of bool bytes (each 0 or 1) as 16 bits: the
// product gathers a word's four bytes into its top nibble.
__device__ __forceinline__ uint32_t bits16(const uint4& v) {
  constexpr uint32_t kGather = 0x10204080u;
  return ((v.x * kGather) >> 28) | (((v.y * kGather) >> 28) << 4) |
         (((v.z * kGather) >> 28) << 8) | (((v.w * kGather) >> 28) << 12);
}

// --------------------------------------------------------------------------
// credit_rank (replaces credit_rank, src/repro/kernels/coherency_step.py:99)
//
// out[r, l] = occupancy of line l's odd/even VC in row r
//           + number of candidates before l in row r on the same parity.
//
// Bound: bytes, 2 in and 4 out per lane; at the engine's [64, 4096] that
// is 1.5 MB, 0.47 us at 3.35 TB/s, so the time is the launch and one trip
// to memory.  One CTA per row segment of kRankThreads 16-lane groups (a
// whole row at L = 4096).  Each thread owns one group: one 16-byte load of
// `active` and one of `cand`, kept in registers as 16-bit masks.  Every
// group starts at an even offset from g0, so lanes at even offsets in a
// group (class X) share one VC and the others (class Y) the other; the
// per-parity counts are __popc of the masks with 0x5555 and 0xAAAA.  The
// block sums the occupancies with __reduce_add_sync and scans the
// candidate counts with warp shuffles and one pass over the warps'
// totals in shared memory; a lane's result is its class's occupancy, the
// candidates before its group, and a __popc of its group's earlier
// candidates.  The results go through shared memory so that each warp
// stores 512 contiguous bytes (a thread's own 64 bytes as four 16-byte
// stores measured 1.7x slower: PERF.md); a segment that is not one
// aligned run of whole groups stores them from each thread.
//
// A row longer than one segment is split over several CTAs; each reads,
// besides its own segment, the other segments' `active` lanes (the
// occupancy) and the earlier segments' `cand` lanes (its prefix).  (A
// cluster of 2 CTAs per row exchanging the totals through distributed
// shared memory, and 128-thread CTAs of 32 lanes a thread, measured
// slower at L = 4096: PERF.md.)
// --------------------------------------------------------------------------

constexpr int kRankThreads = 256;

// Group k of a row plane as 16 bits.
__device__ __forceinline__ uint32_t rank_bits(const uint8_t* __restrict__ p,
                                              const Groups& g, long long k,
                                              int L) {
  const long long lo = g.g0 + 16 * k;
  return bits16((g.vec && lo >= 0 && lo + 16 <= L) ? ld16(p + lo)
                                                   : lanes16(p, lo, L));
}

template <int T>
__global__ void __launch_bounds__(T)
credit_rank_kernel(const uint8_t* __restrict__ active,
                   const uint8_t* __restrict__ cand,
                   int32_t* __restrict__ out, int L) {
  constexpr int kW = T / 32;
  constexpr uint32_t kX = 0x5555u, kY = 0xAAAAu;
  __shared__ int s_red[6][kW];
  __shared__ int4 s_out[4][T + 2];      // padded: no bank conflicts
  const int row = blockIdx.x, seg = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const uint8_t* a = active + (size_t)row * L;
  const uint8_t* c = cand + (size_t)row * L;
  int32_t* o = out + (size_t)row * L;
  const Groups g = groups16(a, same_align(a, c), L);
  const long long k = (long long)seg * T + tid;

  const uint32_t am = rank_bits(a, g, k, L);
  const uint32_t cm = rank_bits(c, g, k, L);
  int ox = __popc(am & kX), oy = __popc(am & kY);
  const int cx = __popc(cm & kX), cy = __popc(cm & kY);
  int px = 0, py = 0;                   // candidates of earlier segments
  for (int s = 0; s < (int)gridDim.y; ++s) {
    if (s == seg) continue;
    const long long ks = (long long)s * T + tid;
    const uint32_t as = rank_bits(a, g, ks, L);
    ox += __popc(as & kX);
    oy += __popc(as & kY);
    if (s < seg) {
      const uint32_t cs = rank_bits(c, g, ks, L);
      px += __popc(cs & kX);
      py += __popc(cs & kY);
    }
  }

  int ix = cx, iy = cy;                 // inclusive scans in the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int ux = __shfl_up_sync(kFull, ix, d);
    const int uy = __shfl_up_sync(kFull, iy, d);
    if (lane >= d) {
      ix += ux;
      iy += uy;
    }
  }
  const int rox = __reduce_add_sync(kFull, ox);
  const int roy = __reduce_add_sync(kFull, oy);
  const int rpx = __reduce_add_sync(kFull, px);
  const int rpy = __reduce_add_sync(kFull, py);
  if (lane == 0) {
    s_red[0][warp] = rox;
    s_red[1][warp] = roy;
    s_red[2][warp] = rpx;
    s_red[3][warp] = rpy;
  }
  if (lane == 31) {
    s_red[4][warp] = ix;
    s_red[5][warp] = iy;
  }
  __syncthreads();
  int vx = ix - cx, vy = iy - cy;       // X and Y lanes before my group
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    vx += s_red[0][w] + s_red[2][w] + (w < warp ? s_red[4][w] : 0);
    vy += s_red[1][w] + s_red[3][w] + (w < warp ? s_red[5][w] : 0);
  }

  int32_t res[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t below = cm & ((1u << j) - 1u);
    res[j] = (j & 1) ? vy + __popc(below & kY) : vx + __popc(below & kX);
  }

  const long long lo = g.g0 + 16 * ((long long)seg * T);
  if (g.vec && lo >= 0 && lo + 16LL * T <= L &&
      ((uintptr_t)(o + lo) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      s_out[q][tid] = make_int4(res[4 * q], res[4 * q + 1], res[4 * q + 2],
                                res[4 * q + 3]);
    __syncthreads();
    int4* d = reinterpret_cast<int4*>(o + lo);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + T * u;        // 16-byte vector i of the segment
      d[i] = s_out[i & 3][i >> 2];
    }
    return;
  }
  const long long mine = g.g0 + 16 * k;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const long long l = mine + e;
    if (l >= 0 && l < L) o[l] = res[e];
  }
}

// --------------------------------------------------------------------------
// arb_winner (replaces arb_winner, coherency_step.py:130)
//
// winner[b, l] = the ready participant p of minimum (p - rr[b, l]) mod P,
// the lowest id among ties (ties occur only at the not-ready fill value P,
// so a line with no ready participant gives 0 — jnp.argmin's rule).
//
// As the Pallas kernel, it reduces one integer key per (participant,
// line), score * (P + 1) + p with score = P for a participant that is not
// ready, so one min gives both the winner and the tie rule.  The pointer
// is brought into [0, P) once per line (r0), and the priority is then
// p - r0 + (p < r0 ? P : 0): no division in the loop.  The work spreads
// both ways: each thread takes 4 neighbouring lines, reading each
// participant row's 4 ready bytes in one 32-bit load (byte loads when L is
// not a multiple of 4, so the rows are not 4-byte aligned); a warp is 8
// such threads across 32 lines times 4 participant rows; the block's 4
// warps take every 16th participant each, then combine in shared memory.
// A block covers 32 lines, so L = 4096 gives 128 blocks per leading row
// (the leading axis, the multi-home fold, is the grid's y).  Bound: P
// bytes + 4 bytes in, 4 bytes out per line — at the engine's sizes,
// launch latency.
// --------------------------------------------------------------------------

constexpr int kArbLines = 32, kArbWarps = 4;

template <bool kVec>
__global__ void __launch_bounds__(kArbWarps * 32)
arb_winner_kernel(const uint8_t* __restrict__ ready,
                  const int32_t* __restrict__ rr, int32_t* __restrict__ out,
                  int P, int L) {
  __shared__ int s_key[kArbWarps][kArbLines];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lg = lane & 7, po = lane >> 3;   // line group, row in the warp
  const int l0 = blockIdx.x * kArbLines + 4 * lg;
  const uint8_t* rd = ready + (size_t)b * P * L;
  const int32_t* rp = rr + (size_t)b * L;
  int r0[4], key[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = l0 + e < L ? rp[l0 + e] : 0;
    r0[e] = (r % P + P) % P;                 // the floor modulo, once
    key[e] = P * (P + 1) + P;                // above every real key
  }
  const int fill = P * (P + 1);              // score P: not ready
  for (int p = 4 * warp + po; p < P; p += 4 * kArbWarps) {
    const uint8_t* row = rd + (size_t)p * L + l0;
    uint32_t w = 0;
    if (kVec) {
      if (l0 < L) w = *reinterpret_cast<const uint32_t*>(row);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (l0 + e < L) w |= (uint32_t)row[e] << (8 * e);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int prio = p - r0[e] + (p < r0[e] ? P : 0);
      const int k = ((w >> (8 * e)) & 0xffu) ? prio * (P + 1) + p : fill + p;
      key[e] = min(key[e], k);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    key[e] = min(key[e], __shfl_xor_sync(0xffffffffu, key[e], 8));
    key[e] = min(key[e], __shfl_xor_sync(0xffffffffu, key[e], 16));
  }
  if (po == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s_key[warp][4 * lg + e] = key[e];
  }
  __syncthreads();
  const int l = blockIdx.x * kArbLines + threadIdx.x;
  if (threadIdx.x < kArbLines && l < L) {
    int k = s_key[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kArbWarps; ++w) k = min(k, s_key[w][threadIdx.x]);
    out[(size_t)b * L + l] = k % (P + 1);
  }
}

// --------------------------------------------------------------------------
// count_fold (replaces count_fold, coherency_step.py:193)
//
// out[0:16] = base[0:16] + histogram of msg under mask; out[16] = base[16]
// + count of masked lanes that carry a payload (no base: zero).  Codes
// outside 0..15 — the HOME_TXN sentinel 100, negative int8 — land in no
// bin.  Exact in int32.
//
// Grouped form: G groups of n lanes each, one after another; group g
// folds into its own row out[17 g .. 17 g + 16], onto its own base row
// (base_c + g * base_c_stride, base_p + g * base_p_stride: the last
// call's out, read where it lies), through its own 17 accumulators.  The grid's y axis is the group, so
// one launch folds every group, and G = 1 is the one-group launch.
//
// Bound: bytes, 3 in per lane; at the engine's [64, 4096] that is 786 kB,
// 0.235 us at 3.35 TB/s, so the time is the launch, one trip to memory
// and the reduction across CTAs.  Each thread issues its three 16-byte
// loads per 16-lane group up front and counts in registers with no
// branch on a loaded value: a lane's code becomes a shift of 4 * code
// (64 or more when it does not count), and 1 << shift lands in a 4-bit
// field of one of two words (bins 0..7, 8..15; a PTX shift of 32 or more
// gives 0), widened to byte fields once per group.  The 17 counts are
// summed across each warp with __reduce_add_sync and across the block in
// shared memory.
//
// The CTAs' sums meet in the same launch with nothing zeroed first: CTA
// b adds (1 << 40) + its sum for bin j to the 64-bit accumulator
// acc[j * stride] with one atomicAdd that returns the old value.  The
// add that brings the arrivals to the grid's size holds bin j's total
// (old + its own), so its CTA writes base + total and sets the
// accumulator back to 0 for the next launch: a ticket per bin, no fence
// and no second pass.  The wrapper puts each accumulator on a line of
// its own.  128-thread CTAs (128 at [64, 4096]) balance each CTA's loads
// against the arrivals at an accumulator.  A plane of kFoldThreads
// groups or fewer (2048 lanes) is one CTA and takes no atomic.
// (Measured slower, PERF.md: one grid-wide ticket whose last CTA sums
// every CTA's partials between two fences; one cluster of 16 CTAs summed
// through distributed shared memory; at [4096], one CTA of 256 threads
// measured the same as two of 128.)
// --------------------------------------------------------------------------

constexpr int kFoldBins = 17;
constexpr int kFoldThreads = 128;
constexpr int kFoldMaxCtas = 1024;   // below the arrival field's 2^24
constexpr int kFoldArrival = 40;     // acc: arrivals << 40 | sum

// 1 << s, and 0 for s >= 32: PTX clamps the shift amount.
__device__ __forceinline__ uint32_t shl1(uint32_t s) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(1u), "r"(s));
  return r;
}

// Adds the 4 lanes of mask word m and code word c to the nibble counters
// lo (bins 0..7) and hi (bins 8..15).  A lane's shift is 4 * code, plus
// 64 when it does not count: its code's high nibble is not 0 (16..127,
// or negative) or it is not masked.
__device__ __forceinline__ void fold_word(uint32_t m, uint32_t c,
                                          uint32_t& lo, uint32_t& hi) {
  const uint32_t high = (((c >> 4) & 0x0F0F0F0Fu) + 0x0F0F0F0Fu) &
                        0x10101010u;
  const uint32_t off = ((m ^ 0x01010101u) & 0x01010101u) << 4;
  const uint32_t s = ((c & 0x0F0F0F0Fu) | high | off) << 2;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t se = (s >> (8 * e)) & 0xffu;
    lo += shl1(se);
    hi += shl1(se ^ 32u);
  }
}

// One 16-lane group into the byte counters b (bins 0,2,4,6 | 1,3,5,7 |
// 8,10,12,14 | 9,11,13,15; each grows by at most 16) and the payload
// count.  Each nibble counter takes 8 lanes, at most 8.
__device__ __forceinline__ void fold_group(const uint4& m, const uint4& c,
                                           const uint4& p, uint32_t (&b)[4],
                                           int& pay) {
  uint32_t alo = 0, ahi = 0, blo = 0, bhi = 0;
  fold_word(m.x, c.x, alo, ahi);
  fold_word(m.y, c.y, alo, ahi);
  fold_word(m.z, c.z, blo, bhi);
  fold_word(m.w, c.w, blo, bhi);
  constexpr uint32_t kN = 0x0F0F0F0Fu;
  b[0] += (alo & kN) + (blo & kN);
  b[1] += ((alo >> 4) & kN) + ((blo >> 4) & kN);
  b[2] += (ahi & kN) + (bhi & kN);
  b[3] += ((ahi >> 4) & kN) + ((bhi >> 4) & kN);
  pay += __popc(m.x & p.x) + __popc(m.y & p.y) + __popc(m.z & p.z) +
         __popc(m.w & p.w);
}

__device__ __forceinline__ void fold_flush(uint32_t (&b)[4],
                                           int (&cnt)[kFoldBins]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cnt[2 * i] += (b[0] >> (8 * i)) & 0xff;
    cnt[2 * i + 1] += (b[1] >> (8 * i)) & 0xff;
    cnt[8 + 2 * i] += (b[2] >> (8 * i)) & 0xff;
    cnt[9 + 2 * i] += (b[3] >> (8 * i)) & 0xff;
  }
  b[0] = b[1] = b[2] = b[3] = 0u;
}

// This thread's counts over groups first, first + stride, ... of the
// flat planes.
__device__ __forceinline__ void fold_lanes(const uint8_t* __restrict__ mask,
                                           const uint8_t* __restrict__ msg,
                                           const uint8_t* __restrict__ pay,
                                           long long n, long long first,
                                           long long stride,
                                           int (&cnt)[kFoldBins]) {
  const Groups g = groups16(mask, same_align(mask, msg) &&
                                      same_align(mask, pay), n);
  uint32_t b[4] = {0u, 0u, 0u, 0u};
  int since = 0;                        // groups since the last flush
  for (long long k = first; k < g.count; k += stride) {
    const long long lo = g.g0 + 16 * k;
    uint4 m, c, p;
    if (g.vec && lo >= 0 && lo + 16 <= n) {
      m = ld16(mask + lo);
      c = ld16(msg + lo);
      p = ld16(pay + lo);
    } else {
      m = lanes16(mask, lo, n);
      c = lanes16(msg, lo, n);
      p = lanes16(pay, lo, n);
    }
    fold_group(m, c, p, b, cnt[16]);
    if (++since == 15) {                // byte counters stay below 256
      fold_flush(b, cnt);
      since = 0;
    }
  }
  fold_flush(b, cnt);
}

// The block's sum of v for bin tid (valid for tid < kFoldBins).
template <int T>
__device__ __forceinline__ int fold_block_sum(const int (&v)[kFoldBins],
                                              int (*part)[kFoldBins]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kFoldBins; ++j) {
    const int s = __reduce_add_sync(kFull, v[j]);
    if (lane == 0) part[warp][j] = s;
  }
  __syncthreads();
  int s = 0;
  if (threadIdx.x < kFoldBins) {
#pragma unroll
    for (int w = 0; w < T / 32; ++w) s += part[w][threadIdx.x];
  }
  return s;
}

__device__ __forceinline__ int fold_base(int j, const int32_t* base_c,
                                         const int32_t* base_p) {
  if (base_c == nullptr) return 0;
  return j < 16 ? base_c[j] : base_p[0];
}

template <int T>
__global__ void __launch_bounds__(T)
count_fold_kernel(const uint8_t* __restrict__ mask,
                  const uint8_t* __restrict__ msg,
                  const uint8_t* __restrict__ pay,
                  const int32_t* __restrict__ base_c,
                  const int32_t* __restrict__ base_p,
                  int32_t* __restrict__ out, long long n,
                  unsigned long long* __restrict__ acc, int stride,
                  long long base_c_stride, long long base_p_stride) {
  __shared__ int part[T / 32][kFoldBins];
  const int tid = threadIdx.x;
  // Group blockIdx.y: its n lanes, its row of out, base and accumulators
  // (a base row may be a strided view, such as the last call's out).
  const long long g = blockIdx.y;
  mask += g * n;
  msg += g * n;
  pay += g * n;
  out += g * kFoldBins;
  acc += g * kFoldBins * (long long)stride;
  if (base_c != nullptr) {
    base_c += g * base_c_stride;
    base_p += g * base_p_stride;
  }
  int cnt[kFoldBins] = {};
  fold_lanes(mask, msg, pay, n, (long long)blockIdx.x * T + tid,
             (long long)gridDim.x * T, cnt);
  const int tot = fold_block_sum<T>(cnt, part);
  if (tid >= kFoldBins) return;
  if (gridDim.x == 1) {
    out[tid] = tot + fold_base(tid, base_c, base_p);
    return;
  }
  constexpr unsigned long long kSum = (1ull << kFoldArrival) - 1;
  unsigned long long* a = acc + (size_t)tid * stride;
  const unsigned long long old =
      atomicAdd(a, (1ull << kFoldArrival) + (unsigned long long)tot);
  if ((old >> kFoldArrival) == gridDim.x - 1) {     // the last arrival
    out[tid] = (int)((old & kSum) + (unsigned long long)tot) +
               fold_base(tid, base_c, base_p);
    *a = 0ull;                                      // ready for the next
  }
}

// --------------------------------------------------------------------------
// lat_hist (replaces lat_hist, coherency_step.py:225)
//
// out[r, b] = number of retired lanes of row r whose latency falls in
// bucket b = sum_e (lat >= kLatEdges[e]); a negative latency lands in
// bucket 0.  The edges are LAT_EDGES of repro_torch/traffic/counters.py
// (engine steps), fixed at compile time.
//
// Bound: bytes, 5 in per lane and 40 out per row; at the engine's
// [64, 4096] that is 1.3 MB, 0.39 us at 3.35 TB/s, so the time is the
// launch and one trip to memory.  The design keeps it to one trip: every
// thread issues all its loads up front and unconditionally — 16 lanes as
// one 16-byte load of `retired` and four of `lat` — and counts in
// registers, with no branch on a loaded value and no shared atomics.
// Each thread keeps 10 running counts: the retired lanes at or above each
// edge and all its retired lanes; the bins are their differences.  One
// CTA per row sums them across each warp with __reduce_add_sync and
// across its warps in shared memory.  (Clusters of 2 and 4 CTAs per row,
// summed through distributed shared memory, measured slower: PERF.md.)
// Lanes outside the 16-byte-aligned body of a row (L % 16, a storage
// offset) are read one at a time.
// --------------------------------------------------------------------------

constexpr int kLatEdges = 9;
constexpr int kLatBins = kLatEdges + 1;
constexpr int kLatThreads = 256;
constexpr int kLatWarps = kLatThreads / 32;

// ge[e] += (lane retired and v >= edge e); ge[kLatEdges] += retired.
__device__ __forceinline__ void lat_count(int32_t v, uint32_t r,
                                          int (&ge)[kLatBins]) {
  const int32_t edges[kLatEdges] = {1, 2, 4, 8, 16, 32, 64, 128, 256};
#pragma unroll
  for (int e = 0; e < kLatEdges; ++e) ge[e] += (int)(r & (v >= edges[e]));
  ge[kLatEdges] += (int)r;
}

// The 4 lanes of a 32-bit word of `retired`, with lat in v.
__device__ __forceinline__ void lat_count4(const int4& v, uint32_t w,
                                           int (&ge)[kLatBins]) {
  lat_count(v.x, (w & 0xffu) != 0, ge);
  lat_count(v.y, (w & 0xff00u) != 0, ge);
  lat_count(v.z, (w & 0xff0000u) != 0, ge);
  lat_count(v.w, (w & 0xff000000u) != 0, ge);
}

__global__ void __launch_bounds__(kLatThreads)
lat_hist_kernel(const int32_t* __restrict__ lat,
                const uint8_t* __restrict__ retired,
                int32_t* __restrict__ out, int L) {
  __shared__ int part[kLatWarps][kLatBins];
  const int row = blockIdx.x;
  const int32_t* lt = lat + (size_t)row * L;
  const uint8_t* rt = retired + (size_t)row * L;
  // The body starts where rt is 16-byte aligned, if lt is there too.
  int head = (int)((16 - ((uintptr_t)rt & 15)) & 15);
  if (head > L) head = L;
  if ((uintptr_t)(lt + head) & 15) head = L;       // no common alignment
  const int groups = (L - head) >> 4;
  const int tail = head + (groups << 4);

  int ge[kLatBins] = {};
  const uint4* r16 = reinterpret_cast<const uint4*>(rt + head);
  const int4* l16 = reinterpret_cast<const int4*>(lt + head);
  for (int g = threadIdx.x; g < groups; g += kLatThreads) {
    const uint4 r = r16[g];
    const int4 v0 = l16[4 * g], v1 = l16[4 * g + 1], v2 = l16[4 * g + 2],
               v3 = l16[4 * g + 3];
    lat_count4(v0, r.x, ge);
    lat_count4(v1, r.y, ge);
    lat_count4(v2, r.z, ge);
    lat_count4(v3, r.w, ge);
  }
  const int scalar = head + (L - tail);   // lanes [0, head) and [tail, L)
  for (int i = threadIdx.x; i < scalar; i += kLatThreads) {
    const int l = i < head ? i : tail + (i - head);
    lat_count(lt[l], rt[l] != 0, ge);
  }

  // Bins from the running counts, then the sums.
  int bin[kLatBins];
  bin[0] = ge[kLatEdges] - ge[0];
#pragma unroll
  for (int b = 1; b < kLatEdges; ++b) bin[b] = ge[b - 1] - ge[b];
  bin[kLatEdges] = ge[kLatEdges - 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < kLatBins; ++b) {
    const int s = (int)__reduce_add_sync(0xffffffffu, (unsigned)bin[b]);
    if (lane == 0) part[warp][b] = s;
  }
  __syncthreads();
  if (threadIdx.x < kLatBins) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kLatWarps; ++w) s += part[w][threadIdx.x];
    out[(size_t)row * kLatBins + threadIdx.x] = s;
  }
}

// --------------------------------------------------------------------------
// Word planes where they lie (packed_any, packed_fanout).
//
// A packed word plane is [..., L, W] int32 with its last two dims dense and
// its leading dims collapsed into one axis of [L, W] blocks at a stride of
// the plane's own (the wrapper's plane_stride).  So a slice [..., p, :, :]
// of the packed [H, 2, L/H, W] view or pending mask is read where it lies,
// at stride 2 * (L/H) * W, and a contiguous plane at stride L * W: the
// engine's fold copies no plane out for these kernels.
// --------------------------------------------------------------------------

struct Plane {
  const int32_t* w;   // the plane's first word
  long long stride;   // words between its [L, W] blocks
};

// The index arithmetic is 32-bit: a division is a few instructions, not
// the 64-bit routine's dozens, and at a launch's floor those show.  So
// the wrappers refuse planes with a word 2^31 or more past their start
// (8 GiB; the engine's are a few hundred KiB): check_plane_span.
__device__ __forceinline__ const int32_t* plane_word(const Plane& p,
                                                     uint32_t b,
                                                     uint32_t off) {
  return p.w + (b * (uint32_t)p.stride + off);
}

// --------------------------------------------------------------------------
// packed_any (replaces packed_any, coherency_step.py:257)
//
// out[l] = any bit set in the W words of line l of the OR of n_planes <= 4
// planes (the reference's popcount-over-words > 0 of one plane; an OR of
// the words gives the same verdict, and any(x) | any(y) == any(x | y)).
// The words are the reference's uint32 bits held as int32.
//
// Bound: 4 W bytes in per plane and 1 byte out per line, a few hundred
// KiB at most on the packed step; at that size one launch is the cost, so
// the kernel's work is to spare launches: the engine's grant test ORs the
// two fan-out planes and the two pending planes in one launch, reading
// the pending slices in place.  One thread per line, every plane's load
// issued before any is used (one memory round trip): a plane's W = 2
// words are one 8-byte load (kPair, when every plane's lines are 8-byte
// aligned), W = 1 one 4-byte load, and neighbouring threads read
// neighbouring lines and write neighbouring bytes.
// --------------------------------------------------------------------------

constexpr int kAnyPlanes = 4;
constexpr int kAnyThreads = 256;

struct AnyPlanes {
  Plane p[kAnyPlanes];
};

template <bool kPair>
__global__ void packed_any_kernel(const AnyPlanes planes, int n_planes,
                                  bool* __restrict__ out, uint32_t n_lines,
                                  uint32_t L, uint32_t W) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lines) return;
  const uint32_t b = i / L, off = (i - b * L) * W;
  int32_t acc = 0;
#pragma unroll
  for (int k = 0; k < kAnyPlanes; ++k) {
    if (k < n_planes) {
      const int32_t* w = plane_word(planes.p[k], b, off);
      if (kPair) {
        const int2 v = __ldg(reinterpret_cast<const int2*>(w));
        acc |= v.x | v.y;
      } else {
        for (uint32_t j = 0; j < W; ++j) acc |= __ldg(w + j);
      }
    }
  }
  out[i] = acc != 0;
}

// --------------------------------------------------------------------------
// packed_fanout (replaces packed_fanout, coherency_step.py:298)
//
// hot      = the one-bit word of remote node[l] in word w (zero elsewhere)
// rec[l,w] = shared_req[l] ? excl[l,w] & ~hot : 0   (HOME_DOWNGRADE_S)
// inv[l,w] = excl_req[l]   ? pres[l,w] & ~hot : 0   (HOME_DOWNGRADE_I)
//
// and, with the home flags (kHome), on a line where home_read or
// home_write is set, the home-side fan-out instead (the reference's
// home_needed_words, which the engine selected with two torch.where):
//
// inv[l,w] = home_write[l] ? pres[l,w] : 0
// rec[l,w] = home_read[l]  ? excl[l,w] & ~inv[l,w] : 0
//
// One thread per (line, word), so the word planes are read and written
// coalesced; pres and excl are read where they lie (two slices of the
// packed view), and every input is loaded before any is used, so a
// thread waits for one memory round trip, not one for the home flags and
// another for the request's inputs.  The hot bit is built
// by shifting an unsigned 1 (a signed 1 << 31 would overflow) and then
// read as int32; node >> 5 and node & 31 are the reference's floor
// division and modulo by 32.  Bound: 8 bytes in and 8 out per word, 6 (8
// with the home flags) bytes in per line; like packed_any it is one
// launch's floor, so what it saves is the engine's plane copies,
// home-side ops and merges around it.
// --------------------------------------------------------------------------

template <bool kHome>
__global__ void packed_fanout_kernel(const Plane pres, const Plane excl,
                                     const int32_t* __restrict__ node,
                                     const bool* __restrict__ shared_req,
                                     const bool* __restrict__ excl_req,
                                     const bool* __restrict__ home_read,
                                     const bool* __restrict__ home_write,
                                     int32_t* __restrict__ rec,
                                     int32_t* __restrict__ inv,
                                     uint32_t n_lines, uint32_t L,
                                     uint32_t W) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lines * W) return;
  const uint32_t line = i / W, w = i - line * W;
  const uint32_t b = line / L, off = (line - b * L) * W + w;
  const int32_t p = __ldg(plane_word(pres, b, off));
  const int32_t e = __ldg(plane_word(excl, b, off));
  const int nd = __ldg(node + line);
  const bool sh = shared_req[line], ex = excl_req[line];
  const bool hr = kHome && home_read[line];
  const bool hw = kHome && home_write[line];
  const unsigned hot_u =
      (nd >= 0 && w == (uint32_t)(nd >> 5)) ? (1u << (nd & 31)) : 0u;
  const int32_t keep = ~(int32_t)hot_u;
  int32_t r = sh ? (e & keep) : 0;
  int32_t v = ex ? (p & keep) : 0;
  if (hr || hw) {
    v = hw ? p : 0;
    r = hr ? (e & ~v) : 0;
  }
  rec[i] = r;
  inv[i] = v;
}

// --------------------------------------------------------------------------
// An empty kernel: the device time of one launch that does no work, timed
// through the same ctypes route as the kernels above (the floor that a
// launch-bound kernel such as packed_any cannot go below).
// --------------------------------------------------------------------------

__global__ void empty_kernel() {}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points.  Shapes are validated by the Python wrappers; the checks
// here only refuse what would launch an invalid grid or, for the packed
// kernels, index past 32 bits.
// ---------------------------------------------------------------------------

extern "C" {

int coh_credit_rank(const void* active, const void* cand, void* out,
                    int rows, int L, void* stream) {
  if (rows <= 0 || L <= 0) return (int)cudaGetLastError();
  // Groups per row: exact when every row starts on the same 16-byte
  // phase, else the most any phase needs (the extra CTAs find no lanes).
  const long long groups =
      L % 16 == 0 ? groups16(active, same_align(active, cand), L).count
                  : (L + 30) / 16;
  const long long nseg = (groups + kRankThreads - 1) / kRankThreads;
  if (nseg > 65535) return (int)cudaErrorInvalidValue;   // grid.y
  credit_rank_kernel<kRankThreads>
      <<<dim3((unsigned)rows, (unsigned)nseg), kRankThreads, 0,
         (cudaStream_t)stream>>>((const uint8_t*)active,
                                 (const uint8_t*)cand, (int32_t*)out, L);
  return (int)cudaGetLastError();
}

int coh_arb_winner(const void* ready, const void* rr, void* out, int n, int P,
                   int L, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((int64_t)n * L == 0) return (int)cudaGetLastError();
  if (P <= 0)                  // no participant: every line's winner is 0
    return (int)cudaMemsetAsync(out, 0, (size_t)n * L * 4, st);
  const dim3 grid((unsigned)((L + kArbLines - 1) / kArbLines), (unsigned)n);
  if (L % 4 == 0 && (uintptr_t)ready % 4 == 0)
    arb_winner_kernel<true><<<grid, kArbWarps * 32, 0, st>>>(
        (const uint8_t*)ready, (const int32_t*)rr, (int32_t*)out, P, L);
  else
    arb_winner_kernel<false><<<grid, kArbWarps * 32, 0, st>>>(
        (const uint8_t*)ready, (const int32_t*)rr, (int32_t*)out, P, L);
  return (int)cudaGetLastError();
}

int coh_count_fold(const void* mask, const void* msg, const void* pay,
                   const void* base_c, const void* base_p, void* out,
                   long long n, int groups, void* acc, int stride,
                   long long base_c_stride, long long base_p_stride,
                   void* stream) {
  if (groups <= 0) return (int)cudaGetLastError();
  const long long lane_groups =
      groups16(mask, same_align(mask, msg) && same_align(mask, pay), n)
          .count;
  long long ctas = (lane_groups + kFoldThreads - 1) / kFoldThreads;
  ctas = ctas < 1 ? 1 : (ctas > kFoldMaxCtas ? kFoldMaxCtas : ctas);
  count_fold_kernel<kFoldThreads>
      <<<dim3((unsigned)ctas, (unsigned)groups), kFoldThreads, 0,
         (cudaStream_t)stream>>>(
          (const uint8_t*)mask, (const uint8_t*)msg, (const uint8_t*)pay,
          (const int32_t*)base_c, (const int32_t*)base_p, (int32_t*)out, n,
          (unsigned long long*)acc, stride, base_c_stride, base_p_stride);
  return (int)cudaGetLastError();
}

int coh_lat_hist(const void* lat, const void* retired, void* out, int rows,
                 int L, void* stream) {
  if (rows > 0)
    lat_hist_kernel<<<rows, kLatThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)lat, (const uint8_t*)retired, (int32_t*)out, L);
  return (int)cudaGetLastError();
}

int coh_packed_any(const void* w0, const void* w1, const void* w2,
                   const void* w3, long long s0, long long s1, long long s2,
                   long long s3, int n_planes, void* out, long long n_lines,
                   long long L, int W, void* stream) {
  if (n_planes < 1 || n_planes > kAnyPlanes)
    return (int)cudaErrorInvalidValue;
  if (n_lines <= 0 || L <= 0 || W <= 0) return (int)cudaGetLastError();
  const void* ptr[kAnyPlanes] = {w0, w1, w2, w3};
  const long long stride[kAnyPlanes] = {s0, s1, s2, s3};
  AnyPlanes planes;
  bool pair = W == 2;
  for (int k = 0; k < kAnyPlanes; ++k) {
    planes.p[k].w = (const int32_t*)ptr[k];
    planes.p[k].stride = stride[k];
    if (k < n_planes)
      pair = pair && (uintptr_t)ptr[k] % 8 == 0 && stride[k] % 2 == 0;
  }
  const unsigned blocks = (unsigned)((n_lines + kAnyThreads - 1) /
                                     kAnyThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (pair)
    packed_any_kernel<true><<<blocks, kAnyThreads, 0, st>>>(
        planes, n_planes, (bool*)out, (uint32_t)n_lines, (uint32_t)L, W);
  else
    packed_any_kernel<false><<<blocks, kAnyThreads, 0, st>>>(
        planes, n_planes, (bool*)out, (uint32_t)n_lines, (uint32_t)L, W);
  return (int)cudaGetLastError();
}

int coh_packed_fanout(const void* pres, long long pres_stride,
                      const void* excl, long long excl_stride,
                      const void* node, const void* shared_req,
                      const void* excl_req, const void* home_read,
                      const void* home_write, void* rec, void* inv,
                      long long n_lines, long long L, int W, void* stream) {
  if (n_lines <= 0 || L <= 0 || W <= 0) return (int)cudaGetLastError();
  const Plane planes[2] = {{(const int32_t*)pres, pres_stride},
                           {(const int32_t*)excl, excl_stride}};
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_lines * W + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* nd = (const int32_t*)node;
  const bool* sh = (const bool*)shared_req;
  const bool* ex = (const bool*)excl_req;
  if (home_read != nullptr && home_write != nullptr)
    packed_fanout_kernel<true><<<blocks, threads, 0, st>>>(
        planes[0], planes[1], nd, sh, ex, (const bool*)home_read,
        (const bool*)home_write, (int32_t*)rec, (int32_t*)inv,
        (uint32_t)n_lines, (uint32_t)L, W);
  else
    packed_fanout_kernel<false><<<blocks, threads, 0, st>>>(
        planes[0], planes[1], nd, sh, ex, nullptr, nullptr, (int32_t*)rec,
        (int32_t*)inv, (uint32_t)n_lines, (uint32_t)L, W);
  return (int)cudaGetLastError();
}

int coh_empty(int blocks, int threads, void* stream) {
  if (blocks > 0)
    empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
