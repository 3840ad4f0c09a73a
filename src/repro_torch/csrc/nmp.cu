// Near-memory-processing kernels for Hopper (sm_90a): the per-shard hot
// loops of the pushdown operators (repro_torch.core.pushdown, through
// repro_torch.kernels.ops).
//
// Three kernels with a plain C interface, built by nvcc into a shared
// library and bound with ctypes (repro_torch/kernels/build.py,
// repro_torch/kernels/nmp.py).  Every entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// They replace the Pallas kernels of src/repro/kernels/select_scan.py,
// regex_dfa.py and hash_probe.py.  Those keep a tile, a DFA table or a
// whole hash table resident in VMEM and compact with a one-hot matmul on
// the MXU; here a scan is a block prefix sum over warp ballots and a copy
// of bits, the DFA walk reads its string field in place through a ring of
// tiles in shared memory, and the probe chases 8-byte (key, next) records
// in device memory at any size.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "tma.cuh"

constexpr int kMaxBlockRows = 1024;

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// --------------------------------------------------------------------------
// select_scan (replaces select_scan, src/repro/kernels/select_scan.py:62)
//
// Per block of block_rows rows of a [n, w] table: the rows with
// col0 > x && col1 < y are packed to the front of the block's output in
// row order, zeros after, and the block's match count is written.
//
// The compare is typed, the copy is not.  T is the table's element type
// (float, __nv_bfloat16, __half or int32_t): the two filter columns are
// compared in T's own values — x and y come already rounded to T, as
// JAX's weak-typed scalars are, so a bf16 table compares with 0.3 as
// 0.30078125; a bf16 or fp16 value and its rounded bound widen to float
// exactly, an int32 compares as an int.  Word is the unit the rows'
// bits are copied in: 16 bytes where the row's bytes allow it, else the
// element's own width.
//
// One CUDA block per row block, one thread per row.  Each thread reads
// its row's two filter columns (one 32-byte sector of a 128-byte row);
// a warp ballot and popc give each match its rank in its warp, one warp
// scans the per-warp counts, and each match writes its row index to its
// slot.  Then the whole block copies: output slot s takes the words of
// row src[s] while s < count, zeros after — neighbouring threads on
// neighbouring words, so the matching rows are read once and the output
// is written once, coalesced.  The rows' bits are copied as integers,
// never as floats (the MXU product 0*x of the Pallas kernel turns -0.0
// into +0.0 and spreads a NaN over its block).  Bound: bytes — one
// sector of every row, the rest of every matching row, and the whole
// output, zeros included.
// --------------------------------------------------------------------------

__device__ __forceinline__ float cmp_value(float v) { return v; }
__device__ __forceinline__ float cmp_value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float cmp_value(__half v) {
  return __half2float(v);
}
__device__ __forceinline__ int cmp_value(int32_t v) { return v; }

template <typename T, typename Word>
__global__ void select_scan_kernel(const T* __restrict__ table,
                                   double x, double y, int w,
                                   Word* __restrict__ out,
                                   int32_t* __restrict__ counts) {
  using C = decltype(cmp_value(T()));
  __shared__ int s_warp[kMaxBlockRows / 32];
  __shared__ int s_src[kMaxBlockRows];
  __shared__ int s_count;
  const int br = blockDim.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const T* rows = table + (int64_t)blockIdx.x * br * w;

  const C a = cmp_value(rows[(int64_t)t * w]);
  const C b = cmp_value(rows[(int64_t)t * w + 1]);
  const bool m = (a > (C)x) && (b < (C)y);
  const unsigned bal = __ballot_sync(0xffffffffu, m);
  if (lane == 0) s_warp[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    const int nw = br >> 5;
    const int v = lane < nw ? s_warp[lane] : 0;
    const int incl = warp_incl_scan(v, lane);
    __syncwarp();
    if (lane < nw) s_warp[lane] = incl - v;          // exclusive offsets
    if (lane == 31) s_count = incl;
  }
  __syncthreads();
  if (m) s_src[s_warp[warp] + __popc(bal & ((1u << lane) - 1u))] = t;
  __syncthreads();

  const int count = s_count;
  const int ww = (int)(w * sizeof(T) / sizeof(Word));   // words per row
  const Word* in = reinterpret_cast<const Word*>(rows);
  Word* o = out + (int64_t)blockIdx.x * br * ww;
  for (int i = t; i < br * ww; i += br) {
    const int slot = i / ww;
    Word v{};
    if (slot < count) v = in[(int64_t)s_src[slot] * ww + (i - slot * ww)];
    o[i] = v;
  }
  if (t == 0) counts[blockIdx.x] = count;
}

template <typename T, typename Word>
void launch_select(const void* table, double x, double y, long long nb,
                   int br, int w, void* out, void* counts,
                   cudaStream_t stream) {
  select_scan_kernel<T, Word><<<(unsigned)nb, br, 0, stream>>>(
      (const T*)table, x, y, w, (Word*)out, (int32_t*)counts);
}

template <typename T, typename Elem>
void select_by_width(const void* table, double x, double y, long long nb,
                     int br, int w, void* out, void* counts,
                     cudaStream_t stream) {
  const bool vec16 = (w * sizeof(T)) % 16 == 0 &&
                     (uintptr_t)table % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec16)
    launch_select<T, uint4>(table, x, y, nb, br, w, out, counts, stream);
  else
    launch_select<T, Elem>(table, x, y, nb, br, w, out, counts, stream);
}

// --------------------------------------------------------------------------
// regex_dfa (replaces regex_dfa, src/repro/kernels/regex_dfa.py:56)
//
// out[r] = accept[the state row r of a uint8 string field ends in], walking
// the [n_states, 256] int32 transition table from state 0, one byte a step.
// The field is read where it lies: row r's w bytes start at strings +
// r * ld, for any row stride ld >= w and any alignment, so the string
// columns of a wider table are read in place, with no copy.
//
// Bound: bytes — the 32-byte sectors that hold each row's bytes up to its
// first accept byte (the accept states of compile_regex absorb), and one
// byte written a row.  In place, a 62-byte field at byte 8 of a 128-byte
// row spans three of the row's four sectors, but on an H100 the walk runs
// at the rate of all four (its time does not move with the sectors a box
// asks for; PERF.md §6): a contiguous copy of the field reads half that,
// and costs more to make than it saves.
//
// Persistent CTAs of kDfaThreads threads walk tiles of kDfaRows rows; a
// ring of kDfaStages tiles in shared memory keeps the next tiles' bytes
// arriving while this one is walked:
// * a row stride that is a multiple of 16 bytes: thread 0 has the TMA copy
//   each tile as 2-D boxes of [256 rows, pitch bytes] from the 16-byte
//   boundary at or below the field's start (a box from the field's first
//   byte itself, 8 bytes past a boundary, did not complete on an H100),
//   pitch the odd multiple of 16 at or above that offset + w, the bytes
//   past the field zero-filled, the L2 asked for 128-byte lines (2%
//   faster than sectors); an mbarrier per stage counts the bytes in;
// * any other stride up to kMaxStageWidth: every thread issues cp.async
//   16-byte copies of the tile's whole byte range, gaps included, from the
//   16-byte boundaries around it (a word that holds one byte of an
//   allocation lies in its page, so reading it never faults).
// A thread takes its rows' bytes 16 at a time from shared memory into
// registers.  The rows of a warp lie m apart (m = 16 / gcd(pitch, 16)),
// so they start at one offset in their 16-byte words and those of a
// quarter-warp an odd number of words apart: the reads are free of bank
// conflicts, and a warp takes a word whole (no per-byte test) or in part
// together.  The transition table sits in shared memory with each entry
// premultiplied to the byte offset of its state's row, so a step is one
// add and one dependent shared load; a thread walks kDfaRowsPerThread
// rows interleaved, so their lookups overlap.  Whether a state absorbs
// and whether it accepts are bits of two 64-bit masks in registers: a row
// stops at an absorbing state (the state the full walk ends in, for any
// table), and the kernel writes the bool answer itself, so a call is one
// device operation.  A table of more than kSmemStates states, rows wider
// than kMaxStageWidth, or a stride the ring cannot hold go to
// regex_dfa_global_kernel: one thread a row, through the L1, every row
// its full width.
//
// The constants below are the fastest of the designs measured at the
// path's shapes (PERF.md §6): 1, 2 or 4 rows a thread, 2 to 4
// stages, int32 or uint16 entries.
// --------------------------------------------------------------------------

constexpr int kSmemStates = 64;            // the masks are 64-bit
constexpr int kMaxStageWidth = 128;
constexpr int kDfaThreads = 256;
constexpr int kDfaRowsPerThread = 2;
constexpr int kDfaRows = kDfaThreads * kDfaRowsPerThread;
constexpr int kDfaStages = 2;
constexpr int kTmaBoxRows = 256;           // TMA's largest box dimension

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t byte_of(const uint4& v, int b) {
  const uint32_t word = b < 4 ? v.x : b < 8 ? v.y : b < 12 ? v.z : v.w;
  return __byte_perm(word, 0, 0x4440 | (b & 3));
}

// One step: ``at`` is the byte offset of the current state's row of the
// table; the entry of byte c is the offset of the next state's row.
__device__ __forceinline__ uint32_t dfa_step(const unsigned char* tbl,
                                             uint32_t at, uint32_t c) {
  return *reinterpret_cast<const uint32_t*>(tbl + at + (c << 2));
}

// ``base``: the 16-byte boundary at or below the field's first byte, which
// lies ``head`` bytes past it; row r's field starts at byte head + r *
// pitch of its tile in shared memory (pitch = ld on the cp.async path).
template <bool kTma>
__global__ void __launch_bounds__(kDfaThreads)
    regex_dfa_smem_kernel(const __grid_constant__ CUtensorMap map,
                          const int32_t* __restrict__ trans,
                          const bool* __restrict__ accept, int n_states,
                          const uint8_t* __restrict__ base, int64_t n,
                          int w, int64_t ld, int head, int pitch,
                          int stage_bytes, bool* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char s_raw[];
  __shared__ __align__(8) uint64_t s_full[kDfaStages];
  __shared__ unsigned char s_flags[kSmemStates];   // 1: leaves, 2: accepts
  // the ring, 128-byte aligned for the TMA, then the table.
  unsigned char* s_mem = s_raw + ((128 - (smem_u32(s_raw) & 127)) & 127);
  unsigned char* s_tbl = s_mem + kDfaStages * stage_bytes;
  const CUtensorMap* tmap = &map;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t n_tiles = (n + kDfaRows - 1) / kDfaRows;
  const int64_t my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  auto issue = [&](int64_t i, int stage) {   // the block's i-th tile
    const int64_t row0 = (blockIdx.x + i * gridDim.x) * kDfaRows;
    unsigned char* dst = s_mem + stage * stage_bytes;
    if constexpr (kTma) {
      if (tid == 0) {
        const uint32_t bar = smem_u32(&s_full[stage]);
        mbar_expect_tx(bar, (uint32_t)(kDfaRows * pitch));
#pragma unroll
        for (int k = 0; k < kDfaRows / kTmaBoxRows; ++k)
          tma_load_2d(smem_u32(dst + k * kTmaBoxRows * pitch), tmap, bar, 0,
                      (int)(row0 + k * kTmaBoxRows));
      }
    } else {
      const int64_t rows = n - row0 < kDfaRows ? n - row0 : kDfaRows;
      const int64_t words = (head + (rows - 1) * ld + w + 15) >> 4;
      const uint8_t* src = base + row0 * ld;       // row0 * ld % 16 == 0
      for (int64_t j = tid; j < words; j += kDfaThreads)
        cp_async16(smem_u32(dst + 16 * j), src + 16 * j);
      cp_async_commit();
    }
  };

  if constexpr (kTma) {
    if (tid == 0) {
      for (int s = 0; s < kDfaStages; ++s) mbar_init(smem_u32(&s_full[s]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  for (int s = 0; s < kDfaStages; ++s) {
    if (s < my_tiles) issue(s, s);
    else if constexpr (!kTma) cp_async_commit();   // keep the group count
  }

  // The table, under the first tiles' loads: entry (s, c) = the offset of
  // state trans[s][c]'s row.
  for (int s = warp; s < n_states; s += kDfaThreads / 32) {
    bool moves = false;
    for (int c = lane; c < 256; c += 32) {
      const int32_t v = __ldg(trans + (s << 8) + c);
      moves |= v != s;
      reinterpret_cast<uint32_t*>(s_tbl)[(s << 8) + c] = (uint32_t)v << 10;
    }
    moves = __any_sync(0xffffffffu, moves);
    if (lane == 0) s_flags[s] = (moves ? 1 : 0) | (accept[s] ? 2 : 0);
  }
  __syncthreads();
  uint64_t leaves = 0, accepts = 0;
  for (int s = 0; s < n_states; ++s) {
    leaves |= (uint64_t)(s_flags[s] & 1) << s;
    accepts |= (uint64_t)(s_flags[s] >> 1) << s;
  }

  // This thread's row of each 256-row block: rows m apart lie the same
  // number of bytes past a 16-byte boundary, so thread t takes row
  // t / L + m * (t % L), L = 256 / m: a warp's rows (a half-warp's when
  // m = 16) all start at one offset in their words, and those of a
  // quarter-warp an odd number of words apart.
  const int m = 16 / min(pitch & -pitch, 16);
  const int L = kDfaThreads / m;
  const int my_row = tid / L + m * (tid % L);
  const int skip = (head + my_row * pitch) & 15;    // the same for k > 0
  const int n_words = (skip + w + 15) >> 4;
  constexpr int R = kDfaRowsPerThread;
  constexpr int kRowShift = 10;                  // state = at >> kRowShift

  for (int64_t i = 0; i < my_tiles; ++i) {
    const int stage = (int)(i % kDfaStages);
    if constexpr (kTma) {
      mbar_wait(smem_u32(&s_full[stage]), (uint32_t)((i / kDfaStages) & 1));
    } else {
      cp_async_wait<kDfaStages - 1>();
      __syncthreads();
    }
    const unsigned char* tile = s_mem + stage * stage_bytes;
    const int64_t row0 = (blockIdx.x + i * gridDim.x) * kDfaRows;
    uint32_t at[R], word0[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      word0[k] = (head + (my_row + k * kDfaThreads) * pitch) & ~15u;
      at[k] = 0;
    }
    for (int c = 0; c < n_words; ++c) {
      uint4 v[R];
#pragma unroll
      for (int k = 0; k < R; ++k)
        v[k] = *reinterpret_cast<const uint4*>(tile + word0[k] + 16 * c);
      // every byte of the word is the rows' (one branch a warp)
      if (16 * c >= skip && 16 * c + 16 <= skip + w) {
#pragma unroll
        for (int b = 0; b < 16; ++b)
#pragma unroll
          for (int k = 0; k < R; ++k)
            at[k] = dfa_step(s_tbl, at[k], byte_of(v[k], b));
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if ((unsigned)(16 * c + b - skip) < (unsigned)w)
#pragma unroll
            for (int k = 0; k < R; ++k)
              at[k] = dfa_step(s_tbl, at[k], byte_of(v[k], b));
      }
      bool moving = false;
#pragma unroll
      for (int k = 0; k < R; ++k)
        moving |= (leaves >> (at[k] >> kRowShift)) & 1;
      if (!moving) break;
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int64_t row = row0 + my_row + k * kDfaThreads;
      if (row < n) out[row] = (accepts >> (at[k] >> kRowShift)) & 1;
    }
    __syncthreads();                         // every thread is done with it
    if (i + kDfaStages < my_tiles) issue(i + kDfaStages, stage);
    else if constexpr (!kTma) cp_async_commit();
  }
}

__global__ void regex_dfa_global_kernel(const int32_t* __restrict__ trans,
                                        const bool* __restrict__ accept,
                                        const uint8_t* __restrict__ strings,
                                        int64_t n, int w, int64_t ld,
                                        bool* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint8_t* str = strings + row * ld;
  int state = 0;
  for (int i = 0; i < w; ++i)
    state = __ldg(trans + (state << 8) + __ldg(str + i));
  out[row] = accept[state];
}

// --------------------------------------------------------------------------
// hash_probe (replaces hash_probe, src/repro/kernels/hash_probe.py:66)
//
// found[q] = the first entry of query q's chain whose key equals the query
// (-1 if none within max_chain entries), steps[q] = the entries read.
// The bucket is the Fibonacci hash ((key * 2654435769) mod 2^32 >> 16)
// mod n_buckets, in native uint32.
//
// The chain's entries are records: an entry's key and next pointer side by
// side in one 8-byte word (the [n, 2] int32 layout that the port's KVS
// build functions allocate, keys and nxt its two columns), so a hop is
// one 8-byte load — one 32-byte sector, one round trip — where two arrays
// took two sectors for 8 useful bytes.  One thread per query; it stops at
// a hit or a nil pointer, which gives the same steps as the lockstep walk
// of max_chain steps.  Bound: not the bytes (25 times above them) nor the
// latency of one chain: at the path's sizes the table sits in the L2 and
// the chase runs at the rate the L1 and L2 serve scattered 8-byte loads,
// about 134 G loads/s on an H100 (PERF.md §6).  Measured there and not
// kept: 2 or 4 queries a thread walked interleaved, persistent threads
// taking the next query as one ends, fewer threads a SM, loads past the
// L1 (slower: queries of one bucket share the chain's first entries), and
// 16-byte loads of a record's pair (a chain's next entry is never the
// neighbour).
// --------------------------------------------------------------------------

constexpr int kProbeThreads = 256;

__global__ void __launch_bounds__(kProbeThreads)
    hash_probe_kernel(const int32_t* __restrict__ heads, uint32_t n_buckets,
                      const int2* __restrict__ rec,
                      const int32_t* __restrict__ queries, int64_t nq,
                      int max_chain, int32_t* __restrict__ found,
                      int32_t* __restrict__ steps) {
  const int64_t i = (int64_t)blockIdx.x * kProbeThreads + threadIdx.x;
  if (i >= nq) return;
  const uint32_t k = (uint32_t)queries[i];
  int32_t ptr = __ldg(heads + ((k * 2654435769u) >> 16) % n_buckets);
  int32_t f = -1, s = 0;
  for (int c = 0; c < max_chain && ptr >= 0; ++c) {
    ++s;
    const int2 e = __ldg(rec + ptr);
    if ((uint32_t)e.x == k) {
      f = ptr;
      break;
    }
    ptr = e.y;
  }
  found[i] = f;
  steps[i] = s;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16, 3 int32.
int nmp_select_scan(const void* table, int dtype, double x, double y,
                    long long n_blocks, int block_rows, int w, void* out,
                    void* counts, void* stream) {
  if (n_blocks > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype) {
      case 0: select_by_width<float, uint32_t>(table, x, y, n_blocks,
                                               block_rows, w, out, counts,
                                               st); break;
      case 1: select_by_width<__nv_bfloat16, uint16_t>(
                  table, x, y, n_blocks, block_rows, w, out, counts, st);
              break;
      case 2: select_by_width<__half, uint16_t>(table, x, y, n_blocks,
                                                block_rows, w, out, counts,
                                                st); break;
      case 3: select_by_width<int32_t, uint32_t>(table, x, y, n_blocks,
                                                 block_rows, w, out, counts,
                                                 st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

int nmp_regex_dfa(const void* trans, const void* accept, int n_states,
                  const void* strings, long long n, int w, long long ld,
                  void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int head = (int)((uintptr_t)strings & 15);
  const uint8_t* base = (const uint8_t*)strings - head;
  const bool staged =
      n_states <= kSmemStates && w >= 1 && w <= kMaxStageWidth;
  const bool tma = staged && ld % 16 == 0 && head + w <= ld;
  if (tma || (staged && ld <= kMaxStageWidth)) {
    const int pitch = tma ? (((head + w + 15) / 16) | 1) * 16 : (int)ld;
    // on the cp.async path a thread's last 16-byte word may reach 44 bytes
    // past its tile's rows.
    const int stage = (kDfaRows * pitch + (tma ? 0 : 64) + 127) / 128 * 128;
    const int smem =
        128 + kDfaStages * stage + n_states * 256 * (int)sizeof(uint32_t);
    int dev = 0, sms = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    // the static part (barriers, flags) takes under 1 KB.
    if (smem <= optin - 1024) {
      auto kernel =
          tma ? regex_dfa_smem_kernel<true> : regex_dfa_smem_kernel<false>;
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      CUtensorMap map{};
      if (tma) {
        // [n rows, head + w bytes] at stride ld, in boxes of [256, pitch]:
        // the bytes past the field come in as zeros.
        const EncodeTiled enc = encode_tiled();
        const cuuint64_t dims[2] = {(cuuint64_t)(head + w), (cuuint64_t)n};
        const cuuint64_t strides[1] = {(cuuint64_t)ld};
        const cuuint32_t box[2] = {(cuuint32_t)pitch, kTmaBoxRows};
        const cuuint32_t estr[2] = {1, 1};
        if (enc == nullptr ||
            enc(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<uint8_t*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
          return (int)cudaErrorInvalidValue;
      }
      int per_sm = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kDfaThreads, smem);
      const long long tiles = (n + kDfaRows - 1) / kDfaRows;
      long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
      if (grid > tiles) grid = tiles;
      kernel<<<(unsigned)grid, kDfaThreads, smem, st>>>(
          map, (const int32_t*)trans, (const bool*)accept, n_states, base,
          (int64_t)n, w, (int64_t)ld, head, pitch, stage, (bool*)out);
      return (int)cudaGetLastError();
    }
  }
  regex_dfa_global_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const int32_t*)trans, (const bool*)accept, (const uint8_t*)strings,
      (int64_t)n, w, (int64_t)ld, (bool*)out);
  return (int)cudaGetLastError();
}

// ``records``: the [n, 2] int32 entries (key, next), 8-byte aligned.
int nmp_hash_probe(const void* heads, int n_buckets, const void* records,
                   const void* queries, long long nq, int max_chain,
                   void* found, void* steps, void* stream) {
  if (nq > 0) {
    const long long blocks = (nq + kProbeThreads - 1) / kProbeThreads;
    hash_probe_kernel<<<(unsigned)blocks, kProbeThreads, 0,
                        (cudaStream_t)stream>>>(
        (const int32_t*)heads, (uint32_t)n_buckets, (const int2*)records,
        (const int32_t*)queries, (int64_t)nq, max_chain, (int32_t*)found,
        (int32_t*)steps);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
