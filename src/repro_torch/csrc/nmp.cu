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
// of bits, the DFA table sits in shared memory, and the hash table stays
// in device memory at any size.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// out[r] = the state row r of a [n, w] uint8 array ends in, walking the
// [n_states, 256] int32 transition table from state 0, one byte a step.
// The wrapper reads accept[out].
//
// One thread per row.  A table of at most kSmemStates states (64 KiB) is
// copied into each block's shared memory, with a flag per state that says
// whether it absorbs (every byte leads back to it); the blocks stride over
// tiles of kDfaRows rows so that each copies the table once.  Each tile's
// bytes are staged into shared memory with 16-byte loads, neighbouring
// threads on neighbouring words: a thread reading its own row straight
// from device memory would make every warp-wide byte load touch 32
// sectors.  A thread stops at an absorbing state — the accept states of
// compile_regex absorb — and the state it stops in is the state the full
// walk ends in, for any table.  A larger table, or rows wider than
// kMaxStageWidth, are read through the L1 and every row walks its full
// width.  Bound: bytes — the string bytes up to each row's first accept
// byte; the walk is a chain of dependent shared-memory reads per row,
// which the many rows in flight hide.
// --------------------------------------------------------------------------

constexpr int kSmemStates = 64;
constexpr int kDfaRows = 256;
constexpr int kMaxStageWidth = 128;
constexpr int kDfaMaxSmem = kSmemStates * 256 * 4 + kDfaRows * kMaxStageWidth;

__global__ void regex_dfa_smem_kernel(const int32_t* __restrict__ trans,
                                      int n_states,
                                      const uint8_t* __restrict__ strings,
                                      int64_t n, int w, bool vec16,
                                      int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char s_mem[];
  int32_t* s_trans = reinterpret_cast<int32_t*>(s_mem);
  uint8_t* s_tile = s_mem + n_states * 256 * sizeof(int32_t);
  __shared__ int s_moves[kSmemStates];   // nonzero: the state can leave
  for (int s = threadIdx.x; s < n_states; s += blockDim.x) s_moves[s] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n_states * 256; i += blockDim.x) {
    const int32_t v = trans[i];
    s_trans[i] = v;
    if (v != (i >> 8)) s_moves[i >> 8] = 1;
  }
  const int64_t n_tiles = (n + kDfaRows - 1) / kDfaRows;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kDfaRows;
    const int64_t left = n - row0;
    const int rows = left < kDfaRows ? (int)left : kDfaRows;
    const int bytes = rows * w;
    const uint8_t* src = strings + row0 * w;
    __syncthreads();               // the table is in; the last tile is done
    if (vec16 && rows == kDfaRows) {         // kDfaRows * w % 16 == 0
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(s_tile);
      for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
        d4[i] = __ldg(s4 + i);
    } else {
      for (int i = threadIdx.x; i < bytes; i += blockDim.x)
        s_tile[i] = __ldg(src + i);
    }
    __syncthreads();
    if (threadIdx.x < rows) {
      const uint8_t* str = s_tile + threadIdx.x * w;
      int state = 0;
      for (int i = 0; i < w && s_moves[state]; ++i)
        state = s_trans[(state << 8) + str[i]];
      out[row0 + threadIdx.x] = state;
    }
  }
}

__global__ void regex_dfa_global_kernel(const int32_t* __restrict__ trans,
                                        const uint8_t* __restrict__ strings,
                                        int64_t n, int w,
                                        int32_t* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint8_t* str = strings + row * w;
  int state = 0;
  for (int i = 0; i < w; ++i)
    state = __ldg(trans + (state << 8) + __ldg(str + i));
  out[row] = state;
}

// --------------------------------------------------------------------------
// hash_probe (replaces hash_probe, src/repro/kernels/hash_probe.py:66)
//
// found[q] = the first entry of query q's chain whose key equals the query
// (-1 if none within max_chain entries), steps[q] = the entries read.
// The bucket is the Fibonacci hash ((key * 2654435769) mod 2^32 >> 16)
// mod n_buckets, in native uint32.
//
// One thread per query; it stops at a hit or a nil pointer, which gives
// the same steps as the lockstep walk of max_chain steps.  The table stays
// in device memory at any size.  Bound: the chase is a chain of dependent
// reads, so it is bound by memory latency, far from the bytes it moves;
// the kernel's answer is the many queries in flight at once.
// --------------------------------------------------------------------------

__global__ void hash_probe_kernel(const int32_t* __restrict__ heads,
                                  uint32_t n_buckets,
                                  const int32_t* __restrict__ keys,
                                  const int32_t* __restrict__ nxt,
                                  const int32_t* __restrict__ queries,
                                  int64_t nq, int max_chain,
                                  int32_t* __restrict__ found,
                                  int32_t* __restrict__ steps) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const uint32_t k = (uint32_t)queries[i];
  const uint32_t h = (k * 2654435769u) >> 16;
  int32_t ptr = __ldg(heads + h % n_buckets);
  int32_t f = -1, s = 0;
  for (int c = 0; c < max_chain && ptr >= 0; ++c) {
    ++s;
    if ((uint32_t)__ldg(keys + ptr) == k) {
      f = ptr;
      break;
    }
    ptr = __ldg(nxt + ptr);
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

int nmp_regex_dfa(const void* trans, int n_states, const void* strings,
                  long long n, int w, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const long long blocks = (n + kDfaRows - 1) / kDfaRows;
  if (n_states <= kSmemStates && w <= kMaxStageWidth) {
    const int smem = n_states * 256 * (int)sizeof(int32_t) + kDfaRows * w;
    // above 48 KB a block's dynamic shared memory must be asked for.
    cudaError_t e = cudaFuncSetAttribute(
        regex_dfa_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDfaMaxSmem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, regex_dfa_smem_kernel, kDfaRows, smem);
    long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (grid > blocks) grid = blocks;
    const bool vec16 = (uintptr_t)strings % 16 == 0;
    regex_dfa_smem_kernel<<<(unsigned)grid, kDfaRows, smem,
                            (cudaStream_t)stream>>>(
        (const int32_t*)trans, n_states, (const uint8_t*)strings,
        (int64_t)n, w, vec16, (int32_t*)out);
  } else {
    regex_dfa_global_kernel<<<(unsigned)blocks, kDfaRows, 0,
                              (cudaStream_t)stream>>>(
        (const int32_t*)trans, (const uint8_t*)strings, (int64_t)n, w,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

int nmp_hash_probe(const void* heads, int n_buckets, const void* keys,
                   const void* nxt, const void* queries, long long nq,
                   int max_chain, void* found, void* steps, void* stream) {
  if (nq > 0) {
    const int threads = 256;
    const long long blocks = (nq + threads - 1) / threads;
    hash_probe_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const int32_t*)heads, (uint32_t)n_buckets, (const int32_t*)keys,
        (const int32_t*)nxt, (const int32_t*)queries, (int64_t)nq,
        max_chain, (int32_t*)found, (int32_t*)steps);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
