// Coherency-step kernels for Hopper (sm_90a): the per-step inner plane of
// the N-remote engine (repro_torch.core.engine_mn, traffic.counters).
//
// Six integer kernels with a plain C interface, built by nvcc into a
// shared library and bound with ctypes (repro_torch/kernels/build.py,
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
// first.  The designs below keep every input read once
// and use shared memory for the partial results.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 256;
constexpr int kWarps = kScanThreads / 32;

// --------------------------------------------------------------------------
// credit_rank (replaces credit_rank, src/repro/kernels/coherency_step.py:86)
//
// out[r, l] = occupancy of line l's odd/even VC in row r
//           + number of candidates before l in row r on the same parity.
//
// One block per row.  Each thread owns a contiguous chunk of the row: it
// counts its active/candidate lanes per parity, the block reduces the
// occupancies and scans the candidate counts (warp shuffles, then one
// warp over the per-warp totals), and each thread walks its chunk again
// emitting occupancy + running rank.  Bound: 2 bytes in + 4 bytes out per
// lane.
// --------------------------------------------------------------------------

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__global__ void credit_rank_kernel(const bool* __restrict__ active,
                                   const bool* __restrict__ cand,
                                   int32_t* __restrict__ out, int L) {
  __shared__ int s_occ[2][kWarps];
  __shared__ int s_scan[2][kWarps];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool* a = active + (size_t)row * L;
  const bool* c = cand + (size_t)row * L;
  int32_t* o = out + (size_t)row * L;

  const int chunk = (L + kScanThreads - 1) / kScanThreads;
  const int lo = min(tid * chunk, L);
  const int hi = min(lo + chunk, L);

  int occ_e = 0, occ_o = 0, cnd_e = 0, cnd_o = 0;
  for (int l = lo; l < hi; ++l) {
    const int odd = l & 1;
    const int av = a[l] ? 1 : 0;
    const int cv = c[l] ? 1 : 0;
    occ_o += odd ? av : 0;
    occ_e += odd ? 0 : av;
    cnd_o += odd ? cv : 0;
    cnd_e += odd ? 0 : cv;
  }

  // block reduction of the two occupancies.
  const int wo_e = warp_sum(occ_e), wo_o = warp_sum(occ_o);
  // block exclusive scan of the candidate counts, per parity.
  const int inc_e = warp_incl_scan(cnd_e, lane);
  const int inc_o = warp_incl_scan(cnd_o, lane);
  if (lane == 31) {
    s_scan[0][warp] = inc_e;
    s_scan[1][warp] = inc_o;
  }
  if (lane == 0) {
    s_occ[0][warp] = wo_e;
    s_occ[1][warp] = wo_o;
  }
  __syncthreads();
  if (warp == 0) {
    int te = lane < kWarps ? s_scan[0][lane] : 0;
    int to = lane < kWarps ? s_scan[1][lane] : 0;
    int ie = warp_incl_scan(te, lane);
    int io = warp_incl_scan(to, lane);
    int oe = warp_sum(lane < kWarps ? s_occ[0][lane] : 0);
    int oo = warp_sum(lane < kWarps ? s_occ[1][lane] : 0);
    __syncwarp();
    if (lane < kWarps) {
      s_scan[0][lane] = ie - te;  // exclusive prefix of the warp totals
      s_scan[1][lane] = io - to;
    }
    if (lane == 0) {
      s_occ[0][0] = oe;
      s_occ[1][0] = oo;
    }
  }
  __syncthreads();
  const int occ_even = s_occ[0][0], occ_odd = s_occ[1][0];
  int run_e = s_scan[0][warp] + inc_e - cnd_e;  // candidates before my chunk
  int run_o = s_scan[1][warp] + inc_o - cnd_o;
  for (int l = lo; l < hi; ++l) {
    const int cv = c[l] ? 1 : 0;
    if (l & 1) {
      o[l] = occ_odd + run_o;
      run_o += cv;
    } else {
      o[l] = occ_even + run_e;
      run_e += cv;
    }
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
// count_fold (replaces count_fold, coherency_step.py:176)
//
// out[0:16] += histogram of msg under mask; out[16] += count of masked
// lanes that carry a payload.  Codes outside 0..15 land in no bin.
//
// A grid-stride loop; each block folds into a 17-int histogram in shared
// memory, then adds its non-zero bins to the output with integer atomics
// (exact in any order).  The wrapper zeroes the output first.  Bound:
// 3 bytes in per lane.
// --------------------------------------------------------------------------

__global__ void count_fold_kernel(const bool* __restrict__ mask,
                                  const int8_t* __restrict__ msg,
                                  const bool* __restrict__ pay,
                                  int32_t* __restrict__ out, int64_t n) {
  __shared__ int hist[17];
  if (threadIdx.x < 17) hist[threadIdx.x] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (mask[i]) {
      const int m = msg[i];
      if (m >= 0 && m < 16) atomicAdd(&hist[m], 1);
      if (pay[i]) atomicAdd(&hist[16], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x < 17 && hist[threadIdx.x] != 0)
    atomicAdd(&out[threadIdx.x], hist[threadIdx.x]);
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
// packed_any (replaces packed_any, coherency_step.py:257)
//
// out[l] = any bit set in the W int32 words of line l (the reference's
// popcount-over-words > 0; an OR of the words gives the same verdict).
// The words are the reference's uint32 bits held as int32.
//
// One thread per line: W <= 2 words at R <= 64, so the W loads of a
// thread are one 4- or 8-byte read, and neighbouring threads read
// neighbouring lines.  Bound: 4W bytes in, 1 byte out per line.
// --------------------------------------------------------------------------

__global__ void packed_any_kernel(const int32_t* __restrict__ words,
                                  bool* __restrict__ out, int64_t n, int W) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* w = words + i * W;
  int32_t acc = 0;
  for (int k = 0; k < W; ++k) acc |= w[k];
  out[i] = acc != 0;
}

// --------------------------------------------------------------------------
// packed_fanout (replaces packed_fanout, coherency_step.py:298)
//
// hot     = the one-bit word of remote node[l] in word w (zero elsewhere)
// rec[l,w] = shared_req[l] ? excl[l,w] & ~hot : 0   (HOME_DOWNGRADE_S)
// inv[l,w] = excl_req[l]   ? pres[l,w] & ~hot : 0   (HOME_DOWNGRADE_I)
//
// One thread per (line, word), so the word planes are read and written
// coalesced.  The hot bit is built by shifting an unsigned 1 (a signed
// 1 << 31 would overflow) and then read as int32; node >> 5 and node & 31
// are the reference's floor division and modulo by 32.  Bound: 8 bytes
// in and 8 out per word, 6 bytes in per line.
// --------------------------------------------------------------------------

__global__ void packed_fanout_kernel(const int32_t* __restrict__ pres,
                                     const int32_t* __restrict__ excl,
                                     const int32_t* __restrict__ node,
                                     const bool* __restrict__ shared_req,
                                     const bool* __restrict__ excl_req,
                                     int32_t* __restrict__ rec,
                                     int32_t* __restrict__ inv,
                                     int64_t n_lines, int W) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lines * W) return;
  const int64_t l = i / W;
  const int w = (int)(i - l * W);
  const int nd = node[l];
  const unsigned hot_u = (w == (nd >> 5)) ? (1u << (nd & 31)) : 0u;
  const int32_t keep = ~(int32_t)hot_u;
  rec[i] = shared_req[l] ? (excl[i] & keep) : 0;
  inv[i] = excl_req[l] ? (pres[i] & keep) : 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points.  Shapes are validated by the Python wrappers; the checks
// here only refuse what would launch an invalid grid.
// ---------------------------------------------------------------------------

extern "C" {

int coh_credit_rank(const void* active, const void* cand, void* out,
                    int rows, int L, void* stream) {
  if (rows > 0 && L > 0)
    credit_rank_kernel<<<rows, kScanThreads, 0, (cudaStream_t)stream>>>(
        (const bool*)active, (const bool*)cand, (int32_t*)out, L);
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
                   void* out, long long n, void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads * 4 - 1) / (threads * 4);
    if (blocks > 1056) blocks = 1056;  // 8 blocks per SM on 132 SMs
    count_fold_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const bool*)mask, (const int8_t*)msg, (const bool*)pay,
        (int32_t*)out, (int64_t)n);
  }
  return (int)cudaGetLastError();
}

int coh_lat_hist(const void* lat, const void* retired, void* out, int rows,
                 int L, void* stream) {
  if (rows > 0)
    lat_hist_kernel<<<rows, kLatThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)lat, (const uint8_t*)retired, (int32_t*)out, L);
  return (int)cudaGetLastError();
}

int coh_packed_any(const void* words, void* out, long long n, int W,
                   void* stream) {
  if (n > 0 && W > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    packed_any_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const int32_t*)words, (bool*)out, (int64_t)n, W);
  }
  return (int)cudaGetLastError();
}

int coh_packed_fanout(const void* pres, const void* excl, const void* node,
                      const void* shared_req, const void* excl_req,
                      void* rec, void* inv, long long n_lines, int W,
                      void* stream) {
  const long long total = n_lines * (long long)W;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    packed_fanout_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)pres, (const int32_t*)excl, (const int32_t*)node,
        (const bool*)shared_req, (const bool*)excl_req, (int32_t*)rec,
        (int32_t*)inv, (int64_t)n_lines, W);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
