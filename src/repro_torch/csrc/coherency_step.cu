// Coherency-step kernels for Hopper (sm_90a): the per-step inner plane of
// the N-remote engine (repro_torch.core.engine_mn, traffic.counters).
//
// Four integer kernels with a plain C interface, built by nvcc into a
// shared library and bound with ctypes (repro_torch/kernels/build.py,
// repro_torch/kernels/coherency_step.py).  Every entry point launches on
// the caller's stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// They replace the Pallas kernels of src/repro/kernels/coherency_step.py.
// Those were shaped for the TPU's matrix unit (a cumsum as two integer
// matmuls against iota masks, an argmin as encode/min/decode); here they
// are what the planes are: scans, per-line selects and histograms over
// small integer planes.  All four move a few bytes per element and do a
// handful of integer operations on each, so each is bound by memory
// traffic — and at the engine's per-step sizes (at most [64, 4096]) by
// launch latency first.  The designs below keep every input read once
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
// One thread per line, looping over the P <= 65 participants; the reads of
// one participant row are coalesced across the warp's lines.  Bound: P
// bytes + 4 bytes in, 4 bytes out per line.
// --------------------------------------------------------------------------

__global__ void arb_winner_kernel(const bool* __restrict__ ready,
                                  const int32_t* __restrict__ rr,
                                  int32_t* __restrict__ out, int n, int P,
                                  int L) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)n * L) return;
  const int64_t b = i / L;
  const int l = (int)(i - b * L);
  const bool* rd = ready + (size_t)b * P * L + l;
  const int r = rr[i];
  int best = 0, best_score = P;
  for (int p = 0; p < P; ++p) {
    if (rd[(size_t)p * L]) {
      // CUDA's % truncates toward zero; this is the floor modulo.
      const int prio = ((p - r) % P + P) % P;
      if (prio < best_score) {
        best_score = prio;
        best = p;
      }
    }
  }
  out[i] = best;
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
// One block per row with a 10-bin histogram in shared memory.  Bound:
// 5 bytes in per lane, 40 bytes out per row.
// --------------------------------------------------------------------------

constexpr int kLatEdges = 9;
constexpr int kLatBins = kLatEdges + 1;

__device__ __forceinline__ int lat_bucket(int32_t v) {
  const int32_t edges[kLatEdges] = {1, 2, 4, 8, 16, 32, 64, 128, 256};
  int b = 0;
#pragma unroll
  for (int e = 0; e < kLatEdges; ++e) b += (v >= edges[e]) ? 1 : 0;
  return b;
}

__global__ void lat_hist_kernel(const int32_t* __restrict__ lat,
                                const bool* __restrict__ retired,
                                int32_t* __restrict__ out, int L) {
  __shared__ int hist[kLatBins];
  const int row = blockIdx.x;
  if (threadIdx.x < kLatBins) hist[threadIdx.x] = 0;
  __syncthreads();
  const int32_t* lt = lat + (size_t)row * L;
  const bool* rt = retired + (size_t)row * L;
  for (int l = threadIdx.x; l < L; l += blockDim.x)
    if (rt[l]) atomicAdd(&hist[lat_bucket(lt[l])], 1);
  __syncthreads();
  if (threadIdx.x < kLatBins)
    out[(size_t)row * kLatBins + threadIdx.x] = hist[threadIdx.x];
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
  const int64_t total = (int64_t)n * L;
  if (total > 0) {
    const int threads = 128;
    const int blocks = (int)((total + threads - 1) / threads);
    arb_winner_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const bool*)ready, (const int32_t*)rr, (int32_t*)out, n, P, L);
  }
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
    lat_hist_kernel<<<rows, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)lat, (const bool*)retired, (int32_t*)out, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
