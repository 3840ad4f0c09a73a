// Model-substrate kernels for Hopper (sm_90a): the prefill hot spots of
// the model layers (repro_torch.models, through repro_torch.kernels.ops).
//
// Two kernels with a plain C interface, built by nvcc into a shared
// library and bound with ctypes (repro_torch/kernels/build.py,
// repro_torch/kernels/models.py).  Every entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// They replace the Pallas kernels of src/repro/kernels/flash_attention.py
// and rglru_scan.py.  Those walk a sequential grid axis on one TPU core
// and carry their state (the online-softmax m, l and accumulator; the
// recurrence's h) in VMEM scratch from one grid step to the next.  Here
// nothing carries between blocks, so the sequential axis is a loop inside
// each block, with the state in shared memory and registers.  Arithmetic
// is fp32 with IEEE expf, tanhf and sqrtf (no fast-math): the contract is
// allclose to the plain versions at 2e-5 (attention) and 3e-5 (RG-LRU) in
// fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as XLA's convert
}

// --------------------------------------------------------------------------
// flash_attention (replaces flash_attention,
// src/repro/kernels/flash_attention.py:114)
//
// out[b, h, i] = softmax_j(mask(cap(scale * q[b, h, i] . k[b, h / rep, j])))
//                . v[b, h / rep, :]
// for q [B, Hq, Sq, D] and k, v [B, Hkv, Sk, D] (rep = Hq / Hkv: GQA and
// MQA read the shared KV head, never a repeated copy).  Queries are
// aligned to the end of the keys: query i sits at position
// i + Sk - Sq.  The mask keeps j <= pos (causal) and pos - j < window;
// a masked logit is -1e30, and a row whose every logit is masked keeps
// p = 0 and alpha = 1, so l == 0 and its output is 0.  The softcap is
// cap * tanh(x / cap).
//
// One thread block of 256 threads per (b, h, tile of 64 queries).  The
// block walks the key tiles of 64 that its queries can see — a tile that
// lies wholly after the last query (causal) or wholly before the window
// of the first is skipped, which changes no result, since such a tile
// leaves m, l and the accumulator as they are.  Per key tile:
//   1. the K tile is staged in shared memory as fp32;
//   2. each thread computes a 4x4 micro-tile of the 64x64 logits
//      (rows ty + 16i, columns tx + 16j), scales, caps and masks them
//      into the shared logit tile;
//   3. the V tile is staged into the same buffer, while each warp runs
//      the online softmax over 8 rows (a shuffle max and sum per row,
//      fp32 m and l in shared memory) and turns the logits into p;
//   4. each thread rescales its 4 x D/16 accumulators (rows ty + 16i,
//      columns tx + 16c) by alpha and adds p . V.
// Q stays in shared memory for the whole walk; rows are padded by one
// float so that neither the row-broadcast nor the column reads conflict
// on banks.  At D = 256 the block takes 148 KB of shared memory (one
// block per SM), above the 48 KB a launch gets without asking.
//
// Bound: operations — 4 * D flops per visible (query, key) pair, on the
// CUDA cores' fp32 FMA here (the tensor cores are a later kernel's).
// --------------------------------------------------------------------------

constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr int attn_smem_bytes() {
  return (kBQ * (D + 1) + kBK * (D + 1) + kBQ * (kBK + 1) + 3 * kBQ) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int Hq, int Hkv, int Sq, int Sk, float scale,
                       float softcap, int causal, int window) {
  constexpr int DP = D + 1, PP = kBK + 1, NC = (D + 15) / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][DP]
  float* KV = Qs + kBQ * DP;           // [kBK][DP]: K, then V
  float* Ps = KV + kBK * DP;           // [kBQ][PP]: logits, then p
  float* m_s = Ps + kBQ * PP;          // [kBQ] running max
  float* l_s = m_s + kBQ;              // [kBQ] normalizer
  float* a_s = l_s + kBQ;              // [kBQ] this tile's alpha

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int nq = (Sq + kBQ - 1) / kBQ;
  const int qt = blockIdx.x % nq;
  const int bh = blockIdx.x / nq;           // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const int off = Sk - Sq;                  // end alignment
  const T* qp = q + ((int64_t)bh * Sq) * D;
  const T* kp = k + ((int64_t)(b * Hkv + hk) * Sk) * D;
  const T* vp = v + ((int64_t)(b * Hkv + hk) * Sk) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    Qs[r * DP + d] = q0 + r < Sq ? to_f32(qp[(int64_t)(q0 + r) * D + d])
                                 : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  // the key tiles any of this tile's queries can see.
  const int pos_lo = q0 + off;
  const int pos_hi = min(q0 + kBQ, Sq) - 1 + off;
  int kt_lo = 0, kt_hi = (Sk + kBK - 1) / kBK;
  if (causal) kt_hi = min(kt_hi, max(pos_hi, -1) / kBK + 1);
  if (window >= 0) {
    const int first = pos_lo - window + 1;   // lowest key position seen
    if (first > 0) kt_lo = first / kBK;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();             // the last tile's V reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      KV[r * DP + d] = k0 + r < Sk ? to_f32(kp[(int64_t)(k0 + r) * D + d])
                                   : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KV[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int pos = q0 + r + off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kj = k0 + c;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool keep = kj < Sk;
        if (causal) keep = keep && kj <= pos;
        if (window >= 0) keep = keep && pos - kj < window;
        Ps[r * PP + c] = keep ? x : kNegInf;
      }
    }
    __syncthreads();             // logits written, K reads done

    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      KV[r * DP + d] = k0 + r < Sk ? to_f32(vp[(int64_t)(k0 + r) * D + d])
                                   : 0.f;
    }
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      const float x0 = Ps[r * PP + lane], x1 = Ps[r * PP + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      const bool dead = m_cur <= kNegInf / 2;
      const float p0 = dead ? 0.f : expf(x0 - m_cur);
      const float p1 = dead ? 0.f : expf(x1 - m_cur);
      Ps[r * PP + lane] = p0;
      Ps[r * PP + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = dead ? 1.f : expf(m_prev - m_cur);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_cur;
      }
    }
    __syncthreads();             // p, alpha and V in place

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        vv[c] = tx + 16 * c < D ? KV[j * DP + tx + 16 * c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
  __syncthreads();

  T* op = out + ((int64_t)bh * Sq) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    const float l = l_s[r];
    const float inv = l == 0.f ? 1.f : l;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) from_f32(op + (int64_t)(q0 + r) * D + d, acc[i][c] / inv);
    }
  }
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int B, int Hq, int Hkv, int Sq, int Sk, float scale,
                 float softcap, int causal, int window, cudaStream_t st) {
  constexpr int smem = attn_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)B * Hq * ((Sq + kBQ - 1) / kBQ);
  flash_attention_kernel<T, D><<<(unsigned)blocks, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Sq, Sk,
      scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int flash_by_dim(int D, const void* q, const void* k, const void* v,
                 void* out, int B, int Hq, int Hkv, int Sq, int Sk,
                 float scale, float softcap, int causal, int window,
                 cudaStream_t st) {
  switch (D) {
    case 16: return launch_flash<T, 16>(q, k, v, out, B, Hq, Hkv, Sq, Sk,
                                        scale, softcap, causal, window, st);
    case 32: return launch_flash<T, 32>(q, k, v, out, B, Hq, Hkv, Sq, Sk,
                                        scale, softcap, causal, window, st);
    case 64: return launch_flash<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Sk,
                                        scale, softcap, causal, window, st);
    case 128: return launch_flash<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Sk,
                                          scale, softcap, causal, window,
                                          st);
    case 256: return launch_flash<T, 256>(q, k, v, out, B, Hq, Hkv, Sq, Sk,
                                          scale, softcap, causal, window,
                                          st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// --------------------------------------------------------------------------
// rglru_scan (replaces rglru_scan, src/repro/kernels/rglru_scan.py:57)
//
// h[b, t, d] = a[b, t, d] * h[b, t - 1, d]
//              + sqrt(max(1 - a[b, t, d]^2, 0)) * x[b, t, d],  h[b, -1] = 0,
// with the carry in fp32 and h written in x's dtype.
//
// One thread per (b, d) channel, walking t; the threads of a warp take 32
// neighbouring channels, so each step's loads of x and a and store of h
// are coalesced.  The recurrence is serial in t, but the loads are not:
// each thread reads kUnroll steps of x and a into registers before it
// runs them, so every thread keeps 2 * kUnroll loads in flight instead of
// waiting on each step's.  Bound: bytes — one read of x and a, one write
// of h.
// --------------------------------------------------------------------------

constexpr int kUnroll = 16;

template <typename T>
__global__ void rglru_scan_kernel(const T* __restrict__ x,
                                  const T* __restrict__ a,
                                  T* __restrict__ out, int B, int S, int D) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (int64_t)B * D) return;
  const int b = (int)(c / D), d = (int)(c - (int64_t)b * D);
  const int64_t base = (int64_t)b * S * D + d;
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float xs[kUnroll], as[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = t0 + u < S;
      const int64_t i = base + (int64_t)(t0 + u) * D;
      xs[u] = in ? to_f32(x[i]) : 0.f;
      as[u] = in ? to_f32(a[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        const float beta = sqrtf(fmaxf(1.f - as[u] * as[u], 0.f));
        h = as[u] * h + beta * xs[u];
        from_f32(out + base + (int64_t)(t0 + u) * D, h);
      }
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  window < 0: no window; softcap <= 0:
// no cap.  q, k, v and out are contiguous.
int models_flash_attention(const void* q, const void* k, const void* v,
                           void* out, int dtype, int B, int Hq, int Hkv,
                           int Sq, int Sk, int D, float scale,
                           float softcap, int causal, int window,
                           void* stream) {
  if ((long long)B * Hq * Sq == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return flash_by_dim<float>(D, q, k, v, out, B, Hq, Hkv, Sq, Sk, scale,
                               softcap, causal, window, st);
  if (dtype == 1)
    return flash_by_dim<__nv_bfloat16>(D, q, k, v, out, B, Hq, Hkv, Sq, Sk,
                                       scale, softcap, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

int models_rglru_scan(const void* x, const void* a, void* out, int dtype,
                      int B, int S, int D, void* stream) {
  const long long n = (long long)B * D;
  if (n > 0 && S > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
      rglru_scan_kernel<float><<<blocks, threads, 0, st>>>(
          (const float*)x, (const float*)a, (float*)out, B, S, D);
    else if (dtype == 1)
      rglru_scan_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
          (const __nv_bfloat16*)x, (const __nv_bfloat16*)a,
          (__nv_bfloat16*)out, B, S, D);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
