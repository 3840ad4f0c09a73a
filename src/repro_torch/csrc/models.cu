// Model-substrate kernels for Hopper (sm_90a): the prefill hot spots of
// the model layers (repro_torch.models, through repro_torch.kernels.ops).
//
// Three kernels with a plain C interface, built by nvcc into a shared
// library and bound with ctypes (repro_torch/kernels/build.py,
// repro_torch/kernels/models.py).  Every entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or the error of a refused tensor map) so the
// wrapper can raise on a refused launch.
//
// They replace the Pallas kernels of src/repro/kernels/flash_attention.py
// and rglru_scan.py.  Those walk a sequential grid axis on one TPU core
// and carry their state (the online-softmax m, l and accumulator; the
// recurrence's h) in VMEM scratch from one grid step to the next.  Here
// nothing carries between blocks, so the sequential axis is a loop inside
// each block, with the state in shared memory and registers.
//
// Attention has two kernels, chosen by dtype in the wrapper: fp32 runs
// flash_attention_simt_kernel on the CUDA cores (IEEE expf and tanhf, no
// fast-math: allclose to the plain version at 2e-5), bf16 runs
// flash_attention_tc_kernel on the tensor cores (wgmma fed by TMA, fp32
// accumulators; allclose at 2e-2).  The RG-LRU scan is fp32 arithmetic
// with an fp32 carry (3e-5 in fp32, 3e-2 in bf16).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "tma.cuh"

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
// src/repro/kernels/flash_attention.py:114): the fp32 kernel
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
// CUDA cores' fp32 FMA here: TF32 on the tensor cores would break the
// 2e-5 contract, so fp32 stays on the CUDA cores; bf16 takes the tensor-
// core kernel below.
// --------------------------------------------------------------------------

constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr int attn_smem_bytes() {
  return (kBQ * (D + 1) + kBK * (D + 1) + kBQ * (kBK + 1) + 3 * kBQ) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
      flash_attention_simt_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)B * Hq * ((Sq + kBQ - 1) / kBQ);
  flash_attention_simt_kernel<T, D><<<(unsigned)blocks, kThreads, smem, st>>>(
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
// flash_attention on the tensor cores: the bf16 kernel of the same function
// (the same mask, -1e30 rule, dead-row rule and end alignment as above).
//
// Bound: operations — 4 * D flops per visible (query, key) pair, at the
// tensor cores' bf16 rate.  The design follows Hopper's shape for such a
// kernel: loads by TMA into a ring in shared memory, products by wgmma
// with fp32 accumulators in registers.
//
// One CTA of two warpgroups (256 threads) per (b, q-head, tile of 128
// queries); the grid's y axis runs the query tiles backwards, so the
// tiles with the most keys (the last, under a causal mask) start first and
// do not form the tail.
//   * Loads: thread 0 issues every TMA load.  Q is loaded once; K and V
//     move in tiles of 64 keys through a two-stage ring, each stage with a
//     "full" mbarrier (the TMA's bytes arrived) and an "empty" one (every
//     thread is done with it).  The tensor maps view q, k and v as 3-D
//     [B*H, S, D] bf16, in boxes 64 elements wide in D (D / 64 boxes per
//     tile) with the 128-byte swizzle wgmma reads (the 64- and 32-byte
//     swizzles for D = 32 and 16): a tile past S is then a real edge,
//     which TMA fills with zeros, not the next head's rows.
//   * Each warpgroup takes 64 query rows.  Per key tile: S = Q K^T by
//     wgmma m64n64k16 with both operands in shared memory (K-major);
//     scale, softcap and mask in registers, the row max over the four
//     threads that share a row, the online softmax with fp32 m and l; P
//     rounded to bf16 in registers, where the accumulator's layout is
//     already the layout of wgmma's A operand; O += P V by wgmma m64nNk16
//     with A = P from registers and B = V from shared memory, read
//     MN-major through the descriptor's transpose bit (so V needs no
//     transposed copy).  Tile i's S is issued together with tile i - 1's
//     P V, and tile i's softmax runs while that P V is on the tensor
//     cores.  O stays in fp32 registers (D / 2 a thread) until the
//     epilogue divides by l and writes bf16.
//   * No producer warpgroup: with one (384 threads) ptxas held every
//     thread to 168 registers in spite of setmaxnreg, spilled and
//     serialised the wgmmas at D = 256 (C7512).  At 256 threads the
//     kernel takes 218 registers at D = 256 and spills nothing.
// Key tiles wholly outside the causal window are never loaded.  The one
// rounding the plain version does not make is P to bf16 before P V.
// Shared memory: Q 128 x D, K and V 2 x 64 x D each, in bf16: 192 KB at
// D = 256 (one CTA per SM).
// --------------------------------------------------------------------------

namespace tc {

// Two warpgroups, 256 threads: each thread may hold up to 255 registers
// (O alone is 128 a thread at D = 256).
constexpr int kBM = 128, kBN = 64, kThreads = 256;

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (in 16-byte units) and the swizzle (1: 128 B, 2: 64 B,
// 3: 32 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)swz << 62);
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
// Keep the compiler from reading an accumulator before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define TC_F8(a, i)                                                    \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]),          \
      "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TC_F8(d, 0), TC_F8(d, 8), TC_F8(d, 16), TC_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] B[16 x N]: A from registers (four bf16 pairs per
// thread), B MN-major in shared memory (transposed through the
// descriptor).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : TC_F8(d, 0), TC_F8(d, 8), TC_F8(d, 16), TC_F8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : TC_F8(d, 0), TC_F8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 16, "wgmma_rs: N is 16, 32 or 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
        "1, 1;\n}\n"
        : TC_F8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}
#undef TC_F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The shape of a tile in shared memory for head dim D: boxes CW elements
// wide (RB bytes a row), D / CW of them side by side, each box's rows in
// 8-row atoms of 8 * RB bytes under the RB-byte swizzle.
template <int D>
struct Tile {
  static constexpr int CW = D < 64 ? D : 64;     // box width, elements
  static constexpr int RB = 2 * CW;              // bytes per box row
  static constexpr int NCH = D / CW;             // boxes per tile row
  static constexpr int KPC = CW / 16;            // k16 steps per box
  static constexpr uint32_t SWZ = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr uint32_t QBYTES = kBM * D * 2, KVBYTES = kBN * D * 2;
  // Q, two K stages, two V stages, 1024-byte aligned, then 9 mbarriers.
  static constexpr int SMEM = 1024 + QBYTES + 4 * KVBYTES + 9 * 8;
};

inline CUtensorMapSwizzle swizzle_of(int rb) {
  return rb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The consumers' per-tile steps, on one warpgroup's 64 query rows.
template <int D>
struct Consumer {
  using T = Tile<D>;
  static constexpr int CW = T::CW, RB = T::RB, NCH = T::NCH, KPC = T::KPC;
  static constexpr int NO = CW / 2;             // O registers per box
  static constexpr float kLog2e = 1.4426950408889634f;

  float o[NCH][NO];     // O, fp32, unnormalised
  float sc[32];         // this tile's logits, then its p
  uint32_t pa[4][4];    // the previous tile's p in bf16: wgmma's A operand
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // l: this
                                                           // thread's part

  // S = Q K^T: wgmma m64n64k16 over D / 16 steps, both operands K-major
  // in shared memory (a step inside a box moves the start by 32 bytes).
  __device__ __forceinline__ void issue_s(uint32_t sQw, uint32_t sK) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / KPC, w = kk % KPC;
      wgmma_ss_n64(sc,
                   smem_desc(sQw + c * kBM * RB + w * 32, 16, 8 * RB, T::SWZ),
                   smem_desc(sK + c * kBN * RB + w * 32, 16, 8 * RB, T::SWZ),
                   kk > 0);
    }
  }

  // O += P V: four k16 steps over the tile's keys, one wgmma per box of
  // D; V is MN-major (keys by rows of 8 at 8 * RB bytes).
  __device__ __forceinline__ void issue_pv(uint32_t sV) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        wgmma_rs<CW>(o[c], pa[kk],
                     smem_desc(sV + c * kBN * RB + kk * 16 * RB, 8 * RB,
                               8 * RB, T::SWZ));
  }

  // Scale, cap and mask the logits of the tile at key k0, then the online
  // softmax: p into sc, m and l updated; returns alpha per row.
  __device__ __forceinline__ float2 softmax(int k0, int Sk, int pos0,
                                            float scale, float softcap,
                                            int causal, int window,
                                            bool need_mask, int tig) {
    const int pos1 = pos0 + 8;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = sc[4 * j + e] * scale, x1 = sc[4 * j + 2 + e] * scale;
        if (softcap > 0.f) {
          x0 = softcap * tanhf(x0 / softcap);
          x1 = softcap * tanhf(x1 / softcap);
        }
        if (need_mask) {
          const int kj = k0 + 8 * j + 2 * tig + e;
          bool keep0 = kj < Sk, keep1 = kj < Sk;
          if (causal) {
            keep0 = keep0 && kj <= pos0;
            keep1 = keep1 && kj <= pos1;
          }
          if (window >= 0) {
            keep0 = keep0 && pos0 - kj < window;
            keep1 = keep1 && pos1 - kj < window;
          }
          x0 = keep0 ? x0 : kNegInf;
          x1 = keep1 ? x1 : kNegInf;
        }
        sc[4 * j + e] = x0;
        sc[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {       // the row's four threads
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float mc0 = fmaxf(m0, mx0), mc1 = fmaxf(m1, mx1);
    const bool dead0 = mc0 <= kNegInf / 2, dead1 = mc1 <= kNegInf / 2;
    const float a0 = dead0 ? 1.f : exp2f((m0 - mc0) * kLog2e);
    const float a1 = dead1 ? 1.f : exp2f((m1 - mc1) * kLog2e);
    m0 = mc0;
    m1 = mc1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = dead0 ? 0.f : exp2f((sc[4 * j + e] - mc0) * kLog2e);
        const float p1 =
            dead1 ? 0.f : exp2f((sc[4 * j + 2 + e] - mc1) * kLog2e);
        sc[4 * j + e] = p0;
        sc[4 * j + 2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    return make_float2(a0, a1);
  }

  // O *= alpha per row, and p to bf16: the accumulator's layout (rows r
  // and r + 8, column pairs 2 * tig) is already wgmma's A layout.
  __device__ __forceinline__ void rescale_and_pack(float2 a) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        o[c][4 * j + 0] *= a.x;
        o[c][4 * j + 1] *= a.x;
        o[c][4 * j + 2] *= a.y;
        o[c][4 * j + 3] *= a.y;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                          int Sq, int Sk, float scale, float softcap,
                          int causal, int window) {
  using T = Tile<D>;
  constexpr int CW = T::CW, RB = T::RB, NCH = T::NCH;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = sQ + T::QBYTES, sV = sK + 2 * T::KVBYTES;
  const uint32_t bars = sV + 2 * T::KVBYTES;
  // mbarriers: Q full; then per stage K full, V full, K empty, V empty.
  const uint32_t q_full = bars;
  auto k_full = [=](int s) { return bars + 8 + 8 * s; };
  auto v_full = [=](int s) { return bars + 24 + 8 * s; };
  auto k_empty = [=](int s) { return bars + 40 + 8 * s; };
  auto v_empty = [=](int s) { return bars + 56 + 8 * s; };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;                      // b * Hq + h
  const int qt = gridDim.y - 1 - blockIdx.y;      // heaviest tiles first
  const int b = bh / Hq, h = bh - b * Hq;
  const int bhk = b * Hkv + h / (Hq / Hkv);
  const int q0 = qt * kBM;
  const int off = Sk - Sq;                        // end alignment

  // the key tiles any of this tile's queries can see.
  const int pos_lo = q0 + off;
  const int pos_hi = min(q0 + kBM, Sq) - 1 + off;
  int kt_lo = 0, kt_hi = (Sk + kBN - 1) / kBN;
  if (causal) kt_hi = min(kt_hi, max(pos_hi, -1) / kBN + 1);
  if (window >= 0) {
    const int first = pos_lo - window + 1;        // lowest key position seen
    if (first > 0) kt_lo = first / kBN;
  }
  const int n_tiles = max(kt_hi - kt_lo, 0);

  auto load_k = [&](int i) {       // tile i's K into stage i % 2
    const int s = i & 1;
    mbar_expect_tx(k_full(s), T::KVBYTES);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      tma_load_3d(sK + s * T::KVBYTES + c * kBN * RB, &tm_k, k_full(s),
                  c * CW, (kt_lo + i) * kBN, bhk);
  };
  auto load_v = [&](int i) {
    const int s = i & 1;
    mbar_expect_tx(v_full(s), T::KVBYTES);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      tma_load_3d(sV + s * T::KVBYTES + c * kBN * RB, &tm_v, v_full(s),
                  c * CW, (kt_lo + i) * kBN, bhk);
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kThreads);            // every thread
      mbar_init(v_empty(s), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Q, and both stages of the ring.
    mbar_expect_tx(q_full, T::QBYTES);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      tma_load_3d(sQ + c * kBM * RB, &tm_q, q_full, c * CW, q0, bh);
    for (int i = 0; i < min(n_tiles, 2); ++i) {
      load_k(i);
      load_v(i);
    }
  }
  __syncthreads();

  // Each warpgroup takes 64 query rows.  Tile i's S = Q K^T is issued
  // together with tile i - 1's O += P V, and tile i's softmax runs while
  // that P V is on the tensor cores.  Thread 0 refills the ring: tile
  // i + 1's K once every thread is done with tile i - 1's K, its V once
  // every thread is done with tile i - 1's P V.
  const int cw = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = q0 + cw * 64 + warp * 16 + g;  // and row0 + 8
  const int pos0 = row0 + off;
  // the warpgroup's first and last query positions: a tile that all of
  // them see whole needs no mask.
  const int wpos_lo = q0 + cw * 64 + off, wpos_hi = wpos_lo + 63;
  const uint32_t sQw = sQ + cw * 64 * RB;
  auto need_mask = [=](int k0) {
    return k0 + kBN > Sk || (causal && k0 + kBN - 1 > wpos_lo) ||
           (window >= 0 && wpos_hi - k0 >= window);
  };

  Consumer<D> st;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int r = 0; r < Consumer<D>::NO; ++r) st.o[c][r] = 0.f;

  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    // tile 0: its S and softmax.
    mbar_wait(k_full(0), 0);
    __syncwarp();
    wgmma_fence();
    st.issue_s(sQw, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st.sc);
    mbar_arrive(k_empty(0));
    st.rescale_and_pack(st.softmax(kt_lo * kBN, Sk, pos0, scale, softcap,
                                   causal, window, need_mask(kt_lo * kBN),
                                   tig));
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i & 1, sp = s ^ 1;
      const uint32_t ph = (i >> 1) & 1, php = ((i - 1) >> 1) & 1;
      const int k0 = (kt_lo + i) * kBN;
      if (tid == 0 && i + 1 < n_tiles) {
        mbar_wait(k_empty(sp), php);
        load_k(i + 1);
      }
      mbar_wait(k_full(s), ph);
      mbar_wait(v_full(sp), php);
      __syncwarp();
      wgmma_fence();
      st.issue_s(sQw, sK + s * T::KVBYTES);
      wgmma_commit();
      st.issue_pv(sV + sp * T::KVBYTES);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st.sc);
      mbar_arrive(k_empty(s));
      const float2 alpha = st.softmax(k0, Sk, pos0, scale, softcap, causal,
                                      window, need_mask(k0), tig);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NCH; ++c) fence_regs(st.o[c]);
      mbar_arrive(v_empty(sp));
      if (tid == 0 && i + 1 < n_tiles) {
        mbar_wait(v_empty(sp), php);
        load_v(i + 1);
      }
      st.rescale_and_pack(alpha);
    }
    // the last tile's P V.
    const int sl = (n_tiles - 1) & 1;
    mbar_wait(v_full(sl), ((n_tiles - 1) >> 1) & 1);
    __syncwarp();
    wgmma_fence();
    st.issue_pv(sV + sl * T::KVBYTES);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(st.o[c]);
  }

  // epilogue: the row sums over the quad, O / l in bf16 ----------------------
  float l0 = st.l0, l1 = st.l1;
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float inv0 = l0 == 0.f ? 1.f : l0, inv1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* op = out + ((int64_t)bh * Sq) * D;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int j = 0; j < Consumer<D>::NO / 4; ++j) {
      const int d = c * CW + 8 * j + 2 * tig;
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(op + (int64_t)row0 * D + d) =
            __floats2bfloat162_rn(st.o[c][4 * j] / inv0,
                                  st.o[c][4 * j + 1] / inv0);
      if (row0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(op + (int64_t)(row0 + 8) * D + d) =
            __floats2bfloat162_rn(st.o[c][4 * j + 2] / inv1,
                                  st.o[c][4 * j + 3] / inv1);
    }
}

// A 3-D [BH, S, D] bf16 tensor map in boxes of [1, rows, cw].
bool make_map(CUtensorMap* map, const void* ptr, int BH, int S, int D,
              int cw, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cw, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle_of(2 * cw), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Sk, float scale, float softcap,
           int causal, int window, cudaStream_t st) {
  using T = Tile<D>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B * Hq, Sq, D, T::CW, kBM) ||
      !make_map(&mk, k, B * Hkv, Sk, D, T::CW, kBN) ||
      !make_map(&mv, v, B * Hkv, Sk, D, T::CW, kBN))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kBM - 1) / kBM));
  flash_attention_tc_kernel<D><<<grid, kThreads, T::SMEM, st>>>(
      mq, mk, mv, (__nv_bfloat16*)out, Hq, Hkv, Sq, Sk, scale, softcap,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace tc

// --------------------------------------------------------------------------
// rglru_scan (replaces rglru_scan, src/repro/kernels/rglru_scan.py:57)
//
// h[b, t, d] = a[b, t, d] * h[b, t - 1, d]
//              + sqrt(max(1 - a[b, t, d]^2, 0)) * x[b, t, d],  h[b, -1] = 0,
// with the carry in fp32 and h written in x's dtype.
//
// Bound: bytes — one read of x and a, one write of h (60.1 us at
// recurrentgemma's [4, 2048, 4096] bf16 at 3.35 TB/s).  A thread per
// channel walking all S steps keeps too few bytes in flight to come near
// that, so the scan is parallel over S too, by the associativity of the
// linear recurrence: a chunk of steps maps a carry c to A c + H, with A
// the product of its a and H its scan from zero, and chunks compose as
// (A1, H1) then (A2, H2) = (A2 A1, A2 H1 + H2).
//
// One CTA of kScanWarps = 16 warps (one CTA an SM, 128 registers a
// thread) owns 64 channels of one batch row, two per lane, so a warp's
// load of one step is one 128-byte line in bf16.  It walks S in
// super-chunks of 16 chunks of kSteps steps, one chunk per warp:
//   1. each warp takes its chunk's x and a out of the registers they were
//      loaded into one super-chunk earlier, and puts the next super-
//      chunk's loads in flight in their place, so the loads of one
//      super-chunk run under the arithmetic of the one before;
//   2. it scans the chunk from zero, giving (A, H) per channel and
//      keeping beta * x, and publishes (A, H) in shared memory (double-
//      buffered: one barrier per super-chunk);
//   3. each warp folds the entries before its own onto the super-chunk's
//      carry-in — its own carry-in — and all of them onto the next
//      super-chunk's;
//   4. it runs its chunk again from its carry-in, out of registers, and
//      writes h.
// The device memory traffic stays one read of x and a and one write of
// h; the price is a second pass of the recurrence's FMAs.  Steps past S
// are the identity (a = 1, x = 0) and are not written; channels past D
// are not written.  Pairs of channels are loaded as one word when D is
// even and the pointers are aligned to it; otherwise one element at a
// time.  A chunk is 16 steps in bf16 and 8 in fp32, so that both fit the
// registers.  Reassociation changes fp32 rounding;
// tests/test_torch_attention.py holds this order against the Pallas
// kernel at the RG-LRU tolerance.  Designs measured before this one are
// in PERF.md.
// --------------------------------------------------------------------------

constexpr int kScanWarps = 16;         // chunks per super-chunk
constexpr int kScanChannels = 64;      // channels per CTA, two per lane

template <typename T> struct ScanPair;
template <> struct ScanPair<__nv_bfloat16> {
  using raw = __nv_bfloat162;
  static constexpr int kSteps = 16;
  __device__ static __nv_bfloat16 of(float v) { return __float2bfloat16(v); }
  __device__ static float2 f32(raw r) { return __bfloat1622float2(r); }
  __device__ static raw pack(float2 v) { return __float22bfloat162_rn(v); }
  __device__ static raw make(__nv_bfloat16 u, __nv_bfloat16 v) {
    return __halves2bfloat162(u, v);
  }
  __device__ static __nv_bfloat16 lo(raw r) { return __low2bfloat16(r); }
  __device__ static __nv_bfloat16 hi(raw r) { return __high2bfloat16(r); }
};
template <> struct ScanPair<float> {
  using raw = float2;
  static constexpr int kSteps = 8;
  __device__ static float of(float v) { return v; }
  __device__ static float2 f32(raw r) { return r; }
  __device__ static raw pack(float2 v) { return v; }
  __device__ static raw make(float u, float v) { return make_float2(u, v); }
  __device__ static float lo(raw r) { return r.x; }
  __device__ static float hi(raw r) { return r.y; }
};

__device__ __forceinline__ float rglru_beta(float a) {
  return sqrtf(fmaxf(1.f - a * a, 0.f));
}

// One chunk's x and a for one lane's two channels, steps past S the
// identity (a = 1, x = 0).
template <typename T, bool kVec, int kSteps>
__device__ __forceinline__ void load_chunk(
    const T* __restrict__ x, const T* __restrict__ a, int64_t i, int64_t D,
    int n, bool in0, bool in1, typename ScanPair<T>::raw (&xr)[kSteps],
    typename ScanPair<T>::raw (&ar)[kSteps]) {
  using P = ScanPair<T>;
  using R = typename P::raw;
  const T one = P::of(1.f), zero = P::of(0.f);
#pragma unroll
  for (int u = 0; u < kSteps; ++u, i += D) {
    const bool i0 = u < n && in0, i1 = u < n && in1;
    if (kVec) {
      xr[u] = i0 ? *reinterpret_cast<const R*>(x + i) : P::make(zero, zero);
      ar[u] = i0 ? *reinterpret_cast<const R*>(a + i) : P::make(one, one);
    } else {
      xr[u] = P::make(i0 ? x[i] : zero, i1 ? x[i + 1] : zero);
      ar[u] = P::make(i0 ? a[i] : one, i1 ? a[i + 1] : one);
    }
  }
}

// Grid (ceil(D / 64), B).  kVec: D even and x, a, out aligned to a pair.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kScanWarps * 32, 16 / kScanWarps)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  T* __restrict__ out, int S, int D) {
  using P = ScanPair<T>;
  using R = typename P::raw;
  constexpr int kSteps = P::kSteps, kSuper = kScanWarps * kSteps;
  __shared__ float2 sA[2][kScanWarps][32], sH[2][kScanWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = blockIdx.x * kScanChannels + 2 * lane;
  const bool in0 = d < D, in1 = d + 1 < D;
  // element (t, d) of this batch row is at row + t * D
  const int64_t row = (int64_t)blockIdx.y * S * D + d;

  R xn[kSteps], an[kSteps];            // the next chunk, in flight
  load_chunk<T, kVec, kSteps>(x, a, row + (int64_t)warp * kSteps * D, D,
                              S - warp * kSteps, in0, in1, xn, an);
  float2 carry = make_float2(0.f, 0.f);
  int buf = 0;
  for (int s0 = 0; s0 < S; s0 += kSuper, buf ^= 1) {
    // 1. take this chunk; put the next super-chunk's in flight
    const int t0 = s0 + warp * kSteps;
    R xr[kSteps], ar[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      xr[u] = xn[u];
      ar[u] = an[u];
    }
    load_chunk<T, kVec, kSteps>(x, a, row + (int64_t)(t0 + kSuper) * D, D,
                                S - (t0 + kSuper), in0, in1, xn, an);

    // 2. the chunk from zero: (A, H) per channel; keep beta * x
    float2 gx[kSteps];
    float2 A = make_float2(1.f, 1.f), H = make_float2(0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const float2 av = P::f32(ar[u]), xv = P::f32(xr[u]);
      gx[u] = make_float2(rglru_beta(av.x) * xv.x, rglru_beta(av.y) * xv.y);
      H.x = av.x * H.x + gx[u].x;
      H.y = av.y * H.y + gx[u].y;
      A.x *= av.x;
      A.y *= av.y;
    }
    sA[buf][warp][lane] = A;
    sH[buf][warp][lane] = H;
    __syncthreads();

    // 3. this warp's carry-in, and the next super-chunk's
    float2 h = carry;
#pragma unroll
    for (int w = 0; w < kScanWarps; ++w) {
      if (w == warp) h = carry;
      const float2 Aw = sA[buf][w][lane], Hw = sH[buf][w][lane];
      carry.x = Aw.x * carry.x + Hw.x;
      carry.y = Aw.y * carry.y + Hw.y;
    }

    // 4. the chunk again from its carry-in; write h
    int64_t i = row + (int64_t)t0 * D;
#pragma unroll
    for (int u = 0; u < kSteps; ++u, i += D) {
      const float2 av = P::f32(ar[u]);
      h.x = av.x * h.x + gx[u].x;
      h.y = av.y * h.y + gx[u].y;
      if (t0 + u < S) {
        const R hv = P::pack(h);
        if (kVec) {
          if (in0) *reinterpret_cast<R*>(out + i) = hv;
        } else {
          if (in0) out[i] = P::lo(hv);
          if (in1) out[i + 1] = P::hi(hv);
        }
      }
    }
  }
}

template <typename T>
int launch_rglru(const void* x, const void* a, void* out, int B, int S,
                 int D, cudaStream_t st) {
  using R = typename ScanPair<T>::raw;
  const dim3 grid((unsigned)((D + kScanChannels - 1) / kScanChannels),
                  (unsigned)B);
  const bool vec = D % 2 == 0 &&
      ((uintptr_t)x | (uintptr_t)a | (uintptr_t)out) % sizeof(R) == 0;
  if (vec)
    rglru_scan_kernel<T, true><<<grid, kScanWarps * 32, 0, st>>>(
        (const T*)x, (const T*)a, (T*)out, S, D);
  else
    rglru_scan_kernel<T, false><<<grid, kScanWarps * 32, 0, st>>>(
        (const T*)x, (const T*)a, (T*)out, S, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 attention on the CUDA cores.  window < 0: no window; softcap <= 0:
// no cap.  q, k, v and out are contiguous.
int models_flash_attention(const void* q, const void* k, const void* v,
                           void* out, int B, int Hq, int Hkv, int Sq, int Sk,
                           int D, float scale, float softcap, int causal,
                           int window, void* stream) {
  if ((long long)B * Hq * Sq == 0) return (int)cudaGetLastError();
  return flash_by_dim<float>(D, q, k, v, out, B, Hq, Hkv, Sq, Sk, scale,
                             softcap, causal, window, (cudaStream_t)stream);
}

// bf16 attention on the tensor cores, with the same arguments; q, k and v
// also start at 16-byte boundaries (TMA's rule).
int models_flash_attention_tc(const void* q, const void* k, const void* v,
                              void* out, int B, int Hq, int Hkv, int Sq,
                              int Sk, int D, float scale, float softcap,
                              int causal, int window, void* stream) {
  const long long n = (long long)B * Hq * Sq;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (Sk == 0)                 // no key: every row is dead, its output 0
    return (int)cudaMemsetAsync(out, 0, (size_t)n * D * 2, st);
  switch (D) {
    case 16: return tc::launch<16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, scale,
                                   softcap, causal, window, st);
    case 32: return tc::launch<32>(q, k, v, out, B, Hq, Hkv, Sq, Sk, scale,
                                   softcap, causal, window, st);
    case 64: return tc::launch<64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, scale,
                                   softcap, causal, window, st);
    case 128: return tc::launch<128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, scale,
                                     softcap, causal, window, st);
    case 256: return tc::launch<256>(q, k, v, out, B, Hq, Hkv, Sq, Sk, scale,
                                     softcap, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int models_rglru_scan(const void* x, const void* a, void* out, int dtype,
                      int B, int S, int D, void* stream) {
  if ((long long)B * D == 0 || S == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_rglru<float>(x, a, out, B, S, D, st);
  if (dtype == 1) return launch_rglru<__nv_bfloat16>(x, a, out, B, S, D, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
