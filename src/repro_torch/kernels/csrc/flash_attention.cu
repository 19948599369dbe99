// Flash-attention forward (online softmax) for Hopper (sm_90a): causal,
// sliding-window and logit-softcapped GQA self-attention over positions
// 0..S-1 (queries) and 0..T-1 (keys).  Plain C interface, loaded with
// ctypes by repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention_fwd (body _flash_fwd_kernel, GQA fold
// flash_attention_gqa).  It computes what repro/models/attention.py
// computes for prefill self-attention, which adds two things the Pallas
// kernel lacks: the logit softcap cap * tanh(s / cap) before the mask,
// and GQA without repeating K/V in memory (query head h reads kv head
// h / G directly).  Ragged S and T are masked in the kernel; the Pallas
// kernel needs S % 512 == T % 512 == 0.
//
// Bound.  At llama3-8b's prefill (B=4, S=1024, H=32, Kv=8, Dh=128, bf16,
// causal) the work is 4 * B * H * Dh * (S^2 + S) / 2 ~ 34.4 GFLOP, >= ~35 us
// at the bf16 tensor-core peak of 989 TFLOP/s, against 84 MB of q/k/v/o
// (>= ~25 us at 3.35 TB/s): compute bound, so the kernel has to reach the
// tensor cores' full rate, which on Hopper only wgmma gives.
//
// Three kernels, chosen in the C entry by dtype and head size alone (never
// as a fallback: a failed descriptor encode or launch is returned as an
// error and the wrapper raises):
//
//  * wgmma + TMA, bf16 with Dh in {64, 128, 256} (the full configs' heads;
//    the model's path).  One block of two warpgroups per (64-query tile,
//    batch * head), two blocks per SM at Dh 64 and 128, one at Dh 256
//    (recurrentgemma's local layers: Q and the K/V ring take 160 KB of
//    shared memory, O 128 registers a consumer thread); the grid walks the
//    causal query tiles heaviest first.  At two blocks per SM warpgroup 0
//    gives up registers (setmaxnreg); one of its threads loads Q once and
//    keeps a ring of 2 K/V tiles
//    (64 keys each) in flight with cp.async.bulk.tensor, each completion
//    counted on an mbarrier.  The tensor maps are built on the host from
//    the real batch and row strides (rank 3: {heads * Dh, rows, batch},
//    64-feature boxes with the 128-byte swizzle, so a Dh = 128 tile is two
//    64-column spans); TMA zero-fills rows past S or T, which the mask then
//    excludes.  Warpgroup 1 takes the registers and owns the 64 query rows:
//    S = Q K^T by wgmma.mma_async m64n64k16 with Q and K read from swizzled
//    shared memory (K-major), the online softmax in registers (scale,
//    softcap, then the mask, applied only on tiles that cross the causal
//    diagonal, the window edge or T; scores kept in log2 units), P rounded
//    to bf16 in registers as the A operand of O += P V (one m64nDhk16
//    product per 16 keys; two m64n128k16 at Dh 256), with V read as the
//    transposed (MN-major) B
//    operand straight from its TMA tile; O stays in f32 registers.  Each
//    consumer warp releases a stage on its "empty" mbarrier once its P V
//    product has completed.  Tiles above the diagonal or before the window
//    are never loaded.  The other block on the SM runs its softmax while
//    this one's products use the tensor cores; a warpgroup still waits on
//    its own products around its softmax, which is what keeps the kernel
//    at about a third of the tensor-core peak (PERF.md has the times and
//    the variants measured against this one: two consumer warpgroups over
//    128 rows, 3 stages, 128-key tiles, and a software pipeline issuing the
//    next tile's scores before this tile's P V were all slower).
//  * mma.sync, bf16 with Dh in {16, 32} (only the smoke configs): one
//    block of 4 warps per (64-query tile, batch * head), each warp owning
//    16 query rows; Q, K and V tiles in padded shared memory, S and O as
//    m16n8k16 fragments in registers (flash-attention-2 layout).
//  * f32 FMA, for float32 inputs (which must not pass through TF32):
//    one block of 256 threads per (64-query tile, batch * head); Q
//    (pre-scaled), the 64-key K and V tiles and the 64x64 score tile in
//    shared memory as f32, a 4x4 score micro-tile and a 4 x (Dh/16) slice
//    of the accumulator in registers.
//
// All three skip whole K tiles above the causal diagonal or before the
// sliding window; mask value -1e30, denominator clamped at 1e-30, as in
// the reference.  Optionally each row's log-sum-exp is written too (the
// training forward saves it for the recompute backward).

#include <cuda.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kSS = kBK + 1;  // padded score-tile row
constexpr float kNegInf = -1e30f;
// returned when the CUDA driver refuses a TMA descriptor (not a cudaError_t)
constexpr int kTensorMapError = 1000;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)2 * kBQ * (DH + 1) + (size_t)kBK * DH +
                          (size_t)kBQ * kSS + 3 * kBQ);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int T_, int H, int G,
                 long long q_sb, long long q_ss, long long k_sb,
                 long long k_ss, long long v_sb, long long v_ss,
                 long long o_sb, long long o_ss, int causal, int window,
                 float softcap, float scale) {
  constexpr int DS = DH + 1;       // padded Q/K row
  constexpr int NJ = DH / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                // [kBQ][DS]
  float* ks = qs + kBQ * DS;       // [kBK][DS]
  float* vs = ks + kBK * DS;       // [kBK][DH]
  float* ss = vs + kBK * DH;       // [kBQ][kSS]
  float* m = ss + kBQ * kSS;       // [kBQ]
  float* l = m + kBQ;              // [kBQ]
  float* corr = l + kBQ;           // [kBQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / G;

  const T* qb = q + b * q_sb + (long long)h * DH;
  const T* kb = k + b * k_sb + (long long)kvh * DH;
  const T* vb = v + b * v_sb + (long long)kvh * DH;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int qpos = q0 + r;
    qs[r * DS + d] = qpos < S ? to_f32(qb[qpos * q_ss + d]) * scale : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // key tiles this query tile can see
  const int q_last = min(q0 + kBQ, S) - 1;
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 - window + 1) / kBK * kBK;
  const int kv_end = causal ? min(T_, q_last + 1) : T_;
  __syncthreads();

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      const int kpos = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kpos < T_) {
        kx = to_f32(kb[kpos * k_ss + d]);
        vx = to_f32(vb[kpos * v_ss + d]);
      }
      ks[r * DS + d] = kx;
      vs[r * DH + d] = vx;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        float val = s[i][j];
        if (softcap > 0.f) val = softcap * tanhf(val / softcap);
        bool ok = kpos < T_;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos < window);
        ss[r * kSS + c] = ok ? val : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: four threads per row, sixteen columns each
    {
      const int r = tid >> 2, sub = tid & 3;
      float* row = ss + r * kSS;
      float mx = kNegInf;
#pragma unroll
      for (int c = sub; c < kBK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = sub; c < kBK; c += 4) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (sub == 0) {
        const float cf = expf(m_old - m_new);
        corr[r] = cf;
        l[r] = l[r] * cf + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cf = corr[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= cf;
    }
#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * kSS + t];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[t * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

  T* ob = out + b * o_sb + (long long)h * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
    if (qpos >= S) continue;
    if (lse != nullptr && tx == 0)
      lse[((long long)b * S + qpos) * H + h] = m[r] + logf(fmaxf(l[r], 1e-30f));
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      ob[qpos * o_ss + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

// ---------------------------------------------------------------------
// mma.sync kernel (bf16, Dh in {16, 32})
// ---------------------------------------------------------------------
constexpr int kMmaThreads = 128;

template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* d, const unsigned* a, const unsigned* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&h);
  }
};

template <typename T>
__device__ __forceinline__ unsigned ld32(const T* p) {
  return *reinterpret_cast<const unsigned*>(p);
}
template <typename T>
__device__ __forceinline__ unsigned pack2(T lo, T hi) {
  const unsigned short l = *reinterpret_cast<const unsigned short*>(&lo);
  const unsigned short h = *reinterpret_cast<const unsigned short*>(&hi);
  return (unsigned)l | ((unsigned)h << 16);
}

template <int DH>
constexpr size_t mma_smem_bytes() {
  return 2 * (size_t)(kBQ + 2 * kBK) * (DH + 8);  // Q, K, V tiles of 16-bit
}

// rows x DH tile from global (row stride rs) into shared (row stride DH+8),
// 16-byte vectors, zero rows at and beyond n_valid
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs, int n_valid,
                                          int tid) {
  constexpr int VPR = DH / 8;  // 16-byte vectors per row
  constexpr int N = ROWS * VPR / kMmaThreads;
  uint4 buf[N > 0 ? N : 1];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = tid + j * kMmaThreads;
    const int r = i / VPR, c = i % VPR;
    buf[j] = r < n_valid ? *reinterpret_cast<const uint4*>(src + r * rs + c * 8)
                         : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = tid + j * kMmaThreads;
    const int r = i / VPR, c = i % VPR;
    *reinterpret_cast<uint4*>(dst + r * (DH + 8) + c * 8) = buf[j];
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int S, int T_, int H, int G,
                 long long q_sb, long long q_ss, long long k_sb,
                     long long k_ss, long long v_sb, long long v_ss, long long o_sb,
                     long long o_ss, int causal, int window, float softcap,
                     float scale) {
  static_assert(DH % 16 == 0 && DH <= 128, "mma path takes Dh in {16..128}");
  static_assert(kBQ * DH / 8 >= kMmaThreads, "tile smaller than the block");
  constexpr int DS = DH + 8;  // padded row: conflict-free fragment loads
  constexpr int NK = DH / 16, NN = kBK / 8, ND = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kBQ][DS]
  T* ks = qs + kBQ * DS;                   // [kBK][DS]
  T* vs = ks + kBK * DS;                   // [kBK][DS]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma group / thread-in-group
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / G;
  const T* qb = q + b * q_sb + (long long)h * DH;
  const T* kb = k + b * k_sb + (long long)kvh * DH;
  const T* vb = v + b * v_sb + (long long)kvh * DH;

  load_tile<T, DH, kBQ>(qs, qb + q0 * q_ss, q_ss, S - q0, tid);

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_row[2] = {kNegInf, kNegInf}, l_row[2] = {0.f, 0.f};
  const int r0 = warp * 16 + gq;  // this thread's rows r0 and r0 + 8
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};

  const int q_last = min(q0 + kBQ, S) - 1;
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 - window + 1) / kBK * kBK;
  const int kv_end = causal ? min(T_, q_last + 1) : T_;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and Q stored)
    load_tile<T, DH, kBK>(ks, kb + k0 * k_ss, k_ss, T_ - k0, tid);
    load_tile<T, DH, kBK>(vs, vb + k0 * v_ss, v_ss, T_ - k0, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sc[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      const T* qa = qs + r0 * DS + kc * 16 + tq * 2;
      const unsigned a[4] = {ld32(qa), ld32(qa + 8 * DS), ld32(qa + 8),
                             ld32(qa + 8 * DS + 8)};
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const T* kp = ks + (n * 8 + gq) * DS + kc * 16 + tq * 2;
        const unsigned bb[2] = {ld32(kp), ld32(kp + 8)};
        Mma<T>::run(sc[n], a, bb);
      }
    }

    // scale, softcap, mask; online softmax over the two rows
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + tq * 2 + (e & 1);
        const int qp = qpos[e >> 1];
        float val = sc[n][e] * scale;
        if (softcap > 0.f) val = softcap * tanhf(val / softcap);
        bool ok = kpos < T_;
        if (causal) ok = ok && kpos <= qp;
        if (window > 0) ok = ok && (qp - kpos < window);
        sc[n][e] = ok ? val : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_row[r], mx[r]);
      corr[r] = expf(m_row[r] - m_new);
      m_row[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[n][e] - m_row[e >> 1]);
        sc[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_row[r] = l_row[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: the S fragments of keys 16kk..16kk+15 are P's A operand
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const unsigned a[4] = {
          Mma<T>::pack(sc[2 * kk][0], sc[2 * kk][1]),
          Mma<T>::pack(sc[2 * kk][2], sc[2 * kk][3]),
          Mma<T>::pack(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          Mma<T>::pack(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const T* vr = vs + (kk * 16 + tq * 2) * DS + gq;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const T* vp = vr + n * 8;
        const unsigned bb[2] = {pack2(vp[0], vp[DS]), pack2(vp[8 * DS], vp[9 * DS])};
        Mma<T>::run(o[n], a, bb);
      }
    }
  }

  T* ob = out + b * o_sb + (long long)h * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= S) continue;
    if (lse != nullptr && tq == 0)
      lse[((long long)b * S + qpos[r]) * H + h] = m_row[r] + logf(fmaxf(l_row[r], 1e-30f));
    const float inv = 1.f / fmaxf(l_row[r], 1e-30f);
    T* orow = ob + qpos[r] * o_ss;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      orow[n * 8 + tq * 2] = from_f32<T>(o[n][2 * r] * inv);
      orow[n * 8 + tq * 2 + 1] = from_f32<T>(o[n][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------
// wgmma + TMA kernel (bf16, Dh in {64, 128})
// ---------------------------------------------------------------------
namespace wg {

constexpr int kBQ = 64;       // query rows per block: one consumer warpgroup
constexpr int kBK = 64;       // keys per K/V tile: S is one N = 64 product per k step
static_assert(kBK == 64, "the score tile is one m64n64k16 product per k step");
constexpr int kStages = 2;    // K/V tiles in flight
constexpr int kThreads = 256;  // warpgroup 0 loads, warpgroup 1 computes
// Dh 64 and 128: two blocks per SM, 2 * 256 threads * 128 registers at
// launch, of which the producer gives 104 a thread to the consumer (24 + 232
// = 2 * 128).  Dh 256: Q and a 2-stage ring take 160 KB of shared memory, so
// one block per SM, whose threads may each hold up to 255 registers without
// any trade (the consumer's O alone is 128 of them).
template <int DH>
__host__ __device__ constexpr int blocks_per_sm() { return DH == 256 ? 1 : 2; }
constexpr int kSpan = 64;     // bf16 columns in one 128-byte swizzle span (one TMA box)
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, 1024-byte aligned (the 128-byte swizzle's period): Q, then
// the K ring, then the V ring, then the barriers.  A tile of R rows x Dh is
// stored as Dh / 64 column spans of R rows x 128 bytes, each span as TMA
// writes it with CU_TENSOR_MAP_SWIZZLE_128B.
template <int DH>
struct Layout {
  static constexpr int kSpans = DH / kSpan;
  static constexpr int kQBytes = kBQ * DH * 2;
  static constexpr int kTileBytes = kBK * DH * 2;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box (64 columns x rows x 1) of a rank-3 map {columns, rows, batch}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(batch), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading and
// stride byte offsets (all in 16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (Q as A, K as B of S = Q K^T): rows of 128 bytes, 8-row
// groups 1024 bytes apart; a 16-column k step moves the start by 32 bytes
// inside the swizzle span.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) { return desc(addr, 16, 1024); }
// MN-major operand (V as B of O = P V, transposed): 8-slot groups 1024 bytes
// apart (stride offset), the 64-feature spans kBK * 128 bytes apart (leading
// offset), so one N = 128 instruction reads both spans of a Dh = 128 tile.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc(addr, kBK * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads/writes across the async MMA
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D (64 x 64, f32 registers) (+)= A (64 x 16, smem) * B (64 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}


// D (64 x 64, f32 registers) += A (64 x 16, bf16 registers) * B (16 x 64, smem,
// MN-major: the 16 rows are 16 slots of V, each 64 features wide)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// D (64 x 128, f32 registers) += A (64 x 16, bf16 registers) * B (16 x 128, smem,
// MN-major: the 16 rows are 16 slots of V, each 128 features wide)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<DH>())
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int S, int T_, int H, int G, long long o_sb,
                       long long o_ss, int causal, int window, float softcap, float scale) {
  using L = Layout<DH>;
  constexpr int kSpans = L::kSpans;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages,
                 empty = v_full + 8 * kStages;  // + 8 * stage

  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // the causal diagonal's heaviest first
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int kv_end = causal ? min(T_, q_last + 1) : T_;
  const int n_kv = kv_end > kv_begin ? (kv_end - kv_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the K/V ring full by TMA ----
    if constexpr (blocks_per_sm<DH>() == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int sp = 0; sp < kSpans; ++sp)
        tma_load(base + L::kQ + sp * kBQ * 128, &tq, h * DH + sp * kSpan, q0, b, q_full);
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * st, ((it / kStages) - 1) & 1);
        const int k0 = kv_begin + it * kBK;
        const uint32_t kd = base + L::kK + st * L::kTileBytes;
        const uint32_t vd = base + L::kV + st * L::kTileBytes;
        mbar_expect_tx(k_full + 8 * st, L::kTileBytes);
#pragma unroll
        for (int sp = 0; sp < kSpans; ++sp)
          tma_load(kd + sp * kBK * 128, &tk, kvh * DH + sp * kSpan, k0, b, k_full + 8 * st);
        mbar_expect_tx(v_full + 8 * st, L::kTileBytes);
#pragma unroll
        for (int sp = 0; sp < kSpans; ++sp)
          tma_load(vd + sp * kBK * 128, &tv, kvh * DH + sp * kSpan, k0, b, v_full + 8 * st);
      }
    }
    return;
  }

  // ---- consumer warpgroup: the block's 64 query rows; every loaded tile is
  // one that some of its rows can see ----
  if constexpr (blocks_per_sm<DH>() == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r_hi = q0 + kBQ - 1;
  const int qpos[2] = {q0 + 16 * warp + lane / 4, q0 + 16 * warp + lane / 4 + 8};
  const int col = 2 * (lane % 4);

  float o[kSpans][32];
#pragma unroll
  for (int sp = 0; sp < kSpans; ++sp)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[sp][i] = 0.f;
  // m in log2 units; l: this thread's share of the row sum
  float m_row[2] = {kNegInf * kLog2e, kNegInf * kLog2e}, l_row[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  const uint32_t q_base = base + L::kQ;

  for (int it = 0; it < n_kv; ++it) {
    const int st = it % kStages, phase = (it / kStages) & 1;
    const int k0 = kv_begin + it * kBK;
    const uint32_t k_base = base + L::kK + st * L::kTileBytes;
    const uint32_t v_base = base + L::kV + st * L::kTileBytes;
    mbar_wait(k_full + 8 * st, phase);
    // S = Q K^T: 64 rows x kBK keys, f32 in registers
    float s[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) {
      const uint32_t off = (kc % 4) * 32;  // 16 columns inside the span
      wgmma_ss_n64(s, desc_kmajor(q_base + (kc / 4) * kBQ * 128 + off),
                   desc_kmajor(k_base + (kc / 4) * kBK * 128 + off), kc > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale, softcap, then the mask (only on tiles that cross an edge);
    // the scores are then kept in log2 units, so that a row whose tile is
    // all masked subtracts equal values exactly (p = 1, wiped later by
    // its first valid key's correction, as in the reference's -1e30 mask)
    const bool mask = k0 + kBK > T_ || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && r_hi - k0 >= window);
    float mx[2] = {kNegInf * kLog2e, kNegInf * kLog2e};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[4 * j + e] * scale;
        if (softcap > 0.f) val = softcap * tanhf(val / softcap);
        if (mask) {
          const int kpos = k0 + 8 * j + col + (e & 1);
          const int qp = qpos[e >> 1];
          bool ok = kpos < T_;
          if (causal) ok = ok && kpos <= qp;
          if (window > 0) ok = ok && (qp - kpos < window);
          val = ok ? val : kNegInf;
        }
        val *= kLog2e;
        s[4 * j + e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_row[r], mx[r]);
      corr[r] = ex2(m_row[r] - m_new);
      m_row[r] = m_new;
      l_row[r] *= corr[r];
    }
    uint32_t p[kBK / 4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float p0 = ex2(s[4 * j] - m_row[0]);
      const float p1 = ex2(s[4 * j + 1] - m_row[0]);
      const float p2 = ex2(s[4 * j + 2] - m_row[1]);
      const float p3 = ex2(s[4 * j + 3] - m_row[1]);
      l_row[0] += p0 + p1;
      l_row[1] += p2 + p3;
      p[2 * j] = pack_bf16(p0, p1);
      p[2 * j + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int sp = 0; sp < kSpans; ++sp)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[sp][4 * j] *= corr[0];
        o[sp][4 * j + 1] *= corr[0];
        o[sp][4 * j + 2] *= corr[1];
        o[sp][4 * j + 3] *= corr[1];
      }

    // O += P V: P (bf16 registers) is the A operand, keys 16 kk .. 16 kk + 15
    mbar_wait(v_full + 8 * st, phase);
#pragma unroll
    for (int sp = 0; sp < kSpans; ++sp) fence_regs(o[sp]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      if constexpr (kSpans == 1)
        wgmma_rs_n64(o[0], a, desc_mnmajor(v_base + kk * 16 * 128));
      else {  // one N = 128 product over each pair of spans
#pragma unroll
        for (int sp = 0; sp < kSpans; sp += 2)
          wgmma_rs_n128(reinterpret_cast<float(&)[64]>(o[sp]), a,
                        desc_mnmajor(v_base + sp * kBK * 128 + kk * 16 * 128));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int sp = 0; sp < kSpans; ++sp) fence_regs(o[sp]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  // epilogue: O / max(l, 1e-30), and m + log(max(l, 1e-30))
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  __nv_bfloat16* ob = out + b * o_sb + (long long)h * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= S) continue;
    const float lc = fmaxf(l_row[r], 1e-30f);
    if (lse != nullptr && (lane % 4) == 0)
      lse[((long long)b * S + qpos[r]) * H + h] = m_row[r] / kLog2e + logf(lc);
    const float inv = 1.f / lc;
    __nv_bfloat16* orow = ob + qpos[r] * o_ss + col;
#pragma unroll
    for (int sp = 0; sp < kSpans; ++sp)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + sp * kSpan + 8 * j) =
            __floats2bfloat162_rn(o[sp][4 * j + 2 * r] * inv, o[sp][4 * j + 2 * r + 1] * inv);
  }
}

// cuTensorMapEncodeTiled, fetched from the CUDA driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The rank-3 map {heads * Dh, rows, batch} of a (B, rows, heads, Dh) bf16
// tensor whose heads and features are packed, from its real row and batch
// strides (elements; 16-byte multiples).  Boxes of 64 features x box_rows
// rows, 128-byte swizzle; rows past `rows` are zero-filled.  A stride of a
// dimension of size 1 is never followed, so it is set to a valid value.
bool make_map(CUtensorMap* map, const void* ptr, int width, int rows, int batch,
              long long row_stride, long long batch_stride, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  if (rows == 1) row_stride = width;
  if (batch == 1) batch_stride = row_stride * rows;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 2, (cuuint64_t)batch_stride * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kSpan, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg

template <typename T, int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                 int S, int T_, int H, int Kv, const long long* st, int causal, int window,
                 float softcap, cudaStream_t stream) {
  static_assert(sizeof(T) == 2 && (DH == 64 || DH == 128 || DH == 256),
                "wgmma path: bf16, Dh 64, 128 or 256");
  CUtensorMap tq, tk, tv;
  if (!wg::make_map(&tq, q, H * DH, S, B, st[1], st[0], wg::kBQ) ||
      !wg::make_map(&tk, k, Kv * DH, T_, B, st[3], st[2], wg::kBK) ||
      !wg::make_map(&tv, v, Kv * DH, T_, B, st[5], st[4], wg::kBK))
    return kTensorMapError;
  constexpr int bytes = wg::Layout<DH>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(wg::flash_fwd_wgmma_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (S + wg::kBQ - 1) / wg::kBQ);
  const float scale = 1.0f / sqrtf((float)DH);
  wg::flash_fwd_wgmma_kernel<DH><<<grid, wg::kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, S, T_, H, H / Kv, st[6], st[7], causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_mma(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
               int T_, int H, int Kv, const long long* st, int causal, int window,
               float softcap, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<DH>();
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  const float scale = 1.0f / sqrtf((float)DH);
  flash_fwd_mma_kernel<T, DH><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, T_, H, H / Kv, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
           int S, int T_, int H, int Kv, const long long* st, int causal,
           int window, float softcap, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DH>();
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  const float scale = 1.0f / sqrtf((float)DH);
  flash_fwd_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, T_, H, H / Kv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], causal, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int Dh, const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int S, int T_, int H, int Kv, const long long* st,
              int causal, int window, float softcap, cudaStream_t stream) {
#define REPRO_FLASH(KIND, D) \
  return KIND<T, D>(q, k, v, out, lse, B, S, T_, H, Kv, st, causal, window, softcap, stream)
  if constexpr (sizeof(T) == 2) {  // tensor cores
    switch (Dh) {
      case 16: REPRO_FLASH(launch_mma, 16);
      case 32: REPRO_FLASH(launch_mma, 32);
      case 64: REPRO_FLASH(launch_wgmma, 64);
      case 128: REPRO_FLASH(launch_wgmma, 128);
      case 256: REPRO_FLASH(launch_wgmma, 256);
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (Dh) {
      case 16: REPRO_FLASH(launch, 16);
      case 32: REPRO_FLASH(launch, 32);
      case 64: REPRO_FLASH(launch, 64);
      case 128: REPRO_FLASH(launch, 128);
      case 256: REPRO_FLASH(launch, 256);
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef REPRO_FLASH
}

}  // namespace

// q (B, S, H, Dh), k/v (B, T, Kv, Dh), out (B, S, H, Dh); lse, when not
// null, (B, S, H) float32 packed: each row's log-sum-exp of its scaled,
// softcapped and masked scores, m + log(max(l, 1e-30)), as the
// reference's flash custom VJP saves it for the backward.  The head and
// feature strides are (Dh, 1); for 16-bit inputs every row is 16-byte
// aligned.  strides = {q_b, q_s, k_b, k_s, v_b, v_s,
// o_b, o_s} in elements.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError(), or kTensorMapError (1000) when the CUDA driver
// refuses a TMA descriptor of the wgmma kernel.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse, int dtype, int B,
    int S, int T_, int H, int Kv, int Dh, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    long long o_sb, long long o_ss, int causal, int window, float softcap,
    void* stream) {
  const long long st[8] = {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dh<float>(Dh, q, k, v, out, static_cast<float*>(lse), B, S, T_, H, Kv, st, causal, window, softcap, s);
    case 1:
      return launch_dh<__nv_bfloat16>(Dh, q, k, v, out, static_cast<float*>(lse), B, S, T_, H, Kv, st, causal, window, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
