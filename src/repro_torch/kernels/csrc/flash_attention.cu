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
// Design.  Two kernels, chosen by dtype in the C entry:
//
//  * tensor cores, for bf16 (Dh <= 128; the model's path): one
//    block of 4 warps per (64-query tile, batch * head), each warp owning
//    16 query rows.  Q, K and V tiles (64 x Dh, 16-byte vector loads) sit
//    in shared memory; S = Q K^T and O += P V run as mma.sync m16n8k16
//    with f32 accumulation, the score tile, the online softmax (m, l) and
//    the O accumulator stay in registers (flash-attention-2 layout: the
//    S accumulator fragments are re-packed as the A operand of P V).
//    P is rounded to the input dtype before the second product.
//  * f32 FMA, for float32 inputs (which must not pass through TF32):
//    one block of 256 threads per (64-query tile, batch *
//    head); Q (pre-scaled), the 64-key K and V tiles and the 64x64 score
//    tile in shared memory as f32, a 4x4 score micro-tile and a
//    4 x (Dh/16) slice of the accumulator in registers.
//
// Both skip whole K tiles above the causal diagonal or before the
// sliding window; mask value -1e30, denominator clamped at 1e-30, as in
// the reference.  Optionally each row's log-sum-exp is written too (the
// training forward saves it for the recompute backward).
//
// Bound.  At llama3-8b's prefill (B=4, S=1024, H=32, Kv=8, Dh=128, bf16,
// causal) the work is 4 * B * H * Dh * (S^2 + S) / 2 ~ 34.4 GFLOP, >= ~35 us
// at the bf16 tensor-core peak of 989 TFLOP/s, against 84 MB of q/k/v/o
// (>= ~25 us at 3.35 TB/s): compute bound.  mma.sync reaches only part of
// that peak (wgmma is Hopper's full-rate path), and the tiles are loaded
// without overlap with compute; both are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kSS = kBK + 1;  // padded score-tile row
constexpr float kNegInf = -1e30f;

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
// tensor-core kernel (bf16, Dh <= 128)
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
  if constexpr (sizeof(T) == 2) {  // tensor cores up to Dh = 128
    switch (Dh) {
      case 16: REPRO_FLASH(launch_mma, 16);
      case 32: REPRO_FLASH(launch_mma, 32);
      case 64: REPRO_FLASH(launch_mma, 64);
      case 128: REPRO_FLASH(launch_mma, 128);
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
// Returns cudaGetLastError().
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
