// Single-token GQA decode attention over the ring-buffer KV cache, for
// Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/decode_attention.py.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py:
// decode_attention_fwd (body _decode_attn_kernel).  It computes the same
// function: for each (sequence, query head) the softmax over the cache
// slots of q·k / sqrt(Dh), logit softcap applied before the mask, the
// slot positions derived from the ring write pointer
//     k_pos(s) = s + W * floor((q_pos - s) / W),   W = window or C,
// masked where k_pos < 0 (never written), k_pos > q_pos, or outside the
// sliding window, with -1e30 as the mask value and the denominator
// clamped at 1e-30.
//
// Design.  One block per (sequence, kv head): the G query heads of the
// group share every K/V tile, so the cache is read once per group.  K/V
// are read by stride straight from the decode cache's (B, C, Kv*Dh)
// layout (no transpose, no padding copy).  Tiles of TILE slots (16 KB of
// K and of V each) stream into shared memory with 16-byte cp.async
// copies, STAGES tiles in flight, so the sweep keeps loads outstanding
// while the previous tile is consumed.  Scores: each warp takes whole
// slots, its lanes split the head dimension and reduce by shuffles; the
// online softmax (m, l) and the probabilities stay in shared memory, the
// output accumulator in registers, all f32.  q_pos is read on the
// device through a pointer to the cache's int32 length, so a decode step
// needs no host sync.  The ragged last tile is zero-filled and masked by
// slot < C.
//
// Bound.  Decode is memory bound: per launch it must read the valid
// slots of K and V once (2 * B * n_valid * Kv * Dh * sizeof(T)) against
// 4 * B * H * n_valid * Dh flops.  At llama3-8b's serving shape
// (B=4, C=1057, Kv=8, Dh=128, bf16) that is ~17 MB, >= ~5 us at
// 3.35 TB/s.  The grid has B*Kv blocks (32 at that shape) on 132 SMs,
// so the card is under-filled and each block's SM must pull its whole
// group's cache; splitting the cache sweep across blocks is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kTileBytes = 16384;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// floor division for b > 0: C++ '/' truncates toward zero, and q_pos - s
// is negative for never-written slots.
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// 16-byte async copy global -> shared; zero-fills when !pred
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the 16-byte vector of VEC elements at p, as floats
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
}

template <typename T, int DH>
struct Shape {
  static constexpr int VEC = 16 / sizeof(T);        // elements per 16 B
  static constexpr int VPR = DH / VEC;              // vectors per slot row
  static constexpr int L = VPR < 32 ? VPR : 32;     // lanes per slot row
  static constexpr int NVL = VPR / L;               // vectors per lane
  static constexpr int R = 32 / L;                  // slot rows per warp
  static constexpr int TILE_MAX = kTileBytes / (DH * (int)sizeof(T));
  static constexpr int TILE = TILE_MAX < 64 ? TILE_MAX : 64;  // slots per tile
  static constexpr int NO = DH / 16;                // outputs per thread (G <= 16)
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   const int* __restrict__ q_pos_ptr, int Kv, int G, int C,
                   long long k_sb, long long k_sc, long long v_sb,
                   long long v_sc, int window, float softcap, float scale) {
  using S = Shape<T, DH>;
  constexpr int TILE = S::TILE, VEC = S::VEC, L = S::L, R = S::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kbuf = reinterpret_cast<T*>(smem_raw);                // [kStages][TILE][DH]
  T* vbuf = kbuf + kStages * TILE * DH;                    // [kStages][TILE][DH]
  float* qs = reinterpret_cast<float*>(vbuf + kStages * TILE * DH);  // [G][DH]
  float* ss = qs + G * DH;                                 // [G][TILE]
  float* m = ss + G * TILE;                                // [G]
  float* l = m + G;                                        // [G]
  float* corr = l + G;                                     // [G]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / Kv, kvh = blockIdx.x % Kv;
  const int H = Kv * G;
  const int GD = G * DH;
  const int qp = *q_pos_ptr;
  const int weff = window > 0 ? window : C;

  const T* qb = q + (long long)b * H * DH + (long long)kvh * G * DH;
  const T* kb = k + (long long)b * k_sb + (long long)kvh * DH;
  const T* vb = v + (long long)b * v_sb + (long long)kvh * DH;

  const int ntiles = (C + TILE - 1) / TILE;
  auto issue = [&](int tile) {
    const int stage = tile % kStages;
    T* kd = kbuf + stage * TILE * DH;
    T* vd = vbuf + stage * TILE * DH;
    for (int i = tid; i < TILE * S::VPR; i += kThreads) {
      const int row = i / S::VPR, c = i % S::VPR;
      const int slot = tile * TILE + row;
      const bool in = slot < C;
      const long long s = in ? slot : 0;
      cp_async16(kd + row * DH + c * VEC, kb + s * k_sc + c * VEC, in);
      cp_async16(vd + row * DH + c * VEC, vb + s * v_sc + c * VEC, in);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) issue(t);
    cp_async_commit();
  }

  for (int i = tid; i < GD; i += kThreads) qs[i] = to_f32(qb[i]) * scale;
  for (int g = tid; g < G; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  float acc[S::NO];
#pragma unroll
  for (int j = 0; j < S::NO; ++j) acc[j] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + kStages - 1 < ntiles) issue(tile + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* kt = kbuf + (tile % kStages) * TILE * DH;
    const T* vt = vbuf + (tile % kStages) * TILE * DH;
    const int base = tile * TILE;

    // scores: a warp takes R slot rows at a time, L lanes per row
    for (int row0 = warp * R; row0 < TILE; row0 += kWarps * R) {
      const int row = row0 + lane / L, c0 = lane % L;
      float kf[S::NVL * VEC];
#pragma unroll
      for (int j = 0; j < S::NVL; ++j)
        load_vec<T, VEC>(kt + row * DH + (c0 + j * L) * VEC, kf + j * VEC);
      const int slot = base + row;
      const int kpos = slot + weff * floor_div(qp - slot, weff);
      bool ok = slot < C && kpos >= 0 && kpos <= qp;
      if (window > 0) ok = ok && (qp - kpos < window);
      for (int g = 0; g < G; ++g) {
        const float* qr = qs + g * DH;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < S::NVL; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            s = fmaf(qr[(c0 + j * L) * VEC + e], kf[j * VEC + e], s);
#pragma unroll
        for (int o = L / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (c0 == 0) {
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          ss[g * TILE + row] = ok ? s : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per query head of the group
    for (int g = warp; g < G; g += kWarps) {
      float* rowp = ss + g * TILE;
      float mx = kNegInf;
      for (int t = lane; t < TILE; t += 32) mx = fmaxf(mx, rowp[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < TILE; t += 32) {
        const float p = expf(rowp[t] - m_new);
        rowp[t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr[g] = c;
        l[g] = l[g] * c + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V; thread owns outputs tid + 256 j of [G][DH]
#pragma unroll
    for (int j = 0; j < S::NO; ++j) {
      const int o = tid + j * kThreads;
      if (o < GD) {
        const int g = o / DH, d = o % DH;
        const float* p = ss + g * TILE;
        float a = acc[j] * corr[g];
#pragma unroll 8
        for (int t = 0; t < TILE; ++t) a = fmaf(p[t], to_f32(vt[t * DH + d]), a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  T* ob = out + (long long)b * H * DH + (long long)kvh * G * DH;
#pragma unroll
  for (int j = 0; j < S::NO; ++j) {
    const int o = tid + j * kThreads;
    if (o < GD) ob[o] = from_f32<T>(acc[j] / fmaxf(l[o / DH], 1e-30f));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out,
           const void* q_pos, int B, int Kv, int G, int C, long long k_sb,
           long long k_sc, long long v_sb, long long v_sc, int window,
           float softcap, cudaStream_t stream) {
  using S = Shape<T, DH>;
  const size_t bytes = 2 * (size_t)kStages * S::TILE * DH * sizeof(T) +
                       sizeof(float) * ((size_t)G * DH + (size_t)G * S::TILE + 3 * G);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_attn_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = 1.0f / sqrtf((float)DH);
  decode_attn_kernel<T, DH><<<B * Kv, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<const int*>(q_pos), Kv, G, C, k_sb, k_sc, v_sb,
      v_sc, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int Dh, const void* q, const void* k, const void* v, void* out,
              const void* q_pos, int B, int Kv, int G, int C, long long k_sb,
              long long k_sc, long long v_sb, long long v_sc, int window,
              float softcap, cudaStream_t s) {
#define REPRO_DECODE_DH(D)                                                        \
  case D:                                                                        \
    return launch<T, D>(q, k, v, out, q_pos, B, Kv, G, C, k_sb, k_sc, v_sb, v_sc, \
                        window, softcap, s);
  switch (Dh) {
    REPRO_DECODE_DH(16)
    REPRO_DECODE_DH(32)
    REPRO_DECODE_DH(64)
    REPRO_DECODE_DH(128)
    REPRO_DECODE_DH(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_DH
}

}  // namespace

// q (B, 1, H, Dh) packed; k/v (B, C, Kv, Dh) with heads and features
// packed, batch/slot strides in elements, every slot row 16-byte aligned.
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out, const void* q_pos,
    int dtype, int B, int Kv, int G, int C, int Dh, long long k_sb,
    long long k_sc, long long v_sb, long long v_sc, int window, float softcap,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dh<float>(Dh, q, k, v, out, q_pos, B, Kv, G, C, k_sb, k_sc, v_sb,
                              v_sc, window, softcap, s);
    case 1:
      return launch_dh<__nv_bfloat16>(Dh, q, k, v, out, q_pos, B, Kv, G, C, k_sb, k_sc,
                                      v_sb, v_sc, window, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
