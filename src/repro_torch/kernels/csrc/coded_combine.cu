// Coded gradient combine out(R, F) = C(R, K) @ G(K, F) for Hopper
// (sm_90a), with the payload's dequantization fused in.  Plain C
// interface, loaded with ctypes by repro_torch/kernels/coded_combine.py.
//
// Replaces the four Pallas TPU kernels of repro/kernels/coded_combine.py:
//
//   kind 0  coded_combine     G float32
//   kind 1  coded_combine_q   G int8, times one f32 scale per block
//   kind 2  coded_combine_q4  G packed int4: value 2i in the low nibble of
//                             byte i, value 2i+1 in the high nibble, each
//                             sign-extended as ((p & 0xF) ^ 8) - 8, then
//                             times the block's scale
//   kind 3  coded_combine_f8  G float8 e4m3 (upcast exactly), times scale
//
// This is the encode (eq. 22) and decode (eqs. 25/27) of hierarchical
// gradient coding, and the fused dequant-combine of the compressed
// edge->master hop (K = number of pods, R = 1).
//
// Bound.  K is skinny (2 on the hop, <= 64 for encode/decode) and F is
// huge (one embedding leaf is 525,336,576 values), so every kind streams
// G once and is bound by memory: each G byte and scale read once, each
// output written once.  For the hop's int8 payload of the embedding leaf
// (K = 2, F = 525,336,576, block 64) that is 1.05 GB + 66 MB of scales +
// 2.10 GB of output, >= ~0.96 ms at 3.35 TB/s; for the evaluation's
// decode (R = 1, K = 40, F = 845,738) 135 MB of G, >= ~0.041 ms.
//
// Kind 0: a balanced persistent grid.  The grid-stride design (the
// generic kernel below with a float32 payload) lost to torch.mm at the
// evaluation shape: its 826 blocks of 256 threads left 34 of 132 SMs a
// seventh block to run alone (a tail of ~13 us at that shape, read as
// the intercept of its time against F), and the loads a thread kept in
// flight were whatever the compiler hoisted out of a loop over a
// runtime K with the vector/scalar branch inside.  This kernel instead:
//   * launches exactly the blocks the SMs hold at once (occupancy times
//     132), so no SM runs a later wave, and interleaves their threads
//     over F (thread i of n takes 4-column chunks i, i + n, ...): every
//     SM has the same work, and at any moment the card reads one
//     contiguous stretch of each row (contiguous per-block spans read
//     ~6% slower);
//   * walks K four rows at a time, issuing the four 16-byte loads (4
//     scalar loads where G's rows are not 16-byte aligned) before their
//     FMAs, with C read through the read-only cache;
//   * FMAs in f32 (never TF32) into RT x 4 registers, one launch per
//     call, K never split across blocks.
// A TMA ring (a producer warp keeping K rows of a column tile in flight
// with 1-D bulk copies, 8 consumer warps reading shared memory) was
// built and measured slower at every shape, as were other unroll
// depths: tools/combine_variants.cu keeps them, and
// tools/torch_combine_variants.py times them beside this kernel.

// Kinds 1-3 keep the grid-stride design: each thread owns VEC consecutive
// columns (16 for the 1-byte and packed payloads) and, for each tile of
// RT rows of C (the whole C sits in shared memory), keeps RT x VEC f32
// accumulators in registers, walking the K rows of G with one vector
// load each (16 bytes; 8 for packed int4), dequantizing in registers.
// A grid-stride loop covers any F; a scalar path takes the tail and rows
// that are not aligned for vector loads.  Any block size that divides
// the payload is taken (one scale per thread when block % VEC == 0, per
// value otherwise).  No padding: the Pallas wrapper's pad of F to 512 is
// gone.  Offsets are 64-bit throughout (a 525M-value f32 output is past
// 2^31 bytes).

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct PayI8 {
  using T = int8_t;
  static constexpr int VEC = 16;
  static constexpr int RT = 4;
  static constexpr bool SCALED = true;
  static __device__ __forceinline__ void load_vec(const T* row, long long f, float* v) {
    const int4 x = *reinterpret_cast<const int4*>(row + f);
    const int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = (float)(int8_t)((w[i >> 2] >> (8 * (i & 3))) & 0xFF);
  }
  static __device__ __forceinline__ float load_one(const T* row, long long f) {
    return (float)row[f];
  }
};

struct PayI4 {
  using T = uint8_t;  // the payload's bytes; two values each
  static constexpr int VEC = 16;
  static constexpr int RT = 4;
  static constexpr bool SCALED = true;
  static __device__ __forceinline__ float nib(unsigned p) {
    return (float)((int)((p & 0xFu) ^ 8u) - 8);
  }
  static __device__ __forceinline__ void load_vec(const T* row, long long f, float* v) {
    const uint2 x = *reinterpret_cast<const uint2*>(row + (f >> 1));
    const unsigned w[2] = {x.x, x.y};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned p = (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
      v[2 * i] = nib(p);
      v[2 * i + 1] = nib(p >> 4);
    }
  }
  static __device__ __forceinline__ float load_one(const T* row, long long f) {
    const unsigned p = row[f >> 1];
    return nib((f & 1) ? (p >> 4) : p);
  }
};

struct PayF8 {
  using T = uint8_t;  // e4m3 bit patterns
  static constexpr int VEC = 16;
  static constexpr int RT = 4;
  static constexpr bool SCALED = true;
  static __device__ __forceinline__ float cvt(unsigned b) {
    __nv_fp8_e4m3 x;
    x.__x = (__nv_fp8_storage_t)b;
    return (float)x;
  }
  static __device__ __forceinline__ void load_vec(const T* row, long long f, float* v) {
    const int4 x = *reinterpret_cast<const int4*>(row + f);
    const unsigned w[4] = {(unsigned)x.x, (unsigned)x.y, (unsigned)x.z, (unsigned)x.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = cvt((w[i >> 2] >> (8 * (i & 3))) & 0xFFu);
  }
  static __device__ __forceinline__ float load_one(const T* row, long long f) {
    return cvt(row[f]);
  }
};

// G row k starts at G + k * g_rs (elements of P::T); scales row k at
// S + k * s_rs; out is (R, F) packed.  vec_ok: G's rows are aligned for
// P's vector loads; out_vec: out's rows for float4 stores.
template <class P, int RT>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ C, int R, int K,
               const typename P::T* __restrict__ G, long long g_rs,
               const float* __restrict__ S, long long s_rs, long long block,
               long long F, float* __restrict__ out, int vec_ok, int out_vec) {
  constexpr int VEC = P::VEC;
  extern __shared__ float cs[];  // [R][K]
  for (int i = threadIdx.x; i < R * K; i += blockDim.x) cs[i] = C[i];
  __syncthreads();

  const bool uniform_scale = (block % VEC) == 0;
  const long long n_chunks = (F + VEC - 1) / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x; ch < n_chunks;
       ch += stride) {
    const long long f0 = ch * VEC;
    const int nv = (int)min((long long)VEC, F - f0);
    const bool full = vec_ok && nv == VEC;
    for (int r0 = 0; r0 < R; r0 += RT) {
      float acc[RT][VEC];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[rr][e] = 0.f;
      for (int k = 0; k < K; ++k) {
        const typename P::T* row = G + (long long)k * g_rs;
        float g[VEC];
        if (full) {
          P::load_vec(row, f0, g);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) g[e] = e < nv ? P::load_one(row, f0 + e) : 0.f;
        }
        if constexpr (P::SCALED) {
          const float* srow = S + (long long)k * s_rs;
          if (uniform_scale) {
            const float s = srow[f0 / block];
#pragma unroll
            for (int e = 0; e < VEC; ++e) g[e] *= s;
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              if (e < nv) g[e] *= srow[(f0 + e) / block];
          }
        }
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          const float c = (r0 + rr < R) ? cs[(r0 + rr) * K + k] : 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[rr][e] = fmaf(c, g[e], acc[rr][e]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        if (r0 + rr >= R) break;
        float* orow = out + (long long)(r0 + rr) * F + f0;
        if (full && out_vec) {
#pragma unroll
          for (int e = 0; e < VEC; e += 4)
            *reinterpret_cast<float4*>(orow + e) =
                make_float4(acc[rr][e], acc[rr][e + 1], acc[rr][e + 2], acc[rr][e + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            if (e < nv) orow[e] = acc[rr][e];
        }
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <class P, int RT>
int launch_rt(const float* C, int R, int K, const void* G, long long g_rs, const float* S,
              long long s_rs, long long block, long long F, float* out, int vec_ok,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)R * K;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(combine_kernel<P, RT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_chunks = (F + P::VEC - 1) / P::VEC;
  long long blocks = (n_chunks + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const int out_vec = (F % 4 == 0) && ((reinterpret_cast<uintptr_t>(out) & 15) == 0);
  combine_kernel<P, RT><<<(unsigned)blocks, kThreads, smem, stream>>>(
      C, R, K, static_cast<const typename P::T*>(G), g_rs, S, s_rs, block, F, out, vec_ok,
      out_vec);
  return (int)cudaGetLastError();
}

template <class P>
int launch(const float* C, int R, int K, const void* G, long long g_rs, const float* S,
           long long s_rs, long long block, long long F, float* out, int vec_ok,
           cudaStream_t stream) {
  if (R == 1)
    return launch_rt<P, 1>(C, R, K, G, g_rs, S, s_rs, block, F, out, vec_ok, stream);
  return launch_rt<P, P::RT>(C, R, K, G, g_rs, S, s_rs, block, F, out, vec_ok, stream);
}


// ---- kind 0: a balanced persistent grid -------------------------------

constexpr int kUnroll = 4;  // rows of G whose loads are in flight before their FMAs

// Thread i of n takes the 4-column chunks i, i + n, i + 2n, ... of F, so
// every SM holds the same number of threads and at any moment the card
// reads one contiguous stretch of every row.  For each tile of RT rows
// of C it walks the K rows of G kUnroll at a time: the kUnroll loads (16
// bytes each where G's rows allow, else 4 scalar loads) are issued
// before any of their FMAs.
template <int RT>
__global__ void __launch_bounds__(kThreads)
combine_f32_kernel(const float* __restrict__ C, int R, int K, const float* __restrict__ G,
                   long long g_rs, long long F, float* __restrict__ out, int vec_ok,
                   int out_vec) {
  const long long chunks = (F + 3) / 4, step = (long long)gridDim.x * blockDim.x;
  for (long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x; ch < chunks;
       ch += step) {
    const long long f0 = ch * 4;
    const int nv = (int)min(4LL, F - f0);
    const bool full = vec_ok && nv == 4;
    for (int r0 = 0; r0 < R; r0 += RT) {
      float acc[RT][4];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rr][e] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kUnroll) {
        float g[kUnroll][4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {  // rows past K reload row 0, unused
          const float* row = G + (long long)(k0 + u < K ? k0 + u : 0) * g_rs + f0;
          if (full) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(row));
            g[u][0] = x.x; g[u][1] = x.y; g[u][2] = x.z; g[u][3] = x.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) g[u][e] = e < nv ? __ldg(row + e) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k0 + u >= K) break;
#pragma unroll
          for (int rr = 0; rr < RT; ++rr) {
            const float c = (r0 + rr < R) ? __ldg(C + (long long)(r0 + rr) * K + k0 + u) : 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[rr][e] = fmaf(c, g[u][e], acc[rr][e]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        if (r0 + rr >= R) break;
        float* orow = out + (long long)(r0 + rr) * F + f0;
        if (full && out_vec) {
          *reinterpret_cast<float4*>(orow) =
              make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e < nv) orow[e] = acc[rr][e];
        }
      }
    }
  }
}

// As many blocks as the SMs hold at once (all resident: no SM runs a
// later wave), fewer when F is small.
template <int RT>
int launch_f32_rt(const float* C, int R, int K, const float* G, long long g_rs, long long F,
                  float* out, int vec_ok, cudaStream_t stream) {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, combine_f32_kernel<RT>, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) per_sm = 1;
  }
  const long long need = ((F + 3) / 4 + kThreads - 1) / kThreads;
  const long long most = (long long)sm_count() * per_sm;
  const long long blocks = need < most ? need : most;
  const int out_vec = (F % 4 == 0) && ((reinterpret_cast<uintptr_t>(out) & 15) == 0);
  combine_f32_kernel<RT><<<(unsigned)blocks, kThreads, 0, stream>>>(C, R, K, G, g_rs, F, out,
                                                                   vec_ok, out_vec);
  return (int)cudaGetLastError();
}

int launch_f32(const float* C, int R, int K, const float* G, long long g_rs, long long F,
               float* out, int vec_ok, cudaStream_t stream) {
  if (R == 1) return launch_f32_rt<1>(C, R, K, G, g_rs, F, out, vec_ok, stream);
  return launch_f32_rt<8>(C, R, K, G, g_rs, F, out, vec_ok, stream);
}

}  // namespace

// C (R, K) float32 packed; G rows of g_rs elements of the payload type
// (kind 2: bytes, each holding two values); S (K, F / block) float32 with
// row stride s_rs (unused for kind 0); out (R, F) float32 packed.  F is
// the number of values per row, block divides F (kinds 1-3).  vec_ok: G's
// base and row stride are aligned for the kind's vector loads (16 bytes;
// 8 for kind 2).  Returns cudaGetLastError().
extern "C" int coded_combine_launch(int kind, const void* C, int R, int K, const void* G,
                                    long long g_rs, const void* S, long long s_rs,
                                    long long block, long long F, void* out, int vec_ok,
                                    void* stream) {
  const float* c = static_cast<const float*>(C);
  const float* s = static_cast<const float*>(S);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || K < 1 || F < 1 || (kind != 0 && (block < 1 || F % block != 0)))
    return (int)cudaErrorInvalidValue;
  switch (kind) {
    case 0:
      return launch_f32(c, R, K, static_cast<const float*>(G), g_rs, F, o, vec_ok, st);
    case 1: return launch<PayI8>(c, R, K, G, g_rs, s, s_rs, block, F, o, vec_ok, st);
    case 2: return launch<PayI4>(c, R, K, G, g_rs, s, s_rs, block, F, o, vec_ok, st);
    case 3: return launch<PayF8>(c, R, K, G, g_rs, s, s_rs, block, F, o, vec_ok, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
