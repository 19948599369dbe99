// The MoE layer's token permutation into and out of the experts' slots,
// forward and backward, for Hopper (sm_90a).  Plain C interface, loaded
// with ctypes by repro_torch/kernels/moe_shuffle.py.
//
// Replaces no Pallas kernel: the reference's dispatch and combine
// (repro/models/moe.py) are jnp gathers and scatter-adds, left to XLA.
// In PyTorch they were eight indexing and copy ops whose backward passes
// are atomic index_adds (see kernels/ref.py for that plain version).
//
// The plan (models/moe.py shuffle_plan), built once per call:
//   src[s]      the entry t*k + j that fills slot s, or -1 (empty slot);
//   slot_tk[e]  the slot of entry e = t*k + j, or -1 (dropped: past its
//               expert's capacity, or its expert on another rank).
// Four passes.  Every output row is written exactly once, by one group
// of TPR threads, and nothing is accumulated across groups: no atomics.
//
//   moe_gather_dispatch_kernel     buf[s] = x[src[s] / k], 0 for an empty slot
//   moe_gather_sum_kernel<W=true>  y[t]   = sum_j w[t,j] * out[slot_tk[t,j]]
//   moe_gather_sum_kernel<W=false> dx[t]  = sum_j dbuf[slot_tk[t,j]]
//   moe_gather_combine_bwd_kernel  dout[s] = w[e] * dy[e / k]; dw[e] = <dy[e / k], out[s]>
//                                  for e = src[s]; 0 for an empty slot, and
//                                  dw[e] = 0 for a dropped entry
//
// The two passes that fill the slots visit them in token order: their
// rows g < N*k are the entries e = g, each of which fills its own slot
// slot_tk[e] (a dropped entry has nothing to do), and their rows g >= N*k
// are the slots s = g - N*k, of which the empty ones (src[s] < 0) are
// zero-filled.  A token's k entries are neighbouring groups, most often
// of one block, so its row (x, or dy) is read from memory once for its k
// copies: in slot order each copy read it again (8 times the tokens'
// bytes at k = 8, measured 0.286 ms for the dispatch at the shape below,
// 58% of its bound).
//
// The sums run over j = 0..k-1 in that order and the dot product over
// each thread's columns in order, then a fixed butterfly across the
// group: no result depends on the order in which threads run, backward
// included.  Arithmetic is float32, rounded once to the working dtype.
//
// Bound.  No pass does more than a few operations a byte: all four are
// bound by memory.  At granite-moe's training shape (N 16,384 tokens,
// k 8, 40 experts of 4,096 slots, d 1,536, bf16, ~118k of 163,840 slots
// filled) the dispatch writes 503 MB and reads 50 MB (0.165 ms at
// 3.35 TB/s), the combine reads ~363 MB of filled rows and writes 50 MB
// (0.123 ms), its backward reads ~413 MB and writes 503 MB (0.274 ms),
// the dispatch's backward reads ~363 MB and writes 50 MB (0.123 ms).
//
// Design.  Rows move as 16-byte vectors (8 bf16 or 4 float32 values;
// one value at a time where a row or a base pointer is not 16-byte
// aligned), neighbouring threads on neighbouring vectors.  A group of
// TPR threads (a power of two, at most a warp) takes one row; a block of
// 256 threads takes 256 / TPR rows, so many rows are in flight on every
// SM.  Each thread issues UNROLL vector loads before it uses them.  The
// wrapper picks TPR from the row's vector count: the same algorithm at
// every width.  Offsets are 64-bit.  Nothing is allocated here, and each
// entry returns cudaGetLastError() for the wrapper to raise on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> zeros() {
  Pack<T, VEC> z;
#pragma unroll
  for (int i = 0; i < VEC; ++i) z.v[i] = from_f<T>(0.f);
  return z;
}

// the lanes of this thread's group, for the group's shuffles
__device__ __forceinline__ unsigned group_mask(int tpr) {
  if (tpr == 32) return 0xffffffffu;
  const int first = (threadIdx.x & 31) & ~(tpr - 1);
  return ((1u << tpr) - 1u) << first;
}

// rows g < n_entries: entry e = g copies its token's row into its slot;
// rows g >= n_entries: slot g - n_entries is zero-filled if empty
template <typename T, int VEC, int UNROLL>
__global__ void __launch_bounds__(kThreads)
moe_gather_dispatch_kernel(const T* __restrict__ x, long long ldx,
                           const int* __restrict__ slot_tk, const int* __restrict__ src,
                           long long n_entries, int n_slots, int top_k, int nvec,
                           int tpr, T* __restrict__ buf) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & (tpr - 1);
  const long long g = (long long)blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  if (g >= n_entries) {
    const long long s = g - n_entries;
    if (s >= n_slots || __ldg(src + s) >= 0) return;
    P* dst = reinterpret_cast<P*>(buf + s * nvec * VEC);
    const P z = zeros<T, VEC>();
    for (int v = lane; v < nvec; v += tpr) dst[v] = z;
    return;
  }
  const int s = __ldg(slot_tk + g);
  if (s < 0) return;
  P* dst = reinterpret_cast<P*>(buf + (long long)s * nvec * VEC);
  const P* row = reinterpret_cast<const P*>(x + (g / top_k) * ldx);
  for (int v0 = lane; v0 < nvec; v0 += tpr * UNROLL) {
    P r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * tpr;
      if (v < nvec) r[u] = row[v];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * tpr;
      if (v < nvec) dst[v] = r[u];
    }
  }
}

// y[t] = sum over kept j of (w[t, j] or 1) * rows[slot_tk[t, j]]
template <typename T, int VEC, int UNROLL, bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
moe_gather_sum_kernel(const T* __restrict__ rows, long long ldr,
                      const int* __restrict__ slot_tk, const float* __restrict__ w,
                      int n_tokens, int top_k, int nvec, int tpr, T* __restrict__ y) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & (tpr - 1);
  const long long t = (long long)blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  if (t >= n_tokens) return;
  const int* st = slot_tk + t * top_k;
  P* dst = reinterpret_cast<P*>(y + t * nvec * VEC);
  for (int v0 = lane; v0 < nvec; v0 += tpr * UNROLL) {
    float acc[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[u][i] = 0.f;
    for (int j = 0; j < top_k; ++j) {
      const int s = __ldg(st + j);
      if (s < 0) continue;
      const float wj = WEIGHTED ? __ldg(w + t * top_k + j) : 1.f;
      const P* row = reinterpret_cast<const P*>(rows + (long long)s * ldr);
      P r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int v = v0 + u * tpr;
        if (v < nvec) r[u] = row[v];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[u][i] = WEIGHTED ? fmaf(wj, to_f(r[u].v[i]), acc[u][i])
                               : acc[u][i] + to_f(r[u].v[i]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * tpr;
      if (v < nvec) {
        P o;
#pragma unroll
        for (int i = 0; i < VEC; ++i) o.v[i] = from_f<T>(acc[u][i]);
        dst[v] = o;
      }
    }
  }
}

// rows g < n_entries: entry e = g, in slot s = slot_tk[e], writes
// dout[s] = w[e] * dy[e / k] and dw[e] = <dy[e / k], out[s]> (0 if it was
// dropped); rows g >= n_entries: slot g - n_entries is zero-filled if empty
template <typename T, int VEC, int UNROLL>
__global__ void __launch_bounds__(kThreads)
moe_gather_combine_bwd_kernel(const T* __restrict__ dy, long long ldy,
                              const T* __restrict__ out, long long ldo,
                              const float* __restrict__ w, const int* __restrict__ slot_tk,
                              const int* __restrict__ src, long long n_entries, int n_slots,
                              int top_k, int nvec, int tpr, T* __restrict__ dout,
                              float* __restrict__ dw) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & (tpr - 1);
  const long long g = (long long)blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  // whole groups leave together, before the group's shuffles
  if (g >= n_entries) {
    const long long s = g - n_entries;
    if (s >= n_slots || __ldg(src + s) >= 0) return;
    P* dst = reinterpret_cast<P*>(dout + s * nvec * VEC);
    const P z = zeros<T, VEC>();
    for (int v = lane; v < nvec; v += tpr) dst[v] = z;
    return;
  }
  const int s = __ldg(slot_tk + g);
  if (s < 0) {
    if (lane == 0) dw[g] = 0.f;
    return;
  }
  const float we = __ldg(w + g);
  const P* g_row = reinterpret_cast<const P*>(dy + (g / top_k) * ldy);
  const P* o_row = reinterpret_cast<const P*>(out + (long long)s * ldo);
  P* dst = reinterpret_cast<P*>(dout + (long long)s * nvec * VEC);
  float part = 0.f;
  for (int v0 = lane; v0 < nvec; v0 += tpr * UNROLL) {
    P a[UNROLL], b[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * tpr;
      if (v < nvec) {
        a[u] = g_row[v];
        b[u] = o_row[v];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * tpr;
      if (v < nvec) {
        P o;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float gy = to_f(a[u].v[i]);
          o.v[i] = from_f<T>(we * gy);
          part = fmaf(gy, to_f(b[u].v[i]), part);
        }
        dst[v] = o;
      }
    }
  }
  const unsigned mask = group_mask(tpr);
  for (int off = tpr >> 1; off > 0; off >>= 1) part += __shfl_xor_sync(mask, part, off);
  if (lane == 0) dw[g] = part;
}

inline unsigned n_blocks(long long rows, int tpr) {
  const int per = kThreads / tpr;
  return (unsigned)((rows + per - 1) / per);
}

template <typename T, int VEC>
int dispatch_t(const void* x, long long ldx, const int* slot_tk, const int* src, int n_tokens,
               int n_slots, int top_k, int d, int tpr, void* buf, cudaStream_t stream) {
  const long long n_entries = (long long)n_tokens * top_k;
  moe_gather_dispatch_kernel<T, VEC, 4><<<n_blocks(n_entries + n_slots, tpr), kThreads, 0, stream>>>(
      (const T*)x, ldx, slot_tk, src, n_entries, n_slots, top_k, d / VEC, tpr, (T*)buf);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int gather_sum_t(const void* rows, long long ldr, const int* slot_tk, const float* w,
                 int n_tokens, int top_k, int d, int tpr, void* y, cudaStream_t stream) {
  const unsigned blocks = n_blocks(n_tokens, tpr);
  if (w)
    moe_gather_sum_kernel<T, VEC, 2, true><<<blocks, kThreads, 0, stream>>>(
        (const T*)rows, ldr, slot_tk, w, n_tokens, top_k, d / VEC, tpr, (T*)y);
  else
    moe_gather_sum_kernel<T, VEC, 2, false><<<blocks, kThreads, 0, stream>>>(
        (const T*)rows, ldr, slot_tk, w, n_tokens, top_k, d / VEC, tpr, (T*)y);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int combine_bwd_t(const void* dy, long long ldy, const void* out, long long ldo,
                  const float* w, const int* slot_tk, const int* src, int n_tokens,
                  int n_slots, int top_k, int d, int tpr, void* dout, float* dw,
                  cudaStream_t stream) {
  const long long n_entries = (long long)n_tokens * top_k;
  moe_gather_combine_bwd_kernel<T, VEC, 2>
      <<<n_blocks(n_entries + n_slots, tpr), kThreads, 0, stream>>>(
          (const T*)dy, ldy, (const T*)out, ldo, w, slot_tk, src, n_entries, n_slots, top_k,
          d / VEC, tpr, (T*)dout, dw);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  vec_ok: every row and base pointer is
// 16-byte aligned and d fills whole vectors.  Row strides are in
// elements; the outputs are packed (N or n_slots rows of d).
extern "C" int moe_dispatch_launch(int dtype, const void* x, long long ldx, const int* slot_tk,
                                   const int* src, int n_tokens, int n_slots, int top_k, int d,
                                   int tpr, int vec_ok, void* buf, cudaStream_t stream) {
  if (dtype == 0)
    return vec_ok ? dispatch_t<float, 4>(x, ldx, slot_tk, src, n_tokens, n_slots, top_k, d, tpr,
                                         buf, stream)
                  : dispatch_t<float, 1>(x, ldx, slot_tk, src, n_tokens, n_slots, top_k, d, tpr,
                                         buf, stream);
  return vec_ok ? dispatch_t<__nv_bfloat16, 8>(x, ldx, slot_tk, src, n_tokens, n_slots, top_k, d,
                                               tpr, buf, stream)
                : dispatch_t<__nv_bfloat16, 1>(x, ldx, slot_tk, src, n_tokens, n_slots, top_k, d,
                                               tpr, buf, stream);
}

// w null: the unweighted sum (the dispatch's backward)
extern "C" int moe_gather_sum_launch(int dtype, const void* rows, long long ldr,
                                     const int* slot_tk, const float* w, int n_tokens,
                                     int top_k, int d, int tpr, int vec_ok, void* y,
                                     cudaStream_t stream) {
  if (dtype == 0)
    return vec_ok ? gather_sum_t<float, 4>(rows, ldr, slot_tk, w, n_tokens, top_k, d, tpr, y, stream)
                  : gather_sum_t<float, 1>(rows, ldr, slot_tk, w, n_tokens, top_k, d, tpr, y, stream);
  return vec_ok
             ? gather_sum_t<__nv_bfloat16, 8>(rows, ldr, slot_tk, w, n_tokens, top_k, d, tpr, y, stream)
             : gather_sum_t<__nv_bfloat16, 1>(rows, ldr, slot_tk, w, n_tokens, top_k, d, tpr, y, stream);
}

extern "C" int moe_combine_bwd_launch(int dtype, const void* dy, long long ldy, const void* out,
                                      long long ldo, const float* w, const int* slot_tk,
                                      const int* src, int n_tokens, int n_slots, int top_k, int d,
                                      int tpr, int vec_ok, void* dout, float* dw,
                                      cudaStream_t stream) {
  if (dtype == 0)
    return vec_ok ? combine_bwd_t<float, 4>(dy, ldy, out, ldo, w, slot_tk, src, n_tokens, n_slots,
                                            top_k, d, tpr, dout, dw, stream)
                  : combine_bwd_t<float, 1>(dy, ldy, out, ldo, w, slot_tk, src, n_tokens, n_slots,
                                            top_k, d, tpr, dout, dw, stream);
  return vec_ok ? combine_bwd_t<__nv_bfloat16, 8>(dy, ldy, out, ldo, w, slot_tk, src, n_tokens,
                                                  n_slots, top_k, d, tpr, dout, dw, stream)
                : combine_bwd_t<__nv_bfloat16, 1>(dy, ldy, out, ldo, w, slot_tk, src, n_tokens,
                                                  n_slots, top_k, d, tpr, dout, dw, stream);
}
