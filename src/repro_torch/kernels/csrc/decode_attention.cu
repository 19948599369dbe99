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
// Bound.  Decode is memory bound: per launch it must read the valid
// slots of K and V once (2 * B * n_valid * Kv * Dh * sizeof(T)) against
// 4 * B * H * n_valid * Dh flops.  At llama3-8b's serving shape
// (B=4, C=1057, Kv=8, Dh=128, bf16) that is ~17 MB, >= ~5 us at
// 3.35 TB/s.  One block per (sequence, kv head) would be 32 blocks on
// 132 SMs, each pulling a 541 KB group alone: the sweep is split.
//
// Design: a split cache sweep (flash-decoding), one launch.
//
//  * Grid (B * Kv, n_split).  The wrapper picks n_split from C, B * Kv and
//    the SM count alone (about two blocks per SM; never from q_pos, which
//    the kernel reads on the device through a pointer to the cache's
//    int32 length, so a decode step needs no host sync).  Block (bk, i)
//    sweeps the slots [i * chunk, min(C, (i + 1) * chunk)) of its group;
//    the G query heads of the group share every K/V tile, so the cache is
//    read once per group.  K/V are read by stride straight from the decode
//    cache's (B, C, Kv * Dh) layout (no transpose, no padding copy).
//  * In a block, tiles of TILE slots (16 KB of K and of V each) stream into
//    shared memory with 16-byte cp.async copies, two tiles in flight.
//    Each row's 16-byte vectors are stored XOR-swizzled by the row, so
//    that reading one vector of consecutive rows is free of bank
//    conflicts.  Scores: each thread computes whole (slot, head) dot
//    products in registers (no shuffles); the online softmax (m, l) and
//    the probabilities stay in shared memory, all f32.  P V: every thread owns
//    one 16-byte column vector of one head's output (G * Dh / VEC items)
//    and a residue class of the tile's slots, so it adds its slots with
//    VEC independent FMAs per 16-byte V load; the slot classes are summed
//    once, at the end of the sweep.  The ragged last tile is zero-filled
//    and masked by slot < the split's end.
//  * A split in which no slot is valid (q_pos = 0 leaves all but the
//    first empty; so does a short window) loads nothing and writes
//    m = -1e30, l = 0, o = 0, so it carries zero weight.  Every other
//    split writes its partial (m, l, o[G][Dh]) in f32 to scratch that the
//    wrapper allocates, then counts itself on a per-(b, kvh) counter.
//    The last block to arrive merges the group's partials,
//        O = sum_i e^{m_i - M} o_i / max(sum_i e^{m_i - M} l_i, 1e-30),
//        M = max_i m_i,
//    and resets the counter to 0, so the counters stay zero between
//    launches (the wrapper allocates them zeroed once per device).  With
//    n_split = 1 the block writes O itself and touches no scratch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kTileBytes = 16384;
constexpr int kMaxSplit = 64;  // the wrapper's plan never exceeds it
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

// the ring formula and the mask: may the token at q_pos attend slot s?
__device__ __forceinline__ bool slot_ok(int slot, int qp, int weff, int window) {
  const int kpos = slot + weff * floor_div(qp - slot, weff);
  bool ok = kpos >= 0 && kpos <= qp;
  if (window > 0) ok = ok && (qp - kpos < window);
  return ok;
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

// the 16-byte vector of VEC elements at p, as floats (bit operations only,
// so the vector never goes through local memory)
__device__ __forceinline__ void unpack(unsigned w, float* out, float) {
  out[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(unsigned w, float* out, __nv_bfloat16) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  constexpr int PER = VEC / 4;  // elements per 32-bit word
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  unpack(raw.x, out, T());
  unpack(raw.y, out + PER, T());
  unpack(raw.z, out + 2 * PER, T());
  unpack(raw.w, out + 3 * PER, T());
}

template <typename T, int DH>
struct Shape {
  static constexpr int VEC = 16 / sizeof(T);        // elements per 16 B
  static constexpr int VPR = DH / VEC;              // vectors per slot row
  // a row's 16-byte vector c is stored at c ^ (row & SWZ), so that threads
  // reading the same vector of consecutive rows hit distinct banks
  static constexpr int SWZ = (VPR < 8 ? VPR : 8) - 1;
  static constexpr int TILE_MAX = kTileBytes / (DH * (int)sizeof(T));
  static constexpr int TILE = TILE_MAX < 64 ? TILE_MAX : 64;  // slots per tile
  // P V items (one head, one column vector) per thread when G = 16
  static constexpr int ITEMS = (16 * VPR + kThreads - 1) / kThreads;
};

// P V work split, from G: NW items of (head, column vector); NQ residue
// classes of slots when the items do not fill the block.
struct PvSplit {
  int nw, nq;
  __host__ __device__ PvSplit(int G, int vpr)
      : nw(G * vpr), nq(nw >= kThreads ? 1 : kThreads / nw) {}
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   const int* __restrict__ q_pos_ptr, float* __restrict__ part,
                   int* __restrict__ counter, int Kv, int G, int C, int chunk,
                   long long k_sb, long long k_sc, long long v_sb,
                   long long v_sc, int window, float softcap, float scale,
                   int ring_bytes) {
  using S = Shape<T, DH>;
  constexpr int TILE = S::TILE, VEC = S::VEC, SWZ = S::SWZ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kbuf = reinterpret_cast<T*>(smem_raw);                // [kStages][TILE][DH]
  T* vbuf = kbuf + kStages * TILE * DH;                    // [kStages][TILE][DH]
  float* red = reinterpret_cast<float*>(smem_raw);         // after the sweep: [nq][G][DH]
  float* qs = reinterpret_cast<float*>(smem_raw + ring_bytes);  // [G][DH]
  float* ss = qs + G * DH;                                 // [G][TILE]
  float* m = ss + G * TILE;                                // [G]
  float* l = m + G;                                        // [G]
  float* corr = l + G;                                     // [G]
  float* wgt = corr + G;                                   // merge: [G][kMaxSplit]
  __shared__ int flag;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int bk = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = bk / Kv, kvh = bk % Kv;
  const int H = Kv * G;
  const int GD = G * DH;
  const int qp = *q_pos_ptr;
  const int weff = window > 0 ? window : C;
  const int s0 = split * chunk, s1 = min(C, s0 + chunk);

  const T* qb = q + (long long)b * H * DH + (long long)kvh * G * DH;
  const T* kb = k + (long long)b * k_sb + (long long)kvh * DH;
  const T* vb = v + (long long)b * v_sb + (long long)kvh * DH;
  // this split's partial: [G][DH + 2] = o[DH], m, l
  float* mine = part == nullptr ? nullptr
                                : part + ((long long)bk * n_split + split) * G * (DH + 2);

  // a split with no valid slot loads nothing and carries zero weight
  bool any = false;
  for (int s = s0 + tid; s < s1 && !any; s += kThreads) any = slot_ok(s, qp, weff, window);
  if (!__syncthreads_or(any)) {
    if (mine == nullptr) return;  // unreachable: the slot of q_pos is valid
    for (int i = tid; i < G * (DH + 2); i += kThreads)
      mine[i] = (i % (DH + 2)) == DH ? kNegInf : 0.f;
  } else {
    const int ntiles = (s1 - s0 + TILE - 1) / TILE;
    auto issue = [&](int tile) {
      const int stage = tile % kStages;
      T* kd = kbuf + stage * TILE * DH;
      T* vd = vbuf + stage * TILE * DH;
      for (int i = tid; i < TILE * S::VPR; i += kThreads) {
        const int row = i / S::VPR, c = i % S::VPR;
        const int slot = s0 + tile * TILE + row;
        const bool in = slot < s1;
        const long long s = in ? slot : 0;
        const int at = row * DH + (c ^ (row & SWZ)) * VEC;
        cp_async16(kd + at, kb + s * k_sc + c * VEC, in);
        cp_async16(vd + at, vb + s * v_sc + c * VEC, in);
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
    const PvSplit pv(G, S::VPR);
    const int cls = pv.nw >= kThreads ? 0 : tid / pv.nw;  // this thread's slot class
    const int item0 = pv.nw >= kThreads ? tid : tid % pv.nw;
    const bool pv_on = cls < pv.nq;
    float acc[S::ITEMS][VEC];
#pragma unroll
    for (int j = 0; j < S::ITEMS; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;

    for (int tile = 0; tile < ntiles; ++tile) {
      if (tile + kStages - 1 < ntiles) issue(tile + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const T* kt = kbuf + (tile % kStages) * TILE * DH;
      const T* vt = vbuf + (tile % kStages) * TILE * DH;
      const int base = s0 + tile * TILE;

      // scores: one (slot, head) pair per thread and pass, the whole dot
      // product in registers (consecutive threads: consecutive slots, one head)
      for (int pr = tid; pr < TILE * G; pr += kThreads) {
        const int row = pr % TILE, g = pr / TILE;
        const T* kr = kt + row * DH;
        const float* qr = qs + g * DH;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < S::VPR; ++c) {
          float kf[VEC];
          load_vec<T, VEC>(kr + (c ^ (row & SWZ)) * VEC, kf);
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qr + c * VEC + e);
            acc[0] = fmaf(q4.x, kf[e], acc[0]);
            acc[1] = fmaf(q4.y, kf[e + 1], acc[1]);
            acc[2] = fmaf(q4.z, kf[e + 2], acc[2]);
            acc[3] = fmaf(q4.w, kf[e + 3], acc[3]);
          }
        }
        float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int slot = base + row;
        ss[g * TILE + row] = slot < s1 && slot_ok(slot, qp, weff, window) ? s : kNegInf;
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

      // acc = acc * corr + P V over this thread's slot class
      if (pv_on) {
#pragma unroll
        for (int j = 0; j < S::ITEMS; ++j) {
          const int item = item0 + j * kThreads;
          if (item < pv.nw) {
            const int g = item / S::VPR, c = item % S::VPR;
            const float cf = corr[g];
            const float* p = ss + g * TILE;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[j][e] *= cf;
            for (int t = cls; t < TILE; t += pv.nq) {
              float vv[VEC];
              load_vec<T, VEC>(vt + t * DH + (c ^ (t & SWZ)) * VEC, vv);
              const float pt = p[t];
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[j][e] = fmaf(pt, vv[e], acc[j][e]);
            }
          }
        }
      }
      __syncthreads();
    }
    cp_async_wait<0>();
    __syncthreads();

    // sum the slot classes: red[cls][g][DH]
    if (pv_on) {
#pragma unroll
      for (int j = 0; j < S::ITEMS; ++j) {
        const int item = item0 + j * kThreads;
        if (item < pv.nw)
#pragma unroll
          for (int e = 0; e < VEC; ++e) red[cls * GD + item * VEC + e] = acc[j][e];
      }
    }
    __syncthreads();
    T* ob = out + (long long)b * H * DH + (long long)kvh * G * DH;
    for (int o = tid; o < GD; o += kThreads) {
      float sum = 0.f;
      for (int c = 0; c < pv.nq; ++c) sum += red[c * GD + o];
      const int g = o / DH;
      if (mine == nullptr) {
        ob[o] = from_f32<T>(sum / fmaxf(l[g], 1e-30f));
      } else {
        mine[g * (DH + 2) + o % DH] = sum;
        if (o % DH == 0) {
          mine[g * (DH + 2) + DH] = m[g];
          mine[g * (DH + 2) + DH + 1] = l[g];
        }
      }
    }
  }
  if (mine == nullptr) return;

  // the last block of the group to arrive merges its partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(counter + bk, 1);
    flag = prev == n_split - 1;
    if (flag) counter[bk] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!flag) return;
  __threadfence();
  const float* grp = part + (long long)bk * n_split * G * (DH + 2);
  for (int g = warp; g < G; g += kWarps) {
    float mx = kNegInf;
    for (int i = lane; i < n_split; i += 32)
      mx = fmaxf(mx, __ldcg(grp + ((long long)i * G + g) * (DH + 2) + DH));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float den = 0.f;
    for (int i = lane; i < n_split; i += 32) {
      const float* pi = grp + ((long long)i * G + g) * (DH + 2);
      const float w = expf(__ldcg(pi + DH) - mx);
      wgt[g * kMaxSplit + i] = w;
      den += w * __ldcg(pi + DH + 1);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
    if (lane == 0) corr[g] = 1.f / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  T* ob = out + (long long)b * H * DH + (long long)kvh * G * DH;
  for (int o = tid; o < GD; o += kThreads) {
    const int g = o / DH, d = o % DH;
    float sum = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_split; ++i)
      sum = fmaf(wgt[g * kMaxSplit + i], __ldcg(grp + ((long long)i * G + g) * (DH + 2) + d),
                 sum);
    ob[o] = from_f32<T>(sum * corr[g]);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, const void* q_pos,
           void* part, void* counter, int B, int Kv, int G, int C, int chunk, int n_split,
           long long k_sb, long long k_sc, long long v_sb, long long v_sc, int window,
           float softcap, cudaStream_t stream) {
  using S = Shape<T, DH>;
  if (n_split < 1 || n_split > kMaxSplit ||
      (n_split > 1 && (part == nullptr || counter == nullptr)))
    return (int)cudaErrorInvalidValue;
  const PvSplit pv(G, S::VPR);
  const size_t ring = 2 * (size_t)kStages * S::TILE * DH * sizeof(T);
  const size_t red = sizeof(float) * (size_t)pv.nq * G * DH;
  const size_t ring_bytes = (ring > red ? ring : red + 15) / 16 * 16;
  const size_t bytes = ring_bytes + sizeof(float) * ((size_t)G * DH + (size_t)G * S::TILE +
                                                     3 * G + (size_t)G * kMaxSplit);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_attn_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = 1.0f / sqrtf((float)DH);
  decode_attn_kernel<T, DH><<<dim3(B * Kv, n_split), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<const int*>(q_pos),
      n_split > 1 ? static_cast<float*>(part) : nullptr, static_cast<int*>(counter), Kv, G, C,
      chunk, k_sb, k_sc, v_sb, v_sc, window, softcap, scale, (int)ring_bytes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int Dh, const void* q, const void* k, const void* v, void* out,
              const void* q_pos, void* part, void* counter, int B, int Kv, int G, int C,
              int chunk, int n_split, long long k_sb, long long k_sc, long long v_sb,
              long long v_sc, int window, float softcap, cudaStream_t s) {
#define REPRO_DECODE_DH(D)                                                              \
  case D:                                                                              \
    return launch<T, D>(q, k, v, out, q_pos, part, counter, B, Kv, G, C, chunk, n_split, \
                        k_sb, k_sc, v_sb, v_sc, window, softcap, s);
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
// The sweep is cut into n_split ranges of `chunk` slots (every range
// non-empty, n_split <= 64); with n_split > 1, `part` is f32 scratch of
// B * Kv * n_split * G * (Dh + 2) values and `counter` B * Kv int32
// zeros, which the launch leaves zero.  dtype: 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out, const void* q_pos, void* part,
    void* counter, int dtype, int B, int Kv, int G, int C, int Dh, int chunk, int n_split,
    long long k_sb, long long k_sc, long long v_sb, long long v_sc, int window, float softcap,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dh<float>(Dh, q, k, v, out, q_pos, part, counter, B, Kv, G, C, chunk,
                              n_split, k_sb, k_sc, v_sb, v_sc, window, softcap, s);
    case 1:
      return launch_dh<__nv_bfloat16>(Dh, q, k, v, out, q_pos, part, counter, B, Kv, G, C,
                                      chunk, n_split, k_sb, k_sc, v_sb, v_sc, window, softcap,
                                      s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
