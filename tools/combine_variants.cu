// Variants of the f32 coded combine (kind 0 of
// src/repro_torch/kernels/csrc/coded_combine.cu), kept to be timed beside
// the shipped kernel by tools/torch_combine_variants.py.  Not part of the
// port: the port builds csrc/ only.  Built with
// -I src/repro_torch/kernels/csrc; the shipped source is included whole.
//
//   variant 0  the previous kind 0: the generic grid-stride kernel of kinds
//              1-3 with a float32 payload (each thread 4 columns, one
//              16-byte load per row of G, 826 blocks at the evaluation
//              shape)
//   variant 1  registers, as many blocks as the SMs hold, each block an
//              equal contiguous span of F, K unrolled by 8
//   variant 2  the shipped kernel (coded_combine_launch, kind 0):
//              registers, the same grid with its threads interleaved
//              over F, K unrolled by 4
//   variants 3-6  the shipped kernel with K unrolled by 2, 5, 8 and 16
//   variant 7  a TMA ring: one block an SM, interleaved column tiles of
//              up to 256 V columns (V = 1, 2 or 4, the widest whose stage
//              stays near 48 KB), a stage holding up to 48 of the K rows;
//              one producer warp keeps the ring full with 1-D bulk copies
//              of each row's 16-byte-aligned interior (4-byte cp.async
//              copies for its head and tail), 8 consumer warps read the
//              stage from shared memory
//   variant 8  the TMA ring with contiguous spans instead of interleaved
//              tiles
//   variant 9  the TMA ring with 1024 columns x 10 rows a stage (4 KB
//              bulk copies)
//   variant 10 the TMA ring with 1024 columns x 5 rows a stage
//   variant 11 the TMA ring, two blocks an SM, 256 columns x 20 rows

#include "coded_combine.cu"

namespace {

struct PayF32 {
  using T = float;
  static constexpr int VEC = 4;
  static constexpr int RT = 8;
  static constexpr bool SCALED = false;
  static __device__ __forceinline__ void load_vec(const T* row, long long f, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(row + f);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ float load_one(const T* row, long long f) { return row[f]; }
};

// the shipped kind-0 kernel with other unroll depths, and with spans
template <int RT, bool kSpans, int U>
__global__ void __launch_bounds__(kThreads)
combine_f32_regs(const float* __restrict__ C, int R, int K, const float* __restrict__ G,
                 long long g_rs, long long F, float* __restrict__ out, int vec_ok, int out_vec) {
  const long long F4 = (F + 3) / 4;
  const long long lo = kSpans ? F4 * blockIdx.x / gridDim.x
                              : (long long)blockIdx.x * blockDim.x;
  const long long hi = kSpans ? F4 * (blockIdx.x + 1) / gridDim.x : F4;
  const long long step = kSpans ? blockDim.x : (long long)gridDim.x * blockDim.x;
  for (long long ch = lo + threadIdx.x; ch < hi; ch += step) {
    const long long f0 = ch * 4;
    const int nv = (int)min(4LL, F - f0);
    const bool full = vec_ok && nv == 4;
    for (int r0 = 0; r0 < R; r0 += RT) {
      float acc[RT][4];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rr][e] = 0.f;
      for (int k0 = 0; k0 < K; k0 += U) {
        float g[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
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
        for (int u = 0; u < U; ++u) {
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

template <int RT, bool kSpans, int U>
int launch_regs(const float* C, int R, int K, const float* G, long long g_rs, long long F,
                float* out, int vec_ok, cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, combine_f32_regs<RT, kSpans, U>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const long long need = ((F + 3) / 4 + kThreads - 1) / kThreads;
  long long blocks = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  if (blocks > need) blocks = need;
  const int out_vec = (F % 4 == 0) && ((reinterpret_cast<uintptr_t>(out) & 15) == 0);
  combine_f32_regs<RT, kSpans, U><<<(unsigned)blocks, kThreads, 0, stream>>>(
      C, R, K, G, g_rs, F, out, vec_ok, out_vec);
  return (int)cudaGetLastError();
}

template <bool kSpans, int U>
int regs(const float* C, int R, int K, const float* G, long long g_rs, long long F, float* out,
         int vec_ok, cudaStream_t st) {
  return R == 1 ? launch_regs<1, kSpans, U>(C, R, K, G, g_rs, F, out, vec_ok, st)
                : launch_regs<8, kSpans, U>(C, R, K, G, g_rs, F, out, vec_ok, st);
}

// ---- the TMA ring ----

constexpr int kConsumerWarps = 8;
constexpr int kTmaThreads = 32 * (kConsumerWarps + 1);  // + one producer warp
constexpr int kMaxStageRows = 48;                        // rows of G a stage holds
constexpr int kMaxStages = 16;
constexpr int kStageTarget = 48 * 1024;                  // bytes a stage aims at
constexpr int kBarBytes = 16 * kMaxStages;               // full[] then empty[]
constexpr int kSmemBytes = 232448;                       // 227 KB, a block's most

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
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
// bytes (a multiple of 16) from a 16-byte-aligned global address to a
// 16-byte-aligned shared one, counted on the mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one float from global to shared memory without waiting for it
// (cp.async); arrive_after_copies makes this thread's arrival on bar wait
// for its earlier ones, so the producer never stalls on a load's latency
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void arrive_after_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Row k of G sits 4-byte word (gb + k * rs) & 3 past a 16-byte boundary
// (gb: G's base, rs: its row stride, both mod 4).  Inside a stage, row kl
// keeps column c0 + j at float kl * pitch + shift + j, so that a bulk
// copy's source and destination agree modulo 16 bytes.
//
// Columns [lo_j, hi_j) of a tile of width w: the row's 16-byte-aligned interior.
__device__ __forceinline__ void interior(int shift, int w, int& lo_j, int& hi_j) {
  lo_j = (4 - shift) & 3;
  hi_j = w - ((shift + w) & 3);
  if (hi_j <= lo_j) lo_j = hi_j = w;  // nothing aligned: every value a plain load
}

// Tile j of block b: columns [c0, c0 + w).  Interleaved: c0 = (j * nb +
// b) * tw, every block the same number of tiles of tw <= TW columns, so at
// any moment the card reads one contiguous stretch of each row.  kSpans:
// block b takes the b-th of nb equal contiguous spans of F, in tiles of TW
// columns.  Tiles start on 16-byte column boundaries; false past the
// block's last tile.
template <bool kSpans, int TW>
__device__ __forceinline__ bool tile_at(long long j, long long F, int tw, long long& c0, int& w) {
  long long end = F;
  if (kSpans) {
    const long long F4 = (F + 3) / 4;
    c0 = F4 * blockIdx.x / gridDim.x * 4 + j * TW;
    end = min(F, F4 * (blockIdx.x + 1) / gridDim.x * 4);
    tw = TW;
  } else {
    c0 = (j * gridDim.x + blockIdx.x) * tw;
  }
  if (c0 >= end) return false;
  w = (int)min((long long)tw, end - c0);
  return true;
}

// A tile is n_kc stages of ks rows each (n_kc = 1 when K <= 48; the last
// chunk may be shorter), once for all of R when n_kc = 1, else once per
// tile of RT rows of C.
template <int RT, int V, bool kSpans>
__global__ void __launch_bounds__(kTmaThreads, 1)
combine_tma_kernel(const float* __restrict__ C, int R, int K, const float* __restrict__ G,
                   long long g_rs, long long F, float* __restrict__ out, int tw, int ks,
                   int n_kc, int stages, int stage_floats) {
  constexpr int TW = 32 * kConsumerWarps * V;
  constexpr int pitch = TW + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);
  const uint32_t full = smem_u32(smem), empty = full + 8 * kMaxStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 32);               // every producer lane arrives
      mbar_init(empty + 8 * s, kConsumerWarps);  // every consumer warp arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const bool multi = n_kc > 1;
  const int passes = multi ? (R + RT - 1) / RT : 1;
  const int gb = (int)((reinterpret_cast<uintptr_t>(G) >> 2) & 3), rs = (int)(g_rs & 3);
  long long c0;
  int w;

  if (warp == kConsumerWarps) {
    // ---- producer warp: lane l loads rows l, l + 32, ... of each stage ----
    int it = 0;
    for (long long j = 0; tile_at<kSpans, TW>(j, F, tw, c0, w); ++j) {
      for (int p = 0; p < passes; ++p) {
        for (int kc = 0; kc < n_kc; ++kc, ++it) {
          const int st = it % stages;
          if (it >= stages) mbar_wait(empty + 8 * st, (it / stages - 1) & 1);
          // plain stores of an earlier round precede this round's bulk writes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          const uint32_t bar = full + 8 * st;
          float* slab = ring + (long long)st * stage_floats;
          const int k0 = kc * ks, kn = min(ks, K - k0);
          int bytes = 0;
          for (int kl = lane; kl < kn; kl += 32) {
            int a, b;
            interior((gb + (k0 + kl) * rs) & 3, w, a, b);
            bytes += 4 * (b - a);
          }
          mbar_expect_tx(bar, bytes);
          for (int kl = lane; kl < kn; kl += 32) {
            const int shift = (gb + (k0 + kl) * rs) & 3;
            int a, b;
            interior(shift, w, a, b);
            if (b > a)
              bulk_load(smem_u32(slab + kl * pitch + shift + a),
                        G + (long long)(k0 + kl) * g_rs + c0 + a, 4 * (b - a), bar);
          }
          for (int kl = lane; kl < kn; kl += 32) {  // heads and tails
            const int shift = (gb + (k0 + kl) * rs) & 3;
            int a, b;
            interior(shift, w, a, b);
            const float* src = G + (long long)(k0 + kl) * g_rs + c0;
            float* dst = slab + kl * pitch + shift;
            for (int j = 0; j < a; ++j) copy4(dst + j, src + j);
            for (int j = b; j < w; ++j) copy4(dst + j, src + j);
          }
          arrive_after_copies(bar);
        }
      }
    }
    return;
  }

  // ---- consumer warps: warp cw owns columns cw * 32 V + v * 32 + lane ----
  const int col0 = warp * 32 * V + lane;
  float acc[RT][V];
  int it = 0;
  for (long long j = 0; tile_at<kSpans, TW>(j, F, tw, c0, w); ++j) {
    for (int p = 0; p < passes; ++p) {
      for (int kc = 0; kc < n_kc; ++kc, ++it) {
        const int st = it % stages;
        mbar_wait(full + 8 * st, (it / stages) & 1);
        const float* slab = ring + (long long)st * stage_floats + col0;
        const int k0 = kc * ks, kn = min(ks, K - k0);
        const int r_lo = multi ? p * RT : 0, r_hi = multi ? min(R, r_lo + RT) : R;
        for (int r0 = r_lo; r0 < r_hi; r0 += RT) {
          if (!multi || kc == 0) {
#pragma unroll
            for (int rr = 0; rr < RT; ++rr)
#pragma unroll
              for (int v = 0; v < V; ++v) acc[rr][v] = 0.f;
          }
#pragma unroll 4
          for (int kl = 0; kl < kn; ++kl) {
            const int k = k0 + kl;
            const float* row = slab + kl * pitch + ((gb + k * rs) & 3);
            float g[V];
#pragma unroll
            for (int v = 0; v < V; ++v) g[v] = row[v * 32];
#pragma unroll
            for (int rr = 0; rr < RT; ++rr) {
              const float c = (RT == 1 || r0 + rr < R) ? __ldg(C + (long long)(r0 + rr) * K + k)
                                                       : 0.f;
#pragma unroll
              for (int v = 0; v < V; ++v) acc[rr][v] = fmaf(c, g[v], acc[rr][v]);
            }
          }
          if (!multi || kc == n_kc - 1) {
#pragma unroll
            for (int rr = 0; rr < RT; ++rr) {
              if (r0 + rr >= R) break;
              float* orow = out + (long long)(r0 + rr) * F + c0;
#pragma unroll
              for (int v = 0; v < V; ++v)
                if (col0 + v * 32 < w) orow[col0 + v * 32] = acc[rr][v];
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * st);
      }
    }
  }
}

template <int RT, int V, bool kSpans = false>
int launch_tma_v(const float* C, int R, int K, const float* G, long long g_rs, long long F,
                 float* out, int ks, int n_kc, cudaStream_t stream, int per_sm = 1) {
  constexpr int TW = 32 * kConsumerWarps * V;
  const int stage_floats = (ks * (TW + 4) + 31) / 32 * 32;  // 128-byte stages
  const int budget = per_sm == 1 ? kSmemBytes : kSmemBytes / per_sm - 1024;
  const int fit = (budget - kBarBytes) / (4 * stage_floats);
  const int stages = fit < kMaxStages ? fit : kMaxStages;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = kBarBytes + 4 * stages * stage_floats;
  static int smem_set = 0;  // the attribute this instantiation was given
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(combine_tma_kernel<RT, V, kSpans>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const long long most = (long long)sm_count() * per_sm, need = (F + TW - 1) / TW;
  const long long blocks = need < most ? need : most;
  // every block ceil(F / (blocks TW)) tiles, as narrow as that allows
  const long long per_block = (F + blocks * TW - 1) / (blocks * TW);
  const int tw = (int)(((F + blocks * per_block - 1) / (blocks * per_block) + 3) / 4 * 4);
  combine_tma_kernel<RT, V, kSpans><<<(unsigned)blocks, kTmaThreads, smem, stream>>>(
      C, R, K, G, g_rs, F, out, tw, ks, n_kc, stages, stage_floats);
  return (int)cudaGetLastError();
}

// The stage's rows: K in n_kc equal chunks of at most 48; its width: the
// widest TW (1024, 512 or 256 columns) whose stage stays near 48 KB.
template <int RT, bool kSpans = false>
int launch_tma_rt(const float* C, int R, int K, const float* G, long long g_rs, long long F,
                  float* out, cudaStream_t stream) {
  const int n_kc = (K + kMaxStageRows - 1) / kMaxStageRows;
  const int ks = (K + n_kc - 1) / n_kc;
  if (ks * (1024 + 4) * 4 <= kStageTarget)
    return launch_tma_v<RT, 4, kSpans>(C, R, K, G, g_rs, F, out, ks, n_kc, stream);
  if (ks * (512 + 4) * 4 <= kStageTarget)
    return launch_tma_v<RT, 2, kSpans>(C, R, K, G, g_rs, F, out, ks, n_kc, stream);
  return launch_tma_v<RT, 1, kSpans>(C, R, K, G, g_rs, F, out, ks, n_kc, stream);
}


template <int V>
int tma(const float* C, int R, int K, const float* G, long long g_rs, long long F, float* out,
        int rows, cudaStream_t st, int per_sm = 1) {
  const int n_kc = (K + rows - 1) / rows, ks = (K + n_kc - 1) / n_kc;
  return R == 1 ? launch_tma_v<1, V>(C, R, K, G, g_rs, F, out, ks, n_kc, st, per_sm)
                : launch_tma_v<8, V>(C, R, K, G, g_rs, F, out, ks, n_kc, st, per_sm);
}

}  // namespace

// Same arguments as coded_combine_launch's kind 0.
extern "C" int combine_variant_launch(int variant, const float* C, int R, int K, const float* G,
                                      long long g_rs, long long F, float* out, int vec_ok,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || K < 1 || F < 1) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0: return launch<PayF32>(C, R, K, G, g_rs, nullptr, 0, 1, F, out, vec_ok, st);
    case 1: return regs<true, 8>(C, R, K, G, g_rs, F, out, vec_ok, st);
    case 2:
      return coded_combine_launch(0, C, R, K, G, g_rs, nullptr, 0, 1, F, out, vec_ok, stream);
    case 3: return regs<false, 2>(C, R, K, G, g_rs, F, out, vec_ok, st);
    case 4: return regs<false, 5>(C, R, K, G, g_rs, F, out, vec_ok, st);
    case 5: return regs<false, 8>(C, R, K, G, g_rs, F, out, vec_ok, st);
    case 6: return regs<false, 16>(C, R, K, G, g_rs, F, out, vec_ok, st);
    case 7:
      return R == 1 ? launch_tma_rt<1>(C, R, K, G, g_rs, F, out, st)
                    : launch_tma_rt<8>(C, R, K, G, g_rs, F, out, st);
    case 8:
      return R == 1 ? launch_tma_rt<1, true>(C, R, K, G, g_rs, F, out, st)
                    : launch_tma_rt<8, true>(C, R, K, G, g_rs, F, out, st);
    case 9: return tma<4>(C, R, K, G, g_rs, F, out, 10, st);
    case 10: return tma<4>(C, R, K, G, g_rs, F, out, 5, st);
    case 11: return tma<1>(C, R, K, G, g_rs, F, out, 20, st, 2);
    default: return (int)cudaErrorInvalidValue;
  }
}
