// GAT's edge attention for Hopper (sm_90a): per head, a softmax of edge
// scores over each destination's in-edges and itself, and the weighted sum
// of its sources' projected rows, forward and backward, over the CSRs of a
// packed set (ops/sized_spmm.py `sized_graph`, positions=True).
//
// Replaces no Pallas kernel: the JAX package has no GAT. It was added for
// the GAT of Velickovic et al. (models/gat.py), which no existing op
// computes: the packed gather (csrc/sized_spmm.cu) sums its sources
// without weights. ops/gat_attention.py binds it.
//
// zst is (N, ld) float32, ld = K*F + 2K: row j holds z_j (K heads of F),
// then s_j (K) and t_j (K), the scores a_src . z_j and a_dst . z_j (one
// product makes all three, models/gat.py). For row i and head k the terms
// are i itself (the self term), then each in-edge j -> i in CSR order:
//
//   forward   e_ij = LeakyReLU_0.2(t_i + s_j);  m_i = max_j e_ij
//             l_i = sum_j exp(e_ij - m_i)
//             o_i = (sum_j exp(e_ij - m_i) z_j) / l_i;  lse_i = m_i + log l_i
//   backward  a_ij = exp(e_ij - lse_i);  D_i = g_i . o_i      (delta kernel)
//             dx_ij = a_ij (g_i . z_j - D_i) (t_i + s_j > 0 ? 1 : 0.2)
//             dz_j = sum_i a_ij g_i;  ds_j = sum_i dx_ij      (bwd kernel,
//             over j's out-edges and itself: the transposed CSR)
//             dt_i = sum_j dx_ij                               (dt kernel,
//             over i's in-edges: the forward CSR, each edge's dx read at
//             its transposed position, pos_t)
// The backward writes dz, ds and dt into one (N, ld) gradient of zst.
//
// What bounds it on an H100: bytes. A term costs 2F operations against a
// row of F floats read, and the rows each destination reads are its own
// bin's (edges never leave a bin), so they come from L2 after the first
// read. The least bytes are zst read once, o and lse written once, the CSR
// read once; the backward reads g, o and zst once and writes the gradient
// once. Design: one warp per (row, head), its lanes across the head's F
// columns with 16-byte loads (4 floats) where F is a multiple of 4 and the
// rows are aligned, else one float a lane (layer 3's heads of 121); each
// lane keeps its share of the row's accumulators in registers and loads
// the rows of UNROLL terms before it adds any of them. The softmax's max
// and sum run with the terms on the lanes, then reduce across the warp; the
// weighted sum runs the terms in order. Every sum runs in a fixed order, so
// two launches give the same bits; no atomics.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / WARP;
constexpr int UNROLL = 4;
constexpr float SLOPE = 0.2f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float leaky(float x) {
  return x > 0.f ? x : x * SLOPE;
}

// Butterfly reductions: every lane ends with the same bits (IEEE add and
// max are commutative, so the pair at each stage computes one value).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// VEC floats moved as one word.
template <int VEC>
struct Vec {
  float v[VEC];
};
template <int VEC>
__device__ __forceinline__ Vec<VEC> load(const float* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    r.v[0] = w.x; r.v[1] = w.y; r.v[2] = w.z; r.v[3] = w.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}
template <int VEC>
__device__ __forceinline__ void store(float* p, const Vec<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}

// Lane `lane`'s n-th vector of a head's F columns starts at column
// (n * WARP + lane) * VEC; it exists where that is below F (F is a multiple
// of VEC).
template <int VEC>
__device__ __forceinline__ int column(int n, int lane) {
  return (n * WARP + lane) * VEC;
}

// The term n of row r (0: r itself; n >= 1: the (n-1)-th CSR entry).
__device__ __forceinline__ int term(int n, int r, const int* __restrict__ col,
                                    int beg) {
  return n == 0 ? r : col[beg + n - 1];
}

template <int VEC, int NV>
__global__ void __launch_bounds__(THREADS)
    gat_attn_fwd_kernel(const int* __restrict__ row_ptr,
                        const int* __restrict__ col,
                        const float* __restrict__ zst, float* __restrict__ o,
                        float* __restrict__ lse, long long pairs, int K,
                        int F, int ld) {
  const int lane = threadIdx.x % WARP;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  const long long KF = static_cast<long long>(K) * F;
  for (long long w = static_cast<long long>(blockIdx.x) * WARPS +
                     threadIdx.x / WARP;
       w < pairs; w += stride) {
    const int i = static_cast<int>(w / K), k = static_cast<int>(w % K);
    const int beg = row_ptr[i];
    const int terms = row_ptr[i + 1] - beg + 1;
    const float t = zst[i * static_cast<long long>(ld) + KF + K + k];
    const float* s = zst + KF + k;  // s_j at s[j * ld]
    // the softmax's max and sum, the terms on the lanes
    float m = -INFINITY;
    for (int n = lane; n < terms; n += WARP)
      m = fmaxf(m, leaky(t + s[term(n, i, col, beg) *
                                 static_cast<long long>(ld)]));
    m = warp_max(m);
    float l = 0.f;
    for (int n = lane; n < terms; n += WARP)
      l += expf(leaky(t + s[term(n, i, col, beg) *
                              static_cast<long long>(ld)]) - m);
    l = warp_sum(l);
    // the weighted sum, the terms in order
    float acc[NV][VEC];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[v][c] = 0.f;
    const float* zk = zst + static_cast<long long>(k) * F;
    for (int n0 = 0; n0 < terms; n0 += UNROLL) {
      int j[UNROLL];
      float p[UNROLL];
      Vec<VEC> x[UNROLL][NV];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        j[u] = n0 + u < terms ? term(n0 + u, i, col, beg) : -1;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (j[u] < 0) continue;
        const long long row = j[u] * static_cast<long long>(ld);
        p[u] = expf(leaky(t + s[row]) - m);
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (column<VEC>(v, lane) < F)
            x[u][v] = load<VEC>(zk + row + column<VEC>(v, lane));
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (j[u] < 0) continue;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (column<VEC>(v, lane) < F)
#pragma unroll
            for (int c = 0; c < VEC; ++c) acc[v][c] += p[u] * x[u][v].v[c];
      }
    }
    float* oi = o + i * KF + static_cast<long long>(k) * F;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (column<VEC>(v, lane) >= F) continue;
      Vec<VEC> r;
#pragma unroll
      for (int c = 0; c < VEC; ++c) r.v[c] = acc[v][c] / l;
      store<VEC>(oi + column<VEC>(v, lane), r);
    }
    if (lane == 0) lse[w] = m + logf(l);
  }
}

// D[i, k] = g_i . o_i over head k's columns.
template <int VEC, int NV>
__global__ void __launch_bounds__(THREADS)
    gat_attn_bwd_delta_kernel(const float* __restrict__ g,
                              const float* __restrict__ o,
                              float* __restrict__ D, long long pairs, int K,
                              int F) {
  const int lane = threadIdx.x % WARP;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  for (long long w = static_cast<long long>(blockIdx.x) * WARPS +
                     threadIdx.x / WARP;
       w < pairs; w += stride) {
    const long long base = w * F;  // (row * K + k) * F
    float d = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (column<VEC>(v, lane) >= F) continue;
      const Vec<VEC> a = load<VEC>(g + base + column<VEC>(v, lane));
      const Vec<VEC> b = load<VEC>(o + base + column<VEC>(v, lane));
#pragma unroll
      for (int c = 0; c < VEC; ++c) d += a.v[c] * b.v[c];
    }
    d = warp_sum(d);
    if (lane == 0) D[w] = d;
  }
}

// Per source row j and head k, over j itself and then its out-edges j -> i
// in the transposed CSR: dz_j and ds_j into dzst, each term's dx into dx_t
// (the edge's transposed position) or dx_self (the self term).
template <int VEC, int NV>
__global__ void __launch_bounds__(THREADS)
    gat_attn_bwd_kernel(const int* __restrict__ row_ptr_t,
                        const int* __restrict__ col_t,
                        const float* __restrict__ zst,
                        const float* __restrict__ lse,
                        const float* __restrict__ D,
                        const float* __restrict__ g, float* __restrict__ dzst,
                        float* __restrict__ dx_t, float* __restrict__ dx_self,
                        long long pairs, int K, int F, int ld) {
  const int lane = threadIdx.x % WARP;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  const long long KF = static_cast<long long>(K) * F;
  for (long long w = static_cast<long long>(blockIdx.x) * WARPS +
                     threadIdx.x / WARP;
       w < pairs; w += stride) {
    const int j = static_cast<int>(w / K), k = static_cast<int>(w % K);
    const int beg = row_ptr_t[j];
    const int terms = row_ptr_t[j + 1] - beg + 1;
    const long long rj = j * static_cast<long long>(ld);
    const float sj = zst[rj + KF + k];
    const long long hk = static_cast<long long>(k) * F;
    Vec<VEC> zj[NV];
    float dz[NV][VEC];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (column<VEC>(v, lane) < F)
        zj[v] = load<VEC>(zst + rj + hk + column<VEC>(v, lane));
#pragma unroll
      for (int c = 0; c < VEC; ++c) dz[v][c] = 0.f;
    }
    float ds = 0.f;
    for (int n0 = 0; n0 < terms; n0 += UNROLL) {
      int i[UNROLL];
      float x[UNROLL], a[UNROLL], dot[UNROLL], Di[UNROLL], Li[UNROLL];
      Vec<VEC> gi[UNROLL][NV];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        i[u] = n0 + u < terms ? term(n0 + u, j, col_t, beg) : -1;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        dot[u] = 0.f;
        if (i[u] < 0) continue;
        const long long pi = static_cast<long long>(i[u]) * K + k;
        x[u] = zst[i[u] * static_cast<long long>(ld) + KF + K + k] + sj;
        Li[u] = lse[pi];
        Di[u] = D[pi];
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (column<VEC>(v, lane) < F)
            gi[u][v] = load<VEC>(g + pi * F + column<VEC>(v, lane));
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i[u] < 0) continue;
        a[u] = expf(leaky(x[u]) - Li[u]);
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (column<VEC>(v, lane) < F)
#pragma unroll
            for (int c = 0; c < VEC; ++c) dot[u] += gi[u][v].v[c] * zj[v].v[c];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) dot[u] = warp_sum(dot[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i[u] < 0) continue;
        const float dx =
            a[u] * (dot[u] - Di[u]) * (x[u] > 0.f ? 1.f : SLOPE);
        ds += dx;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (column<VEC>(v, lane) < F)
#pragma unroll
            for (int c = 0; c < VEC; ++c) dz[v][c] += a[u] * gi[u][v].v[c];
        if (lane == 0) {
          const int n = n0 + u;
          if (n == 0)
            dx_self[w] = dx;
          else
            dx_t[static_cast<long long>(beg + n - 1) * K + k] = dx;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (column<VEC>(v, lane) >= F) continue;
      Vec<VEC> r;
#pragma unroll
      for (int c = 0; c < VEC; ++c) r.v[c] = dz[v][c];
      store<VEC>(dzst + rj + hk + column<VEC>(v, lane), r);
    }
    if (lane == 0) dzst[rj + KF + k] = ds;
  }
}

// dt_i = dx_self[i] + each in-edge's dx, read at its transposed position:
// one thread per (row, head).
__global__ void __launch_bounds__(THREADS)
    gat_attn_bwd_dt_kernel(const int* __restrict__ row_ptr,
                           const int* __restrict__ pos_t,
                           const float* __restrict__ dx_t,
                           const float* __restrict__ dx_self,
                           float* __restrict__ dzst, long long pairs, int K,
                           int F, int ld) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long w = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       w < pairs; w += stride) {
    const int i = static_cast<int>(w / K), k = static_cast<int>(w % K);
    float dt = dx_self[w];
    for (int e = row_ptr[i]; e < row_ptr[i + 1]; ++e)
      dt += dx_t[static_cast<long long>(pos_t[e]) * K + k];
    dzst[i * static_cast<long long>(ld) + static_cast<long long>(K) * F + K +
         k] = dt;
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

unsigned blocks_for(long long work, int per_block) {
  const long long b = (work + per_block - 1) / per_block;
  return static_cast<unsigned>(b < (1LL << 20) ? (b > 0 ? b : 1) : (1LL << 20));
}

// Vectors a lane takes for F columns at VEC floats a vector: 0 where F is
// too wide for the kernels' registers.
int vectors(int F, int vec) {
  const int need = (F + WARP * vec - 1) / (WARP * vec);
  for (int nv = 1; nv <= 8; nv *= 2)
    if (need <= nv) return nv;
  return 0;
}

// The forward's launch, for the kernels' templates.
struct Fwd {
  const int* row_ptr;
  const int* col;
  const float* zst;
  float* o;
  float* lse;
  long long pairs;
  int K, F, ld;
  cudaStream_t st;
  template <int VEC, int NV>
  void run() const {
    gat_attn_fwd_kernel<VEC, NV>
        <<<blocks_for(pairs, WARPS), THREADS, 0, st>>>(row_ptr, col, zst, o,
                                                       lse, pairs, K, F, ld);
  }
};

// The backward's delta and transposed-walk launches.
struct Bwd {
  const int* row_ptr_t;
  const int* col_t;
  const float* zst;
  const float* o;
  const float* lse;
  const float* g;
  float* dzst;
  float* D;
  float* dx_t;
  float* dx_self;
  long long pairs;
  int K, F, ld;
  cudaStream_t st;
  template <int VEC, int NV>
  void run() const {
    gat_attn_bwd_delta_kernel<VEC, NV>
        <<<blocks_for(pairs, WARPS), THREADS, 0, st>>>(g, o, D, pairs, K, F);
    gat_attn_bwd_kernel<VEC, NV><<<blocks_for(pairs, WARPS), THREADS, 0, st>>>(
        row_ptr_t, col_t, zst, lse, D, g, dzst, dx_t, dx_self, pairs, K, F,
        ld);
  }
};

// Runs fn's template for (vec, nv); false where there is none.
template <typename Fn>
bool dispatch(bool vec, int nv, const Fn& fn) {
  switch ((vec ? 16 : 0) + nv) {
    case 16 + 1: fn.template run<4, 1>(); return true;
    case 16 + 2: fn.template run<4, 2>(); return true;
    case 16 + 4: fn.template run<4, 4>(); return true;
    case 16 + 8: fn.template run<4, 8>(); return true;
    case 1: fn.template run<1, 1>(); return true;
    case 2: fn.template run<1, 2>(); return true;
    case 4: fn.template run<1, 4>(); return true;
    case 8: fn.template run<1, 8>(); return true;
  }
  return false;
}

bool check(long long N, int K, int F, int ld) {
  return N >= 0 && N < (1LL << 31) && K > 0 && F > 0 &&
         ld == K * F + 2 * K && N * K < (1LL << 40);
}

}  // namespace

// The forward over N rows of zst (N, ld): o (N, K*F) and lse (N, K).
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int gmeta_gat_attn_fwd(const void* row_ptr, const void* col,
                                  const void* zst, void* o, void* lse,
                                  long long N, int K, int F, int ld,
                                  void* stream) {
  if (!check(N, K, F, ld)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && ld % 4 == 0 && aligned(zst) && aligned(o);
  const Fwd fn{static_cast<const int*>(row_ptr), static_cast<const int*>(col),
               static_cast<const float*>(zst), static_cast<float*>(o),
               static_cast<float*>(lse), N * K, K, F, ld, st};
  if (!dispatch(vec, vectors(F, vec ? 4 : 1), fn))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The backward: from g (N, K*F), the gradient of o, the gradient of zst
// (N, ld) into dzst, with scratch D (N, K), dx_t (nnz, K) and dx_self
// (N, K). Three launches; returns the first error, else 0.
extern "C" int gmeta_gat_attn_bwd(const void* row_ptr, const void* row_ptr_t,
                                  const void* col_t, const void* pos_t,
                                  const void* zst, const void* o,
                                  const void* lse, const void* g, void* dzst,
                                  void* D, void* dx_t, void* dx_self,
                                  long long N, int K, int F, int ld,
                                  void* stream) {
  if (!check(N, K, F, ld)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && ld % 4 == 0 && aligned(zst) && aligned(o) &&
                   aligned(g) && aligned(dzst);
  const long long pairs = N * K;
  const Bwd fn{static_cast<const int*>(row_ptr_t),
               static_cast<const int*>(col_t), static_cast<const float*>(zst),
               static_cast<const float*>(o), static_cast<const float*>(lse),
               static_cast<const float*>(g), static_cast<float*>(dzst),
               static_cast<float*>(D), static_cast<float*>(dx_t),
               static_cast<float*>(dx_self), pairs, K, F, ld, st};
  if (!dispatch(vec, vectors(F, vec ? 4 : 1), fn))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  gat_attn_bwd_dt_kernel<<<blocks_for(pairs, THREADS), THREADS, 0, st>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(pos_t),
      static_cast<const float*>(dx_t), static_cast<const float*>(dx_self),
      static_cast<float*>(dzst), pairs, K, F, ld);
  return static_cast<int>(cudaGetLastError());
}
