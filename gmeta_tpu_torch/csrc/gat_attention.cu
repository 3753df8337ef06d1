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
// row of F floats read. The least bytes are zst read once, o and lse
// written once, the CSR read once; the backward reads g, o and zst once
// and writes the gradient once. Edges never leave a bin, so every source a
// destination reads lies in a short range of rows around it, known before
// the kernels run: a *segment* (a bin of P slots in the slot layout, an
// original bin's live rows in the repacked one, data/repack.py). Two
// designs:
//
// - Staged (`gat_attn_fwd_kernel_staged`, `gat_attn_bwd_staged_kernel`):
//   one block per (segment, head), or per share of a segment's rows where
//   the host splits segments to fill the card. The block stages the
//   segment's CSR (row offsets, and the sources of up to 16 edges a row as
//   offsets into the segment) and its s and t (the backward: also lse, D
//   and each cached term's weight a_ij) once, then walks the head's columns
//   in slices of 32: it copies the segment's rows of the slice (z forward,
//   g backward) into shared memory with cp.async, and sums every term from
//   there. A row takes a group of 8 lanes, 4 columns a lane (a 16-byte
//   shared-memory read a term), so a warp takes 4 rows at once; a group's
//   lanes first work out 8 of its row's terms (source and weight), which
//   they hand to the group through shared memory. So each source row is
//   read from device memory once per block, not once per term, and no
//   row's walk waits for device memory in any slice. Where all of a
//   group's sources lie among the staged rows (always, where the segments
//   hold their edges; a warp votes), the loop has no branch: a row's terms
//   are padded to the group's with a zero row weighted -0, which adds
//   nothing (x + (-0) = x). Forward (512 threads, two blocks an SM at the
//   cell's 586-row segments): each row's max and sum first, once, with the
//   walk kernel's lanes and butterfly emulated by the group (the max is
//   the same in any order), then the weighted sums in CSR order with the
//   same expressions: o and lse are the walk kernel's bits. Backward (1024
//   threads, one block an SM): dz_j sums its terms in the walk kernel's
//   order (its bits too); the full-width dot g_i . z_j crosses slices, so
//   each slice's part of every term's dot is reduced across the group (a
//   transposed butterfly: 4 shuffles for 4 terms) and added, slice by
//   slice in order, in shared memory (or, for an edge past the cache, in
//   its dx slot); after the last slice the block turns the dots into dx
//   (into dx_t and dx_self, for the dt kernel) and sums ds. Its delta
//   kernel sums g_i . o_i in the same order, so where z_j has o_i's bits,
//   g_i . z_j - D_i is exactly 0, as in the plain version. A source
//   outside the staged rows is read from device memory, so the result
//   never depends on the segment table, only the speed does.
// - Walk (`gat_attn_fwd_kernel`, `gat_attn_bwd_kernel`): one warp per
//   (row, head), its lanes across the head's F columns with 16-byte loads
//   (4 floats) where F is a multiple of 4 and the rows are aligned, else
//   one float a lane (layer 3's heads of 121); each term's source row comes
//   from L2. The host takes it where a segment may not fit shared memory.
//
// Every sum runs in a fixed order, so two launches give the same bits; no
// atomics.
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

// ---- staged kernels -------------------------------------------------------

constexpr int SLICE = 32;            // a head's columns staged at a time
constexpr int GROUP = 8;             // lanes a row takes, 4 columns each
constexpr int ROWS = WARP / GROUP;   // rows a warp takes at once
constexpr int SLOTS = GROUP + 1;     // a group's (source, weight) pairs,
                                     // padded against bank conflicts
constexpr int FWD_THREADS = 512;
constexpr int BWD_THREADS = 1024;
constexpr int EDGES_A_ROW = 16;      // most edges a segment caches, a row
constexpr long long SMEM_LIMIT = 232448;   // 227 KB, a block's most
constexpr int NEG_ZERO = static_cast<int>(0x80000000u);   // -0.0f's bits

// Shared memory of a staged block for segments of at most `cap` rows, in
// this order: the slice ((cap + 1) x SLICE floats: the last row zeros, the
// source of the padding that rounds a group's terms up to whole groups,
// weighted -0 so that it adds nothing); each row group's (source, weight)
// slots; floats a row: s, t, m and l forward, s, t, lse, D, the self
// term's dot and its weight backward; the rows' edge offsets (cap + 1
// ints); then, for each cached edge, backward its dot and its weight a_ij
// (floats), and its source (a short). The cache takes what the rest
// leaves of SMEM_LIMIT, at most EDGES_A_ROW edges a row. (Forward, a
// weights' cache would cost the second block an SM: slower.)
long long fwd_fixed(long long cap) {
  return (cap + 1) * SLICE * 4 + FWD_THREADS / GROUP * SLOTS * 8 +
         cap * 4 * 4 + (cap + 1) * 4;
}
long long bwd_fixed(long long cap) {
  return (cap + 1) * SLICE * 4 + BWD_THREADS / GROUP * SLOTS * 8 +
         cap * 6 * 4 + (cap + 1) * 4;
}
long long room(long long fixed, long long cap, int per_edge) {
  const long long left = (SMEM_LIMIT - fixed) / per_edge;
  return left < cap * EDGES_A_ROW ? left : cap * EDGES_A_ROW;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

// Copies columns [0, w) of n rows (row r at src + r * stride) into
// dst[r * SLICE + c], VEC floats a copy (w a multiple of VEC), sets
// columns [w, SLICE) to 0, and waits for them.
template <int VEC>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long stride, int n, int w) {
  constexpr int PER = SLICE / VEC;   // copies a row
  for (int x = threadIdx.x; x < n * PER; x += blockDim.x) {
    const int r = x / PER, q = x % PER * VEC;
    if (q < w) {
      cp_async(dst + r * SLICE + q, src + r * stride + q, VEC == 4);
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c) dst[r * SLICE + q + c] = 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The rows a block owns: [b0, b1) of its segment [r0, r0 + len), the
// segment's rows split evenly among gridDim.z blocks.
struct Share {
  int r0, len, b0, b1;
  __device__ Share(const int* __restrict__ seg) {
    r0 = seg[blockIdx.x];
    len = seg[blockIdx.x + 1] - r0;
    const int per = (len + gridDim.z - 1) / gridDim.z;
    b0 = min(len, static_cast<int>(blockIdx.z) * per);
    b1 = min(len, b0 + per);
  }
};

// A value of row j: its staged copy where j lies among the n staged rows
// from r0, else the one in device memory.
__device__ __forceinline__ float pick(const float* __restrict__ staged,
                                      const float* __restrict__ global,
                                      int j, int r0, int n,
                                      long long stride) {
  const unsigned q = static_cast<unsigned>(j - r0);
  return q < static_cast<unsigned>(n) ? staged[q] : global[j * stride];
}

// A segment's CSR in shared memory, so that a row's terms cost no trip to
// device memory in any slice: rp[r] the first edge of row r0 + r, counted
// from the segment's first edge e0, for r <= n; src[e] the source of each
// of the first `cached` edges as an offset from r0 (-1 where it lies
// outside the n staged rows). Rows past n and edges past `cached` are read
// from device memory.
struct LocalCsr {
  int* rp;
  short* src;
  const int* __restrict__ row_ptr;
  const int* __restrict__ col;
  int r0, n, e0, cached;

  __device__ LocalCsr(int* rp_, short* src_, const int* row_ptr_,
                      const int* col_, int r0_, int n_, int room)
      : rp(rp_), src(src_), row_ptr(row_ptr_), col(col_), r0(r0_), n(n_) {
    e0 = row_ptr[r0];
    cached = min(row_ptr[r0 + n] - e0, room);
    for (int r = threadIdx.x; r <= n; r += blockDim.x)
      rp[r] = row_ptr[r0 + r] - e0;
    for (int e = threadIdx.x; e < cached; e += blockDim.x) {
      const unsigned q = static_cast<unsigned>(col[e0 + e] - r0);
      src[e] = q < static_cast<unsigned>(n) ? static_cast<short>(q) : -1;
    }
  }
  // row r0 + r's edges: [x, y), counted from e0
  __device__ int2 edges(int r) const {
    return r < n ? make_int2(rp[r], rp[r + 1])
                 : make_int2(row_ptr[r0 + r] - e0, row_ptr[r0 + r + 1] - e0);
  }
  // the term q of row i, whose edges start at b: i itself, then its edges
  __device__ int term(int i, int b, int q) const {
    if (q == 0) return i;
    const int e = b + q - 1;
    if (e < cached && src[e] >= 0) return r0 + src[e];
    return col[e0 + e];
  }
};

// The forward's max and sum of row r0 + r's terms, the terms on the lanes:
// the walk kernel's expressions in its order, so the same bits.
__device__ __forceinline__ float2 row_stats(const LocalCsr& csr, int r,
                                            float t,
                                            const float* __restrict__ ss,
                                            const float* __restrict__ s,
                                            int ld, int lane) {
  const int i = csr.r0 + r;
  const int2 e = csr.edges(r);
  const int terms = e.y - e.x + 1;
  float m = -INFINITY;
  for (int q = lane; q < terms; q += WARP)
    m = fmaxf(m, leaky(t + pick(ss, s, csr.term(i, e.x, q), csr.r0, csr.n,
                                ld)));
  m = warp_max(m);
  float l = 0.f;
  for (int q = lane; q < terms; q += WARP)
    l += expf(leaky(t + pick(ss, s, csr.term(i, e.x, q), csr.r0, csr.n,
                             ld)) - m);
  return make_float2(m, warp_sum(l));
}

// The same for a row group's row, with the walk kernel's bits: its 32
// lanes become 4 virtual lanes of each of the group's 8 (lane g holds the
// walk's lanes g, g + 8, g + 16 and g + 24), whose sums the first two
// stages of warp_sum's butterfly (^16, ^8) add in the lane, the last three
// across the group. The max is the same in any order.
__device__ __forceinline__ float2 group_stats(const LocalCsr& csr, int r,
                                              bool live, float t,
                                              const float* __restrict__ ss,
                                              const float* __restrict__ s,
                                              int ld, int gl) {
  const int i = csr.r0 + r;
  int2 e = make_int2(0, -1);
  if (live) e = csr.edges(r);
  const int terms = e.y - e.x + 1;
  float m = -INFINITY;
  for (int q = gl; q < terms; q += GROUP)
    m = fmaxf(m, leaky(t + pick(ss, s, csr.term(i, e.x, q), csr.r0, csr.n,
                                ld)));
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 4));
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
  float x[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x[c] = 0.f;
    for (int q = gl + GROUP * c; q < terms; q += WARP)
      x[c] += expf(leaky(t + pick(ss, s, csr.term(i, e.x, q), csr.r0,
                                  csr.n, ld)) - m);
  }
  float l = (x[0] + x[2]) + (x[1] + x[3]);
  l += __shfl_xor_sync(FULL, l, 4);
  l += __shfl_xor_sync(FULL, l, 2);
  l += __shfl_xor_sync(FULL, l, 1);
  return make_float2(m, l);
}

// A row group's slice: lane g of the group holds columns [4g, 4g + 4).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The forward, staged (the header's first design). Grid (segments, K,
// shares); cap bounds a segment's staged rows, room its cached edges; seg
// (segments + 1) holds the segments' first rows, then N. A group of 8
// lanes takes a row, 4 columns a lane, so a warp takes 4 rows at once.
template <int VEC>
__global__ void __launch_bounds__(FWD_THREADS, 2)
    gat_attn_fwd_kernel_staged(const int* __restrict__ row_ptr,
                               const int* __restrict__ col,
                               const int* __restrict__ seg,
                               const float* __restrict__ zst,
                               float* __restrict__ o, float* __restrict__ lse,
                               int cap, int room, int K, int F, int ld) {
  const Share sh(seg);
  if (sh.b0 >= sh.b1) return;
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int grp = lane / GROUP, gl = lane % GROUP;
  float* zs = reinterpret_cast<float*>(smem4);   // (cap + 1) x SLICE
  int2* slots = reinterpret_cast<int2*>(zs + (cap + 1) * SLICE);
  int2* jp = slots + (warp * ROWS + grp) * SLOTS;   // this group's (j, p)
  float* ss = reinterpret_cast<float*>(slots + FWD_THREADS / GROUP * SLOTS);
  float* ts = ss + cap;                          // s, t of the staged rows
  float* ms = ts + cap;                          // the softmax's max
  float* ls = ms + cap;                          // and sum
  int* rp = reinterpret_cast<int*>(ls + cap);
  const int k = blockIdx.y, r0 = sh.r0, n = min(sh.len, cap);
  const LocalCsr csr(rp, reinterpret_cast<short*>(rp + cap + 1), row_ptr,
                     col, r0, n, room);
  const long long KF = static_cast<long long>(K) * F;
  const float* s = zst + KF + k;       // s_j at s[j * ld]
  const float* tg = zst + KF + K + k;  // t_i at tg[i * ld]
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    ss[r] = s[(r0 + r) * static_cast<long long>(ld)];
    ts[r] = tg[(r0 + r) * static_cast<long long>(ld)];
  }
  if (threadIdx.x < SLICE) zs[cap * SLICE + threadIdx.x] = 0.f;
  __syncthreads();
  for (int rb = sh.b0 + warp * ROWS; rb < sh.b1;
       rb += FWD_THREADS / WARP * ROWS) {
    const int r = rb + grp;
    const bool live = r < sh.b1;
    const float2 ml = group_stats(
        csr, r, live, live ? pick(ts, tg, r0 + r, r0, n, ld) : 0.f, ss, s,
        ld, gl);
    if (live && gl == 0) {
      if (r < n) {
        ms[r] = ml.x;
        ls[r] = ml.y;
      }
      lse[static_cast<long long>(r0 + r) * K + k] = ml.x + logf(ml.y);
    }
  }
  const int b1 = min(sh.b1, n);   // rows past n take the warp loop below
  for (int c0 = 0; c0 < F; c0 += SLICE) {
    const int w = min(SLICE, F - c0);
    const float* zc = zst + static_cast<long long>(k) * F + c0;
    __syncthreads();   // the previous slice is read
    stage<VEC>(zs, zc + r0 * static_cast<long long>(ld), ld, n, w);
    __syncthreads();
    for (int rb = sh.b0 + warp * ROWS; rb < b1;
         rb += FWD_THREADS / WARP * ROWS) {
      const int r = rb + grp, i = r0 + r;
      const bool live = r < b1;
      int2 e = make_int2(0, -1);
      float t = 0.f, m = 0.f, l = 1.f;
      if (live) {
        e = csr.edges(r);
        t = ts[r];
        m = ms[r];
        l = ls[r];
      }
      const int terms = e.y - e.x + 1;
      const int most = static_cast<int>(
          __reduce_max_sync(FULL, static_cast<unsigned>(terms)));
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int n0 = 0; n0 < most; n0 += GROUP) {
        // lane g's term: its source, weight and staged row (past the
        // row's terms the zero row weighted -0; -1 for a source past the
        // staged rows)
        int j = -1, row = cap, pb = NEG_ZERO;
        if (n0 + gl < terms) {
          j = csr.term(i, e.x, n0 + gl);
          pb = __float_as_int(expf(leaky(t + pick(ss, s, j, r0, n, ld)) -
                                   m));
          const unsigned q = static_cast<unsigned>(j - r0);
          row = q < static_cast<unsigned>(n) ? static_cast<int>(q) : -1;
        }
        const bool staged = __all_sync(FULL, row >= 0);
        jp[gl] = make_int2(staged ? row * SLICE : j, pb);
        __syncwarp();
        const int cnt = min(GROUP, most - n0);
        if (staged) {   // every term from shared memory
          const float* zl = zs + 4 * gl;
#pragma unroll 4
          for (int u = 0; u < cnt; ++u) {
            const int2 q = jp[u];
            const float p = __int_as_float(q.y);
            const float4 z = ld4(zl + q.x);
            acc.x += p * z.x;
            acc.y += p * z.y;
            acc.z += p * z.z;
            acc.w += p * z.w;
          }
        } else {
          for (int u = 0; u < cnt; ++u) {
            const int2 q = jp[u];
            if (q.x < 0) continue;   // padding
            const float p = __int_as_float(q.y);
            const unsigned qr = static_cast<unsigned>(q.x - r0);
            float z[4];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              z[c] = qr < static_cast<unsigned>(n)
                         ? zs[qr * SLICE + 4 * gl + c]
                     : 4 * gl + c < w
                         ? zc[q.x * static_cast<long long>(ld) + 4 * gl + c]
                         : 0.f;
            acc.x += p * z[0];
            acc.y += p * z[1];
            acc.z += p * z[2];
            acc.w += p * z[3];
          }
        }
        __syncwarp();
      }
      if (live) {
        float* oi = o + i * KF + static_cast<long long>(k) * F + c0 + 4 * gl;
        const float out[4] = {acc.x / l, acc.y / l, acc.z / l, acc.w / l};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (4 * gl + c < w) oi[c] = out[c];
      }
    }
    // rows past the staged ones (a segment longer than cap): a warp a row,
    // a column a lane, every value read where it lies
    for (int r = max(sh.b0, n) + warp; r < sh.b1; r += FWD_THREADS / WARP) {
      const int i = r0 + r;
      const int2 e = csr.edges(r);
      const int terms = e.y - e.x + 1;
      const float t = tg[i * static_cast<long long>(ld)];
      const float2 ml = row_stats(csr, r, t, ss, s, ld, lane);
      float acc = 0.f;
      for (int q = 0; q < terms; ++q) {
        const int j = csr.term(i, e.x, q);
        const unsigned qr = static_cast<unsigned>(j - r0);
        const float x = qr < static_cast<unsigned>(n) ? zs[qr * SLICE + lane]
                        : lane < w ? zc[j * static_cast<long long>(ld) + lane]
                                   : 0.f;
        acc += expf(leaky(t + pick(ss, s, j, r0, n, ld)) - ml.x) * x;
      }
      if (lane < w) o[i * KF + static_cast<long long>(k) * F + c0 + lane] =
          acc / ml.y;
    }
  }
}

// Sums each of v[0..3] over a row group's 8 lanes: lane g of the group
// returns the sum of v[(g >> 1) & 3]. The first two stages send half of
// what a lane holds to the lane across and keep the other half, so 4 sums
// take 4 shuffles, not 12; a term's 8 values meet in the pairs of a
// butterfly over lanes ^4, ^2, ^1, so the sum has the delta kernel's bits.
__device__ __forceinline__ float group_transpose_sum(const float (&v)[4],
                                                     int gl) {
  const bool h4 = gl & 4, h2 = gl & 2;
  float a[2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
    a[m] = (h4 ? v[m + 2] : v[m]) +
           __shfl_xor_sync(FULL, h4 ? v[m] : v[m + 2], 4);
  const float x =
      (h2 ? a[1] : a[0]) + __shfl_xor_sync(FULL, h2 ? a[0] : a[1], 2);
  return x + __shfl_xor_sync(FULL, x, 1);
}

// A lane's part of a dot over its 4 columns: the products rounded each on
// its own (no FMA), added in column order.
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return ((__fmul_rn(a.x, b.x) + __fmul_rn(a.y, b.y)) +
          __fmul_rn(a.z, b.z)) + __fmul_rn(a.w, b.w);
}

// The F columns of a row's head as the staged backward walks them: slice
// c0's 4 columns of lane g, zero past F.
__device__ __forceinline__ float4 cols4(const float* __restrict__ p, int c,
                                        int F) {
  return make_float4(c < F ? p[c] : 0.f, c + 1 < F ? p[c + 1] : 0.f,
                     c + 2 < F ? p[c + 2] : 0.f, c + 3 < F ? p[c + 3] : 0.f);
}

// D[i, k] = g_i . o_i over head k's columns, summed as the staged backward
// sums each term's dot g_i . z_j: a slice of 32 columns at a time, a row
// group of 8 lanes with 4 columns a lane (dot4), the group's parts added
// by a butterfly over lanes ^4, ^2, ^1, the slices added in order. So a
// term whose z_j has o_i's bits (a row whose every term has one source,
// as a lone node's self term) gets D's bits, and its g . z - D is exactly
// 0, as in the plain version. A group a (row, head), 4 a warp.
__global__ void __launch_bounds__(THREADS)
    gat_attn_bwd_delta_staged_kernel(const float* __restrict__ g,
                                     const float* __restrict__ o,
                                     float* __restrict__ D, long long pairs,
                                     int F) {
  const int lane = threadIdx.x % WARP, gl = lane % GROUP;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS /
                           GROUP;
  for (long long wb = (static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x - lane) / GROUP;
       wb < pairs; wb += stride) {
    const long long w = wb + lane / GROUP;
    const bool live = w < pairs;
    const float* gw = g + w * F;
    const float* ow = o + w * F;
    float d = 0.f;
    for (int c0 = 0; c0 < F; c0 += SLICE) {
      float part = 0.f;
      if (live) part = dot4(cols4(gw, c0 + 4 * gl, F), cols4(ow, c0 + 4 * gl, F));
      part += __shfl_xor_sync(FULL, part, 4);
      part += __shfl_xor_sync(FULL, part, 2);
      part += __shfl_xor_sync(FULL, part, 1);
      d = c0 == 0 ? part : d + part;
    }
    if (live && gl == 0) D[w] = d;
  }
}

// The backward's transposed walk, staged (the header's first design): per
// source row j and head k, over j itself and then its out-edges j -> i,
// dz_j and ds_j into dzst and each term's dx into dx_t (the edge's
// transposed position) or dx_self (the self term). Grid, seg, cap and room
// as the forward's; a group of 8 lanes a row, 4 columns a lane. Each
// term's dot g_i . z_j gathers over the slices in shared memory where the
// edge is cached (the self term where the row is staged), else in its dx
// slot.
template <int VEC>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    gat_attn_bwd_staged_kernel(const int* __restrict__ row_ptr_t,
                               const int* __restrict__ col_t,
                               const int* __restrict__ seg,
                               const float* __restrict__ zst,
                               const float* __restrict__ lse,
                               const float* __restrict__ D,
                               const float* __restrict__ g,
                               float* __restrict__ dzst,
                               float* __restrict__ dx_t,
                               float* __restrict__ dx_self, int cap,
                               int room, int K, int F, int ld) {
  const Share sh(seg);
  if (sh.b0 >= sh.b1) return;
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int grp = lane / GROUP, gl = lane % GROUP;
  float* gs = reinterpret_cast<float*>(smem4);   // (cap + 1) x SLICE
  int2* slots = reinterpret_cast<int2*>(gs + (cap + 1) * SLICE);
  int2* ia = slots + (warp * ROWS + grp) * SLOTS;   // this group's (i, a)
  float* ss = reinterpret_cast<float*>(slots + BWD_THREADS / GROUP * SLOTS);
  float* ts = ss + cap;                          // s, t, lse and D of the
  float* lss = ts + cap;                         // staged rows
  float* Ds = lss + cap;
  float* dot_self = Ds + cap;                    // the self terms' dots
  float* aself = dot_self + cap;                 // and weights
  int* rp = reinterpret_cast<int*>(aself + cap);
  float* dots = reinterpret_cast<float*>(rp + cap + 1);   // cached edges'
  float* acache = dots + room;                   // dots and weights
  const int k = blockIdx.y, r0 = sh.r0, n = min(sh.len, cap);
  const LocalCsr csr(rp, reinterpret_cast<short*>(acache + room), row_ptr_t,
                     col_t, r0, n, room);
  const long long KF = static_cast<long long>(K) * F;
  const float* s = zst + KF + k;        // s_j at s[j * ld]
  const float* tg = zst + KF + K + k;   // t_i at tg[i * ld]
  const float* lg = lse + k;            // lse_i at lg[i * K]
  const float* Dg = D + k;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    ss[r] = s[(r0 + r) * static_cast<long long>(ld)];
    ts[r] = tg[(r0 + r) * static_cast<long long>(ld)];
    lss[r] = lg[(r0 + r) * static_cast<long long>(K)];
    Ds[r] = Dg[(r0 + r) * static_cast<long long>(K)];
  }
  if (threadIdx.x < SLICE) gs[cap * SLICE + threadIdx.x] = 0.f;
  __syncthreads();
  // the weight a_ij of each staged row's cached terms, kept for the slices
  for (int rb = sh.b0 + warp * ROWS; rb < min(sh.b1, n);
       rb += BWD_THREADS / WARP * ROWS) {
    const int r = rb + grp, j = r0 + r;
    if (r >= min(sh.b1, n)) continue;
    const int2 e = csr.edges(r);
    const int last = min(e.y - e.x, max(csr.cached - e.x, 0));
    for (int q = gl; q <= last; q += GROUP) {
      const int i = csr.term(j, e.x, q);
      const float a = expf(leaky(pick(ts, tg, i, r0, n, ld) + ss[r]) -
                           pick(lss, lg, i, r0, n, K));
      if (q == 0)
        aself[r] = a;
      else
        acache[e.x + q - 1] = a;
    }
  }
  // where the dot of row r0 + r's term q gathers: shared memory, else the
  // term's dx slot in device memory
  auto acc = [&](int r, int b, int q) -> float* {
    if (q == 0)
      return r < n ? dot_self + r
                   : dx_self + static_cast<long long>(r0 + r) * K + k;
    const int e = b + q - 1;
    return e < csr.cached ? dots + e
                          : dx_t + static_cast<long long>(csr.e0 + e) * K + k;
  };
  for (int c0 = 0; c0 < F; c0 += SLICE) {
    const int w = min(SLICE, F - c0);
    const float* gc = g + static_cast<long long>(k) * F + c0;
    __syncthreads();   // the previous slice is read
    stage<VEC>(gs, gc + r0 * KF, KF, n, w);
    __syncthreads();
    for (int rb = sh.b0 + warp * ROWS; rb < sh.b1;
         rb += BWD_THREADS / WARP * ROWS) {
      const int r = rb + grp, j = r0 + r;
      const bool live = r < sh.b1;
      int2 e = make_int2(0, -1);
      float sj = 0.f;
      float4 zj = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) {
        e = csr.edges(r);
        sj = pick(ss, s, j, r0, n, ld);
        zj = cols4(zst + j * static_cast<long long>(ld) +
                       static_cast<long long>(k) * F + c0,
                   4 * gl, w);
      }
      const int terms = e.y - e.x + 1;
      const int most = static_cast<int>(
          __reduce_max_sync(FULL, static_cast<unsigned>(terms)));
      float4 dz = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int n0 = 0; n0 < most; n0 += GROUP) {
        // lane g's term, as the forward's
        int i = -1, row = cap, ab = NEG_ZERO;
        if (n0 + gl < terms) {
          const int q = n0 + gl, c = e.x + q - 1;
          if (q == 0 && r < n) {
            i = j;
            ab = __float_as_int(aself[r]);
          } else if (q > 0 && r < n && c < csr.cached) {
            i = csr.term(j, e.x, q);
            ab = __float_as_int(acache[c]);
          } else {
            i = csr.term(j, e.x, q);
            const float x = pick(ts, tg, i, r0, n, ld) + sj;
            ab = __float_as_int(expf(leaky(x) - pick(lss, lg, i, r0, n, K)));
          }
        }
        if (n0 + gl < terms) {
          const unsigned q = static_cast<unsigned>(i - r0);
          row = q < static_cast<unsigned>(n) ? static_cast<int>(q) : -1;
        }
        const bool staged = __all_sync(FULL, row >= 0);
        ia[gl] = make_int2(staged ? row * SLICE : i, ab);
        __syncwarp();
        const int cnt = min(GROUP, most - n0);
        for (int u0 = 0; u0 < cnt; u0 += 4) {   // 4 terms at a time
          float pr[4];
          if (staged) {   // every term from shared memory, zero past w
            const float* gl4 = gs + 4 * gl;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int2 q = ia[u0 + u];
              const float a = __int_as_float(q.y);
              const float4 gv = ld4(gl4 + q.x);
              dz.x += a * gv.x;
              dz.y += a * gv.y;
              dz.z += a * gv.z;
              dz.w += a * gv.w;
              pr[u] = dot4(gv, zj);
            }
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int2 q = ia[u0 + u];
              pr[u] = 0.f;
              if (q.x < 0) continue;   // padding
              const float a = __int_as_float(q.y);
              const unsigned qi = static_cast<unsigned>(q.x - r0);
              const float4 gv = qi < static_cast<unsigned>(n)
                                    ? ld4(gs + qi * SLICE + 4 * gl)
                                    : cols4(gc + q.x * KF, 4 * gl, w);
              dz.x += a * gv.x;
              dz.y += a * gv.y;
              dz.z += a * gv.z;
              dz.w += a * gv.w;
              pr[u] = dot4(gv, zj);
            }
          }
          const float part = group_transpose_sum(pr, gl);
          const int q = n0 + u0 + ((gl >> 1) & 3);
          if ((gl & 1) == 0 && q < terms) {
            float* p = acc(r, e.x, q);
            *p = c0 == 0 ? part : *p + part;
          }
        }
        __syncwarp();
      }
      if (live) {
        float* dzj = dzst + j * static_cast<long long>(ld) +
                     static_cast<long long>(k) * F + c0 + 4 * gl;
        const float out[4] = {dz.x, dz.y, dz.z, dz.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (4 * gl + c < w) dzj[c] = out[c];
      }
    }
  }
  __syncthreads();   // every slice's dots are gathered
  for (int rb = sh.b0 + warp * ROWS; rb < sh.b1;
       rb += BWD_THREADS / WARP * ROWS) {
    const int r = rb + grp, j = r0 + r;
    int2 e = make_int2(0, -1);
    float sj = 0.f;
    if (r < sh.b1) {
      e = csr.edges(r);
      sj = pick(ss, s, j, r0, n, ld);
    }
    const int terms = e.y - e.x + 1;
    float ds = 0.f;
    for (int q = gl; q < terms; q += GROUP) {
      const int i = csr.term(j, e.x, q);
      const float x = pick(ts, tg, i, r0, n, ld) + sj;
      const float a = expf(leaky(x) - pick(lss, lg, i, r0, n, K));
      const float dx = a * (*acc(r, e.x, q) - pick(Ds, Dg, i, r0, n, K)) *
                       (x > 0.f ? 1.f : SLOPE);
      *(q == 0 ? dx_self + static_cast<long long>(j) * K + k
               : dx_t + static_cast<long long>(csr.e0 + e.x + q - 1) * K +
                     k) = dx;
      ds += dx;
    }
    ds += __shfl_xor_sync(FULL, ds, 4);
    ds += __shfl_xor_sync(FULL, ds, 2);
    ds += __shfl_xor_sync(FULL, ds, 1);
    if (r < sh.b1 && gl == 0)
      dzst[j * static_cast<long long>(ld) + KF + k] = ds;
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

// A staged launch's grid: S segments x K heads x `shares` blocks, each
// segment of at most cap rows, whose fixed shared memory leaves room.
bool check_staged(long long S, int cap, int shares, int K, long long fixed) {
  return S >= 0 && S < (1LL << 31) && cap > 0 && cap < 32768 && shares > 0 &&
         shares < 65536 && K < 65536 && fixed <= SMEM_LIMIT;
}

// Raises a staged kernel's shared-memory ceiling to what it takes, and
// asks for the SM's largest share of shared memory (so that as many blocks
// fit as it holds), then launches it; returns the first error, else 0.
template <typename... P, typename... A>
int launch_staged(void (*kernel)(P...), int threads, long long S, int K,
                  int shares, long long smem, cudaStream_t st, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(S), K, shares), threads, smem, st>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

void launch_dt(const void* row_ptr, const void* pos_t, const void* dx_t,
               const void* dx_self, void* dzst, long long pairs, int K, int F,
               int ld, cudaStream_t st) {
  gat_attn_bwd_dt_kernel<<<blocks_for(pairs, THREADS), THREADS, 0, st>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(pos_t),
      static_cast<const float*>(dx_t), static_cast<const float*>(dx_self),
      static_cast<float*>(dzst), pairs, K, F, ld);
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
  launch_dt(row_ptr, pos_t, dx_t, dx_self, dzst, pairs, K, F, ld, st);
  return static_cast<int>(cudaGetLastError());
}

// The staged forward (the header's first design) over N rows in S
// segments: seg (S + 1) holds their first rows, then N; none holds more
// than cap rows; each is split among `shares` blocks. Returns
// cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int gmeta_gat_attn_fwd_staged(const void* row_ptr,
                                         const void* col, const void* seg,
                                         const void* zst, void* o, void* lse,
                                         long long N, long long S, int cap,
                                         int shares, int K, int F, int ld,
                                         void* stream) {
  const long long fixed = fwd_fixed(cap), edges = room(fixed, cap, 2);
  if (!check(N, K, F, ld) || !check_staged(S, cap, shares, K, fixed))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && ld % 4 == 0 && aligned(zst);
  auto kernel = vec ? gat_attn_fwd_kernel_staged<4>
                    : gat_attn_fwd_kernel_staged<1>;
  return launch_staged(kernel, FWD_THREADS, S, K, shares,
                       fixed + edges * 2, st,
                       static_cast<const int*>(row_ptr),
                       static_cast<const int*>(col),
                       static_cast<const int*>(seg),
                       static_cast<const float*>(zst), static_cast<float*>(o),
                       static_cast<float*>(lse), cap,
                       static_cast<int>(edges), K, F, ld);
}

// The staged backward: the staged delta kernel, the staged transposed walk
// and the dt kernel, with the forward's segments and the walk backward's
// arguments and scratch. Three launches; returns the first error, else 0.
extern "C" int gmeta_gat_attn_bwd_staged(
    const void* row_ptr, const void* row_ptr_t, const void* col_t,
    const void* pos_t, const void* seg, const void* zst, const void* o,
    const void* lse, const void* g, void* dzst, void* D, void* dx_t,
    void* dx_self, long long N, long long S, int cap, int shares, int K,
    int F, int ld, void* stream) {
  const long long fixed = bwd_fixed(cap), edges = room(fixed, cap, 10);
  if (!check(N, K, F, ld) || !check_staged(S, cap, shares, K, fixed))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long pairs = N * K;
  gat_attn_bwd_delta_staged_kernel<<<blocks_for(pairs, THREADS / GROUP),
                                     THREADS, 0, st>>>(static_cast<const float*>(g),
                                           static_cast<const float*>(o),
                                           static_cast<float*>(D), pairs, F);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  auto kernel = F % 4 == 0 && aligned(g) ? gat_attn_bwd_staged_kernel<4>
                                         : gat_attn_bwd_staged_kernel<1>;
  err = launch_staged(kernel, BWD_THREADS, S, K, shares, fixed + edges * 10,
                      st,
                      static_cast<const int*>(row_ptr_t),
                      static_cast<const int*>(col_t),
                      static_cast<const int*>(seg),
                      static_cast<const float*>(zst),
                      static_cast<const float*>(lse),
                      static_cast<const float*>(D),
                      static_cast<const float*>(g), static_cast<float*>(dzst),
                      static_cast<float*>(dx_t), static_cast<float*>(dx_self),
                      cap, static_cast<int>(edges), K, F, ld);
  if (err != 0) return err;
  launch_dt(row_ptr, pos_t, dx_t, dx_self, dzst, pairs, K, F, ld, st);
  return static_cast<int>(cudaGetLastError());
}
