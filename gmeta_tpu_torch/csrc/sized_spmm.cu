// Size-aware block-diagonal aggregation for Hopper (sm_90a): both directions
// as one gather over an edge list in CSR form, in two bodies.
//
// Replaces the two TPU kernel bodies behind the one pallas_call of
// gmeta_tpu/ops/pallas_spmm.py:
//   `_fwd_kernel` (:39): out[s] = A[s] @ x[s]    (GraphConv forward)
//   `_bwd_kernel` (:80): out[s] = A[s]^T @ x[s]  (its transpose, the backward
//                                                 of every aggregation)
// The TPU kernels read a dense (S, P, P) adjacency and skip its dead tiles.
// Here A is never built: ops/sized_spmm.py turns a packed set's edge list
// into CSRs over the flat rows N = S * P, one keyed by destination (the
// forward) and one by source (the transpose), so one kernel serves both:
//     out[r, :] = sum over e in [row_ptr[r], row_ptr[r + 1]) of x[col[e], :]
// A row without edges, such as every dead row (>= n_s) of a packed bin, is
// written as zeros, which is the TPU kernels' result on packed data. The
// same function over a table x of any height is the edge-partitioned
// engine's segment-sum (an XLA op in gmeta_tpu/parallel/edgepart_train.py).
//
// Which body serves which path, and why:
// - `csr_gather_kernel` (entry gmeta_sized_spmm) serves the packed sets
//   (ops/sized_spmm.py `launch`). Each group of lanes gathers one row over
//   all of H, and the grid walks the rows in order: the blocks in flight
//   cover a few consecutive bins, whose x rows (1 MB per bin at H = 256
//   float32) stay in the 50 MB L2 while the bins' edges gather from them,
//   so x is read from device memory about once. T tasks that share one
//   graph (the JAX batching rule of a task-invariant adjacency) take the
//   grid's y dimension: one launch, each task's rows walked as one task's
//   are, and no copy of x into rows of T x H.
// - `csr_slab_kernel` and `csr_combine_kernel` (entries gmeta_csr_slab,
//   gmeta_csr_combine) serve the rectangular entry point `csr_gather`,
//   which the edge engine runs over the whole graph. There the row-order
//   argument fails: one graph's edges name rows anywhere in a table of
//   V rows (174 MB at V = 170k, H = 256 float32, 3.5x the L2), so most
//   of the nnz x H row reads missed the L2. The slab body walks the
//   output slab-major: all rows for columns [0, S), then [S, 2S), ... The
//   blocks in flight then read one slab of x, V x S x itemsize bytes,
//   which the wrapper sizes to fit well inside the L2 (S = 32 float32
//   columns at V = 170k: 128 B per row, 21.8 MB); each slab comes from
//   device memory about once and the per-edge reads hit the L2. The CSR
//   is read once per slab, with evict-first loads (__ldcs) so that it
//   does not push the slab out. An L2 access-policy window does not fit:
//   it covers one contiguous range, and a column slab is strided.
// - Rows of power-law graphs are long (a row of 93k edges at V = 170k,
//   Zipf in-degrees), and one lane group summing such a row edge after
//   edge is a tail of tens of ms (33-35 ms there, against 0.8 ms for the
//   rest). Rows of more than `chunk` edges (128) are cut on the host into
//   chunks of `chunk` edges (ops/sized_spmm.py `row_split`); the slab body
//   sums each chunk into a float32 scratch row and skips the split row
//   itself, and the combine body adds each split row's partial sums in
//   chunk order. Every other row takes the slab path and sums exactly as
//   csr_gather_kernel does: bitwise the same result.
//
// What bounds them on an H100: bytes. A is a 0/1 adjacency: the products
// the edges need, 2 nnz H, take 0.03 ms at 67 TFLOP/s on either path. The
// least bytes are x's referenced rows read once, the output written once
// and the int32 indices (chip_smoke.py prints the bound for its data). On
// the full graph the nnz x H x itemsize bytes the edges gather (4.9 GB at
// H = 256) are 28x that bound; served from the L2, the L2's own rate is
// the limit. Tensor cores and TMA have nothing to do here: there is no
// dense tile to multiply, and each gathered row is a 16-byte-per-lane load
// that plain LDG.128 already serves.
//
// Design of both (PERF.md has the times of the alternatives named here,
// from sweep_sized_spmm.py):
// - G lanes per row (G = 32 at H = 256 float32, 16 at H = 128; in a slab,
//   the fewest that cover it), lanes across H with 16-byte loads (a
//   float4, or 8 bf16), at most 8 elements per lane per pass. Where H is
//   not a multiple of the vector width (H = 1, 5, 50 are real widths of
//   other presets) or x is not 16-byte aligned, the same code runs on
//   scalars; x is never padded.
// - A group reads its row's two row pointers and its edges' column indices
//   straight from device memory: every lane of the group reads the same
//   word, one broadcast load. Staging a block's indices in shared memory
//   first (one coalesced read each, two barriers) was slower on the packed
//   sets, so neither body uses shared memory.
// - Output stores are streaming (evict-first), to keep x in L2; at arxiv a
//   plain store measured the same.
// - In the packed body a group sums its row's edges one at a time; the
//   bytes in flight come from occupancy instead: the launch bounds hold a
//   thread to 32 registers, so 2048 threads fill an SM. Loading two or
//   four edges' rows at once before summing them was slower there (rows
//   of about 2 edges), and so was the kernel without the 32-register cap.
//   The slab body, whose rows have about 28 edges and whose reads hit the
//   L2, loads 4 edges' vectors before adding them (in edge order) and
//   takes 64 registers at 1024 threads an SM: 1.09 -> 0.76 ms at H = 256
//   on an H100, where either alone gained 7-14%.
// - Sums in float32 registers in edge order; bf16 is widened as it loads
//   and rounded once as it stores; a split row's partial sums stay float32
//   until the combine rounds them. No atomics, so two launches give the
//   same bits.
//
// The combine body: its bound is bytes (the partials read once, the split
// rows written once), a few us at chip_smoke.py's power-law CSR. What held
// the body it replaced back (a block of 256 scalar lanes per split row,
// each adding one chunk after another) was its longest rows: the adds
// must run in chunk order from 0.0f, so that the result is combine_plain's
// bit for bit, and one warp streams a row's partials at a few tens of GB/s
// however deep its loads run ahead (PERF.md: 4 to 32 chunks in flight a
// lane moved the 729-chunk row by 1.3x). Only the loads can be spread. So
// a row of more than HEAVY_CHUNKS chunks is cut into bands of HEAVY_BAND
// column vectors (128 bytes of each partial row at float32), and the
// bands go to different blocks of a set of one per SM: so one row streams
// through several SMs. There all 256 threads of a block load the next
// round of a band (streaming loads) into registers while the band's owner
// lanes add the round before from a shared tile, in chunk order, reading
// ADD_BATCH tile rows ahead. Every other row gets the fewest lanes (a
// power of two, up to a block) that cover H in one float4 (or scalar)
// each, a block as many rows as it holds, so at H = 1, 5 and 50 blocks do
// not sit mostly idle; each lane loads COMBINE_DEPTH chunks before it adds
// them. Stores are float4, or 4 bf16 as 8 bytes. PERF.md has the times
// beside the replaced body's and the variants sweep_sized_spmm.py tried.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // threads per block
constexpr int MIN_BLOCKS = 2048 / THREADS;  // a full SM: 32 registers
// The full-graph body's: 64 registers, for its edges loaded 4 at a time
constexpr int SLAB_MIN_BLOCKS = 4;
// The combine: a row of more than HEAVY_CHUNKS chunks is summed in bands
// of HEAVY_BAND column vectors, each by a whole block through a shared
// tile of COMBINE_TILE floats (32 KB), its owners reading ADD_BATCH tile
// rows ahead; a lane of a lighter row loads COMBINE_DEPTH chunks' partial
// sums before adding them (sweep_sized_spmm.py combine times the others).
constexpr int HEAVY_CHUNKS = 128;
constexpr int HEAVY_BAND = 8;
constexpr int COMBINE_TILE = 8192;
constexpr int ADD_BATCH = 8;
constexpr int COMBINE_DEPTH = 16;
static_assert(HEAVY_BAND <= THREADS, "a band's vectors each need an owner");

// Vectors per lane per pass over H: 8 elements for the 16-byte paths (two
// float4, one 8 x bf16), which keeps registers at float32's count for bf16.
template <int VEC>
__host__ __device__ constexpr int cpl() {
  return VEC == 1 ? 2 : 8 / VEC;
}

// Vectors per lane per pass of the full-graph body.
template <int VEC>
__host__ __device__ constexpr int slab_cpl() { return cpl<VEC>(); }

// Vector load (widened to float32) and streaming store of VEC elements.
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(b[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 q;
    __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      b[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    __stcs(reinterpret_cast<uint4*>(p), q);
  }
};

// Four bf16 as one 8-byte streaming store (the combine's rows; it reads
// float32 partial sums, four to a 16-byte load, and never loads bf16).
template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[4]) {
    uint2 q;
    __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&q);
    b[0] = __floats2bfloat162_rn(v[0], v[1]);
    b[1] = __floats2bfloat162_rn(v[2], v[3]);
    __stcs(reinterpret_cast<uint2*>(p), q);
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    __stcs(p, v[0]);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[1]) {
    *p = __float2bfloat16(v[0]);
  }
};

// TASKS: the grid's y dimension picks one of several tasks that share the
// graph, laid out N x H elements apart in x and in out. One task's launch
// is built without that offset, which cost it 3-4% at float32.
template <typename T, int VEC, bool TASKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    csr_gather_kernel(const int* __restrict__ row_ptr,
                      const int* __restrict__ col, const T* __restrict__ x,
                      T* __restrict__ out, int N, int H, int G) {
  constexpr int CPL = cpl<VEC>();
  if constexpr (TASKS) {
    const size_t task = static_cast<size_t>(blockIdx.y) * N * H;
    x += task;
    out += task;
  }
  const long long r =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) / G;
  const int lane = threadIdx.x % G;
  if (r >= N) return;
  const int a = row_ptr[r];
  const int b = row_ptr[r + 1];
  const int nv = H / VEC;  // vectors per row
  T* o = out + static_cast<size_t>(r) * H;

  for (int v0 = 0; v0 < nv; v0 += G * CPL) {  // passes over H
    float acc[CPL][VEC];
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[c][k] = 0.f;

    for (int e = a; e < b; ++e) {
      const T* src = x + static_cast<size_t>(col[e]) * H;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int vi = v0 + c * G + lane;
        if (vi < nv) {
          float v[VEC];
          Vec<T, VEC>::load(src + static_cast<size_t>(vi) * VEC, v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[c][k] += v[k];
        }
      }
    }

#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int vi = v0 + c * G + lane;
      if (vi < nv)
        Vec<T, VEC>::store(o + static_cast<size_t>(vi) * VEC, acc[c]);
    }
  }
}

template <typename T, int VEC>
void launch_vec(const int* row_ptr, const int* col, const void* x, void* out,
                int N, int H, int tasks, cudaStream_t stream) {
  const int nv = H / VEC;
  int G = 1;  // lanes per row: the fewest that cover H in cpl vectors each
  while (G < 32 && G * cpl<VEC>() < nv) G *= 2;
  const int rows = THREADS / G;
  const dim3 blocks(static_cast<unsigned>((N + rows - 1) / rows),
                    static_cast<unsigned>(tasks));
  if (tasks > 1)
    csr_gather_kernel<T, VEC, true><<<blocks, THREADS, 0, stream>>>(
        row_ptr, col, static_cast<const T*>(x), static_cast<T*>(out), N, H,
        G);
  else
    csr_gather_kernel<T, VEC, false><<<blocks, THREADS, 0, stream>>>(
        row_ptr, col, static_cast<const T*>(x), static_cast<T*>(out), N, H,
        G);
}

template <typename T>
void launch(const int* row_ptr, const int* col, const void* x, void* out,
            int N, int H, int tasks, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (H % VEC == 0 && aligned)
    launch_vec<T, VEC>(row_ptr, col, x, out, N, H, tasks, stream);
  else
    launch_vec<T, 1>(row_ptr, col, x, out, N, H, tasks, stream);
}

// ---- the full-graph bodies: column slabs, heavy rows split ------------------

// Stores VEC float32 partial sums (plain stores: the combine reads them
// back at once).
template <int VEC>
__device__ __forceinline__ void store_partial(float* p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = v[k];
  }
}

// Work items, slab-major: block b serves slab b / blocks_per_slab. Within
// a slab, item i < N is output row i (skipped if it has more than `chunk`
// edges), item N + c is chunk c of a split row, whose sum over the slab's
// columns goes to partial[c, :].
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, SLAB_MIN_BLOCKS)
    csr_slab_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ col, const T* __restrict__ x,
                    T* __restrict__ out, float* __restrict__ partial,
                    const int* __restrict__ chunk_row,
                    const int* __restrict__ chunk_start, int N, int n_chunks,
                    int H, int slab_v, int G, int chunk, int blocks_per_slab) {
  constexpr int CPL = slab_cpl<VEC>();
  const int slab = blockIdx.x / blocks_per_slab;
  const long long item =
      (static_cast<long long>(blockIdx.x % blocks_per_slab) * THREADS +
       threadIdx.x) / G;
  const int lane = threadIdx.x % G;
  if (item >= static_cast<long long>(N) + n_chunks) return;
  int a, b;
  T* o = nullptr;
  float* p = nullptr;
  if (item < N) {
    a = __ldcs(row_ptr + item);
    b = __ldcs(row_ptr + item + 1);
    if (b - a > chunk) return;  // a split row: its chunks sum it
    o = out + static_cast<size_t>(item) * H;
  } else {
    const int c = static_cast<int>(item - N);
    a = __ldcs(chunk_start + c);
    const int end = __ldcs(row_ptr + __ldcs(chunk_row + c) + 1);
    b = end - a > chunk ? a + chunk : end;
    p = partial + static_cast<size_t>(c) * H;
  }
  const int nv = H / VEC;  // vectors per row
  const int v_end = min(nv, (slab + 1) * slab_v);

  for (int v0 = slab * slab_v; v0 < v_end; v0 += G * CPL) {  // passes
    float acc[CPL][VEC];
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[c][k] = 0.f;

#pragma unroll 4
    for (int e = a; e < b; ++e) {
      const T* src = x + static_cast<size_t>(__ldcs(col + e)) * H;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int vi = v0 + c * G + lane;
        if (vi < v_end) {
          float v[VEC];
          Vec<T, VEC>::load(src + static_cast<size_t>(vi) * VEC, v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[c][k] += v[k];
        }
      }
    }

#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int vi = v0 + c * G + lane;
      if (vi < v_end) {
        if (o != nullptr)
          Vec<T, VEC>::store(o + static_cast<size_t>(vi) * VEC, acc[c]);
        else
          store_partial<VEC>(p + static_cast<size_t>(vi) * VEC, acc[c]);
      }
    }
  }
}

// Streaming (evict-first) load of VEC float32 partial sums: each is read
// once.
template <int VEC>
__device__ __forceinline__ void load_partial(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldcs(p);
  }
}

// A heavy row's round of chunks [c, c + R) over the band of bn vectors from
// b0: element e = threadIdx.x + i THREADS is chunk c + e / bn, vector b0 +
// e % bn, loaded into v[i].
template <int VEC, int LOADS>
__device__ __forceinline__ void load_round(const float* __restrict__ partial,
                                           int c, int c1, int R, int bn,
                                           int b0, int H,
                                           float (&v)[LOADS][VEC]) {
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int k = e / bn;
    if (k < R && c + k < c1)
      load_partial<VEC>(partial + static_cast<size_t>(c + k) * H +
                            static_cast<size_t>(b0 + e % bn) * VEC,
                        v[i]);
  }
}

// acc += the N tile rows at s, s + stride, ..., in order: the N shared
// reads are issued before the adds.
template <int VEC, int N>
__device__ __forceinline__ void add_tile_rows(const float* s, int stride,
                                              float (&acc)[VEC]) {
  float w[N][VEC];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if constexpr (VEC == 4) {
      const float4 q = *reinterpret_cast<const float4*>(s + j * stride);
      w[j][0] = q.x;
      w[j][1] = q.y;
      w[j][2] = q.z;
      w[j][3] = q.w;
    } else {
      w[j][0] = s[j * stride];
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += w[j][k];
}

// One band of a heavy row (more than HEAVY_CHUNKS chunks), by a whole
// block: out[rows[h], v] for the band's column vectors v in [b0, b0 + bn),
// bn <= THREADS, = the sum of partial[c, v] over c in [chunk_ptr[h],
// chunk_ptr[h + 1]), from 0.0f in chunk order. Each round the block loads
// the next R chunks' band into registers (every thread LOADS vectors; R x
// bn in all), while the band's owners (thread t owns vector b0 + t) add
// the round before from the shared tile in chunk order.
template <typename T, int VEC>
__device__ void combine_heavy(int h, int b0, int bn,
                              const int* __restrict__ rows,
                              const int* __restrict__ chunk_ptr,
                              const float* __restrict__ partial,
                              T* __restrict__ out, int H, float* tile) {
  constexpr int TILE_V = COMBINE_TILE / VEC;  // vectors the tile holds
  constexpr int LOADS = TILE_V / THREADS;     // a thread's loads a round
  const int c0 = chunk_ptr[h];
  const int c1 = chunk_ptr[h + 1];
  const int R = TILE_V / bn;                  // chunks a round
  float v[LOADS][VEC];
  load_round<VEC, LOADS>(partial, c0, c1, R, bn, b0, H, v);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int c = c0; c < c1; c += R) {
    __syncthreads();  // the owners are done with the tile
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (e / bn < R && c + e / bn < c1) {
        if constexpr (VEC == 4)
          *reinterpret_cast<float4*>(tile + e * 4) =
              make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
        else
          tile[e] = v[i][0];
      }
    }
    __syncthreads();
    if (c + R < c1)  // in flight while the owners add
      load_round<VEC, LOADS>(partial, c + R, c1, R, bn, b0, H, v);
    if (threadIdx.x < bn) {
      const int n = min(R, c1 - c);
      const float* s = tile + threadIdx.x * VEC;
      int k = 0;
      for (; k + ADD_BATCH <= n; k += ADD_BATCH)  // ADD_BATCH reads ahead
        add_tile_rows<VEC, ADD_BATCH>(s + k * bn * VEC, bn * VEC, acc);
      for (; k < n; ++k) add_tile_rows<VEC, 1>(s + k * bn * VEC, 0, acc);
    }
  }
  if (threadIdx.x < bn)
    Vec<T, VEC>::store(out + static_cast<size_t>(rows[h]) * H +
                           static_cast<size_t>(b0 + threadIdx.x) * VEC,
                       acc);
}

// out[rows[h], :] = the sum of partial[c, :] over row h's chunks
// [chunk_ptr[h], chunk_ptr[h + 1]), from 0.0f in chunk order, for h <
// n_rows. A heavy row's columns are cut into bands of HEAVY_BAND vectors,
// and the first heavy_blocks blocks sum them (combine_heavy): block j
// takes band b of the heavy rows among h = j - b spread, j - b spread +
// heavy_blocks, ... (mod heavy_blocks), so the bands of one row land on
// blocks `spread` apart. The other blocks give each row G lanes, one
// VEC-wide column vector per lane per pass, and skip the heavy rows; each
// lane loads COMBINE_DEPTH chunks' vectors, then adds them in chunk order.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    csr_combine_kernel(const int* __restrict__ rows,
                       const int* __restrict__ chunk_ptr,
                       const float* __restrict__ partial, T* __restrict__ out,
                       int n_rows, int H, int G, int heavy_blocks) {
  __shared__ __align__(16) float tile[COMBINE_TILE];
  if (static_cast<int>(blockIdx.x) < heavy_blocks) {
    __shared__ int found[THREADS];
    __shared__ int n_found;
    const int nv = H / VEC;
    const int n_bands = (nv + HEAVY_BAND - 1) / HEAVY_BAND;
    const int spread = max(1, heavy_blocks / n_bands);
    const long long stride = static_cast<long long>(heavy_blocks) * THREADS;
    for (int band = 0; band < n_bands; ++band) {
      const int b0 = band * HEAVY_BAND;
      const int bn = min(nv - b0, HEAVY_BAND);
      const long long first =
          ((static_cast<long long>(blockIdx.x) -
            static_cast<long long>(band) * spread) % heavy_blocks +
           heavy_blocks) % heavy_blocks;
      for (long long base = first; base < n_rows; base += stride) {
        const long long h =
            base + static_cast<long long>(heavy_blocks) * threadIdx.x;
        if (threadIdx.x == 0) n_found = 0;
        __syncthreads();
        if (h < n_rows && chunk_ptr[h + 1] - chunk_ptr[h] > HEAVY_CHUNKS)
          found[atomicAdd(&n_found, 1)] = static_cast<int>(h);
        __syncthreads();
        const int n = n_found;
        for (int q = 0; q < n; ++q)
          combine_heavy<T, VEC>(found[q], b0, bn, rows, chunk_ptr, partial,
                                out, H, tile);
        __syncthreads();  // every thread has read n_found and found
      }
    }
    return;
  }
  const long long h =
      (static_cast<long long>(blockIdx.x - heavy_blocks) * THREADS +
       threadIdx.x) / G;
  const int lane = threadIdx.x % G;
  if (h >= n_rows) return;
  const int c0 = chunk_ptr[h];
  const int c1 = chunk_ptr[h + 1];
  if (c1 - c0 > HEAVY_CHUNKS) return;  // a heavy block's
  T* o = out + static_cast<size_t>(rows[h]) * H;
  const int nv = H / VEC;  // vectors per row

  for (int vi = lane; vi < nv; vi += G) {  // passes over H
    const float* p =
        partial + static_cast<size_t>(c0) * H + static_cast<size_t>(vi) * VEC;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    for (int c = c0; c < c1; c += COMBINE_DEPTH) {
      float v[COMBINE_DEPTH][VEC];
#pragma unroll
      for (int j = 0; j < COMBINE_DEPTH; ++j)
        if (c + j < c1)
          load_partial<VEC>(p + static_cast<size_t>(j) * H, v[j]);
#pragma unroll
      for (int j = 0; j < COMBINE_DEPTH; ++j)
        if (c + j < c1) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += v[j][k];
        }
      p += static_cast<size_t>(COMBINE_DEPTH) * H;
    }
    Vec<T, VEC>::store(o + static_cast<size_t>(vi) * VEC, acc);
  }
}

template <typename T, int VEC>
int launch_combine_vec(const int* rows, const int* chunk_ptr,
                       const float* partial, void* out, int n_rows, int H,
                       int heavy_blocks, cudaStream_t stream) {
  const int nv = H / VEC;
  int G = 1;  // lanes per light row: the fewest that cover H, a vector each
  while (G < THREADS && G < nv) G *= 2;
  const long long blocks =
      heavy_blocks + (static_cast<long long>(n_rows) * G + THREADS - 1) /
                         THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  csr_combine_kernel<T, VEC><<<static_cast<unsigned>(blocks), THREADS, 0,
                               stream>>>(rows, chunk_ptr, partial,
                                         static_cast<T*>(out), n_rows, H, G,
                                         heavy_blocks);
  return 0;
}

template <typename T>
int launch_combine(const int* rows, const int* chunk_ptr,
                   const float* partial, void* out, int n_rows, int H,
                   cudaStream_t stream) {
  // one heavy block per SM, or per row where there are fewer rows
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int heavy_blocks = n_rows < sms ? n_rows : sms;
  const bool aligned = reinterpret_cast<uintptr_t>(partial) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0;
  if (H % 4 == 0 && aligned)
    return launch_combine_vec<T, 4>(rows, chunk_ptr, partial, out, n_rows, H,
                                    heavy_blocks, stream);
  return launch_combine_vec<T, 1>(rows, chunk_ptr, partial, out, n_rows, H,
                                  heavy_blocks, stream);
}

template <typename T, int VEC>
int launch_slab_vec(const int* row_ptr, const int* col, const void* x,
                    void* out, float* partial, const int* chunk_row,
                    const int* chunk_start, int N, int n_chunks, int H,
                    int slab, int chunk, cudaStream_t stream) {
  const int nv = H / VEC;
  int slab_v = slab > 0 ? (slab + VEC - 1) / VEC : nv;  // vectors per slab
  if (slab_v > nv) slab_v = nv;
  int G = 1;  // lanes per item: the fewest that cover a slab in cpl vectors
  while (G < 32 && G * slab_cpl<VEC>() < slab_v) G *= 2;
  const long long items = static_cast<long long>(N) + n_chunks;
  const long long per_slab = (items * G + THREADS - 1) / THREADS;
  const long long blocks = per_slab * ((nv + slab_v - 1) / slab_v);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  csr_slab_kernel<T, VEC><<<static_cast<unsigned>(blocks), THREADS, 0,
                            stream>>>(
      row_ptr, col, static_cast<const T*>(x), static_cast<T*>(out), partial,
      chunk_row, chunk_start, N, n_chunks, H, slab_v, G, chunk,
      static_cast<int>(per_slab));
  return 0;
}

template <typename T>
int launch_slab(const int* row_ptr, const int* col, const void* x, void* out,
                float* partial, const int* chunk_row, const int* chunk_start,
                int N, int n_chunks, int H, int slab, int chunk,
                cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(partial) % 16 == 0;
  if (H % VEC == 0 && aligned)
    return launch_slab_vec<T, VEC>(row_ptr, col, x, out, partial, chunk_row,
                                   chunk_start, N, n_chunks, H, slab, chunk,
                                   stream);
  return launch_slab_vec<T, 1>(row_ptr, col, x, out, partial, chunk_row,
                               chunk_start, N, n_chunks, H, slab, chunk,
                               stream);
}

}  // namespace

// out (N, H) = the CSR (row_ptr (N + 1,), col) times x (N, H), both int32
// indices, for each of `tasks` (x, out) pairs that share the CSR, laid out
// (tasks, N, H): one launch, the tasks on the grid's y dimension (at most
// 65535); dtype: 0 = float32, 1 = bfloat16 (x and out share it).
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int gmeta_sized_spmm(const int* row_ptr, const int* col,
                                const void* x, void* out, int N, int H,
                                int tasks, int dtype, void* stream) {
  if (tasks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0 && H > 0 && tasks > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      launch<float>(row_ptr, col, x, out, N, H, tasks, st);
    else if (dtype == 1)
      launch<__nv_bfloat16>(row_ptr, col, x, out, N, H, tasks, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The full-graph body: out (N, H) = the CSR (row_ptr (N + 1,), col) times
// the table x (any rows, H), walked in slabs of `slab` columns (<= 0: all
// of H). Rows of more than `chunk` edges are not written: their n_chunks
// chunks (chunk c: edges [chunk_start[c], min(chunk_start[c] + chunk,
// row_ptr[chunk_row[c] + 1]))) are summed into partial (n_chunks, H)
// float32, which gmeta_csr_combine then adds up. dtype as gmeta_sized_spmm.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int gmeta_csr_slab(const int* row_ptr, const int* col,
                              const void* x, void* out, float* partial,
                              const int* chunk_row, const int* chunk_start,
                              int N, int n_chunks, int H, int dtype, int slab,
                              int chunk, void* stream) {
  if (N > 0 && H > 0 && chunk > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err;
    if (dtype == 0)
      err = launch_slab<float>(row_ptr, col, x, out, partial, chunk_row,
                               chunk_start, N, n_chunks, H, slab, chunk, st);
    else if (dtype == 1)
      err = launch_slab<__nv_bfloat16>(row_ptr, col, x, out, partial,
                                       chunk_row, chunk_start, N, n_chunks,
                                       H, slab, chunk, st);
    else
      err = static_cast<int>(cudaErrorInvalidValue);
    if (err != 0) return err;
  } else if (chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The split rows' sums: out[rows[h], :] = sum over c in [chunk_ptr[h],
// chunk_ptr[h + 1]) of partial[c, :], for h < n_rows, rounded to dtype.
extern "C" int gmeta_csr_combine(const int* rows, const int* chunk_ptr,
                                 const float* partial, void* out, int n_rows,
                                 int H, int dtype, void* stream) {
  if (n_rows > 0 && H > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err;
    if (dtype == 0)
      err = launch_combine<float>(rows, chunk_ptr, partial, out, n_rows, H,
                                  st);
    else if (dtype == 1)
      err = launch_combine<__nv_bfloat16>(rows, chunk_ptr, partial, out,
                                          n_rows, H, st);
    else
      err = static_cast<int>(cudaErrorInvalidValue);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

// The L2 cache's bytes on `device` (slabs are sized to it), or a negative
// CUDA error.
extern "C" long long gmeta_l2_bytes(int device) {
  int v = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&v, cudaDevAttrL2CacheSize, device);
  return err == cudaSuccess ? static_cast<long long>(v)
                            : -static_cast<long long>(err);
}
