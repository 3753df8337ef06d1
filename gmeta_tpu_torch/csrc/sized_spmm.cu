// Size-aware block-diagonal aggregation for Hopper (sm_90a): both directions
// as one gather over an edge list in CSR form.
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
// written as zeros, which is the TPU kernels' result on packed data.
//
// What bounds it on an H100: bytes. A is a 0/1 adjacency that holds 0.25%
// non-zeros inside the live blocks at the arxiv query batch (N = 2.36 M
// rows, nnz = 3.9 M, H = 256, float32), so the products the edges need,
// 2 nnz H = 2 GFLOP, take 0.03 ms at 67 TFLOP/s. The bytes are x's
// referenced rows read once (about 1.9 GB), the output written once
// (2.4 GB) and the int32 indices (0.03 GB): about 1.3 ms at 3.35 TB/s
// (chip_smoke.py prints the bound for its data). Tensor cores and TMA have
// nothing to do here: there is no dense tile to multiply, and each gathered
// row is a 16-byte-per-lane load that plain LDG.128 already serves.
//
// Design (PERF.md has the times of the alternatives named here, from
// sweep_sized_spmm.py):
// - G lanes per destination row (G = 32 at H = 256 float32, 16 at H = 128),
//   lanes across H with 16-byte loads (a float4, or 8 bf16), at most 8
//   elements per lane per pass over H. Where H is not a multiple of the
//   vector width (H = 1, 5, 50 are real widths of other presets) or x is not
//   16-byte aligned, the same code runs on scalars; x is never padded.
// - A group reads its row's two row pointers and its edges' column indices
//   straight from device memory: every lane of the group reads the same
//   word, one broadcast load, and a row has about 2 edges at arxiv. Staging
//   a block's indices in shared memory first (one coalesced read each, two
//   barriers) was slower, so the kernel uses no shared memory.
// - The grid walks the rows in order, so the blocks in flight cover a few
//   consecutive bins, whose x rows (1 MB per bin at H = 256 float32) stay in
//   the 50 MB L2 while the bins' edges gather from them: x is read from
//   device memory about once. Output stores are streaming (evict-first),
//   to keep x in L2; at arxiv a plain store measured the same.
// - A group sums its row's edges one at a time; the bytes in flight come
//   from occupancy instead: the launch bounds hold a thread to 32
//   registers, so 2048 threads fill an SM. Loading two or four edges'
//   rows at once before summing them was slower, and so was the kernel
//   without the 32-register cap.
// - Sums in float32 registers in edge order; bf16 is widened as it loads
//   and rounded once as it stores. No atomics, so the result is
//   deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // threads per block
constexpr int MIN_BLOCKS = 2048 / THREADS;  // a full SM: 32 registers

// Vectors per lane per pass over H: 8 elements for the 16-byte paths (two
// float4, one 8 x bf16), which keeps registers at float32's count for bf16.
template <int VEC>
__host__ __device__ constexpr int cpl() {
  return VEC == 1 ? 2 : 8 / VEC;
}

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

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    csr_gather_kernel(const int* __restrict__ row_ptr,
                      const int* __restrict__ col, const T* __restrict__ x,
                      T* __restrict__ out, int N, int H, int G) {
  constexpr int CPL = cpl<VEC>();
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
                int N, int H, cudaStream_t stream) {
  const int nv = H / VEC;
  int G = 1;  // lanes per row: the fewest that cover H in cpl vectors each
  while (G < 32 && G * cpl<VEC>() < nv) G *= 2;
  const int rows = THREADS / G;
  const unsigned blocks = static_cast<unsigned>((N + rows - 1) / rows);
  csr_gather_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(
      row_ptr, col, static_cast<const T*>(x), static_cast<T*>(out), N, H, G);
}

template <typename T>
void launch(const int* row_ptr, const int* col, const void* x, void* out,
            int N, int H, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (H % VEC == 0 && aligned)
    launch_vec<T, VEC>(row_ptr, col, x, out, N, H, stream);
  else
    launch_vec<T, 1>(row_ptr, col, x, out, N, H, stream);
}

}  // namespace

// out (N, H) = the CSR (row_ptr (N + 1,), col) times x (N, H), both int32
// indices; dtype: 0 = float32, 1 = bfloat16 (x and out share it).
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int gmeta_sized_spmm(const int* row_ptr, const int* col,
                                const void* x, void* out, int N, int H,
                                int dtype, void* stream) {
  if (N > 0 && H > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      launch<float>(row_ptr, col, x, out, N, H, st);
    else if (dtype == 1)
      launch<__nv_bfloat16>(row_ptr, col, x, out, N, H, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
