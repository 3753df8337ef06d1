// The GraphConv epilogue for Hopper (sm_90a): the degree-norm scale, the
// bias and the ReLU of a GraphConv, and the next layer's norm pre-scale, in
// one pass over the activations, forward and backward.
//
// Replaces no Pallas kernel. In the JAX package this chain is plain jnp
// (gmeta_tpu/models/gcn.py, `h * norm`, `+ b`, `relu`), which XLA fuses
// into the neighbouring ops by itself. In eager PyTorch each op was its own
// pass over a whole (T, B, P, H) activation, most of them broadcasting the
// (T, B, P, 1) norm or the bias through the generic non-vectorised kernel:
// seven or more passes a GraphConv, forward and backward, 46% of the
// arxiv meta-step's device time (PERF.md). ops/epilogue.py binds it.
//
//   forward   y = relu(x * n + b);  out = y * n (scale_out) or y
//             mask = !(y <= 0), one byte an element, where the backward
//             needs it; y written as well where asked (the oracle check)
//   backward  g_pre = mask ? (scale_out ? g * n : g) : 0;  g_x = g_pre * n
//             (g_pre is what the bias gradient sums, outside the kernel)
//
// x, out, y, g, g_x and g_pre are (rows, H) contiguous; n holds one value a
// row; b is read at b[(row / rows_per_task) * b_stride_t + h * b_stride_h],
// so an (H,) bias, a per-task (T, H) one and a stride-0 expand of either
// are read where they lie, without a copy.
//
// Same bits as the chain it replaces, not only the same function: every
// multiply and add is its own rounded operation (__fmul_rn, __fadd_rn: no
// FMA contraction), in the chain's order ((x * n) + b, max with 0, * n); in
// bf16 each op computes in float32 and rounds to bf16 after it
// (__float2bfloat16, round to nearest even), as PyTorch's bf16 elementwise
// kernels do; the ReLU is PyTorch's clamp (NaN passes, else fmaxf(v, 0)),
// and the mask is the test of threshold_backward (`y <= 0` gives 0), so a
// pre-activation at a kink takes the side the chain takes.
//
// What bounds it on an H100: bytes. A few flops an element against 9 (f32)
// or 5 (bf16) bytes moved. The least bytes are x read once, out (and y)
// written once, the mask written once; n and b are a row's and a column's
// worth. Design: a row of H elements is covered by lanes with 16-byte
// vectors (4 float32, 8 bf16), a block of 256 threads takes as many rows as
// it holds (4 rows at H = 256 float32), and the grid walks the rows, 8
// blocks an SM; in the forward a lane loads two rows before it computes
// either. n is loaded once a row by each of its lanes (one broadcast
// line), the bias from L1. Evict-first hints, 128 or 512 threads a block
// and four rows in flight measured no better (PERF.md). Where H is not a multiple of the vector width,
// or a pointer is not aligned, the same code runs on scalars. No shared
// memory, no atomics, no reduction: two launches give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2048 / THREADS;
// Rows a lane loads before it computes any of them (PERF.md: 2 gained
// 5-15% in the forward, 4 no more; the backward gained nothing).
constexpr int FWD_DEPTH = 2;
constexpr int BWD_DEPTH = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The value of float v once stored in T: the rounding after each op.
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// float v rounded to T (round to nearest even for bf16).
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC elements of T (or VEC mask bytes), moved as one aligned word: 16
// bytes on the vector paths.
template <typename T, int VEC>
struct Pack {
  T v[VEC];
};
template <int BYTES>
struct Word;
template <>
struct Word<16> { using type = uint4; };
template <>
struct Word<8> { using type = uint2; };
template <>
struct Word<4> { using type = uint32_t; };
template <>
struct Word<2> { using type = uint16_t; };
template <>
struct Word<1> { using type = uint8_t; };

template <typename P>
__device__ __forceinline__ P load(const void* p) {
  using W = typename Word<sizeof(P)>::type;
  const W w = *static_cast<const W*>(p);
  P out;
  memcpy(&out, &w, sizeof(P));
  return out;
}
template <typename P>
__device__ __forceinline__ void store(void* p, const P& v) {
  using W = typename Word<sizeof(P)>::type;
  W w;
  memcpy(&w, &v, sizeof(P));
  *static_cast<W*>(p) = w;
}

// Lanes a row takes, for vpr vectors a row: all of them, up to a block.
__host__ __device__ inline int lanes_per_row(int vpr) {
  return vpr < THREADS ? vpr : THREADS;
}

template <typename T, int VEC, int DEPTH>
__global__ void __launch_bounds__(THREADS)
    gcn_epilogue_fwd_kernel(const T* __restrict__ x, const T* __restrict__ n,
                            const T* __restrict__ b, long long b_stride_t,
                            long long b_stride_h, T* __restrict__ out,
                            T* __restrict__ y, uint8_t* __restrict__ mask,
                            unsigned rows, int H, unsigned rows_per_task,
                            bool scale_out) {
  const int vpr = H / VEC;
  const int lpr = lanes_per_row(vpr);
  const unsigned rpb = THREADS / lpr;
  const unsigned rr = threadIdx.x / lpr;
  const int lane = threadIdx.x % lpr;
  if (rr >= rpb) return;
  const unsigned stride = gridDim.x * rpb;
  for (unsigned row0 = blockIdx.x * rpb + rr; row0 < rows;
       row0 += stride * DEPTH) {
    for (int v = lane; v < vpr; v += lpr) {
      Pack<T, VEC> xv[DEPTH];
      float nf[DEPTH];
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
        const unsigned row = row0 + d * stride;
        if (row < rows) {
          nf[d] = to_f(__ldg(n + row));
          xv[d] = load<Pack<T, VEC>>(x + static_cast<long long>(row) * H +
                                     v * VEC);
        }
      }
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
        const unsigned row = row0 + d * stride;
        if (row >= rows) break;
        const T* brow =
            b + static_cast<long long>(row / rows_per_task) * b_stride_t;
        const long long e = static_cast<long long>(row) * H + v * VEC;
        Pack<T, VEC> ov, yv;
        Pack<uint8_t, VEC> mv;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float bf = to_f(__ldg(
              brow + static_cast<long long>(v * VEC + k) * b_stride_h));
          const float a = rnd<T>(__fmul_rn(to_f(xv[d].v[k]), nf[d]));
          const float c = rnd<T>(__fadd_rn(a, bf));
          const float r = isnan(c) ? c : fmaxf(c, 0.0f);  // PyTorch's relu
          yv.v[k] = from_f<T>(r);                          // exact
          mv.v[k] = !(r <= 0.0f);
          ov.v[k] = scale_out ? from_f<T>(__fmul_rn(r, nf[d])) : yv.v[k];
        }
        store(out + e, ov);
        if (y != nullptr) store(y + e, yv);
        if (mask != nullptr) store(mask + e, mv);
      }
    }
  }
}

template <typename T, int VEC, int DEPTH>
__global__ void __launch_bounds__(THREADS)
    gcn_epilogue_bwd_kernel(const T* __restrict__ g, const T* __restrict__ n,
                            const uint8_t* __restrict__ mask,
                            T* __restrict__ g_x, T* __restrict__ g_pre,
                            unsigned rows, int H, bool scale_out) {
  const int vpr = H / VEC;
  const int lpr = lanes_per_row(vpr);
  const unsigned rpb = THREADS / lpr;
  const unsigned rr = threadIdx.x / lpr;
  const int lane = threadIdx.x % lpr;
  if (rr >= rpb) return;
  const unsigned stride = gridDim.x * rpb;
  for (unsigned row0 = blockIdx.x * rpb + rr; row0 < rows;
       row0 += stride * DEPTH) {
    for (int v = lane; v < vpr; v += lpr) {
      Pack<T, VEC> gv[DEPTH];
      Pack<uint8_t, VEC> mv[DEPTH];
      float nf[DEPTH];
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
        const unsigned row = row0 + d * stride;
        if (row < rows) {
          const long long e = static_cast<long long>(row) * H + v * VEC;
          nf[d] = to_f(__ldg(n + row));
          gv[d] = load<Pack<T, VEC>>(g + e);
          mv[d] = load<Pack<uint8_t, VEC>>(mask + e);
        }
      }
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
        const unsigned row = row0 + d * stride;
        if (row >= rows) break;
        const long long e = static_cast<long long>(row) * H + v * VEC;
        Pack<T, VEC> pv, xv;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float gf = to_f(gv[d].v[k]);
          const float gy = scale_out ? rnd<T>(__fmul_rn(gf, nf[d])) : gf;
          const float gp = mv[d].v[k] ? gy : 0.0f;  // threshold_backward's 0
          pv.v[k] = from_f<T>(gp);
          xv.v[k] = from_f<T>(__fmul_rn(gp, nf[d]));
        }
        store(g_x + e, xv);
        if (g_pre != nullptr) store(g_pre + e, pv);
      }
    }
  }
}

int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || v <= 0)
    return 132;
  return v;
}

int grid_for(unsigned rows, int vpr, int depth) {
  const unsigned rpb = THREADS / lanes_per_row(vpr);
  const unsigned long long want = (rows + rpb * depth - 1) / (rpb * depth);
  const unsigned long long cap =
      static_cast<unsigned long long>(sm_count()) * BLOCKS_PER_SM;
  return static_cast<int>(want < cap ? want : cap);
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch_fwd(const void* x, const void* n, const void* b,
               long long b_stride_t, long long b_stride_h, void* out, void* y,
               uint8_t* mask, unsigned rows, int H, unsigned rows_per_task,
               bool scale_out, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = H % VEC == 0 && aligned(x, 16) && aligned(out, 16) &&
                   aligned(y, 16) && aligned(mask, VEC);
  const T* xt = static_cast<const T*>(x);
  const T* nt = static_cast<const T*>(n);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  T* yt = static_cast<T*>(y);
  if (vec)
    gcn_epilogue_fwd_kernel<T, VEC, FWD_DEPTH>
        <<<grid_for(rows, H / VEC, FWD_DEPTH), THREADS, 0, st>>>(
            xt, nt, bt, b_stride_t, b_stride_h, ot, yt, mask, rows, H,
            rows_per_task, scale_out);
  else
    gcn_epilogue_fwd_kernel<T, 1, FWD_DEPTH>
        <<<grid_for(rows, H, FWD_DEPTH), THREADS, 0, st>>>(
            xt, nt, bt, b_stride_t, b_stride_h, ot, yt, mask, rows, H,
            rows_per_task, scale_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* g, const void* n, const uint8_t* mask, void* g_x,
               void* g_pre, unsigned rows, int H, bool scale_out,
               cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = H % VEC == 0 && aligned(g, 16) && aligned(g_x, 16) &&
                   aligned(g_pre, 16) && aligned(mask, VEC);
  const T* gt = static_cast<const T*>(g);
  const T* nt = static_cast<const T*>(n);
  T* xt = static_cast<T*>(g_x);
  T* pt = static_cast<T*>(g_pre);
  if (vec)
    gcn_epilogue_bwd_kernel<T, VEC, BWD_DEPTH>
        <<<grid_for(rows, H / VEC, BWD_DEPTH), THREADS, 0, st>>>(
            gt, nt, mask, xt, pt, rows, H, scale_out);
  else
    gcn_epilogue_bwd_kernel<T, 1, BWD_DEPTH>
        <<<grid_for(rows, H, BWD_DEPTH), THREADS, 0, st>>>(
            gt, nt, mask, xt, pt, rows, H, scale_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The forward over rows x H elements (rows < 2^31, rows_per_task >= 1):
// out always; y and mask where not null. dtype 0 float32, 1 bf16. Returns
// cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int gmeta_gcn_epilogue_fwd(const void* x, const void* n,
                                      const void* b, long long b_stride_t,
                                      long long b_stride_h, void* out,
                                      void* y, void* mask, long long rows,
                                      int H, long long rows_per_task,
                                      int scale_out, int dtype,
                                      void* stream) {
  if (rows < 0 || rows >= (1LL << 31) || H < 0 || rows_per_task < 1 ||
      rows_per_task >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* m = static_cast<uint8_t*>(mask);
  if (dtype == 0)
    return launch_fwd<float>(x, n, b, b_stride_t, b_stride_h, out, y, m,
                             static_cast<unsigned>(rows), H,
                             static_cast<unsigned>(rows_per_task),
                             scale_out != 0, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, n, b, b_stride_t, b_stride_h, out, y,
                                     m, static_cast<unsigned>(rows), H,
                                     static_cast<unsigned>(rows_per_task),
                                     scale_out != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: g_x always; g_pre where not null. As above.
extern "C" int gmeta_gcn_epilogue_bwd(const void* g, const void* n,
                                      const void* mask, void* g_x,
                                      void* g_pre, long long rows, int H,
                                      int scale_out, int dtype,
                                      void* stream) {
  if (rows < 0 || rows >= (1LL << 31) || H < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == 0)
    return launch_bwd<float>(g, n, m, g_x, g_pre,
                             static_cast<unsigned>(rows), H, scale_out != 0,
                             st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, n, m, g_x, g_pre,
                                     static_cast<unsigned>(rows), H,
                                     scale_out != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
