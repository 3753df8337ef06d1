// Graphormer's attention for Hopper (sm_90a): each row of a packed set
// attends to every row of its segment (one graph) with a per-head bias
// gathered through the pair's shortest-path distance, forward and
// backward, and the distances themselves (ops/spatial_attention.py binds
// it; models/graphormer.py calls it).
//
// Replaces no Pallas kernel: the JAX package has no Graphormer. It was
// added for Graphormer (Ying et al., NeurIPS 2021), which no existing op
// computes: the GAT's kernels (csrc/gat_attention.cu) score edges, not all
// pairs.
//
// qkv is (N, 3H) float32, H = K*D: row i holds q_i, k_i and v_i, each K
// heads of D. Segment s (rows seg[s] .. seg[s+1]) belongs to task
// s / per_task, whose spatial table is table[t] (512, K). phi's tile of s
// (stride x stride bytes at s * stride^2) holds the distance byte of each
// pair: 0 on the diagonal, 255 where no path joins them (table row 511),
// else the distance (row = byte). For row i, head h and each key j of
// i's segment that i may see (both live, or j = i):
//
//   forward   s_ij = q_i . k_j / sqrt(D) + b[t, row(phi_ij), h]
//             o_i = sum_j exp(s_ij - lse_i) v_j,  lse_i = log sum_j exp(s_ij)
//   backward  p_ij = exp(s_ij - lse_i);  D_i = g_i . o_i        (delta)
//             dv_j = sum_i p_ij g_i;  dk_j = sum_i ds_ij q_i / sqrt(D)
//             (key kernel, a key's queries in order)
//             ds_ij = p_ij (g_i . v_j - D_i)
//             dq_i = sum_j ds_ij k_j / sqrt(D)                  (query kernel)
//             db[t, row, h] = sum over pairs of t whose row it is of ds_ij
//             (the query kernel's per-block partial sums, then the table
//             kernel sums a task's partials in block order)
//
// What bounds it on an H100: float32 operations. A pair and head costs
// 2D + 2D multiply-adds forward against no byte from device memory (a
// segment's rows are staged in shared memory and reused by all its
// queries); at the cell's 586-row segments and D = 10 the least bytes are
// three orders below the operations' time at the float32 rate. So the
// design keeps the CUDA cores fed from registers and broadcast
// shared-memory reads:
//
// - A block takes 64 rows of one segment (query-major kernels) or 64 keys
//   (the key kernel) for all K heads: warp h is head h, each lane two rows
//   (rows lane and lane + 32 of the tile). The other side's tile of rows
//   (32 keys' k and v forward; 64 rows of q, g, lse and D in the key
//   kernel, of k and v in the query kernel) sits in shared memory with
//   each head padded to a multiple of 4 floats, so a lane reads a head's
//   row with 16-byte loads (forward: one 8-byte load for a width of 4n +
//   2, so that no register holds padding), and all lanes of the warp
//   read the same row at once (a broadcast: one shared-memory transaction
//   serves 64 pairs). A head width of 10 is no multiple of 4: its rows
//   are padded to 12 in shared memory; the kernels are built for the
//   widths ops/spatial_attention.py names.
// - phi's tile rows for the block's rows sit in shared memory with a pitch
//   of 80 bytes, so each lane reads 16 of its pairs' bytes in one 16-byte
//   load without bank conflicts (the forward: 8 bytes at a pitch of 40,
//   so that fewer registers hold them); the task's table sits in shared memory
//   by byte (256 x K floats, byte 255 holding row 511), in log2 units, so
//   a pair's bias is one load at byte * K + h.
// - Scores are kept in base 2 (q . k times log2(e) / sqrt(D), the bias
//   times log2(e)), so each weight is one ex2 instruction; the forward
//   scales q by log2(e) / sqrt(D) as it loads it, and starts each dot
//   product from the pair's bias.
// - The forward takes the softmax in one pass with no buffer of scores: a
//   lane folds each key's weight into its rows' (m, l, acc) before it
//   reads the next key. A row's m is a score it has seen; only a score
//   more than RESCALE (8, base 2) above it becomes the new m, scaling l
//   and acc down to it, so each weight is at most 2^8 and l, over at most
//   1,024 keys, stays far from overflow. After a row's first key the
//   branch is rare (0.19% of the steps at the cell's query set), so each
//   lane takes it alone: a warp-wide vote (__any_sync) before it ran 14%
//   slower, as the compiler then schedules nothing across it. A buffer of
//   each sub-tile's scores, which took the max before any ex2, held 32
//   more registers a lane and spilled inside the loop at 80.
// - A tile whose pairs are all seen (a whole tile of a segment without
//   pad rows: every tile but a segment's last, in the repacked layout)
//   runs a copy of the loop that checks no pair.
// - The tiles are staged with a warp a row and its lanes along the row,
//   with no division by a run-time width. The forward stages by async
//   copies (cp.async, no register on the way) into two buffers of 32 keys:
//   the next tile's copies are in flight while the block computes on this
//   one, and a segment's live bytes are staged once. Staged through
//   registers, one load's wait at a time, its tiles took about 40% of its
//   time (1.46 ms of 2.40 left without them, the cell's query set).
// - The forward runs FWD_BLOCKS blocks an SM (three: at most 80 registers
//   a thread, which it fits without spilling at every width), as more
//   warps hide the latency of its shared-memory reads and of each key's
//   chain (two blocks: 1.78 ms against 1.70); the backward kernels keep
//   two (128 registers), as they spill at 80.
// - The table's gradient adds up in a fixed order with no float atomics:
//   each thread sums its pairs of bytes 0-30 and 255 into slots of its
//   own in shared memory (slot-major, so a warp's 32 lanes hit 32 banks);
//   a pair of a longer distance goes, lane by lane in order, into its
//   warp's own table (a sub-tile of 16 keys checks its bytes for such
//   distances once). A warp's slots then add up by a fixed butterfly, and
//   each block writes its 256 x K partial sums; the table kernel sums a
//   task's blocks in order. So two launches give the same bits.
//
// The distances (`spd_kernel`): one block a segment keeps its adjacency in
// shared memory as 32 words a row (a segment of at most 1024 rows), edges
// taken both ways, and each warp searches from one row at a time,
// breadth first: lane l holds word l of the visited and frontier sets,
// each level ORs the adjacency rows of the frontier's nodes, and the new
// nodes' bytes go to the warp's row buffer, which is then written out
// whole. The search runs until its frontier empties, on the device: no
// level waits for the host.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TABLE_ROWS = 512;
constexpr int CODES = 256;        // phi's bytes
constexpr int NO_PATH = 255;
constexpr int MAX_DISTANCE = 254;
constexpr int TILE = 64;          // rows of a staged tile; phi's stride
                                  // is a multiple of it
constexpr int RPL = 2;            // rows a lane
constexpr int QT = WARP * RPL;    // rows (or keys) a block takes
constexpr int SUB = 16;           // pairs a lane reads bytes of at once
constexpr int PITCH = TILE + 16;  // bytes a staged phi row
constexpr int SLOTS = 32;         // thread-private table-gradient slots
constexpr int FWD_SUB = 8;        // keys a forward lane reads bytes of at once
constexpr int FWD_TILE = 32;      // keys a forward tile stages (two in flight)
// bytes a staged phi row in the forward: 10 words, so that a half-warp's
// 8-byte reads of 16 rows hit all 32 banks once
constexpr int FWD_PITCH = FWD_TILE + 8;
constexpr int FWD_BLOCKS = 3;     // forward blocks an SM (launch bounds)
constexpr float RESCALE = 8.f;    // the forward's rescale step (base 2)
constexpr int MAX_ROWS = 1024;    // rows a segment (the distances' cap)
constexpr long long SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ int table_row(int code) {
  return code == NO_PATH ? TABLE_ROWS - 1 : code;
}

template <int D>
struct Head {
  static constexpr int P = (D + 3) / 4 * 4;  // padded floats in smem
  static constexpr int V = P / 4;            // 16-byte loads
};

// A head's row of D floats from shared memory (16-byte aligned, padded).
template <int D>
__device__ __forceinline__ void load_head(const float* p, float (&x)[D]) {
  float4 v[Head<D>::V];
#pragma unroll
  for (int i = 0; i < Head<D>::V; ++i)
    v[i] = reinterpret_cast<const float4*>(p)[i];
  const float* f = reinterpret_cast<const float*>(v);
#pragma unroll
  for (int c = 0; c < D; ++c) x[c] = f[c];
}

// A head's D floats from shared memory (16-byte aligned) in 16-byte loads
// and, for a width of 4n + 2, one 8-byte load: no register holds padding.
template <int D>
__device__ __forceinline__ void load_row(const float* p, float (&x)[D]) {
  static_assert(D % 2 == 0, "head widths are even");
#pragma unroll
  for (int c = 0; c + 4 <= D; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + c);
    x[c] = v.x;
    x[c + 1] = v.y;
    x[c + 2] = v.z;
    x[c + 3] = v.w;
  }
  if constexpr (D % 4 == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p + D - 2);
    x[D - 2] = v.x;
    x[D - 1] = v.y;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float (&a)[D], const float (&b)[D]) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// b + a . x in two chains of multiply-adds (even and odd features), so a
// score waits on D / 2 of them in turn, not D.
template <int D>
__device__ __forceinline__ float dot_from(const float (&a)[D],
                                          const float (&x)[D], float b) {
  float e = b, f = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 2) {
    e = fmaf(a[c], x[c], e);
    f = fmaf(a[c + 1], x[c + 1], f);
  }
  return e + f;
}

// The bytes of a lane's row (its tile row `r`) for pairs j0 .. j0 + 15.
__device__ __forceinline__ uint4 codes_of(const unsigned char* ph, int r,
                                          int j0) {
  return *reinterpret_cast<const uint4*>(ph + r * PITCH + j0);
}

__device__ __forceinline__ int byte_at(const uint4& w, int jj) {
  const uint32_t word = jj < 4 ? w.x : jj < 8 ? w.y : jj < 12 ? w.z : w.w;
  return (word >> (8 * (jj & 3))) & 0xff;
}

// The same for pairs j0 .. j0 + 7 of the forward's rows (FWD_PITCH).
__device__ __forceinline__ uint2 codes8_of(const unsigned char* ph, int r,
                                           int j0) {
  return *reinterpret_cast<const uint2*>(ph + r * FWD_PITCH + j0);
}

__device__ __forceinline__ int byte_at(const uint2& w, int jj) {
  return ((jj < 4 ? w.x : w.y) >> (8 * (jj & 3))) & 0xff;
}

// 2^x in one instruction (MUFU.EX2; x <= RESCALE here, where its relative
// error is under 2^-22 and a result below 2^-126 flushes to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Copy 4 bytes from device to shared memory without a register (cp.async):
// a thread issues all of a tile's copies before it waits for any.
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Close this thread's group of async copies issued since the last one.
__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are in flight (then a
// barrier shows all threads' copies).
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the task's table by byte, in log2 units: row c of the 256 is the
// table's row(c), so a pair's bias is tab[byte * K + h].
__device__ __forceinline__ void stage_table(float* tab, const float* table,
                                            int t, int K) {
  const float* src = table + static_cast<size_t>(t) * TABLE_ROWS * K;
  for (int c = threadIdx.x; c < CODES; c += blockDim.x)
    for (int h = 0; h < K; ++h)
      tab[c * K + h] = src[table_row(c) * K + h] * LOG2E;
}

// Stage rows [first, first + count) (count <= TILE) of a (., ld) matrix's
// H columns from column `from`, each head padded to P floats; rows past
// count are zero. A warp takes a row, its lanes neighbouring columns.
// ASYNC copies without registers (wait_async before the barrier); ROWS
// rows a tile.
template <int D, bool ASYNC = false, int ROWS = TILE>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long first, int count,
                                           int ld, int from, int K) {
  constexpr int P = Head<D>::P;
  const int H = K * D, lane = threadIdx.x % WARP;
  for (int j = threadIdx.x / WARP; j < ROWS; j += blockDim.x / WARP) {
    const float* row = src + (first + j) * ld + from;
    float* out = dst + j * K * P;
    for (int col = lane; col < H; col += WARP) {
      const int h = col / D, c = col - h * D;
      if (ASYNC && j < count)
        copy_async(out + h * P + c, row + col);
      else
        out[h * P + c] = j < count ? row[col] : 0.f;
    }
  }
}

// Stage rows [first, first + count) of a (., K) matrix, times `scale`.
__device__ __forceinline__ void stage_small(float* dst, const float* src,
                                            long long first, int count,
                                            int K, float scale) {
  for (int i = threadIdx.x; i < TILE * K; i += blockDim.x)
    dst[i] = i / K < count ? src[first * K + i] * scale : 0.f;
}

__device__ __forceinline__ void stage_live(unsigned char* dst,
                                           const unsigned char* live,
                                           long long first, int count) {
  for (int j = threadIdx.x; j < TILE; j += blockDim.x)
    dst[j] = j < count ? live[first + j] : 0;
}

// Stage phi's bytes of tile rows [r0, r0 + QT) (those under n) and
// columns [c0, c0 + COLS) of segment s, PITCH_ bytes a row (ASYNC as in
// stage_rows).
template <bool ASYNC = false, int COLS = TILE, int PITCH_ = PITCH>
__device__ __forceinline__ void stage_phi(unsigned char* ph,
                                          const unsigned char* phi, int s,
                                          int stride, int r0, int c0,
                                          int n) {
  const unsigned char* tile =
      phi + static_cast<size_t>(s) * stride * stride;
  for (int i = threadIdx.x; i < QT * (COLS / 4); i += blockDim.x) {
    const int r = i / (COLS / 4), w = i - r * (COLS / 4);
    const unsigned char* src =
        tile + static_cast<size_t>(r0 + r) * stride + c0 + 4 * w;
    uint32_t* dst = reinterpret_cast<uint32_t*>(ph + r * PITCH_ + 4 * w);
    if (ASYNC && r0 + r < n)
      copy_async(dst, src);
    else
      *dst = r0 + r < n ? *reinterpret_cast<const uint32_t*>(src) : FULL;
  }
}

// Whether every row of the segment is live (then no pair is masked in a
// whole tile).
__device__ __forceinline__ bool all_live(const unsigned char* live,
                                         long long a, int n) {
  int all = 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) all &= live[a + i] != 0;
  return __syncthreads_and(all);
}

// Whether a lane's 16 bytes name a distance past the thread-private slots
// (31 to 254).
__device__ __forceinline__ bool far_bytes(const uint4& w) {
  const uint32_t x = w.x, y = w.y, z = w.z, u = w.w;
  auto far = [](uint32_t b) {
    return __vcmpgeu4(b, 0x1f1f1f1fu) & ~__vcmpeq4(b, FULL);
  };
  return (far(x) | far(y) | far(z) | far(u)) != 0u;
}

// The forward's work on one staged tile of keys: the block's rows of head
// h against keys 0 .. nk - 1 of the tile (k0 its first key), a key at a
// time, each weight folded into (m, l, acc) at once (module header); MASK
// checks each pair (a partial tile, or a segment with pad rows). A masked
// pair adds nothing and never moves m; a row's first key that it sees
// always rescales, from m = -inf (alpha 0).
template <int D, bool MASK>
__device__ __forceinline__ void fwd_tile(
    const float* ks, const float* vs, const unsigned char* ph,
    const unsigned char* kl, const float* tab, int KP, int K, int h,
    int lane, int nk, int k0, int q0, const bool (&lv)[RPL],
    const float (&q)[RPL][D], float (&acc)[RPL][D],
    float (&m)[RPL], float (&l)[RPL]) {
  constexpr int P = Head<D>::P;
  for (int j0 = 0; j0 < nk; j0 += FWD_SUB) {
    uint2 cw[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k)
      cw[k] = codes8_of(ph, lane + WARP * k, j0);
#pragma unroll
    for (int jj = 0; jj < FWD_SUB; ++jj) {
      const int j = j0 + jj;
      float s[RPL], d[RPL];
      bool ok[RPL], up = false;
      {
        float kr[D];
        load_row<D>(ks + j * KP + h * P, kr);
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          s[k] = dot_from<D>(q[k], kr, tab[byte_at(cw[k], jj) * K + h]);
          ok[k] = !MASK || (j < nk && ((lv[k] && kl[j]) ||
                                       k0 + j == q0 + lane + WARP * k));
          d[k] = s[k] - m[k];
          up |= ok[k] && d[k] > RESCALE;
        }
      }
      if (up) {
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          if (ok[k] && d[k] > RESCALE) {
            const float alpha = ex2(-d[k]);   // 0 where m was -inf
            l[k] *= alpha;
#pragma unroll
            for (int c = 0; c < D; ++c) acc[k][c] *= alpha;
            m[k] = s[k];
            d[k] = 0.f;
          }
        }
      }
      float vr[D];
      load_row<D>(vs + j * KP + h * P, vr);
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const float p = ok[k] ? ex2(d[k]) : 0.f;
        l[k] += p;
#pragma unroll
        for (int c = 0; c < D; ++c) acc[k][c] = fmaf(p, vr[c], acc[k][c]);
      }
    }
  }
}

// Stage the forward's key tile from key k0 of segment s (rows a ..) into
// one buffer by async copies: the keys' k and v rows (zero past n) and
// phi's bytes of the block's rows q0 .. for those keys.
template <int D>
__device__ __forceinline__ void stage_keys(float* ks, float* vs,
                                           unsigned char* ph,
                                           const float* qkv,
                                           const unsigned char* phi, int s,
                                           int stride, long long a, int k0,
                                           int n, int q0, int K) {
  const int H = K * D, nk = min(FWD_TILE, n - k0);
  stage_rows<D, true, FWD_TILE>(ks, qkv, a + k0, nk, 3 * H, H, K);
  stage_rows<D, true, FWD_TILE>(vs, qkv, a + k0, nk, 3 * H, 2 * H, K);
  stage_phi<true, FWD_TILE, FWD_PITCH>(ph, phi, s, stride, q0, k0, n);
}

// The forward: grid (S, row tiles of QT), 32 K threads. Key tiles
// alternate between two buffers: tile t + 1's copies are in flight while
// the block computes on tile t.
template <int D>
__global__ void __launch_bounds__(256, FWD_BLOCKS)
    sattn_fwd_kernel(const float* __restrict__ qkv,
                     const float* __restrict__ table,
                     const unsigned char* __restrict__ phi,
                     const int* __restrict__ seg,
                     const unsigned char* __restrict__ live,
                     float* __restrict__ o, float* __restrict__ lse,
                     int per_task, int stride, int K, float c1) {
  constexpr int P = Head<D>::P;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = K * D, ld = 3 * H, KP = K * P;
  float* tab = reinterpret_cast<float*>(smem);
  float* ks = tab + CODES * K;                 // 2 x FWD_TILE keys
  float* vs = ks + 2 * FWD_TILE * KP;
  unsigned char* ph =
      reinterpret_cast<unsigned char*>(vs + 2 * FWD_TILE * KP);
  unsigned char* kl = ph + 2 * QT * FWD_PITCH;  // the segment's live bytes
                                                // (and QT past its end)

  const int s = blockIdx.x;
  const long long a = seg[s];
  const int n = seg[s + 1] - static_cast<int>(a);
  const int q0 = blockIdx.y * QT;
  if (q0 >= n) return;
  const int h = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  stage_keys<D>(ks, vs, ph, qkv, phi, s, stride, a, 0, n, q0, K);
  commit_async();
  stage_table(tab, table, s / per_task, K);
  int all = 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    all &= (kl[i] = live[a + i]) != 0;
  const bool dense = __syncthreads_and(all);

  float q[RPL][D], acc[RPL][D], m[RPL], l[RPL];
  bool valid[RPL], lv[RPL];
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int r = q0 + lane + WARP * k;
    valid[k] = r < n;
    lv[k] = valid[k] && kl[r];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      q[k][c] = valid[k] ? qkv[(a + r) * ld + h * D + c] * c1 : 0.f;
      acc[k][c] = 0.f;
    }
    m[k] = -INFINITY;
    l[k] = 0.f;
  }

  for (int k0 = 0, b = 0; k0 < n; k0 += FWD_TILE, b ^= 1) {
    const int nk = min(FWD_TILE, n - k0);
    if (k0 + FWD_TILE < n) {
      stage_keys<D>(ks + (b ^ 1) * FWD_TILE * KP, vs + (b ^ 1) * FWD_TILE * KP,
                    ph + (b ^ 1) * QT * FWD_PITCH, qkv, phi, s, stride, a,
                    k0 + FWD_TILE, n, q0, K);
      commit_async();
      wait_async<1>();
    } else {
      wait_async<0>();
    }
    __syncthreads();
    const float* kt = ks + b * FWD_TILE * KP;
    const float* vt = vs + b * FWD_TILE * KP;
    const unsigned char* pt = ph + b * QT * FWD_PITCH;
    if (dense && nk == FWD_TILE)
      fwd_tile<D, false>(kt, vt, pt, kl + k0, tab, KP, K, h, lane, nk, k0,
                         q0, lv, q, acc, m, l);
    else
      fwd_tile<D, true>(kt, vt, pt, kl + k0, tab, KP, K, h, lane, nk, k0,
                        q0, lv, q, acc, m, l);
    __syncthreads();   // the buffer is free for tile t + 2
  }
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    if (!valid[k]) continue;
    const long long row = a + q0 + lane + WARP * k;
#pragma unroll
    for (int c = 0; c < D; ++c) o[row * H + h * D + c] = acc[k][c] / l[k];
    lse[row * K + h] = (m[k] + log2f(l[k])) * LN2;
  }
}

// D_i = g_i . o_i for every (row, head), one thread each.
__global__ void sattn_bwd_delta_kernel(const float* __restrict__ g,
                                       const float* __restrict__ o,
                                       float* __restrict__ delta,
                                       long long pairs, int D) {
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       p < pairs; p += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < D; ++c) s = fmaf(g[p * D + c], o[p * D + c], s);
    delta[p] = s;
  }
}

// The key kernel's work on one staged tile of queries (i0 its first, ni of
// them): the block's keys' dk and dv of head h.
template <int D, bool MASK>
__device__ __forceinline__ void key_tile(
    const float* qs, const float* gs, const float* ls, const float* ds_,
    const unsigned char* ph, const unsigned char* ql, const float* tab,
    int KP, int K, int h, int lane, int ni, int i0, int j0k,
    const bool (&lv)[RPL], const float (&kr)[RPL][D],
    const float (&vr)[RPL][D], float (&dk)[RPL][D], float (&dv)[RPL][D],
    float c1) {
  constexpr int P = Head<D>::P;
  for (int t0 = 0; t0 < ni; t0 += SUB) {
    uint4 cw[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) cw[k] = codes_of(ph, lane + WARP * k, t0);
#pragma unroll
    for (int ii = 0; ii < SUB; ++ii) {
      const int i = t0 + ii;
      float qi[D], gi[D];
      load_head<D>(qs + i * KP + h * P, qi);
      load_head<D>(gs + i * KP + h * P, gi);
      const float l2 = ls[i * K + h], di = ds_[i * K + h];
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const float b = tab[byte_at(cw[k], ii) * K + h];
        float p = ex2(fmaf(dot<D>(qi, kr[k]), c1, b) - l2);
        if (MASK) {
          const int j = j0k + lane + WARP * k;
          const bool ok = i < ni && ((lv[k] && ql[i]) || i0 + i == j);
          p = ok ? p : 0.f;
        }
        const float dsv = p * (dot<D>(gi, vr[k]) - di);
#pragma unroll
        for (int c = 0; c < D; ++c) {
          dv[k][c] = fmaf(p, gi[c], dv[k][c]);
          dk[k][c] = fmaf(dsv, qi[c], dk[k][c]);
        }
      }
    }
  }
}

// The keys' gradients: grid (S, key tiles), 32 K threads; each lane two
// keys, walking the segment's queries in order.
template <int D>
__global__ void __launch_bounds__(256, 2)
    sattn_bwd_key_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ table,
                         const unsigned char* __restrict__ phi,
                         const int* __restrict__ seg,
                         const unsigned char* __restrict__ live,
                         const float* __restrict__ lse,
                         const float* __restrict__ g,
                         const float* __restrict__ delta,
                         float* __restrict__ dqkv, int per_task, int stride,
                         int K, float c1, float scale) {
  constexpr int P = Head<D>::P;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = K * D, ld = 3 * H, KP = K * P;
  float* tab = reinterpret_cast<float*>(smem);
  float* qs = tab + CODES * K;
  float* gs = qs + TILE * KP;
  float* ls = gs + TILE * KP;
  float* ds_ = ls + TILE * K;
  unsigned char* ph = reinterpret_cast<unsigned char*>(ds_ + TILE * K);
  unsigned char* ql = ph + QT * PITCH;

  const int s = blockIdx.x;
  const long long a = seg[s];
  const int n = seg[s + 1] - static_cast<int>(a);
  const int j0k = blockIdx.y * QT;
  if (j0k >= n) return;
  const int h = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  stage_table(tab, table, s / per_task, K);
  const bool dense = all_live(live, a, n);

  float kr[RPL][D], vr[RPL][D], dk[RPL][D], dv[RPL][D];
  bool valid[RPL], lv[RPL];
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int j = j0k + lane + WARP * k;
    valid[k] = j < n;
    lv[k] = valid[k] && live[a + j];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      kr[k][c] = valid[k] ? qkv[(a + j) * ld + H + h * D + c] : 0.f;
      vr[k][c] = valid[k] ? qkv[(a + j) * ld + 2 * H + h * D + c] : 0.f;
      dk[k][c] = dv[k][c] = 0.f;
    }
  }

  for (int i0 = 0; i0 < n; i0 += TILE) {
    const int ni = min(TILE, n - i0);
    __syncthreads();
    stage_rows<D>(qs, qkv, a + i0, ni, ld, 0, K);
    stage_rows<D>(gs, g, a + i0, ni, H, 0, K);
    stage_small(ls, lse, a + i0, ni, K, LOG2E);
    stage_small(ds_, delta, a + i0, ni, K, 1.f);
    stage_live(ql, live, a + i0, ni);
    // phi is symmetric: the keys' rows hold their pairs with the queries
    stage_phi(ph, phi, s, stride, j0k, i0, n);
    __syncthreads();
    if (dense && ni == TILE)
      key_tile<D, false>(qs, gs, ls, ds_, ph, ql, tab, KP, K, h, lane, ni,
                         i0, j0k, lv, kr, vr, dk, dv, c1);
    else
      key_tile<D, true>(qs, gs, ls, ds_, ph, ql, tab, KP, K, h, lane, ni,
                        i0, j0k, lv, kr, vr, dk, dv, c1);
  }
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    if (!valid[k]) continue;
    const long long row = a + j0k + lane + WARP * k;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      dqkv[row * ld + H + h * D + c] = dk[k][c] * scale;
      dqkv[row * ld + 2 * H + h * D + c] = dv[k][c];
    }
  }
}

// The query kernel's work on one staged tile of keys (k0 its first, nk of
// them): the block's rows' dq of head h and their pairs' ds into the
// thread's slots (by byte: 0-30, 255 in slot 31, any other in slot 32,
// which is then not read) and, lane by lane, into the warp's table for
// bytes 31-254.
template <int D, bool MASK>
__device__ __forceinline__ void query_tile(
    const float* ks, const float* vs, const unsigned char* ph,
    const unsigned char* kl, const float* tab, float* hist, float* rare,
    int KP, int K, int h, int lane, int tid, int NT, int nk, int k0, int q0,
    const bool (&lv)[RPL], const float (&q)[RPL][D],
    const float (&gq)[RPL][D], float (&dq)[RPL][D], const float (&l2)[RPL],
    const float (&di)[RPL], float c1) {
  constexpr int P = Head<D>::P;
  for (int j0 = 0; j0 < nk; j0 += SUB) {
    uint4 cw[RPL];
    bool far = false;
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      cw[k] = codes_of(ph, lane + WARP * k, j0);
      far |= far_bytes(cw[k]);
    }
    far = __any_sync(FULL, far);
#pragma unroll
    for (int jj = 0; jj < SUB; ++jj) {
      const int j = j0 + jj;
      float kr[D], vr[D];
      load_head<D>(ks + j * KP + h * P, kr);
      load_head<D>(vs + j * KP + h * P, vr);
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const int code = byte_at(cw[k], jj);
        const float b = tab[code * K + h];
        float p = ex2(fmaf(dot<D>(q[k], kr), c1, b) - l2[k]);
        bool ok = true;
        if (MASK) {
          const int r = q0 + lane + WARP * k;
          ok = j < nk && ((lv[k] && kl[j]) || k0 + j == r);
          p = ok ? p : 0.f;
        }
        const float dsv = p * (dot<D>(gq[k], vr) - di[k]);
#pragma unroll
        for (int c = 0; c < D; ++c) dq[k][c] = fmaf(dsv, kr[c], dq[k][c]);
        const int slot = code == NO_PATH ? SLOTS - 1
                         : code < SLOTS - 1 ? code : SLOTS;
        hist[slot * NT + tid] += dsv;
        if (far) {    // bytes 31-254: lane by lane, in order
          const unsigned lanes =
              __ballot_sync(FULL, ok && slot == SLOTS);
          for (int src = 0; src < WARP; ++src) {
            if (!(lanes >> src & 1u)) continue;
            const int c2 = __shfl_sync(FULL, code, src);
            const float v2 = __shfl_sync(FULL, dsv, src);
            if (lane == 0) rare[h * CODES + c2] += v2;
          }
        }
      }
    }
  }
}

// The queries' gradients and the table's partial sums: grid (S, row
// tiles), 32 K threads; each lane two rows, walking the segment's keys in
// order. Block (s, y) writes partial[s * gridDim.y + y] (256 x K).
template <int D>
__global__ void __launch_bounds__(256, 2)
    sattn_bwd_query_kernel(const float* __restrict__ qkv,
                           const float* __restrict__ table,
                           const unsigned char* __restrict__ phi,
                           const int* __restrict__ seg,
                           const unsigned char* __restrict__ live,
                           const float* __restrict__ lse,
                           const float* __restrict__ g,
                           const float* __restrict__ delta,
                           float* __restrict__ dqkv,
                           float* __restrict__ partial, int per_task,
                           int stride, int K, float c1, float scale) {
  constexpr int P = Head<D>::P;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = K * D, ld = 3 * H, KP = K * P, NT = blockDim.x;
  float* tab = reinterpret_cast<float*>(smem);
  float* ks = tab + CODES * K;
  float* vs = ks + TILE * KP;
  float* hist = vs + TILE * KP;              // (SLOTS + 1) x NT, slot-major
  float* rare = hist + (SLOTS + 1) * NT;     // K x CODES
  unsigned char* ph = reinterpret_cast<unsigned char*>(rare + K * CODES);
  unsigned char* kl = ph + QT * PITCH;

  const int s = blockIdx.x;
  const long long a = seg[s];
  const int n = seg[s + 1] - static_cast<int>(a);
  const int q0 = blockIdx.y * QT;
  float* out = partial +
               (static_cast<size_t>(s) * gridDim.y + blockIdx.y) * CODES * K;
  const int tid = threadIdx.x, h = tid / WARP, lane = tid % WARP;
  if (q0 >= n) {
    for (int i = tid; i < CODES * K; i += NT) out[i] = 0.f;
    return;
  }
  stage_table(tab, table, s / per_task, K);
  for (int i = tid; i < (SLOTS + 1) * NT; i += NT) hist[i] = 0.f;
  for (int i = tid; i < K * CODES; i += NT) rare[i] = 0.f;
  const bool dense = all_live(live, a, n);

  float q[RPL][D], gq[RPL][D], dq[RPL][D], l2[RPL], di[RPL];
  bool valid[RPL], lv[RPL];
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int r = q0 + lane + WARP * k;
    valid[k] = r < n;
    lv[k] = valid[k] && live[a + r];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      q[k][c] = valid[k] ? qkv[(a + r) * ld + h * D + c] : 0.f;
      gq[k][c] = valid[k] ? g[(a + r) * H + h * D + c] : 0.f;
      dq[k][c] = 0.f;
    }
    l2[k] = valid[k] ? lse[(a + r) * K + h] * LOG2E : 0.f;
    di[k] = valid[k] ? delta[(a + r) * K + h] : 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += TILE) {
    const int nk = min(TILE, n - k0);
    __syncthreads();
    stage_rows<D>(ks, qkv, a + k0, nk, ld, H, K);
    stage_rows<D>(vs, qkv, a + k0, nk, ld, 2 * H, K);
    stage_live(kl, live, a + k0, nk);
    stage_phi(ph, phi, s, stride, q0, k0, n);
    __syncthreads();
    if (dense && nk == TILE)
      query_tile<D, false>(ks, vs, ph, kl, tab, hist, rare, KP, K, h, lane,
                           tid, NT, nk, k0, q0, lv, q, gq, dq, l2, di, c1);
    else
      query_tile<D, true>(ks, vs, ph, kl, tab, hist, rare, KP, K, h, lane,
                          tid, NT, nk, k0, q0, lv, q, gq, dq, l2, di, c1);
  }
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    if (!valid[k]) continue;
    const long long row = a + q0 + lane + WARP * k;
#pragma unroll
    for (int c = 0; c < D; ++c) dqkv[row * ld + h * D + c] = dq[k][c] * scale;
  }
  // this block's sums: the warp's lanes' slots by a fixed butterfly, plus
  // the warp's table of longer distances
  __syncwarp();
  for (int slot = 0; slot < SLOTS; ++slot) {
    float v = hist[slot * NT + tid];
#pragma unroll
    for (int off = WARP / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(FULL, v, off);
    if (lane == 0)
      rare[h * CODES + (slot == SLOTS - 1 ? NO_PATH : slot)] += v;
  }
  __syncwarp();
  for (int c = lane; c < CODES; c += WARP) out[c * K + h] = rare[h * CODES + c];
}

// The table's gradient: each (task, row, head) sums its task's blocks'
// partials in order; rows 255-510 are never read and take 0.
__global__ void sattn_bwd_table_kernel(const float* __restrict__ partial,
                                       float* __restrict__ dtable, int T,
                                       int K, int blocks_per_task) {
  const long long total = static_cast<long long>(T) * TABLE_ROWS * K;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int h = static_cast<int>(i % K);
    const int row = static_cast<int>(i / K % TABLE_ROWS);
    const long long t = i / (static_cast<long long>(K) * TABLE_ROWS);
    const int code = row < NO_PATH ? row
                     : row == TABLE_ROWS - 1 ? NO_PATH : -1;
    float sum = 0.f;
    if (code >= 0) {
      const float* p = partial + t * blocks_per_task * CODES * K +
                       static_cast<long long>(code) * K + h;
      for (int b = 0; b < blocks_per_task; ++b)
        sum += p[static_cast<long long>(b) * CODES * K];
    }
    dtable[i] = sum;
  }
}

// The distances: one block a segment (module header).
__global__ void __launch_bounds__(512)
    spd_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
               const int* __restrict__ seg, unsigned char* __restrict__ phi,
               int cap, int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* adj = reinterpret_cast<uint32_t*>(smem);    // cap x 32 words
  unsigned char* rows = smem + static_cast<size_t>(cap) * 128;
  const int s = blockIdx.x;
  const int a = seg[s], n = seg[s + 1] - a;
  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  const int warps = blockDim.x / WARP;
  for (int i = tid; i < n * 32; i += blockDim.x) adj[i] = 0u;
  __syncthreads();
  for (int r = tid; r < n; r += blockDim.x) {
    for (int e = row_ptr[a + r]; e < row_ptr[a + r + 1]; ++e) {
      const int j = col[e] - a;
      if (j < 0 || j >= n || j == r) continue;
      atomicOr(&adj[r * 32 + (j >> 5)], 1u << (j & 31));
      atomicOr(&adj[j * 32 + (r >> 5)], 1u << (r & 31));
    }
  }
  __syncthreads();
  unsigned char* buf = rows + static_cast<size_t>(warp) * stride;
  for (int i = warp; i < n; i += warps) {
    for (int c = 4 * lane; c < stride; c += 4 * WARP)
      *reinterpret_cast<uint32_t*>(buf + c) = FULL;
    __syncwarp();
    if (lane == 0) buf[i] = 0;
    uint32_t seen = lane == (i >> 5) ? 1u << (i & 31) : 0u;
    uint32_t front = seen;
    int d = 0;
    while (__any_sync(FULL, front != 0u)) {
      ++d;
      uint32_t next = 0u;
      for (int w = 0; w < 32; ++w) {
        uint32_t bits = __shfl_sync(FULL, front, w);
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          next |= adj[(w * 32 + b) * 32 + lane];
        }
      }
      uint32_t fresh = next & ~seen;
      seen |= fresh;
      front = fresh;
      const unsigned char code =
          static_cast<unsigned char>(d < MAX_DISTANCE ? d : MAX_DISTANCE);
      while (fresh) {
        const int b = __ffs(fresh) - 1;
        fresh &= fresh - 1;
        buf[lane * 32 + b] = code;
      }
    }
    __syncwarp();
    unsigned char* out = phi + static_cast<size_t>(s) * stride * stride +
                         static_cast<size_t>(i) * stride;
    for (int c = 16 * lane; c < stride; c += 16 * WARP)
      *reinterpret_cast<uint4*>(out + c) =
          *reinterpret_cast<const uint4*>(buf + c);
    __syncwarp();
  }
}

int threads_for(int K) { return WARP * K; }

template <int D>
long long fwd_smem(int K) {
  return 4LL * (CODES * K + 4LL * FWD_TILE * K * Head<D>::P) +
         2 * QT * FWD_PITCH + MAX_ROWS + QT;
}

template <int D>
long long key_smem(int K) {
  return 4LL * (CODES * K + 2LL * TILE * K * Head<D>::P + 2LL * TILE * K) +
         QT * PITCH + TILE;
}

template <int D>
long long query_smem(int K) {
  return 4LL * (CODES * K + 2LL * TILE * K * Head<D>::P +
                static_cast<long long>(SLOTS + 1) * threads_for(K) +
                static_cast<long long>(K) * CODES) +
         QT * PITCH + TILE;
}

template <typename... P, typename... A>
int launch(void (*kernel)(P...), dim3 grid, int threads, long long smem,
           cudaStream_t st, A... args) {
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

bool check(long long N, long long S, int per_task, int rows, int stride,
           int K) {
  return N >= 0 && N < (1LL << 31) && S >= 0 && S < (1LL << 31) &&
         per_task > 0 && S % per_task == 0 && rows > 0 &&
         rows <= MAX_ROWS && stride >= rows && stride % TILE == 0 &&
         K >= 1 && K <= 8;
}

unsigned tiles(int rows) { return static_cast<unsigned>((rows + QT - 1) / QT); }

struct Fwd {
  const float* qkv;
  const float* table;
  const unsigned char* phi;
  const int* seg;
  const unsigned char* live;
  float* o;
  float* lse;
  long long S;
  int per_task, rows, stride, K;
  float c1;
  cudaStream_t st;
  template <int D>
  int run() const {
    return launch(sattn_fwd_kernel<D>, dim3(static_cast<unsigned>(S),
                                            tiles(rows)),
                  threads_for(K), fwd_smem<D>(K), st, qkv, table, phi, seg,
                  live, o, lse, per_task, stride, K, c1);
  }
};

struct Bwd {
  const float* qkv;
  const float* table;
  const unsigned char* phi;
  const int* seg;
  const unsigned char* live;
  const float* lse;
  const float* g;
  const float* delta;
  float* dqkv;
  float* partial;
  long long S;
  int per_task, rows, stride, K;
  float c1, scale;
  cudaStream_t st;
  template <int D>
  int run() const {
    const dim3 grid(static_cast<unsigned>(S), tiles(rows));
    int err = launch(sattn_bwd_key_kernel<D>, grid, threads_for(K),
                     key_smem<D>(K), st, qkv, table, phi, seg, live, lse, g,
                     delta, dqkv, per_task, stride, K, c1, scale);
    if (err != 0) return err;
    return launch(sattn_bwd_query_kernel<D>, grid, threads_for(K),
                  query_smem<D>(K), st, qkv, table, phi, seg, live, lse, g,
                  delta, dqkv, partial, per_task, stride, K, c1, scale);
  }
};

// The kernels for head width D, or cudaErrorInvalidValue for a width they
// are not built for.
template <typename F>
int dispatch(int D, const F& f) {
  switch (D) {
    case 4: return f.template run<4>();
    case 8: return f.template run<8>();
    case 10: return f.template run<10>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

unsigned blocks_for(long long work, int threads) {
  const long long b = (work + threads - 1) / threads;
  return static_cast<unsigned>(b < 1 ? 1 : (b > 65535 * 8 ? 65535 * 8 : b));
}

}  // namespace

// The distances of S segments of at most `rows` rows into phi (S tiles of
// stride x stride bytes), from the forward CSR over N rows. Returns
// cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int gmeta_spd(const void* row_ptr, const void* col,
                         const void* seg, void* phi, long long N,
                         long long S, int rows, int stride, void* stream) {
  if (!check(N, S, 1, rows, stride, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 512;
  const long long smem = 128LL * rows + (threads / WARP) * 1LL * stride;
  return launch(spd_kernel, dim3(static_cast<unsigned>(S)), threads, smem,
                static_cast<cudaStream_t>(stream),
                static_cast<const int*>(row_ptr),
                static_cast<const int*>(col), static_cast<const int*>(seg),
                static_cast<unsigned char*>(phi), rows, stride);
}

// The forward over N rows of qkv (N, 3 K D) in S segments: o (N, K D) and
// lse (N, K). Returns cudaGetLastError() after the launch: 0 when it was
// accepted.
extern "C" int gmeta_sattn_fwd(const void* qkv, const void* table,
                               const void* phi, const void* seg,
                               const void* live, void* o, void* lse,
                               long long N, long long S, int per_task,
                               int rows, int stride, int K, int D,
                               void* stream) {
  if (!check(N, S, per_task, rows, stride, K))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const Fwd f{static_cast<const float*>(qkv),
              static_cast<const float*>(table),
              static_cast<const unsigned char*>(phi),
              static_cast<const int*>(seg),
              static_cast<const unsigned char*>(live),
              static_cast<float*>(o), static_cast<float*>(lse), S, per_task,
              rows, stride, K,
              static_cast<float>(1.4426950408889634 /
                                 sqrt(static_cast<double>(D))),
              static_cast<cudaStream_t>(stream)};
  return dispatch(D, f);
}

// The backward: from g (N, K D), the gradient of o, the gradient of qkv
// into dqkv and of the table (T, 512, K) into dtable, with scratch delta
// (N, K) and partial (S * row tiles, 256, K). Four launches; returns the
// first error, else 0.
extern "C" int gmeta_sattn_bwd(const void* qkv, const void* table,
                               const void* phi, const void* seg,
                               const void* live, const void* o,
                               const void* lse, const void* g, void* dqkv,
                               void* dtable, void* delta, void* partial,
                               long long N, long long S, int per_task,
                               int rows, int stride, int T, int K, int D,
                               void* stream) {
  if (!check(N, S, per_task, rows, stride, K) || T != S / per_task)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long pairs = N * K;
  sattn_bwd_delta_kernel<<<blocks_for(pairs, 256), 256, 0, st>>>(
      static_cast<const float*>(g), static_cast<const float*>(o),
      static_cast<float*>(delta), pairs, D);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const Bwd b{static_cast<const float*>(qkv),
              static_cast<const float*>(table),
              static_cast<const unsigned char*>(phi),
              static_cast<const int*>(seg),
              static_cast<const unsigned char*>(live),
              static_cast<const float*>(lse), static_cast<const float*>(g),
              static_cast<const float*>(delta), static_cast<float*>(dqkv),
              static_cast<float*>(partial), S, per_task, rows, stride, K,
              static_cast<float>(1.4426950408889634 /
                                 sqrt(static_cast<double>(D))),
              static_cast<float>(1.0 / sqrt(static_cast<double>(D))), st};
  err = dispatch(D, b);
  if (err != 0) return err;
  const long long outs = static_cast<long long>(T) * TABLE_ROWS * K;
  sattn_bwd_table_kernel<<<blocks_for(outs, 256), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dtable), T, K,
      per_task * static_cast<int>(tiles(rows)));
  return static_cast<int>(cudaGetLastError());
}
