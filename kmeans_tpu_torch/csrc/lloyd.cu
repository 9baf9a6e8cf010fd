// Hand-written Hopper (sm_90a) kernels for the Lloyd sweeps of the port: the
// untiled K1-K4 and the k-tiled pair K5 (streamed argmin) and K6 (bucketed
// fold) that the planner (kmeans_tpu_torch/ops/plan.py) picks where -2C and
// the f32 sums outgrow L2.
//
// Built by kmeans_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  Every
// entry point launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() after its launch.  Python wrappers, checks and
// the plain PyTorch versions live in kmeans_tpu_torch/ops/cuda_lloyd.py.
//
// Two scoring cores.  K1 and K2 score bf16 x in bf16 compute with d % 8 == 0
// and 16-byte-aligned bases (the rule is scoring_core in cuda_lloyd.py, and
// the wrapper passes its choice in) with the Hopper core below
// (core_score_kernel: TMA into an mbarrier ring, wgmma, the argmin taken
// from registers).  Every other input of K1 and K2, and every input of K4
// and K5, runs score_block:
//
// * A block scores BM = 128 rows against every centroid in k-tiles of
//   BN = 128 (score_block).  The rows are a contiguous block (K1, K2) or
//   128 rows gathered by index (K4).  For each k-tile it streams d in chunks
//   of BK through shared memory: the row chunk cast to the compute dtype
//   (cd) and the centroid chunk, pre-scaled by -2 in cd by the wrapper.
//   Scores are csq + x_cd . (-2 C_cd)^T with f32 accumulation:
//     - bf16: nvcuda::wmma 16x16x16 bf16 tiles with f32 accumulators
//       (8 warps, each a 64 x 32 sub-tile);
//     - f32: plain f32 FMA on an 8 x 8 register micro-tile per thread, never
//       TF32.
//   A row's score does not depend on where in the tile the row sits, so K4
//   gives a row the bits K2 gives it.
// * The (BM, BN) score tile goes through shared memory, where two threads per
//   row scan its columns in increasing order with strict '<' and merge the
//   halves by (value, index): the lowest index wins a tie inside a tile.
//   Tiles are merged with strict '<' in increasing k, so the lowest index
//   wins across tiles too -- the rule of jnp.argmin and _argmin_rows.  K4
//   also carries the least score over the other columns (second): within a
//   scan a new best pushes the old best into second; a merge takes
//   min(second_a, second_b, max(best_a, best_b)), so an exact duplicate of
//   the best column makes second == best.
//   Columns past k and rows past n are masked, so any d and k are taken.
// * K1 folds with K6's bucketed fold (below), so its sums have the same bits
//   every launch.  K2 and K4 scatter their changed rows: a warp per row adds
//   +-w * float(cd(x[r, :])) into the sums with f32 atomicAdd, in an order
//   that changes from run to run at the f32 rounding level.  At the
//   headline shape (k = 1000, d = 2048) the f32 sums are 8 MB, so the
//   atomics resolve in L2.
// * ||x||^2 is taken from x in its stored dtype, widened to f32, a lane per
//   32nd column and a butterfly sum, the same order in every kernel.
//
// What bounds them on an H100: the distance product, 2*n*d*k operations
// (5.24 TFLOP at n = 1.28M, d = 2048, k = 1000: >= 5.3 ms at 989 TFLOP/s
// bf16), against one read of x (5.24 GB bf16: >= 1.56 ms at 3.35 TB/s); K4
// does the product for its needed rows only.  score_block is simple rather
// than fast: no wgmma, no TMA, no software pipelining; the x tile is re-read
// from L2 once per k-tile.

#include <cuda.h>             // CUtensorMap and its enums only: no driver call is linked
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;            // rows per block
constexpr int BN = 128;            // centroids per k-tile
constexpr int NT = 256;            // threads per block
constexpr int NWARP = NT / 32;
constexpr int LDS = BN + 4;        // score-tile row stride (floats)
constexpr int GROUP_ROWS = 1024;   // row group of the dense_tiles report

template <class CT> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int BK = 64;          // features per stage
  static constexpr int LDX = BK + 8;     // smem row stride (elements)
  static constexpr int VW = 8;           // elements per vector load
};
template <> struct Cfg<float> {
  static constexpr int BK = 32;
  static constexpr int LDX = BK + 1;
  static constexpr int VW = 4;
};

template <class CT>
constexpr int smem_bytes() {
  constexpr int tiles = 2 * BM * Cfg<CT>::LDX * (int)sizeof(CT);
  constexpr int scores = BM * LDS * (int)sizeof(float);
  return tiles > scores ? tiles : scores;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <class CT> __device__ __forceinline__ CT cast_cd(float v);
template <> __device__ __forceinline__ float cast_cd<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 cast_cd<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// float(cd(v)): the value a row element contributes to the fold.
template <class CT> __device__ __forceinline__ float cd_round(float v) {
  return to_f32(cast_cd<CT>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VW consecutive elements of XT at p (aligned) -> cd, into shared memory.
template <class XT, class CT> __device__ __forceinline__ void load_vec(const XT* p, CT* dst);

template <> __device__ __forceinline__ void load_vec<bf16, bf16>(const bf16* p, bf16* dst) {
  *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(p));
}
template <> __device__ __forceinline__ void load_vec<float, bf16>(const float* p, bf16* dst) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  uint4 packed;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
  h[0] = __floats2bfloat162_rn(a.x, a.y);
  h[1] = __floats2bfloat162_rn(a.z, a.w);
  h[2] = __floats2bfloat162_rn(b.x, b.y);
  h[3] = __floats2bfloat162_rn(b.z, b.w);
  *reinterpret_cast<uint4*>(dst) = packed;
}
template <> __device__ __forceinline__ void load_vec<float, float>(const float* p, float* dst) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
}
template <> __device__ __forceinline__ void load_vec<bf16, float>(const bf16* p, float* dst) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = __bfloat162float(h[e]);
}

// Stage rows [0, rows) x columns [col0, col0 + BK) of a row-major (., d)
// matrix into dst (row stride LDX) in cd; rows >= rows_valid and columns
// >= d are zero.  With GATHER, tile row r is row gather[r] of src.
template <class XT, class CT, bool VEC, bool GATHER = false>
__device__ __forceinline__ void load_tile(CT* dst, const XT* __restrict__ src, int rows,
                                          int rows_valid, int col0, int d,
                                          const int* gather = nullptr) {
  constexpr int BK = Cfg<CT>::BK, LDX = Cfg<CT>::LDX, VW = Cfg<CT>::VW;
  if constexpr (VEC) {
    constexpr int PER_ROW = BK / VW;
    for (int v = threadIdx.x; v < rows * PER_ROW; v += NT) {
      const int r = v / PER_ROW, c = (v % PER_ROW) * VW;
      CT* o = dst + r * LDX + c;
      if (r < rows_valid && col0 + c < d) {
        const size_t row = GATHER ? (size_t)gather[r] : (size_t)r;
        load_vec<XT, CT>(src + row * d + col0 + c, o);
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) o[e] = cast_cd<CT>(0.f);
      }
    }
  } else {
    for (int v = threadIdx.x; v < rows * BK; v += NT) {
      const int r = v / BK, c = v % BK;
      float val = 0.f;
      if (r < rows_valid && col0 + c < d) {
        const size_t row = GATHER ? (size_t)gather[r] : (size_t)r;
        val = to_f32(src[row * d + col0 + c]);
      }
      dst[r * LDX + c] = cast_cd<CT>(val);
    }
  }
}

// Scores of rows_valid (<= BM) rows against every centroid: rows [0,
// rows_valid) of xblk, or with GATHER the rows gather[0 .. rows_valid) of
// xblk.  Leaves each row's (min score, lowest argmin) in s_min / s_lab and,
// with SECOND, the least score over the other columns in s_second.  Ends
// with a barrier.
template <class XT, class CT, bool VEC, bool GATHER, bool SECOND>
__device__ void score_block(const XT* __restrict__ xblk, const int* gather, int rows_valid,
                            const CT* __restrict__ neg2c, const float* __restrict__ csq,
                            int d, int k, unsigned char* smem, float* s_csq, float* s_min,
                            float* s_second, int* s_lab) {
  constexpr int BK = Cfg<CT>::BK, LDX = Cfg<CT>::LDX;
  CT* xs = reinterpret_cast<CT*>(smem);
  CT* cs = xs + BM * LDX;
  float* sc = reinterpret_cast<float*>(smem);   // reuses the staging buffers
  const int tid = threadIdx.x;
  const int rr = tid >> 1, side = tid & 1;      // two scanning threads per row
  float run_best = INFINITY, run_second = INFINITY;
  int run_idx = 0;

  for (int k0 = 0; k0 < k; k0 += BN) {
    const int cols_valid = min(BN, k - k0);
    if (tid < BN) s_csq[tid] = tid < cols_valid ? csq[k0 + tid] : INFINITY;
    const CT* cblk = neg2c + (size_t)k0 * d;

    if constexpr (std::is_same<CT, bf16>::value) {
      using namespace nvcuda;
      const int warp = tid >> 5, wr = warp >> 2, wc = warp & 3;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      for (int d0 = 0; d0 < d; d0 += BK) {
        load_tile<XT, CT, VEC, GATHER>(xs, xblk, BM, rows_valid, d0, d, gather);
        load_tile<CT, CT, VEC>(cs, cblk, BN, cols_valid, d0, d);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            wmma::load_matrix_sync(a[i], xs + (wr * 64 + i * 16) * LDX + kk, LDX);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(b[j], cs + (wc * 32 + j * 16) * LDX + kk, LDX);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(sc + (wr * 64 + i * 16) * LDS + wc * 32 + j * 16,
                                  acc[i][j], LDS, wmma::mem_row_major);
    } else {
      const int ty = tid >> 4, tx = tid & 15;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int d0 = 0; d0 < d; d0 += BK) {
        load_tile<XT, CT, VEC, GATHER>(xs, xblk, BM, rows_valid, d0, d, gather);
        load_tile<CT, CT, VEC>(cs, cblk, BN, cols_valid, d0, d);
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          float a[8], b[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = xs[(ty + 16 * i) * LDX + kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) b[j] = cs[(tx + 16 * j) * LDX + kk];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[(ty + 16 * i) * LDS + tx + 16 * j] = acc[i][j];
    }
    __syncthreads();

    // Lowest-index argmin of this tile, then a strict-'<' merge into the
    // running carry (earlier tiles hold lower indices).
    float best = INFINITY, second = INFINITY;
    int bi = INT_MAX;
    const float* srow = sc + rr * LDS;
    for (int j = 0; j < BN / 2; ++j) {
      const int col = side * (BN / 2) + j;
      if (col >= cols_valid) break;
      const float v = s_csq[col] + srow[col];
      if (v < best) {
        if constexpr (SECOND) second = best;
        best = v;
        bi = k0 + col;
      } else if constexpr (SECOND) {
        if (v < second) second = v;
      }
    }
    const float ob = __shfl_xor_sync(0xffffffffu, best, 1);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, 1);
    if constexpr (SECOND) {
      const float os = __shfl_xor_sync(0xffffffffu, second, 1);
      second = fminf(fminf(second, os), fmaxf(best, ob));
    }
    if (ob < best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    if constexpr (SECOND)
      run_second = fminf(fminf(run_second, second), fmaxf(run_best, best));
    if (best < run_best) { run_best = best; run_idx = bi; }
    __syncthreads();
  }
  if (side == 0) {
    s_min[rr] = run_best;
    s_lab[rr] = run_idx;
    if constexpr (SECOND) s_second[rr] = run_second;
  }
  __syncthreads();
}

// ||x[row]||^2 in f32 from x in its stored dtype: lane l sums columns l,
// l + 32, ... and the warp adds the lanes up in a butterfly.  Every kernel
// takes the norm in this order, so they give one row the same bits.
template <class XT>
__device__ __forceinline__ float row_sq(const XT* __restrict__ xr, int d, int lane) {
  float sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float xf = to_f32(xr[c]);
    sq = fmaf(xf, xf, sq);
  }
  return warp_sum(sq);
}

// K1 -- replaces kmeans_tpu/ops/pallas_lloyd.py::lloyd_pass_pallas (_kernel).
// Bound on an H100: the distance product (2*n*d*k operations); the fold adds
// one more read of x (every row is folded).  Design: the argmin (this
// kernel with score_block, or the Hopper core and tiled_merge_kernel), then
// with with_update K6's single fold on the labels just written.  This kernel
// scores a 128-row block and a warp per row reads the row for ||x||^2.  raw
// (the sharded callers' hook) writes the raw min score and skips the norm;
// the other hook, valid_cols, is a +inf csq set by the wrapper.
template <class XT, class CT, bool VEC>
__global__ void __launch_bounds__(NT, 2)
lloyd_pass_kernel(const XT* __restrict__ x, const CT* __restrict__ neg2c,
                  const float* __restrict__ csq, int n, int d, int k, int raw,
                  int* __restrict__ labels, float* __restrict__ mind) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_csq[BN], s_min[BM];
  __shared__ int s_lab[BM];
  const int row0 = blockIdx.x * BM;
  score_block<XT, CT, VEC, false, false>(x + (size_t)row0 * d, nullptr, min(BM, n - row0),
                                         neg2c, csq, d, k, smem, s_csq, s_min, nullptr,
                                         s_lab);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += NWARP) {
    const int gr = row0 + r;
    if (gr >= n) break;
    const float sq = raw ? 0.f : row_sq(x + (size_t)gr * d, d, lane);
    if (lane == 0) {
      labels[gr] = s_lab[r];
      mind[gr] = raw ? s_min[r] : fmaxf(s_min[r] + sq, 0.f);
    }
  }
}

// K2 -- replaces kmeans_tpu/ops/pallas_lloyd.py::lloyd_delta_pallas
// (_delta_kernel).  Bound on an H100: the distance product; only changed rows
// are read a second time.  Design: the TPU kernel compacted changed rows with
// a permutation-matrix matmul and folded them with a signed one-hot matmul,
// both workarounds for Mosaic; here each changed row (label != prev, w > 0)
// is scattered directly: +w at the new label, -w at the old one when
// 0 <= prev < k.  n_changed is one shared-memory count per block plus one
// global atomic; group_counts[g] counts the changed rows of the g-th
// 1024-row group, from which the wrapper reports dense_tiles.  The epilogue
// of one row (delta_row) is shared with the Hopper core's finishing launch.
template <class XT, class CT>
__device__ __forceinline__ bool delta_row(const XT* __restrict__ x, const float* __restrict__ w,
                                          const int* __restrict__ prev, int gr, int d, int k,
                                          int with_mind, int lab, float best, int lane,
                                          int* __restrict__ labels, float* __restrict__ mind,
                                          float* __restrict__ dsums,
                                          float* __restrict__ dcounts) {
  const int old = prev[gr];
  const float wr = w[gr];
  const bool changed = lab != old && wr > 0.f;
  const bool sub = changed && old >= 0 && old < k;
  float sq = 0.f;
  if (with_mind || changed) {
    const XT* xr = x + (size_t)gr * d;
    float* add_row = dsums + (size_t)lab * d;
    float* sub_row = dsums + (size_t)(sub ? old : 0) * d;
    for (int c = lane; c < d; c += 32) {
      const float xf = to_f32(xr[c]);
      sq = fmaf(xf, xf, sq);
      if (changed) {
        const float v = wr * cd_round<CT>(xf);
        atomicAdd(add_row + c, v);
        if (sub) atomicAdd(sub_row + c, -v);
      }
    }
    sq = warp_sum(sq);
  }
  if (lane == 0) {
    labels[gr] = lab;
    mind[gr] = with_mind ? fmaxf(best + sq, 0.f) : best;
    if (changed) {
      atomicAdd(dcounts + lab, wr);
      if (sub) atomicAdd(dcounts + old, -wr);
    }
  }
  return changed;
}

template <class XT, class CT, bool VEC>
__global__ void __launch_bounds__(NT, 2)
lloyd_delta_kernel(const XT* __restrict__ x, const CT* __restrict__ neg2c,
                   const float* __restrict__ csq, const float* __restrict__ w,
                   const int* __restrict__ prev, int n, int d, int k, int with_mind,
                   int* __restrict__ labels, float* __restrict__ mind,
                   float* __restrict__ dsums, float* __restrict__ dcounts,
                   int* __restrict__ n_changed, int* __restrict__ group_counts) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_csq[BN], s_min[BM];
  __shared__ int s_lab[BM];
  __shared__ int s_changed;
  if (threadIdx.x == 0) s_changed = 0;
  const int row0 = blockIdx.x * BM;
  score_block<XT, CT, VEC, false, false>(x + (size_t)row0 * d, nullptr, min(BM, n - row0),
                                         neg2c, csq, d, k, smem, s_csq, s_min, nullptr,
                                         s_lab);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += NWARP) {
    const int gr = row0 + r;
    if (gr >= n) break;
    if (delta_row<XT, CT>(x, w, prev, gr, d, k, with_mind, s_lab[r], s_min[r], lane, labels,
                          mind, dsums, dcounts) &&
        lane == 0)
      atomicAdd(&s_changed, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_changed > 0) {
    atomicAdd(n_changed, s_changed);
    atomicAdd(group_counts + row0 / GROUP_ROWS, s_changed);
  }
}

// K4 -- replaces kmeans_tpu/ops/pallas_lloyd.py::lloyd_hamerly_pallas
// (_hamerly_kernel).  Bound on an H100: the distance product of the rows
// flagged need (2*n_rec*d*k operations); the other rows only pass their
// label and bounds through.  Design: the TPU kernel compacted needed rows
// with a permutation-matrix matmul (a Mosaic workaround) and fell back to a
// dense branch past mc = 256 of them.  Here a block owns one 1024-row group:
// it compacts the group's needed rows into shared memory (a ballot prefix
// per 256-row round, so they stay in increasing order), writes prev / sb_in
// / slb_in through for the others, then scores the needed rows 128 at a
// time with score_block on gathered rows.  A needed row gets label = the
// lowest argmin, sb = its score, slb = the least score over the other
// columns; a changed one (label != prev, w > 0) is scattered as in K2.
// group_counts[g] is the group's needed-row count, from which the wrapper
// reports dense_tiles; there is no dense branch.
template <class XT, class CT, bool VEC>
__global__ void __launch_bounds__(NT, 2)
lloyd_hamerly_kernel(const XT* __restrict__ x, const CT* __restrict__ neg2c,
                     const float* __restrict__ csq, const float* __restrict__ w,
                     const int* __restrict__ prev, const unsigned char* __restrict__ need,
                     const float* __restrict__ sb_in, const float* __restrict__ slb_in,
                     int n, int d, int k, int* __restrict__ labels, float* __restrict__ sb,
                     float* __restrict__ slb, float* __restrict__ dsums,
                     float* __restrict__ dcounts, int* __restrict__ n_rec,
                     int* __restrict__ group_counts) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_csq[BN], s_min[BM], s_second[BM];
  __shared__ int s_lab[BM];
  __shared__ int s_rows[GROUP_ROWS];   // the group's needed rows, compacted
  __shared__ int s_warp[NWARP];
  __shared__ int s_count;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * GROUP_ROWS;
  const int rows = min(GROUP_ROWS, n - row0);
  if (tid == 0) s_count = 0;
  __syncthreads();
  for (int r0 = 0; r0 < GROUP_ROWS; r0 += NT) {
    const int r = r0 + tid, gr = row0 + r;
    const bool valid = r < rows;
    const bool needed = valid && need[gr];
    const unsigned ballot = __ballot_sync(0xffffffffu, needed);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int slot = s_count + __popc(ballot & ((1u << lane) - 1u));
    for (int v = 0; v < warp; ++v) slot += s_warp[v];
    if (needed) {
      s_rows[slot] = gr;
    } else if (valid) {
      labels[gr] = prev[gr];
      sb[gr] = sb_in[gr];
      slb[gr] = slb_in[gr];
    }
    __syncthreads();
    if (tid == 0)
      for (int v = 0; v < NWARP; ++v) s_count += s_warp[v];
    __syncthreads();
  }
  const int count = s_count;

  for (int s0 = 0; s0 < count; s0 += BM) {
    const int m = min(BM, count - s0);
    score_block<XT, CT, VEC, true, true>(x, s_rows + s0, m, neg2c, csq, d, k, smem, s_csq,
                                         s_min, s_second, s_lab);
    for (int r = warp; r < m; r += NWARP) {
      const int gr = s_rows[s0 + r];
      const int lab = s_lab[r];
      const int old = prev[gr];
      const float wr = w[gr];
      const bool changed = lab != old && wr > 0.f;
      const bool sub = changed && old >= 0 && old < k;
      if (changed) {
        const XT* xr = x + (size_t)gr * d;
        float* add_row = dsums + (size_t)lab * d;
        float* sub_row = dsums + (size_t)(sub ? old : 0) * d;
        for (int c = lane; c < d; c += 32) {
          const float v = wr * cd_round<CT>(to_f32(xr[c]));
          atomicAdd(add_row + c, v);
          if (sub) atomicAdd(sub_row + c, -v);
        }
      }
      if (lane == 0) {
        labels[gr] = lab;
        sb[gr] = s_min[r];
        slb[gr] = s_second[r];
        if (changed) {
          atomicAdd(dcounts + lab, wr);
          if (sub) atomicAdd(dcounts + old, -wr);
        }
      }
    }
  }
  if (tid == 0) {
    group_counts[blockIdx.x] = count;
    if (count > 0) atomicAdd(n_rec, count);
  }
}

// K3 -- replaces kmeans_tpu/ops/pallas_lloyd.py::accumulate_pallas
// (_acc_kernel).  Bound on an H100: bytes -- one read of x (5.24 GB bf16 at
// the headline shape, >= 1.56 ms at 3.35 TB/s); it does no product.  Design:
// a warp per row reads the row once, for ||x||^2 (min_d2 = max(scores +
// ||x||^2, 0)) and for its scatter fold; labels outside [0, k) contribute
// nothing.
template <class XT, class CT>
__global__ void __launch_bounds__(NT)
accumulate_kernel(const XT* __restrict__ x, const int* __restrict__ labels,
                  const float* __restrict__ scores, const float* __restrict__ w,
                  int n, int d, int k, float* __restrict__ sums,
                  float* __restrict__ counts, float* __restrict__ mind) {
  const int row = (int)((blockIdx.x * (size_t)NT + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int lab = labels[row];
  const float wr = w[row];
  const bool fold = lab >= 0 && lab < k && wr != 0.f;
  const XT* xr = x + (size_t)row * d;
  float* dst = sums + (size_t)(fold ? lab : 0) * d;
  float sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float xf = to_f32(xr[c]);
    sq = fmaf(xf, xf, sq);
    if (fold) atomicAdd(dst + c, wr * cd_round<CT>(xf));
  }
  sq = warp_sum(sq);
  if (lane == 0) {
    mind[row] = fmaxf((scores != nullptr ? scores[row] : 0.f) + sq, 0.f);
    if (fold) atomicAdd(counts + lab, wr);
  }
}

// ---------------------------------------------------------------------------
// The k-tiled pair, for shapes whose -2C and f32 sums outgrow L2 (the
// planner, kmeans_tpu_torch/ops/plan.py, decides).  At the codebook shape
// (n = 1.28M, d = 2048, k = 65536) -2C in bf16 is 268 MB and the sums are
// 512 MiB against a 50 MB L2: an untiled sweep streams all of -2C through
// every 128-row block and folds with atomics into sums that live in HBM.
// ---------------------------------------------------------------------------

// K5 -- replaces kmeans_tpu/ops/pallas_lloyd.py::_tiled_argmin
// (_tiled_argmin_kernel).  Bound on an H100: the distance product,
// 2*n*d*k operations (3.44e14 at the codebook shape: >= 347 ms at 989
// TFLOP/s bf16).  Design: the TPU kernel carried a per-row argmin across the
// sequential k-slice axis of its grid; blocks on the card run in no order,
// so K5 is two launches.  The score launch has a block for each (k slice,
// 128-row block), numbered slice-major, so the blocks resident at one time
// work on the same slice and that slice's -2C stays in L2; each runs
// score_block over its slice's columns -- the loop K1, K2 and K4 run, so
// every score is theirs bit for bit -- and writes the slice's (best, index
// [, second]) for its rows to a (slices, n) buffer.  The merge launch (a
// warp per row) walks the slices in increasing order with strict '<', the
// reference's carry rule, so the lowest global index wins a tie, one that
// straddles a slice edge included; the second-min merges on the same
// lattice as score_block's.  It adds ||x||^2 (read as K1 reads it) unless
// raw.
template <class XT, class CT, bool VEC, bool SECOND>
__global__ void __launch_bounds__(NT, 2)
tiled_score_kernel(const XT* __restrict__ x, const CT* __restrict__ neg2c,
                   const float* __restrict__ csq, int n, int d, int k, int k_tile,
                   int row_blocks, float* __restrict__ part_best, int* __restrict__ part_idx,
                   float* __restrict__ part_second) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_csq[BN], s_min[BM], s_second[BM];
  __shared__ int s_lab[BM];
  const int slice = blockIdx.x / row_blocks;
  const int row0 = (blockIdx.x - slice * row_blocks) * BM;
  const int col0 = slice * k_tile;
  const int rows = min(BM, n - row0);
  score_block<XT, CT, VEC, false, SECOND>(x + (size_t)row0 * d, nullptr, rows,
                                          neg2c + (size_t)col0 * d, csq + col0, d,
                                          min(k_tile, k - col0), smem, s_csq, s_min,
                                          s_second, s_lab);
  for (int r = threadIdx.x; r < rows; r += NT) {
    const size_t o = (size_t)slice * n + row0 + r;
    part_best[o] = s_min[r];
    part_idx[o] = col0 + s_lab[r];
    if constexpr (SECOND) part_second[o] = s_second[r];
  }
}

template <class XT>
__global__ void __launch_bounds__(NT)
tiled_merge_kernel(const XT* __restrict__ x, const float* __restrict__ part_best,
                   const int* __restrict__ part_idx, const float* __restrict__ part_second,
                   int n, int d, int slices, int raw, int* __restrict__ labels,
                   float* __restrict__ mind, float* __restrict__ second) {
  const int row = (int)((blockIdx.x * (size_t)NT + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float sq = raw ? 0.f : row_sq(x + (size_t)row * d, d, lane);
  if (lane != 0) return;
  float best = part_best[row];
  int idx = part_idx[row];
  float sec = part_second != nullptr ? part_second[row] : 0.f;
  for (int s = 1; s < slices; ++s) {
    const size_t o = (size_t)s * n + row;
    const float b = part_best[o];
    if (part_second != nullptr) sec = fminf(fminf(sec, part_second[o]), fmaxf(best, b));
    if (b < best) {
      best = b;
      idx = part_idx[o];
    }
  }
  labels[row] = idx;
  mind[row] = raw ? best : fmaxf(best + sq, 0.f);
  if (part_second != nullptr) second[row] = sec;
}

// K6 -- replaces kmeans_tpu/ops/pallas_lloyd.py::_tiled_fold
// (_tiled_fold_kernel).  Bound on an H100: bytes -- one read of each folded
// row (5.24 GB for a full fold at the codebook shape) and one write of the
// sums (512 MiB): >= 1.72 ms at 3.35 TB/s.  Design: the TPU kernel re-read x
// once per k slice; on the card that would be a read of x per 128 columns.
// Instead the fold's entries -- a row's +w at lab and, in the dual mode, its
// -w at lab2 (entry e = row * S + side, S = 1 or 2) -- are bucketed by label
// in integer arithmetic only:
//   1. fold_hist: per (chunk of entries, bucket) counts, integer atomics;
//   2. fold_chunk_scan: each bucket's counts turned into per-chunk offsets;
//   3. fold_bucket_scan (one block): each bucket's first entry, first fold
//      block and first partial row;
//   4. fold_scatter: a warp per chunk walks its entries in order, 32 at a
//      time, ranking equal buckets with __match_any_sync, so each bucket
//      lists its entries in increasing entry (so row) order;
// then fold_sum gives each (bucket, chunk of FOLD_CHUNK entries, 2048
// columns) a block whose threads sum their columns over the chunk's entries
// in that order, in f32, as w * float(cd(x)) -- no float atomics -- and
// write each sums element once; a bucket of more than FOLD_CHUNK entries (a
// skewed label) writes partial rows that fold_combine adds in chunk order.
// Two launches therefore give the same bits.  Entries with w == 0, labels
// outside [0, k), and in the dual mode rows with lab == lab2 fold nothing.
constexpr int FOLD_CHUNK = 512;             // entries a fold block sums
constexpr int FOLD_COLS = 8;                // columns a fold thread sums
constexpr int FOLD_SPAN = NT * FOLD_COLS;   // columns a fold block sums

template <bool DUAL>
__device__ __forceinline__ int fold_bucket(const int* __restrict__ lab,
                                           const int* __restrict__ lab2,
                                           const float* __restrict__ w, int e, int k) {
  const int row = DUAL ? e >> 1 : e;
  if (w[row] == 0.f) return -1;
  int b = lab[row];
  if constexpr (DUAL) {
    const int p = lab2[row];
    if (b == p) return -1;
    if (e & 1) b = p;
  }
  return (b >= 0 && b < k) ? b : -1;
}

template <bool DUAL>
__global__ void __launch_bounds__(NT)
fold_hist_kernel(const int* __restrict__ lab, const int* __restrict__ lab2,
                 const float* __restrict__ w, int entries, int k, int chunk_entries,
                 int* __restrict__ hist) {
  const int e = (int)(blockIdx.x * (size_t)NT + threadIdx.x);
  if (e >= entries) return;
  const int b = fold_bucket<DUAL>(lab, lab2, w, e, k);
  if (b >= 0) atomicAdd(hist + (size_t)(e / chunk_entries) * k + b, 1);
}

__global__ void __launch_bounds__(NT)
fold_chunk_scan_kernel(int* __restrict__ hist, int chunks, int k, int* __restrict__ total) {
  const int b = (int)(blockIdx.x * (size_t)NT + threadIdx.x);
  if (b >= k) return;
  int run = 0;
  for (int c = 0; c < chunks; ++c) {
    int* p = hist + (size_t)c * k + b;
    const int v = *p;
    *p = run;
    run += v;
  }
  total[b] = run;
}

__device__ __forceinline__ int fold_blocks(int entries) {
  return max(1, (entries + FOLD_CHUNK - 1) / FOLD_CHUNK);
}

constexpr int SCAN_NT = 1024;

__global__ void __launch_bounds__(SCAN_NT)
fold_bucket_scan_kernel(const int* __restrict__ total, int k, int* __restrict__ start,
                        int* __restrict__ cstart, int* __restrict__ pstart) {
  __shared__ int s[3][SCAN_NT];
  const int t = threadIdx.x;
  const int per = (k + SCAN_NT - 1) / SCAN_NT;
  const int b0 = min(k, t * per), b1 = min(k, b0 + per);
  int a = 0, c = 0, p = 0;
  for (int b = b0; b < b1; ++b) {
    const int m = fold_blocks(total[b]);
    a += total[b];
    c += m;
    p += m > 1 ? m : 0;
  }
  s[0][t] = a;
  s[1][t] = c;
  s[2][t] = p;
  __syncthreads();
  for (int off = 1; off < SCAN_NT; off <<= 1) {
    int va = 0, vc = 0, vp = 0;
    if (t >= off) {
      va = s[0][t - off];
      vc = s[1][t - off];
      vp = s[2][t - off];
    }
    __syncthreads();
    s[0][t] += va;
    s[1][t] += vc;
    s[2][t] += vp;
    __syncthreads();
  }
  a = s[0][t] - a;
  c = s[1][t] - c;
  p = s[2][t] - p;
  for (int b = b0; b < b1; ++b) {
    const int m = fold_blocks(total[b]);
    start[b] = a;
    cstart[b] = c;
    pstart[b] = p;
    a += total[b];
    c += m;
    p += m > 1 ? m : 0;
  }
  if (t == SCAN_NT - 1) {
    start[k] = s[0][t];
    cstart[k] = s[1][t];
    pstart[k] = s[2][t];
  }
}

template <bool DUAL>
__global__ void __launch_bounds__(NT)
fold_scatter_kernel(const int* __restrict__ lab, const int* __restrict__ lab2,
                    const float* __restrict__ w, int entries, int k, int chunk_entries,
                    int chunks, const int* __restrict__ start, int* hist,
                    int* __restrict__ order) {
  const int c = (int)((blockIdx.x * (size_t)NT + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= chunks) return;
  const int e_end = (int)min((long long)entries, (long long)(c + 1) * chunk_entries);
  for (int e0 = c * chunk_entries; e0 < e_end; e0 += 32) {
    const int e = e0 + lane;
    const int b = e < e_end ? fold_bucket<DUAL>(lab, lab2, w, e, k) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    volatile int* cur = hist + (size_t)c * k + (b >= 0 ? b : 0);
    int base = 0;
    if (b >= 0) {
      base = *cur;
      order[start[b] + base + rank] = e;
    }
    __syncwarp();
    if (b >= 0 && rank == 0) *cur = base + __popc(peers);
    __syncwarp();
  }
}

// FOLD_COLS columns of row xr for this thread, as f32 (0 past d): with VEC
// eight consecutive columns from one 16-byte (bf16) or two (f32) loads,
// else columns strided by NT.
template <class XT, bool VEC>
__device__ __forceinline__ void fold_load(const XT* __restrict__ xr, int colb, int d,
                                          float* v) {
  if constexpr (VEC) {
    const int c0 = colb + threadIdx.x * FOLD_COLS;
    if (c0 >= d) {
#pragma unroll
      for (int j = 0; j < FOLD_COLS; ++j) v[j] = 0.f;
    } else if constexpr (std::is_same<XT, bf16>::value) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(xr + c0));
      const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < FOLD_COLS; ++j) v[j] = __bfloat162float(h[j]);
    } else {
      const float4 a = __ldg(reinterpret_cast<const float4*>(xr + c0));
      const float4 b = __ldg(reinterpret_cast<const float4*>(xr + c0) + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < FOLD_COLS; ++j) {
      const int c = colb + threadIdx.x + NT * j;
      v[j] = c < d ? to_f32(xr[c]) : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void fold_store(float* __restrict__ dst, int colb, int d,
                                           const float* acc) {
  if constexpr (VEC) {
    const int c0 = colb + threadIdx.x * FOLD_COLS;
    if (c0 < d) {
      reinterpret_cast<float4*>(dst + c0)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      reinterpret_cast<float4*>(dst + c0)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < FOLD_COLS; ++j) {
      const int c = colb + threadIdx.x + NT * j;
      if (c < d) dst[c] = acc[j];
    }
  }
}

template <class XT, class CT, bool VEC, bool DUAL>
__global__ void __launch_bounds__(NT)
fold_sum_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                const int* __restrict__ order, const int* __restrict__ start,
                const int* __restrict__ cstart, const int* __restrict__ pstart, int d,
                int k, float* __restrict__ sums, float* __restrict__ counts,
                float* __restrict__ part, float* __restrict__ part_counts) {
  const int g = blockIdx.x;
  if (g >= cstart[k]) return;
  int lo = 0, hi = k - 1;          // the bucket: the last b with cstart[b] <= g
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cstart[mid] <= g) lo = mid; else hi = mid - 1;
  }
  const int b = lo, j = g - cstart[b];
  const bool split = cstart[b + 1] - cstart[b] > 1;
  const int e_beg = start[b] + j * FOLD_CHUNK;
  const int e_end = min(start[b + 1], e_beg + FOLD_CHUNK);
  const int colb = blockIdx.y * FOLD_SPAN;
  float acc[FOLD_COLS];
#pragma unroll
  for (int c = 0; c < FOLD_COLS; ++c) acc[c] = 0.f;
  float cnt = 0.f;
  for (int e = e_beg; e < e_end; ++e) {
    const int id = order[e];
    const int row = DUAL ? id >> 1 : id;
    const float wr = (DUAL && (id & 1)) ? -w[row] : w[row];
    float v[FOLD_COLS];
    fold_load<XT, VEC>(x + (size_t)row * d, colb, d, v);
#pragma unroll
    for (int c = 0; c < FOLD_COLS; ++c)
      acc[c] = __fadd_rn(acc[c], __fmul_rn(wr, cd_round<CT>(v[c])));
    cnt = __fadd_rn(cnt, wr);
  }
  const size_t dst_row = split ? (size_t)(pstart[b] + j) : (size_t)b;
  fold_store<VEC>((split ? part : sums) + dst_row * d, colb, d, acc);
  if (blockIdx.y == 0 && threadIdx.x == 0) (split ? part_counts : counts)[dst_row] = cnt;
}

__global__ void __launch_bounds__(NT)
fold_combine_kernel(const int* __restrict__ cstart, const int* __restrict__ pstart, int d,
                    const float* __restrict__ part, const float* __restrict__ part_counts,
                    float* __restrict__ sums, float* __restrict__ counts) {
  const int b = blockIdx.x;
  const int m = cstart[b + 1] - cstart[b];
  if (m < 2) return;
  const size_t p0 = pstart[b];
  for (int c = threadIdx.x; c < d; c += NT) {
    float acc = 0.f;
    for (int j = 0; j < m; ++j) acc = __fadd_rn(acc, part[(p0 + j) * d + c]);
    sums[(size_t)b * d + c] = acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int j = 0; j < m; ++j) acc = __fadd_rn(acc, part_counts[p0 + j]);
    counts[b] = acc;
  }
}

// ---------------------------------------------------------------------------
// The Hopper scoring core of K1 and K2 (bf16 x in bf16 compute, d % 8 == 0,
// 16-byte-aligned bases).  What bounds it: the distance product, 2*n*d*k
// bf16 operations on the tensor cores (>= 5.3 ms at the headline shape),
// and the L2 traffic of its tiles.  score_block lost to the library's
// matmul + argmin by 4-6x for four reasons, and the design answers each:
//   * no pipelining: one producer thread keeps TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle) of an x tile (128 x 64) and a
//     -2C tile (256 x 64) in flight into a ring of CORE_STAGES stages, each
//     with a full and an empty mbarrier; TMA fills rows past n, centroids
//     past k and features past d with zeros, which add 0 to a product;
//   * mma.sync instead of wgmma: two consumer warpgroups, 64 rows each,
//     issue wgmma.mma_async m64n256k16 (bf16 in, f32 accumulators in
//     registers, 128 a thread), four per stage, with one stage's group left
//     in flight while the next stage is awaited; setmaxnreg moves registers
//     from the producer warpgroup to them;
//   * a score tile in shared memory: the argmin is taken in registers.  Each
//     thread adds csq (+inf past k) to its 64 columns of each of its 2 rows,
//     in increasing column order with strict '<', and the 4 lanes that share
//     a row merge by (value, index), so the lowest index wins a tie;
//   * x re-streamed per 128-column k-tile: the kernel is persistent (a block
//     per SM) and walks (row block, 256-column slice) tiles numbered
//     row-block-major, so the ceil(k/256) slices of a row block run on
//     neighbouring blocks at about the same time and all but the first read
//     its x tile from L2, while -2C (4 MB at the headline shape) stays there.
// Each tile writes its (best, index) per row to a (slices, n) buffer; the
// finishing launch (a warp per row: tiled_merge_kernel for K1,
// core_delta_finish_kernel for K2) walks the slices in increasing order with
// strict '<', K5's rule, so the lowest global index wins across a slice edge.
// The wgmma products sum in the order mma.sync does: the core's scores equal
// score_block's bit for bit (chip_smoke.py checks it).  A cluster of two
// blocks sharing the -2C tile by TMA multicast halved the L2 reads of -2C
// and did not move the headline time beyond its run-to-run spread
// (PERF.md, PR 4), so L2 is not what holds the core and it stays one block.
// ---------------------------------------------------------------------------
constexpr int CORE_BM = 128;                 // rows of a tile: two warpgroups of 64
constexpr int CORE_BN = 256;                 // centroids of a tile: one column slice
constexpr int CORE_BK = 64;                  // features a stage: one 128-byte swizzle row
constexpr int CORE_STAGES = 4;
constexpr int CORE_THREADS = 3 * 128;        // the producer warpgroup and two consumers
constexpr int CORE_X_BYTES = CORE_BM * CORE_BK * 2;
constexpr int CORE_C_BYTES = CORE_BN * CORE_BK * 2;
constexpr int CORE_STAGE_BYTES = CORE_X_BYTES + CORE_C_BYTES;
// Dynamic shared memory: the ring and the slack that aligns it to 1024 bytes
// (the 128-byte swizzle's period).  kmeans_tpu_torch/ops/plan.py prices it,
// with the ring's 2 * CORE_STAGES mbarriers, as CORE_SMEM_BYTES.
constexpr int CORE_SMEM = CORE_STAGES * CORE_STAGE_BYTES + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D TMA load of the box at (col, row) of map into dst, completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO), the leading offset unused (1).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A . B^T over 16 features: A 64 rows of x, B 256 rows of -2C, both
// K-major in shared memory; scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__global__ void __launch_bounds__(CORE_THREADS, 1)
core_score_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap c_map, const float* __restrict__ csq,
                  int n, int d, int k, float* __restrict__ part_best,
                  int* __restrict__ part_idx) {
  extern __shared__ __align__(1024) unsigned char core_smem[];
  __shared__ __align__(8) uint64_t full[CORE_STAGES], empty[CORE_STAGES];
  unsigned char* ring = core_smem + ((1024u - (smem_u32(core_smem) & 1023u)) & 1023u);
  const int slices = (k + CORE_BN - 1) / CORE_BN;
  const int tiles = ((n + CORE_BM - 1) / CORE_BM) * slices;
  const int kblocks = (d + CORE_BK - 1) / CORE_BK;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < CORE_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);          // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row0 = (t / slices) * CORE_BM, col0 = (t % slices) * CORE_BN;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1u);
          unsigned char* xs = ring + stage * CORE_STAGE_BYTES;
          mbar_expect_tx(&full[stage], CORE_STAGE_BYTES);
          tma_load_2d(xs, &x_map, &full[stage], kb * CORE_BK, row0);
          tma_load_2d(xs + CORE_X_BYTES, &c_map, &full[stage], kb * CORE_BK, col0);
          if (++stage == CORE_STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // A consumer: rows cw*64 .. cw*64 + 63 of each tile.  Thread t of the
    // warpgroup holds rows 16*(t/32) + (t%32)/4 (+8) and, in n8 chunk j,
    // columns 8j + 2(t%4) (+1): acc[4j + 2h + e] is (row + 8h, column + e).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, t128 = threadIdx.x & 127, lane = threadIdx.x & 31;
    const int r_lo = cw * 64 + (t128 >> 5) * 16 + (lane >> 2);
    const int c_lo = (lane & 3) * 2;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int slice = t % slices;
      const int row0 = (t / slices) * CORE_BM, col0 = slice * CORE_BN;
      int held = -1;                    // the stage whose wgmma group is in flight
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&full[stage], phase);
        const unsigned char* xs = ring + stage * CORE_STAGE_BYTES;
        const uint64_t da = sw128_desc(xs + cw * 64 * CORE_BK * 2);
        const uint64_t db = sw128_desc(xs + CORE_X_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CORE_BK / 16; ++kk)   // 16 features = 32 bytes = 2 units
          wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk, (kb > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (held >= 0 && t128 == 0) mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == CORE_STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
      if (t128 == 0) mbar_arrive(&empty[held]);

      float best[2] = {INFINITY, INFINITY};
      int idx[2] = {col0, col0};
#pragma unroll
      for (int j = 0; j < CORE_BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * j + c_lo + e;
          const float cs = col < k ? __ldg(csq + col) : INFINITY;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = cs + acc[4 * j + 2 * h + e];
            if (v < best[h]) {
              best[h] = v;
              idx[h] = col;
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best[h], o);
          const int oi = __shfl_xor_sync(0xffffffffu, idx[h], o);
          if (ob < best[h] || (ob == best[h] && oi < idx[h])) {
            best[h] = ob;
            idx[h] = oi;
          }
        }
        const int row = row0 + r_lo + 8 * h;
        if ((lane & 3) == 0 && row < n) {
          const size_t o = (size_t)slice * n + row;
          part_best[o] = best[h];
          part_idx[o] = idx[h];
        }
      }
    }
  }
}

// K2's finishing launch after the core: a warp per row merges the slices
// (strict '<' in increasing slice order) and runs K2's row epilogue.
template <class XT, class CT>
__global__ void __launch_bounds__(NT)
core_delta_finish_kernel(const XT* __restrict__ x, const float* __restrict__ part_best,
                         const int* __restrict__ part_idx, int slices,
                         const float* __restrict__ w, const int* __restrict__ prev, int n, int d,
                         int k, int with_mind, int* __restrict__ labels,
                         float* __restrict__ mind, float* __restrict__ dsums,
                         float* __restrict__ dcounts, int* __restrict__ n_changed,
                         int* __restrict__ group_counts) {
  __shared__ int s_changed;
  if (threadIdx.x == 0) s_changed = 0;
  __syncthreads();
  const int row0 = (int)(((size_t)blockIdx.x * NT) >> 5);
  const int gr = row0 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (gr < n) {
    float best = part_best[gr];
    int lab = part_idx[gr];
    for (int s = 1; s < slices; ++s) {
      const size_t o = (size_t)s * n + gr;
      const float b = part_best[o];
      if (b < best) {
        best = b;
        lab = part_idx[o];
      }
    }
    if (delta_row<XT, CT>(x, w, prev, gr, d, k, with_mind, lab, best, lane, labels, mind, dsums,
                          dcounts) &&
        lane == 0)
      atomicAdd(&s_changed, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_changed > 0) {
    atomicAdd(n_changed, s_changed);
    atomicAdd(group_counts + row0 / GROUP_ROWS, s_changed);
  }
}

template <class F>
int set_smem(F kern, int bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <class XT, class CT, bool VEC>
int launch_hamerly(const void* x, const void* neg2c, const float* csq, const float* w,
                   const int* prev, const unsigned char* need, const float* sb_in,
                   const float* slb_in, int n, int d, int k, int* labels, float* sb, float* slb,
                   float* dsums, float* dcounts, int* n_rec, int* group_counts,
                   cudaStream_t stream) {
  auto kern = lloyd_hamerly_kernel<XT, CT, VEC>;
  constexpr int smem = smem_bytes<CT>();
  if (int e = set_smem(kern, smem)) return e;
  kern<<<(n + GROUP_ROWS - 1) / GROUP_ROWS, NT, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const CT*>(neg2c), csq, w, prev, need, sb_in,
      slb_in, n, d, k, labels, sb, slb, dsums, dcounts, n_rec, group_counts);
  return (int)cudaGetLastError();
}

template <class XT, class CT>
int launch_acc(const void* x, const int* labels, const float* scores, const float* w, int n,
               int d, int k, float* sums, float* counts, float* mind, cudaStream_t stream) {
  const size_t blocks = ((size_t)n * 32 + NT - 1) / NT;
  accumulate_kernel<XT, CT><<<(unsigned)blocks, NT, 0, stream>>>(
      static_cast<const XT*>(x), labels, scores, w, n, d, k, sums, counts, mind);
  return (int)cudaGetLastError();
}

template <class XT, class CT, bool VEC>
int launch_tiled_argmin(const void* x, const void* neg2c, const float* csq, int n, int d,
                        int k, int k_tile, int raw, int with_second, float* part_best,
                        int* part_idx, float* part_second, int* labels, float* mind,
                        float* second, cudaStream_t stream) {
  const int row_blocks = (n + BM - 1) / BM;
  const int slices = (k + k_tile - 1) / k_tile;
  constexpr int smem = smem_bytes<CT>();
  const XT* xt = static_cast<const XT*>(x);
  const CT* ct = static_cast<const CT*>(neg2c);
  if (with_second) {
    auto kern = tiled_score_kernel<XT, CT, VEC, true>;
    if (int e = set_smem(kern, smem)) return e;
    kern<<<row_blocks * slices, NT, smem, stream>>>(xt, ct, csq, n, d, k, k_tile, row_blocks,
                                                    part_best, part_idx, part_second);
  } else {
    auto kern = tiled_score_kernel<XT, CT, VEC, false>;
    if (int e = set_smem(kern, smem)) return e;
    kern<<<row_blocks * slices, NT, smem, stream>>>(xt, ct, csq, n, d, k, k_tile, row_blocks,
                                                    part_best, part_idx, nullptr);
  }
  if (int e = (int)cudaGetLastError()) return e;
  const size_t blocks = ((size_t)n * 32 + NT - 1) / NT;
  tiled_merge_kernel<XT><<<(unsigned)blocks, NT, 0, stream>>>(
      xt, part_best, part_idx, with_second ? part_second : nullptr, n, d, slices, raw, labels,
      mind, with_second ? second : nullptr);
  return (int)cudaGetLastError();
}

template <class XT, class CT, bool VEC, bool DUAL>
int launch_fold_dual(const void* x, const float* w, const int* lab, const int* lab2, int n,
                     int d, int k, int chunk_entries, int chunks, int* hist, int* total,
                     int* start, int* cstart, int* pstart, int* order, float* part,
                     float* part_counts, float* sums, float* counts, cudaStream_t stream) {
  const int entries = DUAL ? 2 * n : n;
  const unsigned entry_blocks = (unsigned)(((size_t)entries + NT - 1) / NT);
  fold_hist_kernel<DUAL><<<entry_blocks, NT, 0, stream>>>(lab, lab2, w, entries, k,
                                                          chunk_entries, hist);
  if (int e = (int)cudaGetLastError()) return e;
  fold_chunk_scan_kernel<<<(k + NT - 1) / NT, NT, 0, stream>>>(hist, chunks, k, total);
  if (int e = (int)cudaGetLastError()) return e;
  fold_bucket_scan_kernel<<<1, SCAN_NT, 0, stream>>>(total, k, start, cstart, pstart);
  if (int e = (int)cudaGetLastError()) return e;
  fold_scatter_kernel<DUAL><<<(unsigned)(((size_t)chunks * 32 + NT - 1) / NT), NT, 0,
                              stream>>>(lab, lab2, w, entries, k, chunk_entries, chunks,
                                        start, hist, order);
  if (int e = (int)cudaGetLastError()) return e;
  // Every bucket has at least one fold block; the others come from entries.
  const dim3 grid((unsigned)(k + (entries + FOLD_CHUNK - 1) / FOLD_CHUNK),
                  (unsigned)((d + FOLD_SPAN - 1) / FOLD_SPAN));
  fold_sum_kernel<XT, CT, VEC, DUAL><<<grid, NT, 0, stream>>>(
      static_cast<const XT*>(x), w, order, start, cstart, pstart, d, k, sums, counts, part,
      part_counts);
  if (int e = (int)cudaGetLastError()) return e;
  fold_combine_kernel<<<k, NT, 0, stream>>>(cstart, pstart, d, part, part_counts, sums,
                                            counts);
  return (int)cudaGetLastError();
}

template <class XT, class CT, bool VEC>
int launch_fold(const void* x, const float* w, const int* lab, const int* lab2, int n, int d,
                int k, int chunk_entries, int chunks, int* hist, int* total, int* start,
                int* cstart, int* pstart, int* order, float* part, float* part_counts,
                float* sums, float* counts, cudaStream_t stream) {
  if (lab2 != nullptr)
    return launch_fold_dual<XT, CT, VEC, true>(x, w, lab, lab2, n, d, k, chunk_entries,
                                               chunks, hist, total, start, cstart, pstart,
                                               order, part, part_counts, sums, counts,
                                               stream);
  return launch_fold_dual<XT, CT, VEC, false>(x, w, lab, lab2, n, d, k, chunk_entries, chunks,
                                              hist, total, start, cstart, pstart, order, part,
                                              part_counts, sums, counts, stream);
}

// Error codes of the entry points besides CUDA's own (which are positive).
constexpr int kBadDtype = -1;       // no kernel for this dtype pair
constexpr int kBadCore = -2;        // the Hopper core was asked for an input it does not take
constexpr int kNoTensorMap = -3;    // the driver offers no cuTensorMapEncodeTiled
constexpr int kBadTensorMap = -4;   // cuTensorMapEncodeTiled refused an operand

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so the
// library links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major (rows, d) bf16 matrix, read in boxes of
// CORE_BK features by box_rows rows with the 128-byte swizzle; reads past
// the edges fill zeros.
int make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int d, int rows,
             int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)CORE_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadTensorMap;
}

// The core's score launch: (best, index) of every (slice, row) into
// part_best / part_idx, (ceil(k / CORE_BN), n) each.
int launch_core_score(const void* x, const void* neg2c, const float* csq, int n, int d, int k,
                      float* part_best, int* part_idx, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoTensorMap;
  CUtensorMap x_map, c_map;
  if (int e = make_map(encode, &x_map, x, d, n, CORE_BM)) return e;
  if (int e = make_map(encode, &c_map, neg2c, d, k, CORE_BN)) return e;
  int dev = 0, sms = 0;
  if (int e = (int)cudaGetDevice(&dev)) return e;
  if (int e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) return e;
  if (int e = set_smem(core_score_kernel, CORE_SMEM)) return e;
  const long long tiles =
      (long long)((n + CORE_BM - 1) / CORE_BM) * ((k + CORE_BN - 1) / CORE_BN);
  const int grid = (int)std::min<long long>(tiles, sms);
  core_score_kernel<<<grid, CORE_THREADS, CORE_SMEM, stream>>>(x_map, c_map, csq, n, d, k,
                                                               part_best, part_idx);
  return (int)cudaGetLastError();
}

template <class XT, class CT, bool VEC>
constexpr bool core_takes = std::is_same<XT, bf16>::value && std::is_same<CT, bf16>::value && VEC;

template <class XT, class CT, bool VEC>
int launch_pass(const void* x, const void* neg2c, const float* csq, const float* w, int n,
                int d, int k, int with_update, int raw, int core, int* labels, float* mind,
                float* sums, float* counts, float* part_best, int* part_idx, int chunk_entries,
                int chunks, int fold_vec, int* hist, int* total, int* start, int* cstart,
                int* pstart, int* order, float* part, float* part_counts, cudaStream_t stream) {
  const XT* xt = static_cast<const XT*>(x);
  if (core) {
    if constexpr (core_takes<XT, CT, VEC>) {
      if (int e = launch_core_score(x, neg2c, csq, n, d, k, part_best, part_idx, stream))
        return e;
      const size_t blocks = ((size_t)n * 32 + NT - 1) / NT;
      tiled_merge_kernel<XT><<<(unsigned)blocks, NT, 0, stream>>>(
          xt, part_best, part_idx, nullptr, n, d, (k + CORE_BN - 1) / CORE_BN, raw, labels,
          mind, nullptr);
    } else {
      return kBadCore;
    }
  } else {
    auto kern = lloyd_pass_kernel<XT, CT, VEC>;
    constexpr int smem = smem_bytes<CT>();
    if (int e = set_smem(kern, smem)) return e;
    kern<<<(n + BM - 1) / BM, NT, smem, stream>>>(xt, static_cast<const CT*>(neg2c), csq, n, d,
                                                  k, raw, labels, mind);
  }
  if (int e = (int)cudaGetLastError()) return e;
  if (!with_update) return 0;
  if (fold_vec)
    return launch_fold_dual<XT, CT, true, false>(x, w, labels, nullptr, n, d, k, chunk_entries,
                                                 chunks, hist, total, start, cstart, pstart,
                                                 order, part, part_counts, sums, counts, stream);
  return launch_fold_dual<XT, CT, false, false>(x, w, labels, nullptr, n, d, k, chunk_entries,
                                                chunks, hist, total, start, cstart, pstart, order,
                                                part, part_counts, sums, counts, stream);
}

template <class XT, class CT, bool VEC>
int launch_delta(const void* x, const void* neg2c, const float* csq, const float* w,
                 const int* prev, int n, int d, int k, int with_mind, int core, int* labels,
                 float* mind, float* dsums, float* dcounts, int* n_changed, int* group_counts,
                 float* part_best, int* part_idx, cudaStream_t stream) {
  const XT* xt = static_cast<const XT*>(x);
  if (core) {
    if constexpr (core_takes<XT, CT, VEC>) {
      if (int e = launch_core_score(x, neg2c, csq, n, d, k, part_best, part_idx, stream))
        return e;
      const size_t blocks = ((size_t)n * 32 + NT - 1) / NT;
      core_delta_finish_kernel<XT, CT><<<(unsigned)blocks, NT, 0, stream>>>(
          xt, part_best, part_idx, (k + CORE_BN - 1) / CORE_BN, w, prev, n, d, k, with_mind,
          labels, mind, dsums, dcounts, n_changed, group_counts);
      return (int)cudaGetLastError();
    } else {
      return kBadCore;
    }
  }
  auto kern = lloyd_delta_kernel<XT, CT, VEC>;
  constexpr int smem = smem_bytes<CT>();
  if (int e = set_smem(kern, smem)) return e;
  kern<<<(n + BM - 1) / BM, NT, smem, stream>>>(xt, static_cast<const CT*>(neg2c), csq, w, prev,
                                                n, d, k, with_mind, labels, mind, dsums,
                                                dcounts, n_changed, group_counts);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  vec = 1 takes vector loads
// (d a multiple of 8 for bf16 compute, of 4 for f32; 16-byte aligned bases).
#define KML_DISPATCH(FN, ...)                                                       \
  do {                                                                              \
    if (x_dtype == 1 && cd == 1) return vec ? FN<bf16, bf16, true>(__VA_ARGS__)     \
                                            : FN<bf16, bf16, false>(__VA_ARGS__);   \
    if (x_dtype == 0 && cd == 1) return vec ? FN<float, bf16, true>(__VA_ARGS__)    \
                                            : FN<float, bf16, false>(__VA_ARGS__);  \
    if (x_dtype == 0 && cd == 0) return vec ? FN<float, float, true>(__VA_ARGS__)   \
                                            : FN<float, float, false>(__VA_ARGS__); \
    if (x_dtype == 1 && cd == 0) return vec ? FN<bf16, float, true>(__VA_ARGS__)    \
                                            : FN<bf16, float, false>(__VA_ARGS__);  \
    return kBadDtype;                                                               \
  } while (0)

// core = 1 scores with the Hopper core (the wrapper's scoring_core rule);
// part_best / part_idx are its (ceil(k / 256), n) slice buffers.  K1 folds
// with K6's single fold when with_update; the wrapper zeroes hist and sizes
// the fold's scratch (_fold_scratch in cuda_lloyd.py).
extern "C" int kml_lloyd_pass(const void* x, int x_dtype, const void* neg2c, int cd,
                              const float* csq, const float* w, int n, int d, int k,
                              int with_update, int raw, int vec, int core, int* labels,
                              float* mind, float* sums, float* counts, float* part_best,
                              int* part_idx, int chunk_entries, int chunks, int fold_vec,
                              int* hist, int* total, int* start, int* cstart, int* pstart,
                              int* order, float* part, float* part_counts, void* stream) {
  KML_DISPATCH(launch_pass, x, neg2c, csq, w, n, d, k, with_update, raw, core, labels, mind,
               sums, counts, part_best, part_idx, chunk_entries, chunks, fold_vec, hist, total,
               start, cstart, pstart, order, part, part_counts,
               static_cast<cudaStream_t>(stream));
}

extern "C" int kml_lloyd_delta(const void* x, int x_dtype, const void* neg2c, int cd,
                               const float* csq, const float* w, const int* prev, int n, int d,
                               int k, int with_mind, int vec, int core, int* labels, float* mind,
                               float* dsums, float* dcounts, int* n_changed, int* group_counts,
                               float* part_best, int* part_idx, void* stream) {
  KML_DISPATCH(launch_delta, x, neg2c, csq, w, prev, n, d, k, with_mind, core, labels, mind,
               dsums, dcounts, n_changed, group_counts, part_best, part_idx,
               static_cast<cudaStream_t>(stream));
}

extern "C" int kml_accumulate(const void* x, int x_dtype, int cd, const int* labels,
                              const float* scores, const float* w, int n, int d, int k,
                              float* sums, float* counts, float* mind, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && cd == 1) return launch_acc<bf16, bf16>(x, labels, scores, w, n, d, k, sums, counts, mind, s);
  if (x_dtype == 0 && cd == 1) return launch_acc<float, bf16>(x, labels, scores, w, n, d, k, sums, counts, mind, s);
  if (x_dtype == 0 && cd == 0) return launch_acc<float, float>(x, labels, scores, w, n, d, k, sums, counts, mind, s);
  if (x_dtype == 1 && cd == 0) return launch_acc<bf16, float>(x, labels, scores, w, n, d, k, sums, counts, mind, s);
  return kBadDtype;
}

extern "C" int kml_lloyd_hamerly(const void* x, int x_dtype, const void* neg2c, int cd,
                                 const float* csq, const float* w, const int* prev,
                                 const unsigned char* need, const float* sb_in,
                                 const float* slb_in, int n, int d, int k, int vec, int* labels,
                                 float* sb, float* slb, float* dsums, float* dcounts,
                                 int* n_rec, int* group_counts, void* stream) {
  KML_DISPATCH(launch_hamerly, x, neg2c, csq, w, prev, need, sb_in, slb_in, n, d, k, labels,
               sb, slb, dsums, dcounts, n_rec, group_counts, static_cast<cudaStream_t>(stream));
}

extern "C" int kml_tiled_argmin(const void* x, int x_dtype, const void* neg2c, int cd,
                                const float* csq, int n, int d, int k, int k_tile, int raw,
                                int with_second, int vec, float* part_best, int* part_idx,
                                float* part_second, int* labels, float* mind, float* second,
                                void* stream) {
  KML_DISPATCH(launch_tiled_argmin, x, neg2c, csq, n, d, k, k_tile, raw, with_second,
               part_best, part_idx, part_second, labels, mind, second,
               static_cast<cudaStream_t>(stream));
}

// lab2 == nullptr: the single fold.  The wrapper zeroes hist (chunks x k)
// and sizes order (n or 2n entries) and part (rows of split buckets).
extern "C" int kml_tiled_fold(const void* x, int x_dtype, int cd, const float* w,
                              const int* lab, const int* lab2, int n, int d, int k,
                              int chunk_entries, int chunks, int vec, int* hist, int* total,
                              int* start, int* cstart, int* pstart, int* order, float* part,
                              float* part_counts, float* sums, float* counts, void* stream) {
  KML_DISPATCH(launch_fold, x, w, lab, lab2, n, d, k, chunk_entries, chunks, hist, total,
               start, cstart, pstart, order, part, part_counts, sums, counts,
               static_cast<cudaStream_t>(stream));
}
