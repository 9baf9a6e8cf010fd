// Hand-written Hopper (sm_90a) kernels for the Lloyd sweeps of the port: the
// untiled K1-K4 and the k-tiled pair K5 (streamed argmin) and K6 (bucketed
// fold) that the planner (kmeans_tpu_torch/ops/plan.py) picks where -2C and
// the f32 sums outgrow L2.  K1's fold, K3 and K6 run on one fold core.
//
// Built by kmeans_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  Every
// entry point launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() after its launch.  Python wrappers, checks and
// the plain PyTorch versions live in kmeans_tpu_torch/ops/cuda_lloyd.py.
//
// Two scoring cores.  K1, K2, K4 and K5 score bf16 x in bf16 compute with
// d % 8 == 0, and f32 x in f32 compute with d % 4 == 0, with 16-byte-aligned
// bases (the rule is scoring_core in cuda_lloyd.py, and the wrapper passes
// its choice in) on the Hopper core below (core_score_kernel: TMA into an
// mbarrier ring -- cp.async for K4's gathered rows --, wgmma, the argmin and
// second-min taken from registers, over a column range for K5; in f32,
// core32_score_kernel: the reference's six-pass bf16 product, x split into
// three bf16 pieces on chip and -2C's pieces split by the wrapper).  Every
// other input runs score_block:
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
// * K1 folds on the fold core (below) that K3 and K6 run, and adds
//   ||x||^2 there.  K2 and K4 fold their changed rows there too, with the
//   dual fold: the scoring epilogue writes each row's fold weight (w on a
//   changed row, 0 elsewhere) and the fold adds +w at the new label and -w
//   at the old one.  No kernel sums floats with atomics, so every output
//   has the same bits every launch.
// * ||x||^2 is taken from x in its stored dtype, widened to f32: a lane per
//   32nd column and a butterfly sum (row_sq, the scoring kernels' order),
//   or on the fold core in its own fixed order.
//
// What bounds them on an H100: the distance product, 2*n*d*k operations
// (5.24 TFLOP at n = 1.28M, d = 2048, k = 1000: >= 5.3 ms at 989 TFLOP/s
// bf16), against one read of x (5.24 GB bf16: >= 1.56 ms at 3.35 TB/s); K4
// does the product for its needed rows only.  score_block is simple rather
// than fast: no wgmma, no TMA, no software pipelining; the x tile is re-read
// from L2 once per k-tile.  It stays for the inputs the Hopper core does not
// take (f32 x in bf16 compute, bf16 x in f32 compute, a d off TMA's
// 16-byte row stride, misaligned bases).

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
constexpr int SCAN_NT = 1024;      // threads of the one-block scans

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
// with with_update the fold core's single fold on the labels just written,
// which also adds ||x||^2 to the raw score from its read of the row, so x is
// read once after scoring.  Without the fold this kernel scores a 128-row
// block and a warp per row reads the row for ||x||^2.  raw (the sharded
// callers' hook, and the fold's) writes the raw min score and skips the
// norm; the other hook, valid_cols, is a +inf csq set by the wrapper.
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
// both workarounds for Mosaic.  Here the scoring launch's row epilogue
// (delta_row, shared with the Hopper core's finishing launch) writes the
// label, min_d2 and the row's fold weight: w when the row changed (label !=
// prev, w > 0), else 0.  The fold core's dual fold then sums the changed
// rows, +w at the new label and -w at the old one when 0 <= prev < k, each
// bucket in row order (launch_delta_fold).  n_changed is one shared-memory
// count per block plus one global integer atomic; group_counts[g] counts
// the changed rows of the g-th 1024-row group, from which the wrapper
// reports dense_tiles.
template <class XT>
__device__ __forceinline__ bool delta_row(const XT* __restrict__ x, const float* __restrict__ w,
                                          const int* __restrict__ prev, int gr, int d,
                                          int with_mind, int lab, float best, int lane,
                                          int* __restrict__ labels, float* __restrict__ mind,
                                          float* __restrict__ fold_w) {
  const float wr = w[gr];
  const bool changed = lab != prev[gr] && wr > 0.f;
  const float sq = with_mind ? row_sq(x + (size_t)gr * d, d, lane) : 0.f;
  if (lane == 0) {
    labels[gr] = lab;
    mind[gr] = with_mind ? fmaxf(best + sq, 0.f) : best;
    fold_w[gr] = changed ? wr : 0.f;
  }
  return changed;
}

template <class XT, class CT, bool VEC>
__global__ void __launch_bounds__(NT, 2)
lloyd_delta_kernel(const XT* __restrict__ x, const CT* __restrict__ neg2c,
                   const float* __restrict__ csq, const float* __restrict__ w,
                   const int* __restrict__ prev, int n, int d, int k, int with_mind,
                   int* __restrict__ labels, float* __restrict__ mind,
                   float* __restrict__ fold_w, int* __restrict__ n_changed,
                   int* __restrict__ group_counts) {
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
    if (delta_row(x, w, prev, gr, d, with_mind, s_lab[r], s_min[r], lane, labels, mind,
                  fold_w) &&
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
// dense branch past mc = 256 of them.  Here the needed rows of a 1024-row
// group are listed in increasing order (compact_group: a ballot prefix per
// 256-row round) and the others pass prev / sb_in / slb_in through.  A
// needed row gets label = the lowest argmin, sb = its score, slb = the least
// score over the other columns and K2's fold weight (hamerly_row), every
// other row a fold weight of 0; the dual fold then sums the changed rows
// as it does K2's (launch_delta_fold).  group_counts[g] is the group's
// needed-row count, from which the wrapper reports dense_tiles; there is no
// dense branch.  On score_block a block owns one group and scores its
// needed rows 128 at a time, gathered (lloyd_hamerly_kernel), so the
// 128-row sub-blocks are as full as the group's share of needed rows.  On
// the Hopper core the rows are listed globally (hamerly_count_kernel, a
// scan of the group counts, hamerly_list_kernel), the core scores them 128
// at a time, gathered with cp.async, so every tile but the last is full,
// and core_hamerly_finish_kernel runs the row epilogue.

// The needed rows of the 1024-row group at row0 in increasing order:
// take(slot, gr) for each, slot being its rank among the group's needed
// rows, and skip(gr) for every other row below n.  Every thread of the
// block calls it; it returns the group's needed-row count.
template <class Take, class Skip>
__device__ __forceinline__ int compact_group(const unsigned char* __restrict__ need, int row0,
                                             int n, Take take, Skip skip) {
  __shared__ int s_warp[NWARP];
  __shared__ int s_count;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
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
    if (needed)
      take(slot, gr);
    else if (valid)
      skip(gr);
    __syncthreads();
    if (tid == 0)
      for (int v = 0; v < NWARP; ++v) s_count += s_warp[v];
    __syncthreads();
  }
  return s_count;
}

// A scored row's epilogue, a thread per row: label, sb = best, slb =
// second, and the row's fold weight.
__device__ __forceinline__ void hamerly_row(const float* __restrict__ w,
                                            const int* __restrict__ prev, int gr, int lab,
                                            float best, float second, int* __restrict__ labels,
                                            float* __restrict__ sb, float* __restrict__ slb,
                                            float* __restrict__ fold_w) {
  const float wr = w[gr];
  labels[gr] = lab;
  sb[gr] = best;
  slb[gr] = second;
  fold_w[gr] = lab != prev[gr] && wr > 0.f ? wr : 0.f;
}

template <class XT, class CT, bool VEC>
__global__ void __launch_bounds__(NT, 2)
lloyd_hamerly_kernel(const XT* __restrict__ x, const CT* __restrict__ neg2c,
                     const float* __restrict__ csq, const float* __restrict__ w,
                     const int* __restrict__ prev, const unsigned char* __restrict__ need,
                     const float* __restrict__ sb_in, const float* __restrict__ slb_in,
                     int n, int d, int k, int* __restrict__ labels, float* __restrict__ sb,
                     float* __restrict__ slb, float* __restrict__ fold_w,
                     int* __restrict__ n_rec, int* __restrict__ group_counts) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_csq[BN], s_min[BM], s_second[BM];
  __shared__ int s_lab[BM];
  __shared__ int s_rows[GROUP_ROWS];   // the group's needed rows, compacted
  const int count = compact_group(
      need, blockIdx.x * GROUP_ROWS, n, [&](int slot, int gr) { s_rows[slot] = gr; },
      [&](int gr) {
        labels[gr] = prev[gr];
        sb[gr] = sb_in[gr];
        slb[gr] = slb_in[gr];
        fold_w[gr] = 0.f;
      });

  for (int s0 = 0; s0 < count; s0 += BM) {
    const int m = min(BM, count - s0);
    score_block<XT, CT, VEC, true, true>(x, s_rows + s0, m, neg2c, csq, d, k, smem, s_csq,
                                         s_min, s_second, s_lab);
    for (int r = threadIdx.x; r < m; r += NT)
      hamerly_row(w, prev, s_rows[s0 + r], s_lab[r], s_min[r], s_second[r], labels, sb, slb,
                  fold_w);
  }
  if (threadIdx.x == 0) {
    group_counts[blockIdx.x] = count;
    if (count > 0) atomicAdd(n_rec, count);
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
// so K5 is two launches.  The score launch writes each (k slice, row)'s
// (best, index[, second]) to a (slices, n) buffer.  On the Hopper core
// (core_score_kernel below, over column ranges of k_tile) a persistent block
// walks the slice's 256-column sub-slices and carries the row's triple in
// registers; on score_block (tiled_score_kernel) a block for each (k slice,
// 128-row block), numbered slice-major, runs score_block over its slice's
// columns.  Either way every score is K1's, K2's and K4's bit for bit.  The
// merge launch (a warp per row) walks the slices in increasing order with
// strict '<', the reference's carry rule, so the lowest global index wins a
// tie, one that straddles a slice edge included; the second-min merges on
// the same lattice as score_block's.  It adds ||x||^2 (read as K1 reads it)
// unless raw.
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

// Entry i of a (slices, n) part buffer merged over its slices in increasing
// order: strict '<' on the best, the second-min lattice when part_second is
// given (else second is left 0).
__device__ __forceinline__ void merge_parts(const float* __restrict__ part_best,
                                            const int* __restrict__ part_idx,
                                            const float* __restrict__ part_second, int slices,
                                            int n, int i, float& best, int& idx, float& second) {
  best = part_best[i];
  idx = part_idx[i];
  second = part_second != nullptr ? part_second[i] : 0.f;
  for (int s = 1; s < slices; ++s) {
    const size_t o = (size_t)s * n + i;
    const float b = part_best[o];
    if (part_second != nullptr) second = fminf(fminf(second, part_second[o]), fmaxf(best, b));
    if (b < best) {
      best = b;
      idx = part_idx[o];
    }
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
  float best, sec;
  int idx;
  merge_parts(part_best, part_idx, part_second, slices, n, row, best, idx, sec);
  labels[row] = idx;
  mind[row] = raw ? best : fmaxf(best + sq, 0.f);
  if (part_second != nullptr) second[row] = sec;
}

// ---------------------------------------------------------------------------
// The Hopper scoring core of K1, K2, K4 and K5 (bf16 x in bf16 compute,
// d % 8 == 0, 16-byte-aligned bases; its f32 route, core32_score_kernel, is
// described after it and shares its epilogue).  What bounds it: the distance product,
// 2*n*d*k bf16 operations on the tensor cores (>= 5.3 ms at the headline
// shape), and the L2 traffic of its tiles.  score_block lost to the
// library's matmul + argmin by 4-6x for four reasons, and the design answers
// each:
//   * no pipelining: the producer warpgroup keeps loads of an x tile
//     (128 x 64) and a -2C tile (256 x 64) in flight into a ring of
//     CORE_STAGES stages, each with a full and an empty mbarrier.  -2C, and
//     x where its rows are contiguous, come by TMA (cp.async.bulk.tensor,
//     128-byte swizzle), which fills rows past n, centroids past k and
//     features past d with zeros, which add 0 to a product.  K4's rows are
//     gathered by index, which TMA cannot do (GATHER): all 128 producer
//     threads copy them with cp.async, 16 bytes each, into the same swizzled
//     layout (16-byte chunk c of tile row r at chunk c ^ (r & 7)), with a
//     source size of 0 past the needed rows and past d, and complete on the
//     stage's full barrier with cp.async.mbarrier.arrive.noinc (the barrier
//     counts those 128 arrivals beside the TMA's);
//   * mma.sync instead of wgmma: two consumer warpgroups, 64 rows each,
//     issue wgmma.mma_async m64n256k16 (bf16 in, f32 accumulators in
//     registers, 128 a thread), four per stage, with one stage's group left
//     in flight while the next stage is awaited; setmaxnreg moves registers
//     from the producer warpgroup to them;
//   * a score tile in shared memory: the argmin is taken in registers.  Each
//     thread adds csq (+inf past the column range) to its 64 columns of each
//     of its 2 rows, in increasing column order with strict '<', and the 4
//     lanes that share a row merge by (value, index), so the lowest index
//     wins a tie.  With SECOND (K4, K5's Hamerly sub-route) it also carries
//     the least score over the other columns on score_block's lattice: in
//     the scan a new best pushes the old one into second, and a merge takes
//     min(second_a, second_b, max(best_a, best_b));
//   * x re-streamed per 128-column k-tile: the kernel is persistent (a block
//     per SM) and walks tiles of (128-row block, column range of k_tile
//     columns), walking a range's 256-column sub-slices in increasing order
//     and carrying each row's (best, index[, second]) across them in
//     registers.  K1, K2 and K4 take k_tile = 256, K5 the planner's.  Tiles
//     are numbered row-block-major, so the ranges of a row block run on
//     neighbouring blocks at about the same time and all but the first read
//     its x tile from L2; -2C (4 MB at the headline shape) stays there, and
//     at the codebook shape each range's current 256-column sub-slice is
//     shared by the ~19 blocks on that range.  Numbering the tiles
//     range-major instead (the resident blocks on one range) keeps 132 row
//     blocks of x in flight, 67 MB against a 50 MB L2, and measured 14%
//     slower at the codebook shape (PERF.md).
// Each tile writes its triple per row to a (ranges, n) buffer; the finishing
// launch (tiled_merge_kernel for K1 and K5, core_delta_finish_kernel for
// K2, a warp per row; core_hamerly_finish_kernel for K4, a thread) walks
// the ranges in increasing order with strict '<', K5's rule, so the lowest
// global index wins across a range edge.  Min and max are exact, so the
// result does not depend on how the columns are grouped, and the wgmma
// products sum in the order mma.sync does: the core's labels, scores and
// second-min equal score_block's bit for bit in bf16 (chip_smoke.py checks
// it; the f32 route's six passes agree with its FMA to the f32 tolerance).  A
// cluster of two blocks sharing the -2C tile by TMA multicast halved the L2
// reads of -2C and did not move the headline time beyond its run-to-run
// spread (PERF.md), so L2 is not what holds the core and it stays one
// block.
// ---------------------------------------------------------------------------
constexpr int CORE_BM = 128;                 // rows of a tile: two warpgroups of 64
constexpr int CORE_BN = 256;                 // centroids of a tile: one column slice
constexpr int CORE_BK = 64;                  // features a stage: one 128-byte swizzle row
constexpr int CORE_STAGES = 4;
constexpr int CORE_THREADS = 3 * 128;        // the producer warpgroup and two consumers
constexpr int CORE_X_BYTES = CORE_BM * CORE_BK * 2;
constexpr int CORE_C_BYTES = CORE_BN * CORE_BK * 2;
constexpr int CORE_STAGE_BYTES = CORE_X_BYTES + CORE_C_BYTES;
// Registers a thread after setmaxnreg: the producer warpgroup gives up what
// the two consumer warpgroups take.  setmaxnreg.inc waits until the block's
// own pool -- 168 a thread at launch, all __launch_bounds__(384, 1) leaves --
// can supply it, so a budget that asks for more than the producer frees
// never returns.
constexpr int CORE_PRODUCER_REGS = 40;
constexpr int CORE_CONSUMER_REGS = 232;
static_assert(128 * (168 - CORE_PRODUCER_REGS) >= 256 * (CORE_CONSUMER_REGS - 168),
              "the consumers' setmaxnreg.inc would wait forever");
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

// 16 bytes from src to dst (src_bytes of them read, the rest zero-filled).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// An arrival on bar once this thread's earlier cp.async copies land; the
// barrier's count includes it (.noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
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

// Merge (ob, oi, os) into (best, idx, second): the lower (value, index)
// wins, the second-min on score_block's lattice.
template <bool SECOND>
__device__ __forceinline__ void core_merge(float& best, int& idx, float& second, float ob, int oi,
                                           float os) {
  if constexpr (SECOND) second = fminf(fminf(second, os), fmaxf(best, ob));
  if (ob < best || (ob == best && oi < idx)) {
    best = ob;
    idx = oi;
  }
}

// A consumer thread's part of one column sub-slice's argmin: it holds rows
// r and r + 8 (h = 0, 1) and, in n8 chunk j, columns col0 + 8j + c_lo (+1),
// score acc[4j + 2h + e] - csq.  It adds csq (+inf at or past col_hi) in
// increasing column order with strict '<', the 4 lanes that share a row
// merge by (value, index), and the sub-slice is carried into the row's
// run with strict '<' (later sub-slices hold higher indices); with SECOND
// the second-min rides the same lattice as score_block's.
template <int NJ, bool SECOND>
__device__ __forceinline__ void core_scan_slice(const float (&acc)[4 * NJ],
                                                const float* __restrict__ csq, int col0,
                                                int col_hi, int c_lo, float (&run_best)[2],
                                                int (&run_idx)[2], float (&run_second)[2]) {
  float best[2] = {INFINITY, INFINITY}, second[2] = {INFINITY, INFINITY};
  int idx[2] = {col0, col0};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + c_lo + e;
      const float cs = col < col_hi ? __ldg(csq + col) : INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = cs + acc[4 * j + 2 * h + e];
        if (v < best[h]) {
          if constexpr (SECOND) second[h] = best[h];
          best[h] = v;
          idx[h] = col;
        } else if constexpr (SECOND) {
          second[h] = fminf(second[h], v);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
      core_merge<SECOND>(best[h], idx[h], second[h],
                         __shfl_xor_sync(0xffffffffu, best[h], o),
                         __shfl_xor_sync(0xffffffffu, idx[h], o),
                         SECOND ? __shfl_xor_sync(0xffffffffu, second[h], o) : 0.f);
    if constexpr (SECOND)
      run_second[h] = fminf(fminf(run_second[h], second[h]), fmaxf(run_best[h], best[h]));
    if (best[h] < run_best[h]) {
      run_best[h] = best[h];
      run_idx[h] = idx[h];
    }
  }
}

// A tile's per-row triples into the (ranges, n) part buffers: one lane of
// the 4 that share each of the thread's two rows r_lo and r_lo + 8.
template <bool SECOND>
__device__ __forceinline__ void core_write_parts(const float (&run_best)[2],
                                                 const int (&run_idx)[2],
                                                 const float (&run_second)[2], int row0,
                                                 int r_lo, int lane, int m, int n, int range,
                                                 float* __restrict__ part_best,
                                                 int* __restrict__ part_idx,
                                                 float* __restrict__ part_second) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r_lo + 8 * h;
    if ((lane & 3) == 0 && row < m) {
      const size_t o = (size_t)range * n + row;
      part_best[o] = run_best[h];
      part_idx[o] = run_idx[h];
      if constexpr (SECOND) part_second[o] = run_second[h];
    }
  }
}

// Scores rows [0, n) of x_map, or with GATHER the rows rows[0 .. *count)
// of x (a slot per listed row), against the columns of c_map in ranges of
// k_tile (a multiple of 128), and writes each (range, row or slot)'s
// (best, index[, second]) at range * n + row.
template <bool GATHER, bool SECOND>
__global__ void __launch_bounds__(CORE_THREADS, 1)
core_score_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap c_map, const float* __restrict__ csq,
                  const bf16* __restrict__ x, const int* __restrict__ rows,
                  const int* __restrict__ count, int n, int d, int k, int k_tile,
                  float* __restrict__ part_best, int* __restrict__ part_idx,
                  float* __restrict__ part_second) {
  extern __shared__ __align__(1024) unsigned char core_smem[];
  __shared__ __align__(8) uint64_t full[CORE_STAGES], empty[CORE_STAGES];
  unsigned char* ring = core_smem + ((1024u - (smem_u32(core_smem) & 1023u)) & 1023u);
  const int m = GATHER ? *count : n;     // rows to score
  const int ranges = (k + k_tile - 1) / k_tile;
  const int tiles = ((m + CORE_BM - 1) / CORE_BM) * ranges;   // row-block-major
  const int kblocks = (d + CORE_BK - 1) / CORE_BK;
  const int wg = threadIdx.x >> 7, t128 = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < CORE_STAGES; ++s) {
      // The TMA thread's arrival, and with GATHER each copying thread's.
      mbar_init(&full[s], GATHER ? 1 + 128 : 1);
      mbar_init(&empty[s], 2);          // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: thread 0 issues the TMA loads; with GATHER every thread
    // copies 8 rows' 16-byte chunk t128 % 8 of each x tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(CORE_PRODUCER_REGS));
    if (!GATHER && t128 != 0) return;
    const int chunk = t128 & 7;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int row0 = (t / ranges) * CORE_BM, range = t % ranges;
      const int col_lo = range * k_tile, col_hi = min(k, col_lo + k_tile);
      for (int col0 = col_lo; col0 < col_hi; col0 += CORE_BN) {
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1u);
          unsigned char* xs = ring + stage * CORE_STAGE_BYTES;
          if (t128 == 0) {
            mbar_expect_tx(&full[stage], GATHER ? CORE_C_BYTES : CORE_STAGE_BYTES);
            if constexpr (!GATHER) tma_load_2d(xs, &x_map, &full[stage], kb * CORE_BK, row0);
            tma_load_2d(xs + CORE_X_BYTES, &c_map, &full[stage], kb * CORE_BK, col0);
          }
          if constexpr (GATHER) {
            // Tile row r is listed row rows[row0 + r], its index re-read
            // from L1 each stage and the rows copied one at a time, so the
            // producer stays within its 40 registers.
            const int f = kb * CORE_BK + chunk * 8;
#pragma unroll 1
            for (int i = 0; i < 8; ++i) {
              const int r = (t128 >> 3) + 16 * i;
              const int src = row0 + r < m && f < d ? __ldg(rows + row0 + r) : -1;
              cp_async_16(xs + r * (CORE_BK * 2) + ((chunk ^ (r & 7)) << 4),
                          x + (src >= 0 ? (size_t)src * d + f : 0), src >= 0 ? 16 : 0);
            }
            cp_async_arrive(&full[stage]);
          }
          if (++stage == CORE_STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    if constexpr (GATHER) asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // A consumer: rows cw*64 .. cw*64 + 63 of each tile.  Thread t of the
    // warpgroup holds rows 16*(t/32) + (t%32)/4 (+8) and, in n8 chunk j,
    // columns 8j + 2(t%4) (+1): acc[4j + 2h + e] is (row + 8h, column + e).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CORE_CONSUMER_REGS));
    const int cw = wg - 1, lane = threadIdx.x & 31;
    const int r_lo = cw * 64 + (t128 >> 5) * 16 + (lane >> 2);
    const int c_lo = (lane & 3) * 2;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int row0 = (t / ranges) * CORE_BM, range = t % ranges;
      const int col_lo = range * k_tile, col_hi = min(k, col_lo + k_tile);
      // Each row's triple, carried across the range's sub-slices.
      float run_best[2] = {INFINITY, INFINITY}, run_second[2] = {INFINITY, INFINITY};
      int run_idx[2] = {col_lo, col_lo};
      for (int col0 = col_lo; col0 < col_hi; col0 += CORE_BN) {
        int held = -1;                  // the stage whose wgmma group is in flight
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&full[stage], phase);
          // cp.async writes through the generic proxy; wgmma reads through
          // the async proxy.
          if constexpr (GATHER) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
        core_scan_slice<CORE_BN / 8, SECOND>(acc, csq, col0, col_hi, c_lo, run_best, run_idx,
                                             run_second);
      }
      core_write_parts<SECOND>(run_best, run_idx, run_second, row0, r_lo, lane, m, n, range,
                               part_best, part_idx, part_second);
    }
  }
}

// ---------------------------------------------------------------------------
// The core's f32 route: f32 x in f32 compute (d % 4 == 0, 16-byte-aligned
// bases), K1, K2, K4 and K5 alike.  The reference computes every f32
// product at Precision.HIGHEST, which on its own chip is six bf16 passes
// (jax.lax.Precision's own documentation; DotAlgorithmPreset
// BF16_BF16_F32_X6): each f32 operand is split exactly into three bf16
// pieces, v = v1 + v2 + v3, and x1c1 + x1c2 + x2c1 + x1c3 + x2c2 + x3c1 is
// summed in f32; the dropped products are each below 2^-24 of |x.c|.  This
// route runs the same six products on wgmma.  What bounds it: 6 x 2*n*d*k
// bf16 operations (31.5 TFLOP at the headline shape: >= 31.8 ms at 989
// TFLOP/s), against 67 TFLOP/s for any f32 FMA kernel (>= 78 ms there).
// Relative to the bf16 core it adds:
//   * operands: -2C's three pieces (3, k, d8) bf16 are split by the wrapper
//     (d8 = d rounded up to 8, zero columns past d) and come by one 3-D TMA
//     load a stage (64-byte swizzle, 32 features of 128 centroids a piece).
//     x comes as f32 -- by TMA (128-byte swizzle, 32 features of 128 rows),
//     or for K4's gathered rows by cp.async, 16 bytes each, into the same
//     layout -- into a ring of C32_XSTAGES tiles of its own, loaded
//     C32_XSTAGES - 1 stages ahead, and the producer warpgroup splits each
//     tile into three bf16 tiles in the stage (64-byte swizzle, the layout
//     TMA gives the C pieces): x is never split in device memory, which
//     would be 1.5x an f32 x more to read.  The split is cvt.rn.bf16x2 and
//     an exact f32 subtraction, twice (split_bf16x3 in cuda_lloyd.py, the
//     same bits), bank-conflict free on both sides;
//   * accumulation: per 16-feature step each consumer warpgroup issues the
//     five correction products, smallest first, into one accumulator and
//     then x1c1 into another (m64n128k16: 64 + 64 registers a thread, so a
//     sub-slice is 128 columns), and the epilogue adds the two once:
//     the tensor core's accumulation, which aligns to the largest addend
//     and truncates, never mixes the small terms into the large sum, and
//     x1c1 alone carries the bf16 core's error (all six in one
//     accumulator measured 1.0-1.5e-5 of the row scale against f64, over
//     SCORE_RTOL, and no faster);
//   * the epilogue is the bf16 core's (core_scan_slice), over 128 columns:
//     csq + (x1c1 + corrections), +inf past the range, the lowest-index
//     argmin and the second-min carried in registers, the ranges merged in
//     order by the finishing launches.  K1, K2 and K4 take 256-column
//     ranges (two sub-slices), as on the bf16 core, so their part buffers
//     are the same shape, and a column's sum does not depend on the range:
//     K1, K2, K4 and K5 give a row the same bits.  Against score_block's
//     IEEE f32 FMA the scores agree to the f32 tolerance, not bit for bit.
// ---------------------------------------------------------------------------
constexpr int C32_BN = 128;                      // centroids of a sub-slice
constexpr int C32_BK = 32;                       // features a stage: 128 bytes of f32 x
constexpr int C32_STAGES = 3;                    // the pieces ring
constexpr int C32_XSTAGES = 4;                   // the f32 x ring
constexpr int C32_XF_BYTES = CORE_BM * C32_BK * 4;        // an f32 x tile
constexpr int C32_XP_BYTES = CORE_BM * C32_BK * 2;        // one bf16 piece of it
constexpr int C32_CP_BYTES = C32_BN * C32_BK * 2;         // one bf16 piece of a -2C tile
constexpr int C32_STAGE_BYTES = 3 * (C32_XP_BYTES + C32_CP_BYTES);
// Dynamic shared memory: the pieces ring, the x ring and the alignment
// slack; kmeans_tpu_torch/ops/plan.py prices it, with the rings' 14
// mbarriers, as CORE_F32_SMEM_BYTES.
constexpr int CORE32_SMEM = C32_STAGES * C32_STAGE_BYTES + C32_XSTAGES * C32_XF_BYTES + 1024;
// The producer warpgroup splits x, so it keeps more registers than the
// bf16 core's; the consumers hold 128 accumulators, not 128 + 128.
constexpr int C32_PRODUCER_REGS = 88;
constexpr int C32_CONSUMER_REGS = 208;
static_assert(128 * (168 - C32_PRODUCER_REGS) >= 256 * (C32_CONSUMER_REGS - 168),
              "the consumers' setmaxnreg.inc would wait forever");
static_assert(CORE32_SMEM + 14 * 8 <= 232448, "the f32 core's rings overflow shared memory");

// wgmma shared-memory descriptor of a K-major bf16 tile with 64-byte rows
// and the 64-byte swizzle: 8-row groups 512 bytes apart (SBO).
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

// A 3-D TMA load of the box at (c0, c1, c2) of map into dst, completing on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// d (+)= A . B^T over 16 features: A 64 rows of an x piece, B 128 rows of a
// -2C piece, both K-major in shared memory (64-byte swizzle); scale_d == 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two f32 values split exactly into three bf16 pairs (see above).
__device__ __forceinline__ void split3(float a, float b, uint32_t& p0, uint32_t& p1,
                                       uint32_t& p2) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(a, b);
  const float2 f0 = __bfloat1622float2(h0);
  const float ra = __fsub_rn(a, f0.x), rb = __fsub_rn(b, f0.y);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(ra, rb);
  const float2 f1 = __bfloat1622float2(h1);
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(__fsub_rn(ra, f1.x), __fsub_rn(rb, f1.y));
  p0 = bf2_bits(h0);
  p1 = bf2_bits(h1);
  p2 = bf2_bits(h2);
}

// A block's walk over its work, in the order the consumers score it:
// tiles t = blockIdx.x, + gridDim.x, ... (row-block-major), each range's
// 128-column sub-slices, each sub-slice's 32-feature blocks.
struct Walk32 {
  int tiles, ranges, kblocks, k, k_tile;
  int t, col0, kb;
  __device__ __forceinline__ Walk32(int tiles_, int ranges_, int kblocks_, int k_, int k_tile_)
      : tiles(tiles_), ranges(ranges_), kblocks(kblocks_), k(k_), k_tile(k_tile_),
        t(blockIdx.x), col0((blockIdx.x % ranges_) * k_tile_), kb(0) {}
  __device__ __forceinline__ bool valid() const { return t < tiles; }
  __device__ __forceinline__ int row0() const { return (t / ranges) * CORE_BM; }
  __device__ __forceinline__ void next() {
    if (++kb < kblocks) return;
    kb = 0;
    col0 += C32_BN;
    if (col0 < min(k, (t % ranges) * k_tile + k_tile)) return;
    t += gridDim.x;
    col0 = (t % ranges) * k_tile;
  }
};

// core_score_kernel's f32 route (see above): the same arguments, x in f32,
// c_map over -2C's three bf16 pieces.
template <bool GATHER, bool SECOND>
__global__ void __launch_bounds__(CORE_THREADS, 1)
core32_score_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap c_map, const float* __restrict__ csq,
                    const float* __restrict__ x, const int* __restrict__ rows,
                    const int* __restrict__ count, int n, int d, int k, int k_tile,
                    float* __restrict__ part_best, int* __restrict__ part_idx,
                    float* __restrict__ part_second) {
  extern __shared__ __align__(1024) unsigned char core_smem[];
  __shared__ __align__(8) uint64_t full[C32_STAGES], empty[C32_STAGES];
  __shared__ __align__(8) uint64_t xfull[C32_XSTAGES], xempty[C32_XSTAGES];
  unsigned char* ring = core_smem + ((1024u - (smem_u32(core_smem) & 1023u)) & 1023u);
  unsigned char* xring = ring + C32_STAGES * C32_STAGE_BYTES;
  const int m = GATHER ? *count : n;     // rows to score
  const int ranges = (k + k_tile - 1) / k_tile;
  const int tiles = ((m + CORE_BM - 1) / CORE_BM) * ranges;   // row-block-major
  const int kblocks = (d + C32_BK - 1) / C32_BK;
  const int wg = threadIdx.x >> 7, t128 = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C32_STAGES; ++s) {
      mbar_init(&full[s], 1 + 128);     // the C pieces' TMA and the 128 splitting threads
      mbar_init(&empty[s], 2);          // one arrival from each consumer warpgroup
    }
    for (int s = 0; s < C32_XSTAGES; ++s) {
      mbar_init(&xfull[s], GATHER ? 128 : 1);   // each copying thread, or the TMA's
      mbar_init(&xempty[s], 128);               // each splitting thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: thread 0 issues the TMA loads (with GATHER every thread
    // copies 8 rows' 16-byte chunk t128 % 8 of each x tile), x tiles
    // C32_XSTAGES - 1 stages ahead; every thread splits 4 16-byte chunks
    // (8 features of a row) of each tile into the three pieces.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C32_PRODUCER_REGS));
    const int chunk = t128 & 7;
    const CUtensorMap* xm = &x_map;
    Walk32 cv(tiles, ranges, kblocks, k, k_tile), ld = cv;
    int loads = 0;
    auto load_x = [&]() {
      const int slot = loads % C32_XSTAGES;
      unsigned char* xf = xring + slot * C32_XF_BYTES;
      if (GATHER || t128 == 0) mbar_wait(&xempty[slot], ((loads / C32_XSTAGES) & 1) ^ 1u);
      if constexpr (GATHER) {
        const int f = ld.kb * C32_BK + chunk * 4, row0 = ld.row0();
#pragma unroll 1
        for (int i = 0; i < 8; ++i) {
          const int r = (t128 >> 3) + 16 * i;
          const int src = row0 + r < m && f < d ? __ldg(rows + row0 + r) : -1;
          cp_async_16(xf + r * (C32_BK * 4) + ((chunk ^ (r & 7)) << 4),
                      x + (src >= 0 ? (size_t)src * d + f : 0), src >= 0 ? 16 : 0);
        }
        cp_async_arrive(&xfull[slot]);
      } else if (t128 == 0) {
        mbar_expect_tx(&xfull[slot], C32_XF_BYTES);
        tma_load_2d(xf, xm, &xfull[slot], ld.kb * C32_BK, ld.row0());
      }
      ++loads;
      ld.next();
    };
    for (int i = 0; i < C32_XSTAGES - 1 && ld.valid(); ++i) load_x();
    for (int i = 0; cv.valid(); ++i, cv.next()) {
      if (ld.valid()) load_x();
      const int stage = i % C32_STAGES;
      mbar_wait(&empty[stage], ((i / C32_STAGES) & 1) ^ 1u);
      unsigned char* st = ring + stage * C32_STAGE_BYTES;
      if (t128 == 0) {
        mbar_expect_tx(&full[stage], 3 * C32_CP_BYTES);
        tma_load_3d(st + 3 * C32_XP_BYTES, &c_map, &full[stage], cv.kb * C32_BK, cv.col0, 0);
      }
      const int slot = i % C32_XSTAGES;
      mbar_wait(&xfull[slot], (i / C32_XSTAGES) & 1);
      const unsigned char* xf = xring + slot * C32_XF_BYTES;
#pragma unroll 1
      for (int u = t128; u < CORE_BM * 4; u += 128) {
        // Row r's 16-byte output chunk c: features 8c .. 8c + 7, the f32
        // chunks 2c and 2c + 1 of the 128-byte-swizzled tile.
        const int r = u >> 2, c = u & 3;
        const float4 a =
            *reinterpret_cast<const float4*>(xf + r * 128 + (((2 * c) ^ (r & 7)) << 4));
        const float4 b =
            *reinterpret_cast<const float4*>(xf + r * 128 + (((2 * c + 1) ^ (r & 7)) << 4));
        uint4 q0, q1, q2;
        split3(a.x, a.y, q0.x, q1.x, q2.x);
        split3(a.z, a.w, q0.y, q1.y, q2.y);
        split3(b.x, b.y, q0.z, q1.z, q2.z);
        split3(b.z, b.w, q0.w, q1.w, q2.w);
        const int o = r * (C32_BK * 2) + ((c ^ ((r >> 1) & 3)) << 4);
        *reinterpret_cast<uint4*>(st + o) = q0;
        *reinterpret_cast<uint4*>(st + C32_XP_BYTES + o) = q1;
        *reinterpret_cast<uint4*>(st + 2 * C32_XP_BYTES + o) = q2;
      }
      mbar_arrive(&xempty[slot]);
      // The pieces were written through the generic proxy; wgmma reads
      // through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[stage]);
    }
    if constexpr (GATHER) asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // A consumer: rows cw*64 .. cw*64 + 63 of each tile, the bf16 core's
    // fragment layout over 128 columns.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C32_CONSUMER_REGS));
    const int cw = wg - 1, lane = threadIdx.x & 31;
    const int r_lo = cw * 64 + (t128 >> 5) * 16 + (lane >> 2);
    const int c_lo = (lane & 3) * 2;
    float acc[64], acc_c[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_c[i] = 0.f;
    int i = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int row0 = (t / ranges) * CORE_BM, range = t % ranges;
      const int col_lo = range * k_tile, col_hi = min(k, col_lo + k_tile);
      float run_best[2] = {INFINITY, INFINITY}, run_second[2] = {INFINITY, INFINITY};
      int run_idx[2] = {col_lo, col_lo};
      for (int col0 = col_lo; col0 < col_hi; col0 += C32_BN) {
        int held = -1;                  // the stage whose wgmma group is in flight
        for (int kb = 0; kb < kblocks; ++kb, ++i) {
          const int stage = i % C32_STAGES;
          mbar_wait(&full[stage], (i / C32_STAGES) & 1);
          const unsigned char* st = ring + stage * C32_STAGE_BYTES;
          uint64_t xa[3], cb[3];
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            xa[p] = sw64_desc(st + p * C32_XP_BYTES + cw * 64 * (C32_BK * 2));
            cb[p] = sw64_desc(st + 3 * C32_XP_BYTES + p * C32_CP_BYTES);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < C32_BK / 16; ++kk) {   // 16 features = 32 bytes = 2 units
            const int acc_on = (kb > 0 || kk > 0) ? 1 : 0;
            const int u = 2 * kk;
            wgmma_m64n128k16(acc_c, xa[2] + u, cb[0] + u, acc_on);
            wgmma_m64n128k16(acc_c, xa[1] + u, cb[1] + u, 1);
            wgmma_m64n128k16(acc_c, xa[0] + u, cb[2] + u, 1);
            wgmma_m64n128k16(acc_c, xa[1] + u, cb[0] + u, 1);
            wgmma_m64n128k16(acc_c, xa[0] + u, cb[1] + u, 1);
            wgmma_m64n128k16(acc, xa[0] + u, cb[0] + u, acc_on);
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (held >= 0 && t128 == 0) mbar_arrive(&empty[held]);
          held = stage;
        }
        wgmma_wait<0>();
        if (t128 == 0) mbar_arrive(&empty[held]);
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[j] = __fadd_rn(acc[j], acc_c[j]);
        core_scan_slice<C32_BN / 8, SECOND>(acc, csq, col0, col_hi, c_lo, run_best, run_idx,
                                            run_second);
      }
      core_write_parts<SECOND>(run_best, run_idx, run_second, row0, r_lo, lane, m, n, range,
                               part_best, part_idx, part_second);
    }
  }
}

// K2's finishing launch after the core: a warp per row merges the slices
// (strict '<' in increasing slice order) and runs K2's row epilogue.
template <class XT>
__global__ void __launch_bounds__(NT)
core_delta_finish_kernel(const XT* __restrict__ x, const float* __restrict__ part_best,
                         const int* __restrict__ part_idx, int slices,
                         const float* __restrict__ w, const int* __restrict__ prev, int n, int d,
                         int with_mind, int* __restrict__ labels, float* __restrict__ mind,
                         float* __restrict__ fold_w, int* __restrict__ n_changed,
                         int* __restrict__ group_counts) {
  __shared__ int s_changed;
  if (threadIdx.x == 0) s_changed = 0;
  __syncthreads();
  const int row0 = (int)(((size_t)blockIdx.x * NT) >> 5);
  const int gr = row0 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (gr < n) {
    float best, unused;
    int lab;
    merge_parts(part_best, part_idx, nullptr, slices, n, gr, best, lab, unused);
    if (delta_row(x, w, prev, gr, d, with_mind, lab, best, lane, labels, mind, fold_w) &&
        lane == 0)
      atomicAdd(&s_changed, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_changed > 0) {
    atomicAdd(n_changed, s_changed);
    atomicAdd(group_counts + row0 / GROUP_ROWS, s_changed);
  }
}

// K4 on the core, launch 1 of 5: each 1024-row group's needed-row count;
// the rows not needed pass prev / sb_in / slb_in through, with a fold
// weight of 0.
__global__ void __launch_bounds__(NT)
hamerly_count_kernel(const unsigned char* __restrict__ need, const int* __restrict__ prev,
                     const float* __restrict__ sb_in, const float* __restrict__ slb_in, int n,
                     int* __restrict__ labels, float* __restrict__ sb, float* __restrict__ slb,
                     float* __restrict__ fold_w, int* __restrict__ group_counts) {
  const int count = compact_group(
      need, blockIdx.x * GROUP_ROWS, n, [](int, int) {},
      [&](int gr) {
        labels[gr] = prev[gr];
        sb[gr] = sb_in[gr];
        slb[gr] = slb_in[gr];
        fold_w[gr] = 0.f;
      });
  if (threadIdx.x == 0) group_counts[blockIdx.x] = count;
}

// Launch 2 of 5 (one block): out = the exclusive prefix sums of in[0, m),
// *total = their sum -- the needed-row count the core reads.
__global__ void __launch_bounds__(SCAN_NT)
exclusive_scan_kernel(const int* __restrict__ in, int m, int* __restrict__ out,
                      int* __restrict__ total) {
  __shared__ int s[SCAN_NT];
  const int t = threadIdx.x;
  const int per = (m + SCAN_NT - 1) / SCAN_NT;
  const int b0 = min(m, t * per), b1 = min(m, b0 + per);
  int a = 0;
  for (int b = b0; b < b1; ++b) a += in[b];
  s[t] = a;
  __syncthreads();
  for (int off = 1; off < SCAN_NT; off <<= 1) {
    const int v = t >= off ? s[t - off] : 0;
    __syncthreads();
    s[t] += v;
    __syncthreads();
  }
  a = s[t] - a;
  for (int b = b0; b < b1; ++b) {
    out[b] = a;
    a += in[b];
  }
  if (t == SCAN_NT - 1) *total = s[t];
}

// Launch 3 of 5: the needed rows listed in increasing row order.
__global__ void __launch_bounds__(NT)
hamerly_list_kernel(const unsigned char* __restrict__ need, int n,
                    const int* __restrict__ group_start, int* __restrict__ rows) {
  int* out = rows + group_start[blockIdx.x];
  compact_group(
      need, blockIdx.x * GROUP_ROWS, n, [&](int slot, int gr) { out[slot] = gr; }, [](int) {});
}

// Launch 5 of 5, after the core's gathered scoring (4 of 5): a thread per
// listed row merges its slices with the second-min and runs K4's row
// epilogue.
__global__ void __launch_bounds__(NT)
core_hamerly_finish_kernel(const int* __restrict__ rows, const int* __restrict__ count,
                           const float* __restrict__ part_best,
                           const int* __restrict__ part_idx,
                           const float* __restrict__ part_second, int slices, int n,
                           const float* __restrict__ w, const int* __restrict__ prev,
                           int* __restrict__ labels, float* __restrict__ sb,
                           float* __restrict__ slb, float* __restrict__ fold_w) {
  const int slot = (int)(blockIdx.x * (size_t)NT + threadIdx.x);
  if (slot >= *count) return;
  float best, second;
  int lab;
  merge_parts(part_best, part_idx, part_second, slices, n, slot, best, lab, second);
  hamerly_row(w, prev, rows[slot], lab, best, second, labels, sb, slb, fold_w);
}

// ---------------------------------------------------------------------------
// The fold core: K6's single and dual folds, K3, and K1's fold.
//
// K6 -- replaces kmeans_tpu/ops/pallas_lloyd.py::_tiled_fold
// (_tiled_fold_kernel); K3 -- replaces accumulate_pallas (_acc_kernel).  In
// the reference both are _fold_tile, and K3 adds min_d2 = max(scores +
// ||x||^2, 0) from the same read of x; here one core serves both, and K1's
// fold.  Bound on an H100: bytes -- one read of each folded row (5.24 GB
// for a full fold at n = 1.28M, d = 2048 in bf16) and one write of the f32
// sums (8 MB at k = 1000, 512 MiB at k = 65536): >= 1.57 ms at the headline
// shape, >= 1.72 ms at the codebook shape, at 3.35 TB/s.
//
// A fold entry is a row's +w at lab and, in the dual mode, its -w at lab2
// (entry e = row * S + side, S = 1 or 2).  Its key is its bucket, or k for
// an entry that folds nothing (w == 0, a label outside [0, k), and in the
// dual mode lab == lab2).  The launches, in integer arithmetic until the
// sum and with no float atomics anywhere:
//   1. a stable LSD radix sort of (key, entry) by SORT_BITS-bit digits,
//      ceil(bits(k) / 8) passes of three launches: sort_hist (each tile of
//      SORT_TILE entries counts its digits in shared memory, a warp's equal
//      digits counted once with __match_any_sync, and writes the counts
//      digit-major), sort_digit_scan (a block a digit: each tile's offset
//      within the digit, and the digit's total), sort_scatter (each warp
//      ranks its 512 consecutive entries with __match_any_sync and
//      per-warp counters in shared memory and scans the 256 digit totals
//      itself, so a digit's entries keep entry order within the tile and
//      across tiles).  Nothing grows with (chunks x k), and every launch
//      fills the card: a tile is a block.  Keys end sorted with entries in
//      increasing order within a bucket -- each bucket in row order -- and
//      the excluded entries (key k) last;
//   2. fold_start: each bucket's first position in the sorted list (a
//      binary search a bucket; start[k] is the count of folded entries);
//   3. fold: a block for each (chunk of FOLD_CHUNK consecutive sorted
//      entries, FOLD_SPAN columns) -- no search: its chunk is its
//      blockIdx.x, and it finds each next bucket by stepping forward
//      through the chunk.  It sums each run of one bucket in order, in
//      f32, as __fadd_rn(acc, __fmul_rn(w, float(cd(x)))), the count as
//      the sum of w.  A run that is its whole bucket is written to the sums
//      directly; the runs of a bucket that crosses a chunk edge go to
//      partial rows (slot 0 for the run at the chunk's start, slot 1 for
//      the one at its end).  Chunks past the folded entries return at once
//      (the dual fold at a steady churn), unless the norms are asked for.
//      With VEC (d % 8 == 0, 16-byte-aligned x) each thread keeps its
//      FOLD_COLS columns of the next 16 rows (8 in f32) in flight with
//      cp.async into a 64 KB shared-memory ring that it alone reads back,
//      one commit group a row, so the loads never wait on the sums and no
//      barrier guards a slot; otherwise a thread loads columns a stride
//      of NT apart (the same order for any d);
//   4. fold_combine: a warp per (bucket, 512 columns) writes an empty
//      bucket's zeros and sums a crossing bucket's partial rows in chunk
//      order; a bucket inside one chunk is already written.
// With norms (K3, and K1 after a raw merge) every row is one entry, the
// excluded ones included, and the fold block also reduces each row's
// ||x||^2 from the same registers in a fixed order (a thread's columns in
// order with fmaf, the warp's butterfly, the warps in order, the column
// spans in order) and writes min_d2 = max(scores + ||x||^2, 0); past one
// column span the spans' sums go to sq_part and fold_norm_finish adds
// them.  Every step is in a fixed order, so two launches give the same
// bits, and K3's and K1's sums and counts are K6's single fold's.
// ---------------------------------------------------------------------------
constexpr int SORT_BITS = 8;
constexpr int SORT_BINS = 1 << SORT_BITS;
constexpr int SORT_WARP_ENTRIES = 512;                  // a warp's run of a tile
constexpr int SORT_ROUNDS = SORT_WARP_ENTRIES / 32;
constexpr int SORT_TILE = NWARP * SORT_WARP_ENTRIES;    // entries a sort block takes
constexpr int FOLD_CHUNK = 256;                         // sorted entries a fold block sums
constexpr int FOLD_COLS = 8;                            // columns a fold thread sums
constexpr int FOLD_SPAN = NT * FOLD_COLS;               // columns a fold block sums
constexpr int FOLD_BATCH = 8;                           // rows a norm reduction takes
constexpr int COMBINE_COLS = 512;                       // columns a combine warp writes

// Entry e's key: its bucket, or k when it folds nothing.
template <bool DUAL>
__device__ __forceinline__ int fold_key(const int* __restrict__ lab, const int* __restrict__ lab2,
                                        const float* __restrict__ w, int e, int k) {
  const int row = DUAL ? e >> 1 : e;
  if (w[row] == 0.f) return k;
  int b = lab[row];
  if constexpr (DUAL) {
    const int p = lab2[row];
    if (b == p) return k;
    if (e & 1) b = p;
  }
  return (b >= 0 && b < k) ? b : k;
}

// Sort pass, launch 1 of 3: the digit counts of each tile, digit-major
// (hist[digit * tiles + tile]).  FIRST takes the keys from the labels.
template <bool FIRST, bool DUAL>
__global__ void __launch_bounds__(NT)
sort_hist_kernel(const int* __restrict__ lab, const int* __restrict__ lab2,
                 const float* __restrict__ w, const int* __restrict__ keys, int entries, int k,
                 int shift, int tiles, int* __restrict__ hist) {
  __shared__ int s_hist[SORT_BINS];
  for (int b = threadIdx.x; b < SORT_BINS; b += NT) s_hist[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < SORT_TILE; i += NT) {
    const int e = blockIdx.x * SORT_TILE + i;
    int digit = -1;
    if (e < entries)
      digit = ((FIRST ? fold_key<DUAL>(lab, lab2, w, e, k) : keys[e]) >> shift) & (SORT_BINS - 1);
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    if (digit >= 0 && lane == __ffs(peers) - 1) atomicAdd(&s_hist[digit], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < SORT_BINS; b += NT)
    hist[(size_t)b * tiles + blockIdx.x] = s_hist[b];
}

// The exclusive prefix sum of v over the block's NT threads; total gets
// the block's sum.  Ends with a barrier.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int base = 0;
  total = 0;
  for (int v2 = 0; v2 < NWARP; ++v2) {
    const int t = s_warp[v2];
    base += v2 < warp ? t : 0;
    total += t;
  }
  __syncthreads();
  return base + inc - v;
}

// Sort pass, launch 2 of 3: a block a digit turns its row of hist into
// each tile's offset within the digit (in place) and writes the digit's
// total.
__global__ void __launch_bounds__(NT)
sort_digit_scan_kernel(int* __restrict__ hist, int tiles, int* __restrict__ digit_total) {
  __shared__ int s_warp[NWARP];
  int* row = hist + (size_t)blockIdx.x * tiles;
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += NT) {
    const int t = t0 + threadIdx.x;
    const int v = t < tiles ? row[t] : 0;
    int total;
    const int ex = block_exclusive_scan(v, s_warp, total);
    if (t < tiles) row[t] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) digit_total[blockIdx.x] = carry;
}

static_assert(SORT_BINS == NT, "sort_scatter scans the digit totals a thread a digit");

// Sort pass, launch 3 of 3: each entry to (the digits below its own) +
// offs[digit * tiles + tile] + its rank among the tile's entries of that
// digit, in entry order.
template <bool FIRST, bool DUAL>
__global__ void __launch_bounds__(NT)
sort_scatter_kernel(const int* __restrict__ lab, const int* __restrict__ lab2,
                    const float* __restrict__ w, const int* __restrict__ keys_in,
                    const int* __restrict__ vals_in, int entries, int k, int shift, int tiles,
                    const int* __restrict__ offs, const int* __restrict__ digit_total,
                    int* __restrict__ keys_out, int* __restrict__ vals_out) {
  __shared__ int s_cnt[NWARP][SORT_BINS];
  __shared__ int s_base[SORT_BINS];
  __shared__ int s_warp[NWARP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < NWARP * SORT_BINS; i += NT) (&s_cnt[0][0])[i] = 0;
  int unused;
  s_base[threadIdx.x] = block_exclusive_scan(digit_total[threadIdx.x], s_warp, unused);
  const int e0 = blockIdx.x * SORT_TILE + warp * SORT_WARP_ENTRIES;
  int key[SORT_ROUNDS], val[SORT_ROUNDS], rank[SORT_ROUNDS];
#pragma unroll
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const int e = e0 + r * 32 + lane;
    int digit = -1;
    key[r] = 0;
    val[r] = 0;
    if (e < entries) {
      key[r] = FIRST ? fold_key<DUAL>(lab, lab2, w, e, k) : keys_in[e];
      val[r] = FIRST ? e : vals_in[e];
      digit = (key[r] >> shift) & (SORT_BINS - 1);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    const int base = digit >= 0 ? s_cnt[warp][digit] : 0;
    rank[r] = base + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
    if (digit >= 0 && lane == __ffs(peers) - 1) s_cnt[warp][digit] = base + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // A digit's first slot for each warp: the tile's slot, then the warps
  // before it in order.
  for (int b = threadIdx.x; b < SORT_BINS; b += NT) {
    int run = s_base[b] + offs[(size_t)b * tiles + blockIdx.x];
    for (int v = 0; v < NWARP; ++v) {
      const int c = s_cnt[v][b];
      s_cnt[v][b] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    if (e0 + r * 32 + lane < entries) {
      const int pos = s_cnt[warp][(key[r] >> shift) & (SORT_BINS - 1)] + rank[r];
      keys_out[pos] = key[r];
      vals_out[pos] = val[r];
    }
  }
}

// start[b] = the first sorted position whose key is >= b, for b in [0, k].
__global__ void __launch_bounds__(NT)
fold_start_kernel(const int* __restrict__ keys, int entries, int k, int* __restrict__ start) {
  const int b = (int)(blockIdx.x * (size_t)NT + threadIdx.x);
  if (b > k) return;
  int lo = 0, hi = entries;
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (keys[mid] < b) lo = mid + 1; else hi = mid;
  }
  start[b] = lo;
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The fold's ring (VEC): each thread's FOLD_COLS columns of FOLD_RING rows
// in flight, copied with cp.async and read back by the same thread only, so
// no barrier guards a slot: 64 KB a block, 16 rows a thread in bf16, 8 in
// f32.
constexpr int FOLD_RING_BYTES = 64 * 1024;

// The fold (see above).  s_key[i + 1] is the key at chunk position i, for
// i in [-1, cnt]; -1 outside the list.
template <class XT, class CT, bool VEC, bool NORM>
__global__ void __launch_bounds__(NT)
fold_kernel(const XT* __restrict__ x, const float* __restrict__ w, const int* __restrict__ keys,
            const int* __restrict__ vals, int entries, int dual, int n, int d, int k,
            const float* scores, float* mind, float* __restrict__ sq_part,
            float* __restrict__ sums, float* __restrict__ counts, float* __restrict__ part,
            float* __restrict__ part_counts) {
  constexpr int SEG = FOLD_COLS * (int)sizeof(XT);    // a thread's bytes of a row
  constexpr int RING = FOLD_RING_BYTES / (NT * SEG);   // rows in flight a thread
  extern __shared__ __align__(16) unsigned char fold_ring[];
  __shared__ int s_key[FOLD_CHUNK + 2];
  __shared__ int s_row[FOLD_CHUNK];
  __shared__ float s_w[FOLD_CHUNK];
  __shared__ float s_sq[FOLD_BATCH][NWARP];
  const int chunk = blockIdx.x;
  const int c0 = chunk * FOLD_CHUNK;
  const int cnt = min(FOLD_CHUNK, entries - c0);
  if (!NORM && keys[c0] == k) return;            // only excluded entries from here on
  for (int i = threadIdx.x; i < cnt + 2; i += NT) {
    const int p = c0 + i - 1;
    s_key[i] = (p >= 0 && p < entries) ? keys[p] : -1;
    if (i >= 1 && i <= cnt) {
      const int v = vals[p];
      const int row = v >> dual;
      s_row[i - 1] = row;
      s_w[i - 1] = (v & dual) ? -w[row] : w[row];
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int colb = blockIdx.y * FOLD_SPAN;
  const int col = colb + threadIdx.x * FOLD_COLS;     // VEC: this thread's first column
  float acc[FOLD_COLS];
#pragma unroll
  for (int c = 0; c < FOLD_COLS; ++c) acc[c] = 0.f;
  float acc_w = 0.f;
  int run_key = s_key[1], run_a = 0, end = cnt;

  // Whether chunk position q's row is read: every row with the norms,
  // else the folded ones.
  auto reads = [&](int q) { return q < cnt && (NORM || s_key[q + 1] < k); };
  // VEC: copy position q's columns into its ring slot (one commit group a
  // position, empty past the chunk, so the groups count positions).
  auto issue = [&](int q) {
    if (reads(q) && col < d) {
      unsigned char* dst = fold_ring + ((q % RING) * NT + threadIdx.x) * SEG;
      const XT* src = x + (size_t)s_row[q] * d + col;
#pragma unroll
      for (int o = 0; o < SEG; o += 16)
        cp_async_16(dst + o, reinterpret_cast<const char*>(src) + o, 16);
    }
    cp_async_commit();
  };
  // Writes the run [a, b) of key: to the sums when it is its whole bucket,
  // else to the chunk's partial row for the run at its start (slot 0) or
  // end (slot 1).
  auto flush = [&](int key, int a, int b) {
    if (key >= k) return;
    const bool whole = s_key[a] != key && s_key[b + 1] != key;
    const size_t slot = 2 * (size_t)chunk + (a == 0 ? 0 : 1);
    fold_store<VEC>((whole ? sums + (size_t)key * d : part + slot * d), colb, d, acc);
    if (blockIdx.y == 0 && threadIdx.x == 0) (whole ? counts[key] : part_counts[slot]) = acc_w;
  };

  if constexpr (VEC)
    for (int q = 0; q < RING - 1; ++q) issue(q);
  for (int p = 0; p < cnt; p += FOLD_BATCH) {
    if (!NORM && s_key[p + 1] == k) {
      end = p;
      break;
    }
    float sq[FOLD_BATCH];
#pragma unroll
    for (int u = 0; u < FOLD_BATCH; ++u) {
      const int q = p + u;
      float v[FOLD_COLS];
#pragma unroll
      for (int c = 0; c < FOLD_COLS; ++c) v[c] = 0.f;
      if constexpr (VEC) {
        issue(q + RING - 1);
        cp_async_wait<RING - 1>();          // position q's group has landed
        if (reads(q) && col < d) {
          const unsigned char* src = fold_ring + ((q % RING) * NT + threadIdx.x) * SEG;
          if constexpr (std::is_same<XT, bf16>::value) {
            const uint4 raw = *reinterpret_cast<const uint4*>(src);
            const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
            for (int c = 0; c < FOLD_COLS; ++c) v[c] = __bfloat162float(h[c]);
          } else {
            const float4 lo = reinterpret_cast<const float4*>(src)[0];
            const float4 hi = reinterpret_cast<const float4*>(src)[1];
            v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
            v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
          }
        }
      } else if (reads(q)) {
        fold_load<XT, false>(x + (size_t)s_row[q] * d, colb, d, v);
      }
      if (q < cnt) {
        const int key = s_key[q + 1];
        if (key != run_key) {
          flush(run_key, run_a, q);
          run_key = key;
          run_a = q;
#pragma unroll
          for (int c = 0; c < FOLD_COLS; ++c) acc[c] = 0.f;
          acc_w = 0.f;
        }
        if (key < k) {
          const float wr = s_w[q];
          // float(cd(x)): a bf16 x, and any x in f32 compute, is its own
          // rounding, so only f32 x in bf16 compute pays the conversions.
          constexpr bool ROUND = std::is_same<XT, float>::value && std::is_same<CT, bf16>::value;
#pragma unroll
          for (int c = 0; c < FOLD_COLS; ++c)
            acc[c] = __fadd_rn(acc[c], __fmul_rn(wr, ROUND ? cd_round<CT>(v[c]) : v[c]));
          acc_w = __fadd_rn(acc_w, wr);
        }
      }
      if constexpr (NORM) {
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < FOLD_COLS; ++c) sum = fmaf(v[c], v[c], sum);
        sq[u] = sum;
      }
    }
    if constexpr (NORM) {
#pragma unroll
      for (int u = 0; u < FOLD_BATCH; ++u) {
        const float sum = warp_sum(sq[u]);
        if (lane == 0) s_sq[u][warp] = sum;
      }
      __syncthreads();
      const int q = p + threadIdx.x;
      if (threadIdx.x < FOLD_BATCH && q < cnt) {
        float sum = 0.f;
        for (int v2 = 0; v2 < NWARP; ++v2) sum = __fadd_rn(sum, s_sq[threadIdx.x][v2]);
        const int row = s_row[q];
        if (gridDim.y == 1)
          mind[row] = fmaxf((scores != nullptr ? scores[row] : 0.f) + sum, 0.f);
        else
          sq_part[(size_t)blockIdx.y * n + row] = sum;
      }
      __syncthreads();
    }
  }
  flush(run_key, run_a, end);
  if constexpr (VEC) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A warp per (bucket, COMBINE_COLS columns): an empty bucket's zeros, or a
// crossing bucket's partial rows added in chunk order; a bucket inside one
// chunk was written by its fold block.
__global__ void __launch_bounds__(NT)
fold_combine_kernel(const int* __restrict__ start, int k, int d, const float* __restrict__ part,
                    const float* __restrict__ part_counts, float* __restrict__ sums,
                    float* __restrict__ counts) {
  constexpr int PER = COMBINE_COLS / 32;
  const int lane = threadIdx.x & 31;
  const int segs = (d + COMBINE_COLS - 1) / COMBINE_COLS;
  const long long items = (long long)k * segs;
  const long long stride = (long long)gridDim.x * (NT / 32);
  for (long long it = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5); it < items;
       it += stride) {
    const int b = (int)(it / segs), seg = (int)(it % segs);
    const int s = start[b], e = start[b + 1];
    const int j0 = s / FOLD_CHUNK, j1 = (e - 1) / FOLD_CHUNK;
    if (e > s && j0 == j1) continue;
    const int col0 = seg * COMBINE_COLS + lane;
    float acc[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = 0.f;
    float acc_w = 0.f;
    for (int j = j0; e > s && j <= j1; ++j) {
      const size_t slot = 2 * (size_t)j + (j == j0 && s != j0 * FOLD_CHUNK ? 1 : 0);
      const float* src = part + slot * d;
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (col0 + 32 * i < d) acc[i] = __fadd_rn(acc[i], src[col0 + 32 * i]);
      acc_w = __fadd_rn(acc_w, part_counts[slot]);
    }
    float* dst = sums + (size_t)b * d;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (col0 + 32 * i < d) dst[col0 + 32 * i] = acc[i];
    if (seg == 0 && lane == 0) counts[b] = acc_w;
  }
}

// min_d2 from the column spans' ||x||^2 sums, added in span order.
__global__ void __launch_bounds__(NT)
fold_norm_finish_kernel(const float* scores, const float* __restrict__ sq_part, int n,
                        int spans, float* mind) {
  const int row = (int)(blockIdx.x * (size_t)NT + threadIdx.x);
  if (row >= n) return;
  float s = sq_part[row];
  for (int j = 1; j < spans; ++j) s = __fadd_rn(s, sq_part[(size_t)j * n + row]);
  mind[row] = fmaxf((scores != nullptr ? scores[row] : 0.f) + s, 0.f);
}

template <class F>
int set_smem(F kern, int bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// One pass of the radix sort: hist, digit scan, scatter (hist holds the
// (digit, tile) counts, then their offsets within the digit, then the
// SORT_BINS digit totals).
template <bool FIRST, bool DUAL>
int sort_pass(const int* lab, const int* lab2, const float* w, const int* keys_in,
              const int* vals_in, int entries, int k, int shift, int tiles, int* hist,
              int* keys_out, int* vals_out, cudaStream_t stream) {
  int* digit_total = hist + (size_t)SORT_BINS * tiles;
  sort_hist_kernel<FIRST, DUAL><<<tiles, NT, 0, stream>>>(lab, lab2, w, keys_in, entries, k,
                                                          shift, tiles, hist);
  if (int e = (int)cudaGetLastError()) return e;
  sort_digit_scan_kernel<<<SORT_BINS, NT, 0, stream>>>(hist, tiles, digit_total);
  if (int e = (int)cudaGetLastError()) return e;
  sort_scatter_kernel<FIRST, DUAL><<<tiles, NT, 0, stream>>>(
      lab, lab2, w, keys_in, vals_in, entries, k, shift, tiles, hist, digit_total, keys_out,
      vals_out);
  return (int)cudaGetLastError();
}

// The fold core's launches (see above); mind != nullptr asks for the norms
// and min_d2 = max(scores + ||x||^2, 0) (single fold only; scores may be
// nullptr, or mind itself).  Scratch, as _fold_scratch in cuda_lloyd.py
// sizes it: sort 4 * entries ints (two key and two value buffers), hist
// SORT_BINS * (tiles + 1) ints (the counts, then offsets, and the totals),
// start k + 1 ints, part 2 * chunks rows of d floats and part_counts
// 2 * chunks floats, sq_part spans * n floats when the norms run over more
// than one column span.
template <class XT, class CT, bool VEC>
int launch_fold(const void* x, const float* w, const int* lab, const int* lab2, int n, int d,
                int k, const float* scores, float* mind, int* sort, int* hist, int* start,
                float* part, float* part_counts, float* sq_part, float* sums, float* counts,
                cudaStream_t stream) {
  const int dual = lab2 != nullptr;
  const int entries = dual ? 2 * n : n;
  const int tiles = (entries + SORT_TILE - 1) / SORT_TILE;
  const int chunks = (entries + FOLD_CHUNK - 1) / FOLD_CHUNK;
  const int spans = (d + FOLD_SPAN - 1) / FOLD_SPAN;
  const int passes = (32 - __builtin_clz((unsigned)k) + SORT_BITS - 1) / SORT_BITS;
  int* keys[2] = {sort, sort + 2 * (size_t)entries};
  int* vals[2] = {sort + (size_t)entries, sort + 3 * (size_t)entries};
  for (int pass = 0; pass < passes; ++pass) {
    const int out = pass & 1, shift = pass * SORT_BITS;
    const int* kin = keys[out ^ 1];
    const int* vin = vals[out ^ 1];
    int e = 0;
    if (pass > 0)
      e = sort_pass<false, false>(lab, lab2, w, kin, vin, entries, k, shift, tiles, hist,
                                  keys[out], vals[out], stream);
    else if (dual)
      e = sort_pass<true, true>(lab, lab2, w, kin, vin, entries, k, shift, tiles, hist,
                                keys[out], vals[out], stream);
    else
      e = sort_pass<true, false>(lab, lab2, w, kin, vin, entries, k, shift, tiles, hist,
                                 keys[out], vals[out], stream);
    if (e) return e;
  }
  const int fin = (passes - 1) & 1;
  fold_start_kernel<<<(k + NT) / NT, NT, 0, stream>>>(keys[fin], entries, k, start);
  if (int e = (int)cudaGetLastError()) return e;
  const dim3 grid((unsigned)chunks, (unsigned)spans);
  const XT* xt = static_cast<const XT*>(x);
  constexpr int ring = VEC ? FOLD_RING_BYTES : 0;
  if (mind != nullptr) {
    auto kern = fold_kernel<XT, CT, VEC, true>;
    if (int e = set_smem(kern, ring)) return e;
    kern<<<grid, NT, ring, stream>>>(xt, w, keys[fin], vals[fin], entries, dual, n, d, k,
                                     scores, mind, sq_part, sums, counts, part, part_counts);
  } else {
    auto kern = fold_kernel<XT, CT, VEC, false>;
    if (int e = set_smem(kern, ring)) return e;
    kern<<<grid, NT, ring, stream>>>(xt, w, keys[fin], vals[fin], entries, dual, n, d, k,
                                     nullptr, nullptr, nullptr, sums, counts, part,
                                     part_counts);
  }
  if (int e = (int)cudaGetLastError()) return e;
  const long long items = (long long)k * ((d + COMBINE_COLS - 1) / COMBINE_COLS);
  const int combine_blocks = (int)std::min<long long>((items + NWARP - 1) / NWARP, 4096);
  fold_combine_kernel<<<combine_blocks, NT, 0, stream>>>(start, k, d, part, part_counts, sums,
                                                         counts);
  if (int e = (int)cudaGetLastError()) return e;
  if (mind != nullptr && spans > 1)
    fold_norm_finish_kernel<<<(n + NT - 1) / NT, NT, 0, stream>>>(scores, sq_part, n, spans,
                                                                   mind);
  return (int)cudaGetLastError();
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

// The tensor map of a row-major (rows, d) matrix of esize-byte elements,
// read in boxes of box_cols features by box_rows rows with the 128-byte
// swizzle; reads past the edges fill zeros.
int make_map(EncodeTiled encode, CUtensorMap* map, const void* base, CUtensorMapDataType dtype,
             int esize, int d, int rows, int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadTensorMap;
}

// The tensor map of -2C's three bf16 pieces, a (3, k, d8) array, read in
// boxes of C32_BK features by C32_BN centroids by all 3 pieces with the
// 64-byte swizzle; reads past k and d8 fill zeros.
int make_pieces_map(EncodeTiled encode, CUtensorMap* map, const void* base, int d8, int k) {
  const cuuint64_t dims[3] = {(cuuint64_t)d8, (cuuint64_t)k, 3};
  const cuuint64_t strides[2] = {(cuuint64_t)d8 * 2, (cuuint64_t)k * d8 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)C32_BK, (cuuint32_t)C32_BN, 3};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadTensorMap;
}

// The core's score launch: the (best, index[, second]) of every (range of
// k_tile columns, row) into part_best / part_idx / part_second, (ceil(k /
// k_tile), n) each.  With GATHER the rows are x's rows rows[0 .. *count),
// read on the card; the grid is sized for n of them.
template <bool GATHER, bool SECOND>
int launch_core_score(const void* x, const void* neg2c, const float* csq, const int* rows,
                      const int* count, int n, int d, int k, int k_tile, float* part_best,
                      int* part_idx, float* part_second, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoTensorMap;
  CUtensorMap x_map{}, c_map;
  constexpr CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!GATHER)
    if (int e = make_map(encode, &x_map, x, bf, 2, d, n, CORE_BK, CORE_BM)) return e;
  if (int e = make_map(encode, &c_map, neg2c, bf, 2, d, k, CORE_BK, CORE_BN)) return e;
  int dev = 0, sms = 0;
  if (int e = (int)cudaGetDevice(&dev)) return e;
  if (int e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) return e;
  auto kern = core_score_kernel<GATHER, SECOND>;
  if (int e = set_smem(kern, CORE_SMEM)) return e;
  const long long tiles =
      (long long)((n + CORE_BM - 1) / CORE_BM) * ((k + k_tile - 1) / k_tile);
  const int grid = (int)std::min<long long>(tiles, sms);
  kern<<<grid, CORE_THREADS, CORE_SMEM, stream>>>(
      x_map, c_map, csq, static_cast<const bf16*>(x), rows, count, n, d, k, k_tile, part_best,
      part_idx, part_second);
  return (int)cudaGetLastError();
}

// The f32 route's score launch, as launch_core_score's: x in f32, pieces
// -2C's (3, k, round_up(d, 8)) bf16 split.
template <bool GATHER, bool SECOND>
int launch_core32_score(const void* x, const void* pieces, const float* csq, const int* rows,
                        const int* count, int n, int d, int k, int k_tile, float* part_best,
                        int* part_idx, float* part_second, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoTensorMap;
  CUtensorMap x_map{}, c_map;
  if (!GATHER)
    if (int e = make_map(encode, &x_map, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, d, n, C32_BK,
                         CORE_BM))
      return e;
  if (int e = make_pieces_map(encode, &c_map, pieces, (d + 7) & ~7, k)) return e;
  int dev = 0, sms = 0;
  if (int e = (int)cudaGetDevice(&dev)) return e;
  if (int e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) return e;
  auto kern = core32_score_kernel<GATHER, SECOND>;
  if (int e = set_smem(kern, CORE32_SMEM)) return e;
  const long long tiles =
      (long long)((n + CORE_BM - 1) / CORE_BM) * ((k + k_tile - 1) / k_tile);
  const int grid = (int)std::min<long long>(tiles, sms);
  kern<<<grid, CORE_THREADS, CORE32_SMEM, stream>>>(
      x_map, c_map, csq, static_cast<const float*>(x), rows, count, n, d, k, k_tile, part_best,
      part_idx, part_second);
  return (int)cudaGetLastError();
}

// The core for x of type XT (core = 1): the bf16 core or the f32 route.
template <class XT, bool GATHER, bool SECOND>
int launch_core(int core, const void* x, const void* c, const float* csq, const int* rows,
                const int* count, int n, int d, int k, int k_tile, float* part_best,
                int* part_idx, float* part_second, cudaStream_t stream) {
  if (core != 1) return kBadCore;
  if constexpr (std::is_same<XT, bf16>::value)
    return launch_core_score<GATHER, SECOND>(x, c, csq, rows, count, n, d, k, k_tile, part_best,
                                             part_idx, part_second, stream);
  else
    return launch_core32_score<GATHER, SECOND>(x, c, csq, rows, count, n, d, k, k_tile,
                                               part_best, part_idx, part_second, stream);
}

// The Hopper core takes bf16 x in bf16 compute and f32 x in f32 compute,
// with vector rows (d a multiple of 8, or of 4 in f32; aligned bases).
template <class XT, class CT, bool VEC>
constexpr bool core_takes = std::is_same<XT, CT>::value && VEC;

// K2's and K4's delta on the fold core: the dual fold of the weights fold_w
// (w on a changed row, 0 elsewhere, as the scoring epilogue wrote them) at
// labels and prev -- +w at the new label, -w at the old one, each bucket
// in row order.  The scratch is the fold core's (launch_fold).
template <class XT, class CT>
int launch_delta_fold(const void* x, const float* fold_w, const int* labels, const int* prev,
                      int n, int d, int k, int fold_vec, int* sort, int* hist, int* start,
                      float* part, float* part_counts, float* sq_part, float* dsums,
                      float* dcounts, cudaStream_t stream) {
  if (fold_vec)
    return launch_fold<XT, CT, true>(x, fold_w, labels, prev, n, d, k, nullptr, nullptr, sort,
                                     hist, start, part, part_counts, sq_part, dsums, dcounts,
                                     stream);
  return launch_fold<XT, CT, false>(x, fold_w, labels, prev, n, d, k, nullptr, nullptr, sort,
                                    hist, start, part, part_counts, sq_part, dsums, dcounts,
                                    stream);
}

template <class XT, class CT, bool VEC>
int launch_hamerly(const void* x, const void* neg2c, const float* csq, const float* w,
                   const int* prev, const unsigned char* need, const float* sb_in,
                   const float* slb_in, int n, int d, int k, int core, int* labels, float* sb,
                   float* slb, float* fold_w, float* dsums, float* dcounts, int* n_rec,
                   int* group_counts, float* part_best, int* part_idx, float* part_second,
                   int* rows, int* group_start, int fold_vec, int* sort, int* hist, int* start,
                   float* part, float* part_counts, float* sq_part, cudaStream_t stream) {
  const int groups = (n + GROUP_ROWS - 1) / GROUP_ROWS;
  if (!core) {
    auto kern = lloyd_hamerly_kernel<XT, CT, VEC>;
    constexpr int smem = smem_bytes<CT>();
    if (int e = set_smem(kern, smem)) return e;
    kern<<<groups, NT, smem, stream>>>(static_cast<const XT*>(x), static_cast<const CT*>(neg2c),
                                       csq, w, prev, need, sb_in, slb_in, n, d, k, labels, sb,
                                       slb, fold_w, n_rec, group_counts);
  } else if constexpr (core_takes<XT, CT, VEC>) {
    hamerly_count_kernel<<<groups, NT, 0, stream>>>(need, prev, sb_in, slb_in, n, labels, sb,
                                                    slb, fold_w, group_counts);
    if (int e = (int)cudaGetLastError()) return e;
    exclusive_scan_kernel<<<1, SCAN_NT, 0, stream>>>(group_counts, groups, group_start, n_rec);
    if (int e = (int)cudaGetLastError()) return e;
    hamerly_list_kernel<<<groups, NT, 0, stream>>>(need, n, group_start, rows);
    if (int e = (int)cudaGetLastError()) return e;
    if (int e = launch_core<XT, true, true>(core, x, neg2c, csq, rows, n_rec, n, d, k, CORE_BN,
                                            part_best, part_idx, part_second, stream))
      return e;
    core_hamerly_finish_kernel<<<(n + NT - 1) / NT, NT, 0, stream>>>(
        rows, n_rec, part_best, part_idx, part_second, (k + CORE_BN - 1) / CORE_BN, n, w, prev,
        labels, sb, slb, fold_w);
  } else {
    return kBadCore;
  }
  if (int e = (int)cudaGetLastError()) return e;
  return launch_delta_fold<XT, CT>(x, fold_w, labels, prev, n, d, k, fold_vec, sort, hist, start,
                                   part, part_counts, sq_part, dsums, dcounts, stream);
}

template <class XT, class CT, bool VEC>
int launch_tiled_argmin(const void* x, const void* neg2c, const float* csq, int n, int d,
                        int k, int k_tile, int raw, int with_second, int core,
                        float* part_best, int* part_idx, float* part_second, int* labels,
                        float* mind, float* second, cudaStream_t stream) {
  const int row_blocks = (n + BM - 1) / BM;
  const int slices = (k + k_tile - 1) / k_tile;
  constexpr int smem = smem_bytes<CT>();
  const XT* xt = static_cast<const XT*>(x);
  const CT* ct = static_cast<const CT*>(neg2c);
  if (core) {
    if constexpr (core_takes<XT, CT, VEC>) {
      if (int e = with_second
                      ? launch_core<XT, false, true>(core, x, neg2c, csq, nullptr, nullptr, n, d,
                                                     k, k_tile, part_best, part_idx, part_second,
                                                     stream)
                      : launch_core<XT, false, false>(core, x, neg2c, csq, nullptr, nullptr, n, d,
                                                      k, k_tile, part_best, part_idx, nullptr,
                                                      stream))
        return e;
    } else {
      return kBadCore;
    }
  } else if (with_second) {
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

template <class XT, class CT, bool VEC>
int launch_pass(const void* x, const void* neg2c, const float* csq, const float* w, int n,
                int d, int k, int with_update, int raw, int core, int* labels, float* mind,
                float* sums, float* counts, float* part_best, int* part_idx, int fold_vec,
                int* sort, int* hist, int* start, float* part, float* part_counts,
                float* sq_part, cudaStream_t stream) {
  const XT* xt = static_cast<const XT*>(x);
  // With the fold, the merge writes the raw score and the fold core adds
  // ||x||^2 from its own read of the row (unless raw).
  const int merge_raw = raw || with_update;
  if (core) {
    if constexpr (core_takes<XT, CT, VEC>) {
      if (int e = launch_core<XT, false, false>(core, x, neg2c, csq, nullptr, nullptr, n, d, k,
                                                CORE_BN, part_best, part_idx, nullptr, stream))
        return e;
      const size_t blocks = ((size_t)n * 32 + NT - 1) / NT;
      tiled_merge_kernel<XT><<<(unsigned)blocks, NT, 0, stream>>>(
          xt, part_best, part_idx, nullptr, n, d, (k + CORE_BN - 1) / CORE_BN, merge_raw,
          labels, mind, nullptr);
    } else {
      return kBadCore;
    }
  } else {
    auto kern = lloyd_pass_kernel<XT, CT, VEC>;
    constexpr int smem = smem_bytes<CT>();
    if (int e = set_smem(kern, smem)) return e;
    kern<<<(n + BM - 1) / BM, NT, smem, stream>>>(xt, static_cast<const CT*>(neg2c), csq, n, d,
                                                  k, merge_raw, labels, mind);
  }
  if (int e = (int)cudaGetLastError()) return e;
  if (!with_update) return 0;
  float* norms = raw ? nullptr : mind;
  if (fold_vec)
    return launch_fold<XT, CT, true>(x, w, labels, nullptr, n, d, k, norms, norms, sort, hist,
                                     start, part, part_counts, sq_part, sums, counts, stream);
  return launch_fold<XT, CT, false>(x, w, labels, nullptr, n, d, k, norms, norms, sort, hist,
                                    start, part, part_counts, sq_part, sums, counts, stream);
}

template <class XT, class CT, bool VEC>
int launch_delta(const void* x, const void* neg2c, const float* csq, const float* w,
                 const int* prev, int n, int d, int k, int with_mind, int core, int* labels,
                 float* mind, float* fold_w, float* dsums, float* dcounts, int* n_changed,
                 int* group_counts, float* part_best, int* part_idx, int fold_vec, int* sort,
                 int* hist, int* start, float* part, float* part_counts, float* sq_part,
                 cudaStream_t stream) {
  const XT* xt = static_cast<const XT*>(x);
  if (!core) {
    auto kern = lloyd_delta_kernel<XT, CT, VEC>;
    constexpr int smem = smem_bytes<CT>();
    if (int e = set_smem(kern, smem)) return e;
    kern<<<(n + BM - 1) / BM, NT, smem, stream>>>(xt, static_cast<const CT*>(neg2c), csq, w,
                                                  prev, n, d, k, with_mind, labels, mind, fold_w,
                                                  n_changed, group_counts);
  } else if constexpr (core_takes<XT, CT, VEC>) {
    if (int e = launch_core<XT, false, false>(core, x, neg2c, csq, nullptr, nullptr, n, d, k,
                                              CORE_BN, part_best, part_idx, nullptr, stream))
      return e;
    const size_t blocks = ((size_t)n * 32 + NT - 1) / NT;
    core_delta_finish_kernel<XT><<<(unsigned)blocks, NT, 0, stream>>>(
        xt, part_best, part_idx, (k + CORE_BN - 1) / CORE_BN, w, prev, n, d, with_mind, labels,
        mind, fold_w, n_changed, group_counts);
  } else {
    return kBadCore;
  }
  if (int e = (int)cudaGetLastError()) return e;
  return launch_delta_fold<XT, CT>(x, fold_w, labels, prev, n, d, k, fold_vec, sort, hist, start,
                                   part, part_counts, sq_part, dsums, dcounts, stream);
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

// core = 1 scores with the Hopper core (the wrapper's scoring_core rule; in
// f32, neg2c is then -2C's (3, k, round_up(d, 8)) bf16 pieces);
// part_best / part_idx are its (ceil(k / 256), n) slice buffers.  K1 folds
// on the fold core when with_update (fold_vec its vector rule, the scratch
// as _fold_scratch in cuda_lloyd.py sizes it, with the norms unless raw).
extern "C" int kml_lloyd_pass(const void* x, int x_dtype, const void* neg2c, int cd,
                              const float* csq, const float* w, int n, int d, int k,
                              int with_update, int raw, int vec, int core, int* labels,
                              float* mind, float* sums, float* counts, float* part_best,
                              int* part_idx, int fold_vec, int* sort, int* hist, int* start,
                              float* part, float* part_counts, float* sq_part, void* stream) {
  KML_DISPATCH(launch_pass, x, neg2c, csq, w, n, d, k, with_update, raw, core, labels, mind,
               sums, counts, part_best, part_idx, fold_vec, sort, hist, start, part,
               part_counts, sq_part, static_cast<cudaStream_t>(stream));
}

// K2: fold_w (n floats) holds each row's fold weight between the scoring
// launch and the fold core's dual fold, which takes the scratch as
// kml_tiled_fold's (fold_vec its vector rule).
extern "C" int kml_lloyd_delta(const void* x, int x_dtype, const void* neg2c, int cd,
                               const float* csq, const float* w, const int* prev, int n, int d,
                               int k, int with_mind, int vec, int core, int* labels, float* mind,
                               float* fold_w, float* dsums, float* dcounts, int* n_changed,
                               int* group_counts, float* part_best, int* part_idx, int fold_vec,
                               int* sort, int* hist, int* start, float* part,
                               float* part_counts, float* sq_part, void* stream) {
  KML_DISPATCH(launch_delta, x, neg2c, csq, w, prev, n, d, k, with_mind, core, labels, mind,
               fold_w, dsums, dcounts, n_changed, group_counts, part_best, part_idx, fold_vec,
               sort, hist, start, part, part_counts, sq_part, static_cast<cudaStream_t>(stream));
}

// K3 on the fold core: the single fold with the norms (scores may be
// nullptr); vec is the fold's vector rule.
extern "C" int kml_accumulate(const void* x, int x_dtype, int cd, const int* labels,
                              const float* scores, const float* w, int n, int d, int k, int vec,
                              int* sort, int* hist, int* start, float* part,
                              float* part_counts, float* sq_part, float* sums, float* counts,
                              float* mind, void* stream) {
  KML_DISPATCH(launch_fold, x, w, labels, nullptr, n, d, k, scores, mind, sort, hist, start,
               part, part_counts, sq_part, sums, counts, static_cast<cudaStream_t>(stream));
}

// core = 1: the Hopper core (in f32 neg2c is -2C's bf16 pieces, as for
// kml_lloyd_pass).  part_best / part_idx / part_second are its
// (ceil(k / 256), n) slice buffers, rows (n) and group_start (one per
// 1024-row group) the list of needed rows; n_rec is the device-side count
// the core reads.  score_block (core = 0) takes none of them.  fold_w and
// the fold's scratch as for kml_lloyd_delta.
extern "C" int kml_lloyd_hamerly(const void* x, int x_dtype, const void* neg2c, int cd,
                                 const float* csq, const float* w, const int* prev,
                                 const unsigned char* need, const float* sb_in,
                                 const float* slb_in, int n, int d, int k, int vec, int core,
                                 int* labels, float* sb, float* slb, float* fold_w,
                                 float* dsums, float* dcounts, int* n_rec, int* group_counts,
                                 float* part_best, int* part_idx, float* part_second,
                                 int* rows, int* group_start, int fold_vec, int* sort,
                                 int* hist, int* start, float* part, float* part_counts,
                                 float* sq_part, void* stream) {
  KML_DISPATCH(launch_hamerly, x, neg2c, csq, w, prev, need, sb_in, slb_in, n, d, k, core,
               labels, sb, slb, fold_w, dsums, dcounts, n_rec, group_counts, part_best,
               part_idx, part_second, rows, group_start, fold_vec, sort, hist, start, part,
               part_counts, sq_part, static_cast<cudaStream_t>(stream));
}

// core = 1: the Hopper core over ranges of k_tile columns (in f32 neg2c is
// -2C's bf16 pieces).
extern "C" int kml_tiled_argmin(const void* x, int x_dtype, const void* neg2c, int cd,
                                const float* csq, int n, int d, int k, int k_tile, int raw,
                                int with_second, int vec, int core, float* part_best,
                                int* part_idx, float* part_second, int* labels, float* mind,
                                float* second, void* stream) {
  KML_DISPATCH(launch_tiled_argmin, x, neg2c, csq, n, d, k, k_tile, raw, with_second, core,
               part_best, part_idx, part_second, labels, mind, second,
               static_cast<cudaStream_t>(stream));
}

// K6 on the fold core: lab2 == nullptr is the single fold; no norms.
extern "C" int kml_tiled_fold(const void* x, int x_dtype, int cd, const float* w,
                              const int* lab, const int* lab2, int n, int d, int k, int vec,
                              int* sort, int* hist, int* start, float* part,
                              float* part_counts, float* sq_part, float* sums, float* counts,
                              void* stream) {
  KML_DISPATCH(launch_fold, x, w, lab, lab2, n, d, k, nullptr, nullptr, sort, hist, start, part,
               part_counts, sq_part, sums, counts, static_cast<cudaStream_t>(stream));
}
