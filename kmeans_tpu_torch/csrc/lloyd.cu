// Hand-written Hopper (sm_90a) kernels for the three Lloyd sweeps of the port.
//
// Built by kmeans_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  Every
// entry point launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() after its launch.  Python wrappers, checks and
// the plain PyTorch versions live in kmeans_tpu_torch/ops/cuda_lloyd.py.
//
// Shared design of the two scoring kernels (K1, K2):
//
// * One block owns BM = 128 rows and walks every centroid in k-tiles of
//   BN = 128.  For each k-tile it streams d in chunks of BK through shared
//   memory: the row chunk cast to the compute dtype (cd) and the centroid
//   chunk, pre-scaled by -2 in cd by the wrapper.  Scores are
//   csq + x_cd . (-2 C_cd)^T with f32 accumulation:
//     - bf16: nvcuda::wmma 16x16x16 bf16 tiles with f32 accumulators
//       (8 warps, each a 64 x 32 sub-tile);
//     - f32: plain f32 FMA on an 8 x 8 register micro-tile per thread, never
//       TF32.
// * The (BM, BN) score tile goes through shared memory, where two threads per
//   row scan its columns in increasing order with strict '<' and merge the
//   halves by (value, index): the lowest index wins a tie inside a tile.
//   Tiles are merged with strict '<' in increasing k, so the lowest index
//   wins across tiles too -- the rule of jnp.argmin and _argmin_rows.
//   Columns past k and rows past n are masked, so any d and k are taken.
// * The fold is a scatter: a warp per row adds w * float(cd(x[r, :])) into
//   sums[label, :] and w into counts[label] with f32 atomicAdd.  At the
//   headline shape (k = 1000, d = 2048) the f32 sums are 8 MB, so the
//   atomics resolve in L2.  The sum order is that of the atomics: it changes
//   from run to run at the f32 rounding level.
// * ||x||^2 is taken from x in its stored dtype, widened to f32.
//
// What bounds them on an H100: the distance product, 2*n*d*k operations
// (5.24 TFLOP at n = 1.28M, d = 2048, k = 1000: >= 5.3 ms at 989 TFLOP/s
// bf16), against one read of x (5.24 GB bf16: >= 1.56 ms at 3.35 TB/s).
// This first version is simple rather than fast: no wgmma, no TMA, no
// software pipelining; the x tile is re-read from L2 once per k-tile.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
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
// >= d are zero.
template <class XT, class CT, bool VEC>
__device__ __forceinline__ void load_tile(CT* dst, const XT* __restrict__ src, int rows,
                                          int rows_valid, int col0, int d) {
  constexpr int BK = Cfg<CT>::BK, LDX = Cfg<CT>::LDX, VW = Cfg<CT>::VW;
  if constexpr (VEC) {
    constexpr int PER_ROW = BK / VW;
    for (int v = threadIdx.x; v < rows * PER_ROW; v += NT) {
      const int r = v / PER_ROW, c = (v % PER_ROW) * VW;
      CT* o = dst + r * LDX + c;
      if (r < rows_valid && col0 + c < d) {
        load_vec<XT, CT>(src + (size_t)r * d + col0 + c, o);
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) o[e] = cast_cd<CT>(0.f);
      }
    }
  } else {
    for (int v = threadIdx.x; v < rows * BK; v += NT) {
      const int r = v / BK, c = v % BK;
      const float val = (r < rows_valid && col0 + c < d)
                            ? to_f32(src[(size_t)r * d + col0 + c]) : 0.f;
      dst[r * LDX + c] = cast_cd<CT>(val);
    }
  }
}

// Scores of rows [row0, row0 + BM) against every centroid; leaves each row's
// (min score, lowest argmin) in s_min / s_lab.  Ends with a barrier.
template <class XT, class CT, bool VEC>
__device__ void score_block(const XT* __restrict__ x, const CT* __restrict__ neg2c,
                            const float* __restrict__ csq, int n, int d, int k, int row0,
                            unsigned char* smem, float* s_csq, float* s_min, int* s_lab) {
  constexpr int BK = Cfg<CT>::BK, LDX = Cfg<CT>::LDX;
  CT* xs = reinterpret_cast<CT*>(smem);
  CT* cs = xs + BM * LDX;
  float* sc = reinterpret_cast<float*>(smem);   // reuses the staging buffers
  const int tid = threadIdx.x;
  const int rows_valid = min(BM, n - row0);
  const int rr = tid >> 1, side = tid & 1;      // two scanning threads per row
  const XT* xblk = x + (size_t)row0 * d;
  float run_best = INFINITY;
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
        load_tile<XT, CT, VEC>(xs, xblk, BM, rows_valid, d0, d);
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
        load_tile<XT, CT, VEC>(xs, xblk, BM, rows_valid, d0, d);
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
    float best = INFINITY;
    int bi = INT_MAX;
    const float* srow = sc + rr * LDS;
    for (int j = 0; j < BN / 2; ++j) {
      const int col = side * (BN / 2) + j;
      if (col >= cols_valid) break;
      const float v = s_csq[col] + srow[col];
      if (v < best) { best = v; bi = k0 + col; }
    }
    const float ob = __shfl_xor_sync(0xffffffffu, best, 1);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, 1);
    if (ob < best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    if (best < run_best) { run_best = best; run_idx = bi; }
    __syncthreads();
  }
  if (side == 0) { s_min[rr] = run_best; s_lab[rr] = run_idx; }
  __syncthreads();
}

// K1 -- replaces kmeans_tpu/ops/pallas_lloyd.py::lloyd_pass_pallas (_kernel).
// Bound on an H100: the distance product (2*n*d*k operations); the fold adds
// one more read of x (every row is folded).  Design: score_block for the
// argmin, then a warp per row reads the row once for ||x||^2 and, with
// with_update, its scatter fold.
template <class XT, class CT, bool VEC>
__global__ void __launch_bounds__(NT, 2)
lloyd_pass_kernel(const XT* __restrict__ x, const CT* __restrict__ neg2c,
                  const float* __restrict__ csq, const float* __restrict__ w,
                  int n, int d, int k, int with_update,
                  int* __restrict__ labels, float* __restrict__ mind,
                  float* __restrict__ sums, float* __restrict__ counts) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_csq[BN], s_min[BM];
  __shared__ int s_lab[BM];
  const int row0 = blockIdx.x * BM;
  score_block<XT, CT, VEC>(x, neg2c, csq, n, d, k, row0, smem, s_csq, s_min, s_lab);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += NWARP) {
    const int gr = row0 + r;
    if (gr >= n) break;
    const int lab = s_lab[r];
    const float wr = w[gr];
    const bool fold = with_update && wr != 0.f;
    const XT* xr = x + (size_t)gr * d;
    float* dst = sums + (size_t)lab * d;
    float sq = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xf = to_f32(xr[c]);
      sq = fmaf(xf, xf, sq);
      if (fold) atomicAdd(dst + c, wr * cd_round<CT>(xf));
    }
    sq = warp_sum(sq);
    if (lane == 0) {
      labels[gr] = lab;
      mind[gr] = fmaxf(s_min[r] + sq, 0.f);
      if (fold) atomicAdd(counts + lab, wr);
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
// 1024-row group, from which the wrapper reports dense_tiles.
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
  score_block<XT, CT, VEC>(x, neg2c, csq, n, d, k, row0, smem, s_csq, s_min, s_lab);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += NWARP) {
    const int gr = row0 + r;
    if (gr >= n) break;
    const int lab = s_lab[r];
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
      mind[gr] = with_mind ? fmaxf(s_min[r] + sq, 0.f) : s_min[r];
      if (changed) {
        atomicAdd(dcounts + lab, wr);
        if (sub) atomicAdd(dcounts + old, -wr);
        atomicAdd(&s_changed, 1);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_changed > 0) {
    atomicAdd(n_changed, s_changed);
    atomicAdd(group_counts + row0 / GROUP_ROWS, s_changed);
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

template <class F>
int set_smem(F kern, int bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <class XT, class CT, bool VEC>
int launch_pass(const void* x, const void* neg2c, const float* csq, const float* w, int n,
                int d, int k, int with_update, int* labels, float* mind, float* sums,
                float* counts, cudaStream_t stream) {
  auto kern = lloyd_pass_kernel<XT, CT, VEC>;
  constexpr int smem = smem_bytes<CT>();
  if (int e = set_smem(kern, smem)) return e;
  kern<<<(n + BM - 1) / BM, NT, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const CT*>(neg2c), csq, w, n, d, k, with_update,
      labels, mind, sums, counts);
  return (int)cudaGetLastError();
}

template <class XT, class CT, bool VEC>
int launch_delta(const void* x, const void* neg2c, const float* csq, const float* w,
                 const int* prev, int n, int d, int k, int with_mind, int* labels, float* mind,
                 float* dsums, float* dcounts, int* n_changed, int* group_counts,
                 cudaStream_t stream) {
  auto kern = lloyd_delta_kernel<XT, CT, VEC>;
  constexpr int smem = smem_bytes<CT>();
  if (int e = set_smem(kern, smem)) return e;
  kern<<<(n + BM - 1) / BM, NT, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const CT*>(neg2c), csq, w, prev, n, d, k,
      with_mind, labels, mind, dsums, dcounts, n_changed, group_counts);
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

constexpr int kBadDtype = -1;

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

extern "C" int kml_lloyd_pass(const void* x, int x_dtype, const void* neg2c, int cd,
                              const float* csq, const float* w, int n, int d, int k,
                              int with_update, int vec, int* labels, float* mind,
                              float* sums, float* counts, void* stream) {
  KML_DISPATCH(launch_pass, x, neg2c, csq, w, n, d, k, with_update, labels, mind, sums,
               counts, static_cast<cudaStream_t>(stream));
}

extern "C" int kml_lloyd_delta(const void* x, int x_dtype, const void* neg2c, int cd,
                               const float* csq, const float* w, const int* prev, int n, int d,
                               int k, int with_mind, int vec, int* labels, float* mind,
                               float* dsums, float* dcounts, int* n_changed,
                               int* group_counts, void* stream) {
  KML_DISPATCH(launch_delta, x, neg2c, csq, w, prev, n, d, k, with_mind, labels, mind, dsums,
               dcounts, n_changed, group_counts, static_cast<cudaStream_t>(stream));
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
