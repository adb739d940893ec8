// Distance-covariance Gram for NVIDIA Hopper (sm_90a), float32 throughout.
//
// Replaces the Pallas TPU kernels repro/kernels/dcov/dcov.py::
// _row_sum_batch_kernel and _gram_batch_kernel (entry dcov_gram_pallas).
// For C one-dimensional samples stacked as the columns of an (n, C) block
// it computes the (C, C) Gram of double-centred distance matrices (paper
// Eq. 1-3):
//
//   a_c[i][j] = |x_ic - x_jc|,  r_c[i] = sum_j a_c[i][j]
//   A_c[i][j] = a_c[i][j] - r_c[i]/n - r_c[j]/n + sum_i r_c[i]/n^2
//   G[c][c']  = sum_ij A_c[i][j] A_c'[i][j]
//
// without writing an n x n matrix to device memory. The caller turns G
// into dCor (Eq. 4). Two entries:
//
// * repro_dcov_windows -- the CORAL loop's per-step form: B episodes, each
//   a (W, C) window whose rows past n_valid[b] are padding and are masked
//   out of every sum (the zero-padded window of the reference's
//   dcor_all_cols). One block per episode, W <= 64, C <= 8. The window is
//   padded to 8 columns in shared memory, not in device memory. The block
//   forms the masked distances, the row sums once (column sums are the row
//   sums transposed, bit for bit, since |x_i - x_j| is symmetric), the
//   centred matrices, and the sums <A_c, A_c'>. Every sum runs in one fixed
//   order -- over j for each row i, then over i -- with no fused
//   multiply-add, in the same order as the plain version
//   (kernels/dcov/ref.py::dcov_gram_windows_ref), so an episode's Gram is
//   bitwise the plain version's and does not depend on B or on where the
//   episode sits in the batch.
// * repro_dcov_gram -- the ORACLE-scale form: one (n, C) block of
//   thousands of rows. The Pallas kernel accumulated one output block
//   across its whole (n/b x n/b) grid and relied on the TPU running the
//   grid in sequence; Hopper runs blocks in parallel and in no order. Here
//   pass 1 gives each 64-row tile's row sums and the tile's column totals;
//   pass 2 gives every 64 x 64 tile pair at or above the diagonal its own
//   partial Gram (a pair below the diagonal equals its mirror, so the
//   off-diagonal partials count twice); pass 3 reduces the partials in a
//   fixed order. No float atomics, so a result is the same on every run.
//
// What bounds it on the card. The windows form at the grid shape (B = 162
// episodes, W = 10, C = 7) is ~0.1 MFLOP and ~50 KB: one launch costs far
// more than the work, so the bound is launch latency; the design answer is
// one launch per CORAL step for the whole batch. The ORACLE-scale form at
// n = 1600, C = 8 is ~n^2/2 pairs x (8 centrings + 36 products) of float32
// work on the CUDA cores (C = 8 is too narrow for the tensor cores to
// matter): the bound is float32 throughput, a few microseconds at 67 TFLOP/s;
// the design answer is register accumulators per thread, the symmetry
// halving the tile pairs, and one block reduction per tile pair.

#include <cuda_runtime.h>

namespace {

constexpr int CP = 8;                     // columns, padded in shared memory
constexpr int NPAIR = CP * (CP + 1) / 2;  // c <= c' pairs of the Gram
constexpr int MAXW = 64;                  // longest window of the windows form
constexpr int NT = 256;                   // threads per block
constexpr int TILE = 64;                  // rows per tile of the ORACLE-scale form
constexpr size_t MAX_SMEM = 232448;       // what one Hopper block may use

__device__ __forceinline__ void pair_of(int p, int* c, int* d) {
  // p-th (c, d) with c <= d, in row-major order of the upper triangle
  int cc = 0;
  while (p >= CP - cc) {
    p -= CP - cc;
    ++cc;
  }
  *c = cc;
  *d = cc + p;
}

// ---------------------------------------------------------------- windows
// Shared memory: x (W x CP), row (W x CP), grand (CP), A (W x W x CP) and the
// per-row partial Grams P (W x NPAIR).
__host__ __device__ inline size_t windows_smem_floats(int w) {
  return static_cast<size_t>(2 * w * CP + CP + w * w * CP + w * NPAIR);
}

__global__ void __launch_bounds__(NT)
dcov_windows_kernel(const float* __restrict__ cols, const int* __restrict__ n_valid,
                    float* __restrict__ gram, int w, int c) {
  extern __shared__ float smem[];
  float* xs = smem;              // [w][CP]
  float* row = xs + w * CP;      // [w][CP]
  float* grand = row + w * CP;   // [CP]
  float* A = grand + CP;         // [w][w][CP]
  float* P = A + w * w * CP;     // [w][NPAIR]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = n_valid[b];
  const float inv_n = __frcp_rn(static_cast<float>(n));
  const float* xb = cols + static_cast<long long>(b) * w * c;

  for (int k = tid; k < w * CP; k += NT) {
    const int i = k / CP, cc = k % CP;
    xs[k] = cc < c ? xb[i * c + cc] : 0.0f;
  }
  __syncthreads();

  // row sums over j, in order: r[i][c] = (sum_j |x_i - x_j| m_ij) / n
  for (int k = tid; k < w * CP; k += NT) {
    const int i = k / CP, cc = k % CP;
    const float xi = xs[k];
    float acc = 0.0f;
    for (int j = 0; j < w; ++j) {
      const float m = (i < n && j < n) ? 1.0f : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(fabsf(__fsub_rn(xi, xs[j * CP + cc])), m));
    }
    row[k] = __fmul_rn(acc, inv_n);
  }
  __syncthreads();

  if (tid < CP) {  // grand mean: the row means summed over i, in order, / n
    float acc = 0.0f;
    for (int i = 0; i < w; ++i) acc = __fadd_rn(acc, row[i * CP + tid]);
    grand[tid] = __fmul_rn(acc, inv_n);
  }
  __syncthreads();

  // centred matrices: A = (((a - r_i) - r_j) + grand) * m
  for (int k = tid; k < w * w * CP; k += NT) {
    const int cc = k % CP, ij = k / CP, i = ij / w, j = ij % w;
    const float m = (i < n && j < n) ? 1.0f : 0.0f;
    const float a = __fmul_rn(fabsf(__fsub_rn(xs[i * CP + cc], xs[j * CP + cc])), m);
    const float v = __fadd_rn(__fsub_rn(__fsub_rn(a, row[i * CP + cc]), row[j * CP + cc]),
                              grand[cc]);
    A[k] = __fmul_rn(v, m);
  }
  __syncthreads();

  // per-row partials over j, in order: P[i][cd] = sum_j A_c[i][j] A_d[i][j]
  for (int k = tid; k < w * NPAIR; k += NT) {
    const int i = k / NPAIR;
    int cc, dd;
    pair_of(k % NPAIR, &cc, &dd);
    const float* Ai = A + i * w * CP;
    float acc = 0.0f;
    for (int j = 0; j < w; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(Ai[j * CP + cc], Ai[j * CP + dd]));
    }
    P[k] = acc;
  }
  __syncthreads();

  // the Gram: the partials summed over i, in order; mirrored (a*b == b*a)
  if (tid < NPAIR) {
    int cc, dd;
    pair_of(tid, &cc, &dd);
    if (dd < c) {
      float acc = 0.0f;
      for (int i = 0; i < w; ++i) acc = __fadd_rn(acc, P[i * NPAIR + tid]);
      float* gb = gram + static_cast<long long>(b) * c * c;
      gb[cc * c + dd] = acc;
      gb[dd * c + cc] = acc;
    }
  }
}

// ----------------------------------------------------------- ORACLE scale
// Pass 1: one block per 64-row tile, thread (i, c) sums |x_ic - x_jc| over
// every j in order (tiles of x staged in shared memory). Writes the raw row
// sums and the tile's column totals (a fixed tree over the tile's rows).
__global__ void __launch_bounds__(TILE * CP)
dcov_rowsum_kernel(const float* __restrict__ x, float* __restrict__ rs,
                   float* __restrict__ tile_tot, int n, int c) {
  __shared__ float xj[TILE * CP];
  __shared__ float red[TILE * CP];
  const int tid = threadIdx.x;
  const int i = tid / CP, cc = tid % CP;
  const int gi = blockIdx.x * TILE + i;
  const float xi = (gi < n && cc < c) ? x[static_cast<long long>(gi) * c + cc] : 0.0f;
  float acc = 0.0f;
  for (int j0 = 0; j0 < n; j0 += TILE) {
    const int gj = j0 + i;
    xj[tid] = (gj < n && cc < c) ? x[static_cast<long long>(gj) * c + cc] : 0.0f;
    __syncthreads();
    const int jn = min(TILE, n - j0);
    for (int j = 0; j < jn; ++j) acc += fabsf(xi - xj[j * CP + cc]);
    __syncthreads();
  }
  const float r = gi < n ? acc : 0.0f;
  rs[static_cast<long long>(blockIdx.x) * TILE * CP + tid] = r;
  red[tid] = r;
  __syncthreads();
  for (int s = TILE / 2; s > 0; s >>= 1) {
    if (i < s) red[tid] += red[tid + s * CP];
    __syncthreads();
  }
  if (i == 0) tile_tot[blockIdx.x * CP + cc] = red[cc];
}

// Pass 2: one block per tile pair (ti <= tj). Each thread takes 16 of the
// tile's 64 x 64 (i, j) pairs, centres the 8 columns and keeps the 36
// products in registers; the block then reduces them in a fixed tree.
__global__ void __launch_bounds__(NT)
dcov_gram_tiles_kernel(const float* __restrict__ x, const float* __restrict__ rs,
                       const float* __restrict__ tile_tot, float* __restrict__ partial,
                       int n, int c, int nb) {
  __shared__ float xi_s[TILE * CP], xj_s[TILE * CP], ri_s[TILE * CP], rj_s[TILE * CP];
  __shared__ float grand_s[CP];
  __shared__ float wred[NT / 32][NPAIR];
  // linear block id -> (ti, tj), ti <= tj, row-major over the upper triangle
  int p = blockIdx.x, ti = 0;
  while (p >= nb - ti) {
    p -= nb - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int tid = threadIdx.x;
  const float inv_n = 1.0f / static_cast<float>(n);
  for (int k = tid; k < TILE * CP; k += NT) {
    const int r = k / CP, cc = k % CP;
    const int gi = ti * TILE + r, gj = tj * TILE + r;
    xi_s[k] = (gi < n && cc < c) ? x[static_cast<long long>(gi) * c + cc] : 0.0f;
    xj_s[k] = (gj < n && cc < c) ? x[static_cast<long long>(gj) * c + cc] : 0.0f;
    ri_s[k] = rs[static_cast<long long>(ti) * TILE * CP + k] * inv_n;
    rj_s[k] = rs[static_cast<long long>(tj) * TILE * CP + k] * inv_n;
  }
  if (tid < CP) {
    float g = 0.0f;
    for (int t = 0; t < nb; ++t) g += tile_tot[t * CP + tid];
    grand_s[tid] = g * inv_n * inv_n;
  }
  __syncthreads();

  float acc[NPAIR];
#pragma unroll
  for (int q = 0; q < NPAIR; ++q) acc[q] = 0.0f;
  const int j = tid % TILE;
  const bool jv = tj * TILE + j < n;
  for (int i = tid / TILE; i < TILE; i += NT / TILE) {
    if (!(jv && ti * TILE + i < n)) continue;
    float a[CP];
#pragma unroll
    for (int cc = 0; cc < CP; ++cc) {
      a[cc] = fabsf(xi_s[i * CP + cc] - xj_s[j * CP + cc]) - ri_s[i * CP + cc] -
              rj_s[j * CP + cc] + grand_s[cc];
    }
    int q = 0;
#pragma unroll
    for (int cc = 0; cc < CP; ++cc) {
#pragma unroll
      for (int dd = cc; dd < CP; ++dd) {
        acc[q] = fmaf(a[cc], a[dd], acc[q]);
        ++q;
      }
    }
  }
  // a fixed-order reduction: a shuffle tree inside each warp, then the
  // eight warp sums in order
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int q = 0; q < NPAIR; ++q) {
    float v = acc[q];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) wred[warp][q] = v;
  }
  __syncthreads();
  if (tid < NPAIR) {
    float v = 0.0f;
    for (int k = 0; k < NT / 32; ++k) v += wred[k][tid];
    partial[static_cast<long long>(blockIdx.x) * NPAIR + tid] = v * (ti == tj ? 1.0f : 2.0f);
  }
}

// Pass 3: one block per (c, d) pair sums the tile-pair partials in a fixed
// order (strided per thread, then a tree) and writes G[c][d] and G[d][c].
__global__ void __launch_bounds__(NT)
dcov_reduce_kernel(const float* __restrict__ partial, float* __restrict__ gram,
                   int nblocks, int c) {
  __shared__ float red[NT];
  const int q = blockIdx.x, tid = threadIdx.x;
  float acc = 0.0f;
  for (int k = tid; k < nblocks; k += NT) acc += partial[static_cast<long long>(k) * NPAIR + q];
  red[tid] = acc;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) {
    int cc, dd;
    pair_of(q, &cc, &dd);
    if (dd < c) {
      gram[cc * c + dd] = red[0];
      gram[dd * c + cc] = red[0];
    }
  }
}

}  // namespace

extern "C" int repro_dcov_windows(const void* cols, const void* n_valid, void* gram,
                                  int device, int batch, int w, int c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch < 1 || w < 1 || w > MAXW || c < 1 || c > CP) return cudaErrorInvalidValue;
  const size_t smem = windows_smem_floats(w) * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  static size_t smem_set[64] = {};  // per device: the attribute as last raised
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (smem > smem_set[device]) {
    err = cudaFuncSetAttribute(dcov_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set[device] = smem;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dcov_windows_kernel<<<batch, NT, smem, s>>>(static_cast<const float*>(cols),
                                              static_cast<const int*>(n_valid),
                                              static_cast<float*>(gram), w, c);
  return cudaGetLastError();
}

// Scratch the caller allocates: rs (tiles(n) * 64 * 8 floats), tile_tot
// (tiles(n) * 8), partial (tiles(n) * (tiles(n) + 1) / 2 * 36).
extern "C" int repro_dcov_gram(const void* x, void* rs, void* tile_tot, void* partial,
                               void* gram, int device, int n, int c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 1 || c < 1 || c > CP) return cudaErrorInvalidValue;
  const int nb = (n + TILE - 1) / TILE;
  const int nblocks = nb * (nb + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dcov_rowsum_kernel<<<nb, TILE * CP, 0, s>>>(static_cast<const float*>(x),
                                              static_cast<float*>(rs),
                                              static_cast<float*>(tile_tot), n, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dcov_gram_tiles_kernel<<<nblocks, NT, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(rs),
      static_cast<const float*>(tile_tot), static_cast<float*>(partial), n, c, nb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dcov_reduce_kernel<<<NPAIR, NT, 0, s>>>(static_cast<const float*>(partial),
                                          static_cast<float*>(gram), nblocks, c);
  return cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
