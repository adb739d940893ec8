// Distance-covariance Gram for NVIDIA Hopper (sm_90a), float32 (the single-block
// form adds its per-CTA partials in float64).
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
//   a row-sum pass spread over the card and a persistent Gram pass over
//   the upper triangle of tile pairs, launched back to back with
//   programmatic dependent launch; the last CTA of the Gram pass adds the
//   per-CTA partials in a fixed order (section "ORACLE scale" below). No
//   float atomics, so a result is the same on every run.
//
// What bounds it on the card. The windows form at the grid shape (B = 162
// episodes, W = 10, C = 7) is ~0.1 MFLOP and ~50 KB: one launch costs far
// more than the work, so the bound is launch latency; the design answer is
// one launch per CORAL step for the whole batch. The ORACLE-scale form is
// n^2/2 pairs x (C distances, their row sums, C centrings, C(C+1)/2
// products) of float32 work on the CUDA cores (C <= 8 is too narrow for
// the tensor cores to matter, and TF32 would not hold the Gram to float64
// at the 1e-6 its zero-dCor pairs need): at n = 1600, C = 7, 0.134 GFLOP,
// 2 us at 67 TFLOP/s, so two dependent launches and the latency of short
// serial chains weigh as much as the work; at n = 16384 the work (0.26 ms)
// does. The design answers: every SM busy in both passes, independent
// register accumulators, one reduction per CTA rather than per tile pair,
// one launch fewer, and the second launch overlapped with the first.

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
// Two kernels, the second launched by programmatic dependent launch, with
// scratch from the caller (layout in gram_plan):
//
// Pass 1, dcov_rowsum_kernel: a CTA per tile of RT rows (RT = 16 ... 128,
// the largest that still gives every SM work at this n), 32 C threads.
// Thread (column c, row group g, j phase k) keeps eight rows' x and eight
// independent sums in registers and walks x_j for j = k, k + K, ... (K = 32
// / (RT / 8)) out of shared memory (the threads of a warp read one or two
// rows x_j: no bank conflicts). x arrives by cp.async: whole up to RS_ONE
// rows, else in RS_JC-row chunks through two buffers, the next landing
// while this one is summed. The K phases are added in order in shared
// memory; the CTA writes its rows' means m_i = r_i / n and the tile's
// column total of them (rows in order).
//
// Pass 2, dcov_gram_kernel: a persistent grid (at most GRID_CAP CTAs, a
// count fixed by n alone) walks the upper triangle of 64 x 64 tile pairs
// in a static order. Each CTA first adds every tile's total in a fixed
// order for the grand mean. Thread (j, half) holds x_j and g - m_j in
// registers and walks half of the i-tile from shared memory (a broadcast
// per i), the next tile pair's inputs already loading into registers (two
// i-tile buffers, one barrier per tile pair); a
// pair's centred values are (|x_i - x_j| - m_i) + (g - m_j), and its
// C(C+1)/2 products go into register accumulators kept across all the
// CTA's tile pairs. The accumulators hold half the Gram: a tile pair off
// the diagonal once (its mirror is the same sum), a diagonal tile its
// strict upper triangle plus half of each i = j term (an exact halving);
// the result is doubled at the end. The CTA reduces once (a shuffle tree,
// then the four warps in order) into its partial; the last CTA to take the
// integer ticket adds the partials in float64: each thread a fixed set of
// CTAs, then a shuffle tree and the warps in order. Every order is fixed by
// n, so two runs give the same bits; no float atomics.
//
// Both kernels are instantiated for each C in 1..8, so a C = 7 block costs
// 7 centrings and 28 products per pair, not 8 and 36.

constexpr int RS_RPT = 8;            // rows per pass-1 thread
constexpr int RS_ONE = 2048;         // n up to this: pass 1 stages x whole
constexpr int RS_JC = 512;           // beyond: chunks of this many rows, two buffers
constexpr int RS_MIN_CTAS = 2 * 132;  // pass-1 CTAs to aim for
constexpr int GT = 128;              // pass-2 threads: 64 j x 2 halves of the i-tile
constexpr int GRID_CAP = 4 * 132;    // pass-2 CTAs at most (four per SM)

struct GramPlan {
  int rt;          // rows per pass-1 CTA
  int nrt;         // pass-1 CTAs
  int jc;          // rows of x per pass-1 chunk
  size_t rs_smem;  // pass-1 dynamic shared memory
  int nb;          // 64-row tiles of pass 2
  int npairs;      // tile pairs (ti <= tj)
  int grid;        // pass-2 CTAs
  size_t mean_off, tot_off, partial_off, ticket_off, bytes;  // scratch layout
};

inline size_t align256(size_t b) { return (b + 255) / 256 * 256; }

inline GramPlan gram_plan(int n, int c) {
  GramPlan p;
  p.rt = 128;  // the most rows per CTA (reuse of each x_j) that still fill the card
  while (p.rt > 16 && (n + p.rt - 1) / p.rt < RS_MIN_CTAS) p.rt /= 2;
  p.nrt = (n + p.rt - 1) / p.rt;
  p.jc = n <= RS_ONE ? n : RS_JC;
  p.rs_smem = sizeof(float) * (n <= RS_ONE ? 1 : 2) * p.jc * c;
  p.nb = (n + TILE - 1) / TILE;
  p.npairs = p.nb * (p.nb + 1) / 2;
  p.grid = p.npairs < GRID_CAP ? p.npairs : GRID_CAP;
  const size_t rows = static_cast<size_t>(p.nrt) * p.rt;
  p.mean_off = 0;  // float [rows][c]: the row means
  p.tot_off = align256(sizeof(float) * rows * c);  // float [nrt][c]: tile totals
  p.partial_off = align256(p.tot_off + sizeof(float) * p.nrt * c);  // float [NPAIR][grid]
  p.ticket_off = align256(p.partial_off + sizeof(float) * p.grid * NPAIR);
  p.bytes = p.ticket_off + sizeof(int);
  return p;
}

// Under programmatic dependent launch a kernel may start before the one
// before it on the stream has finished: wait for it (and its writes) here.
// Without that launch attribute this returns at once.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Sums over the warp, every lane getting the same bits; for an array the
// levels go outermost, so its N shuffles of a level are in flight together.
template <typename T, int N>
__device__ __forceinline__ void warp_sum(T (&v)[N]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] += __shfl_xor_sync(0xffffffffu, v[q], off);
  }
}

// 16 bytes global -> shared without registers; bytes < 16 fills the rest
// with zeros (0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {  // all but the newest N groups have landed
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int C>
__global__ void __launch_bounds__(32 * C)
dcov_rowsum_kernel(const float* __restrict__ x, float* __restrict__ mean,
                   float* __restrict__ tot, int* __restrict__ ticket, int n, int rt, int jc) {
  constexpr int NTH = 32 * C;
  extern __shared__ __align__(16) float xs[];  // x_j: one chunk of jc rows, or two
  __shared__ float red[NTH][RS_RPT];  // each thread's sums, then the CTA's row means
  const int tid = threadIdx.x, c = tid % C, u = tid / C;
  const int rg = rt / RS_RPT, k = u / rg, g = u % rg, kk = 32 / rg;
  if (blockIdx.x == 0 && tid == 0) *ticket = 0;  // pass 2 reads it after its wait
  const int i0 = blockIdx.x * rt + g * RS_RPT;
  float xi[RS_RPT], acc[RS_RPT];
#pragma unroll
  for (int r = 0; r < RS_RPT; ++r) {
    xi[r] = i0 + r < n ? x[static_cast<long long>(i0 + r) * C + c] : 0.0f;
    acc[r] = 0.0f;
  }
  // x in chunks of jc rows by cp.async, the next chunk landing while this
  // one is summed (a chunk of jc * C floats starts on a 16-byte boundary)
  const long long total = static_cast<long long>(n) * C;
  auto load = [&](int ch, int buf) {
    const long long base = static_cast<long long>(ch) * jc * C;
    const long long left = total - base;
    const int f4 = static_cast<int>(((left < static_cast<long long>(jc) * C ? left
                                                                          : jc * C) + 3) / 4);
    float* dst = xs + static_cast<size_t>(buf) * jc * C;
    for (int q = tid; q < f4; q += NTH) {
      const long long e = base + 4LL * q;
      const int bytes = total - e < 4 ? static_cast<int>(4 * (total - e)) : 16;
      cp_async16(dst + 4 * q, x + e, bytes);
    }
    cp_async_commit();
  };
  const int nch = (n + jc - 1) / jc;
  load(0, 0);
  for (int ch = 0; ch < nch; ++ch) {
    const int cur = ch & 1;
    if (ch + 1 < nch) {
      load(ch + 1, cur ^ 1);  // its buffer was last read in the chunk before: all are past it
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int jn = min(jc, n - ch * jc);
    const float* xc = xs + static_cast<size_t>(cur) * jc * C + c;
#pragma unroll 4
    for (int j = k; j < jn; j += kk) {
      const float xj = xc[j * C];
#pragma unroll
      for (int r = 0; r < RS_RPT; ++r) acc[r] += fabsf(xi[r] - xj);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RS_RPT; ++r) red[tid][r] = acc[r];
  __syncthreads();
  const float inv_n = 1.0f / static_cast<float>(n);
  float m[RS_RPT];
  if (k == 0) {  // the j phases in order, then the means
#pragma unroll
    for (int r = 0; r < RS_RPT; ++r) {
      float v = red[tid][r];
      for (int q = 1; q < kk; ++q) v += red[tid + q * rg * C][r];
      m[r] = i0 + r < n ? v * inv_n : 0.0f;
      if (i0 + r < n) mean[static_cast<long long>(i0 + r) * C + c] = m[r];
    }
  }
  __syncthreads();
  if (k == 0) {
#pragma unroll
    for (int r = 0; r < RS_RPT; ++r) red[tid][r] = m[r];
  }
  __syncthreads();
  if (tid < C) {  // the tile's column total, rows in order
    float v = 0.0f;
    for (int q = 0; q < rg; ++q) {
#pragma unroll
      for (int r = 0; r < RS_RPT; ++r) v += red[tid + q * C][r];
    }
    tot[static_cast<long long>(blockIdx.x) * C + tid] = v;
  }
}

template <int C>
__device__ __forceinline__ void pair_of_c(int p, int* c, int* d) {
  int cc = 0;
  while (p >= C - cc) {
    p -= C - cc;
    ++cc;
  }
  *c = cc;
  *d = cc + p;
}

template <int C>
__device__ __forceinline__ void accumulate(const float (&a)[C], float half,
                                           float (&acc)[C * (C + 1) / 2]) {
  int q = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float ac = a[c] * half;  // half is 1 or 0.5: exact
#pragma unroll
    for (int d = c; d < C; ++d) {
      acc[q] = fmaf(ac, a[d], acc[q]);
      ++q;
    }
  }
}

// One (i, j) pair: the centred values, then the products.
template <int C, int CQ>
__device__ __forceinline__ void pair_terms(const float* xs, const float* ms, const float (&xj)[C],
                                           const float (&hj)[C], float half,
                                           float (&acc)[C * (C + 1) / 2]) {
  float xi[CQ], mi[CQ];
#pragma unroll
  for (int k = 0; k < CQ / 4; ++k) {
    const float4 u = reinterpret_cast<const float4*>(xs)[k];
    const float4 v = reinterpret_cast<const float4*>(ms)[k];
    xi[4 * k] = u.x, xi[4 * k + 1] = u.y, xi[4 * k + 2] = u.z, xi[4 * k + 3] = u.w;
    mi[4 * k] = v.x, mi[4 * k + 1] = v.y, mi[4 * k + 2] = v.z, mi[4 * k + 3] = v.w;
  }
  float a[C];
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = (fabsf(xi[c] - xj[c]) - mi[c]) + hj[c];
  accumulate<C>(a, half, acc);
}

// The next tile pair of a CTA that walks the column-major upper triangle
// (p = tj (tj + 1) / 2 + ti, ti <= tj) in steps of `step`.
__device__ __forceinline__ void next_pair(int step, int* ti, int* tj) {
  *ti += step;
  while (*ti > *tj) {
    *ti -= *tj + 1;
    ++*tj;
  }
}

template <int C>
__global__ void __launch_bounds__(GT, 4)
dcov_gram_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ tot, float* __restrict__ partial,
                 float* __restrict__ gram, int* __restrict__ ticket, int n, int nb, int nrt) {
  constexpr int CQ = (C + 3) / 4 * 4;  // a row of the i-tile, padded for float4 loads
  constexpr int NP = C * (C + 1) / 2;
  constexpr int NW = GT / 32;
  constexpr int PER = (TILE * C + GT - 1) / GT;  // i-tile values per thread
  __shared__ __align__(16) float xi_s[2][TILE * CQ];  // two i-tiles: this pair's, the next's
  __shared__ __align__(16) float mi_s[2][TILE * CQ];
  __shared__ float g_s[C];
  __shared__ double wred[NW][NP];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = tid % TILE, ih = tid / TILE;
  const float inv_n = 1.0f / static_cast<float>(n);
  const int npairs = nb * (nb + 1) / 2;
  int ti = 0, tj = 0;
  next_pair(blockIdx.x, &ti, &tj);
  grid_dependency_wait();

  // the grand mean: every tile total in order (per lane, then a tree), / n;
  // warp w takes columns w and w + 4
  {
    float v[2] = {0.0f, 0.0f};
#pragma unroll 4
    for (int t = lane; t < nrt; t += 32) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (warp + h * NW < C) v[h] += __ldcg(tot + static_cast<long long>(t) * C + warp + h * NW);
    }
    warp_sum(v);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (lane == 0 && warp + h * NW < C) g_s[warp + h * NW] = v[h] * inv_n;
  }

  // a tile pair's inputs, into registers: the i-tile's x and m (this
  // thread's share) and x_j, m_j of this thread's j
  float px[PER], pm[PER], nx[C], nm[C];
  auto fetch = [&](int fi, int fj) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + q * GT, gi = fi * TILE + e / C;
      const bool v = e < TILE * C && gi < n;
      px[q] = v ? x[static_cast<long long>(gi) * C + e % C] : 0.0f;
      pm[q] = v ? __ldcg(mean + static_cast<long long>(gi) * C + e % C) : 0.0f;
    }
    const int gj = fj * TILE + j;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      nx[c] = gj < n ? x[static_cast<long long>(gj) * C + c] : 0.0f;
      nm[c] = gj < n ? __ldcg(mean + static_cast<long long>(gj) * C + c) : 0.0f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + q * GT;
      if (e < TILE * C) {
        xi_s[buf][(e / C) * CQ + e % C] = px[q];
        mi_s[buf][(e / C) * CQ + e % C] = pm[q];
      }
    }
  };
  if (blockIdx.x < npairs) {
    fetch(ti, tj);
    stash(0);
  }
  __syncthreads();
  float grand[C];
#pragma unroll
  for (int c = 0; c < C; ++c) grand[c] = g_s[c];

  float acc[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) acc[q] = 0.0f;
  int cur = 0;
  for (int p = blockIdx.x; p < npairs; p += gridDim.x) {
    const int ci = ti, cj = tj;
    const bool jv = cj * TILE + j < n;
    float xj[C], hj[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      xj[c] = nx[c];
      hj[c] = grand[c] - nm[c];
    }
    const bool more = p + static_cast<int>(gridDim.x) < npairs;
    if (more) {  // the next tile pair's inputs load under this one's work
      next_pair(gridDim.x, &ti, &tj);
      fetch(ti, tj);
    }
    if (jv) {
      const float* xs = xi_s[cur];
      const float* ms = mi_s[cur];
      const int i0 = ih * (TILE / 2);
      int i1 = min(i0 + TILE / 2, n - ci * TILE);
      if (ci == cj) i1 = min(i1, j);  // the strict upper triangle of a diagonal tile
      for (int i = i0; i < i1; ++i) pair_terms<C, CQ>(xs + i * CQ, ms + i * CQ, xj, hj, 1.0f, acc);
      if (ci == cj && ih == 0)  // i = j, at half weight
        pair_terms<C, CQ>(xs + j * CQ, ms + j * CQ, xj, hj, 0.5f, acc);
    }
    if (more) stash(cur ^ 1);  // read last in the tile pair before: all are past it
    __syncthreads();
    cur ^= 1;
  }

  // the CTA's partial: a shuffle tree in each warp, then the warps in order
  warp_sum(acc);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < NP; ++q) wred[warp][q] = acc[q];
  }
  __syncthreads();
  if (tid < NP) {
    float v = static_cast<float>(wred[0][tid]);
    for (int w = 1; w < NW; ++w) v += static_cast<float>(wred[w][tid]);
    partial[static_cast<size_t>(tid) * gridDim.x + blockIdx.x] = v;  // [NP][grid]
  }
  __syncthreads();
  if (tid == 0) {  // the CTA's partial is visible before its ticket; the last sees every partial
    __threadfence();
    last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // the last CTA adds the partials (read from L2, past its own cache) in
  // float64: thread t the CTAs t, t + GT, ... in order, then a shuffle tree
  // and the warps in order; the Gram is twice the half-Gram
  double s[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) s[q] = 0.0;
  for (int b = tid; b < static_cast<int>(gridDim.x); b += GT) {
#pragma unroll
    for (int q = 0; q < NP; ++q)
      s[q] += static_cast<double>(__ldcg(partial + static_cast<size_t>(q) * gridDim.x + b));
  }
  __syncthreads();  // every thread has read wred above
  warp_sum(s);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < NP; ++q) wred[warp][q] = s[q];
  }
  __syncthreads();
  if (tid < NP) {
    double v = wred[0][tid];
    for (int w = 1; w < NW; ++w) v += wred[w][tid];
    int c, d;
    pair_of_c<C>(tid, &c, &d);
    const float out = static_cast<float>(2.0 * v);
    gram[c * C + d] = out;
    gram[d * C + c] = out;
  }
}

template <int C>
cudaError_t launch_gram(const float* x, char* scratch, float* gram, int n, cudaStream_t stream) {
  const GramPlan p = gram_plan(n, C);
  float* mean = reinterpret_cast<float*>(scratch + p.mean_off);
  float* tot = reinterpret_cast<float*>(scratch + p.tot_off);
  float* partial = reinterpret_cast<float*>(scratch + p.partial_off);
  int* ticket = reinterpret_cast<int*>(scratch + p.ticket_off);
  static bool granted[64] = {};  // per device: the pass-1 shared memory raised once
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!granted[device]) {
    err = cudaFuncSetAttribute(dcov_rowsum_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(float) * RS_ONE * C));
    if (err != cudaSuccess) return err;
    granted[device] = true;
  }
  dcov_rowsum_kernel<C><<<p.nrt, 32 * C, p.rs_smem, stream>>>(x, mean, tot, ticket, n, p.rt, p.jc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(GT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dcov_gram_kernel<C>, x, static_cast<const float*>(mean),
                            static_cast<const float*>(tot), partial, gram, ticket, n, p.nb,
                            p.nrt);
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

// Bytes of scratch the caller allocates for repro_dcov_gram at (n, c).
extern "C" long long repro_dcov_gram_scratch_bytes(int n, int c) {
  if (n < 1 || c < 1 || c > CP) return -1;
  return static_cast<long long>(gram_plan(n, c).bytes);
}

extern "C" int repro_dcov_gram(const void* x, void* scratch, void* gram, int device, int n,
                               int c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 1 || c < 1 || c > CP || reinterpret_cast<size_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  char* sc = static_cast<char*>(scratch);
  float* g = static_cast<float*>(gram);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return launch_gram<1>(xf, sc, g, n, s);
    case 2: return launch_gram<2>(xf, sc, g, n, s);
    case 3: return launch_gram<3>(xf, sc, g, n, s);
    case 4: return launch_gram<4>(xf, sc, g, n, s);
    case 5: return launch_gram<5>(xf, sc, g, n, s);
    case 6: return launch_gram<6>(xf, sc, g, n, s);
    case 7: return launch_gram<7>(xf, sc, g, n, s);
    default: return launch_gram<8>(xf, sc, g, n, s);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
