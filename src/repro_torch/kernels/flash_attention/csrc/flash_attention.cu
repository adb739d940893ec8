// Flash attention forward for NVIDIA Hopper (sm_90a): causal, sliding
// window and grouped-query attention with an online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/
// flash_attention.py::_flash_kernel (entry flash_attention_bhsd). It
// computes the same function: out = softmax(mask(q k^T * D^-1/2)) v with
// float32 running max, denominator and accumulator, query head h reading
// KV head h / (Hq / Hkv), positions contiguous from 0 on both axes, keys at
// or past Sk masked, and the output written in the inputs' dtype.
//
// Layout of the work. The TPU ran a sequential grid (B, Hq, nQ, nK) and
// carried the softmax state across the nK axis in VMEM scratch. Here one
// thread block owns one (batch, query head, 64-row query tile); a loop
// inside the block walks the 64-key tiles, so the state never leaves
// registers. Tiles that the causal mask or the sliding window empties are
// never loaded; the ragged tail is zero-filled on load and masked.
//
// Two bodies share that layout:
//
// * flash_fwd_mma — bf16 with D == Dv in {16, 32, 64, 128} (the serving
//   path). Four warps, each owning 16 query rows, run the two products on
//   the tensor cores with mma.sync m16n8k16 (bf16 in, float32 out). Tiles
//   are staged in shared memory as bf16 with rows padded by 16 bytes so
//   ldmatrix reads hit distinct banks, in two stages: cp.async brings
//   the next K/V tile in while the current one is multiplied. Q
//   fragments stay in registers for the whole key loop; S stays in
//   registers and is re-packed as the bf16 A operand of P V (P is
//   rounded to bf16 there, as FlashAttention-2 does; the row sums use
//   the float32 values).
// * flash_fwd_simt — every other case (float32, Dv != D, unaligned
//   views): float32 FMAs on the CUDA cores from float32 tiles in shared
//   memory; 256 threads as a 16 x 16 grid, thread (ty, tx) owning query
//   rows 4*ty .. 4*ty+3, keys tx + 16*j and output columns tx + 16*c.
//
// What bounds it on the card: at the serving shape (B=4, Hq=16, Hkv=2,
// S=512, D=128, bf16) the function moves ~19 MB and does ~4.3 GFLOP, so
// the roofline is the memory side (~5.6 us). Neither body uses wgmma or
// TMA, and each block re-reads K/V once per 64-row query tile, so both
// run well above that roofline; see PERF.md for the measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block (both bodies)
constexpr int BK = 64;       // keys per tile (both bodies)
constexpr int TX = 16;       // threads across keys / output columns
constexpr int TY = 16;       // threads across query rows
constexpr int NT = TX * TY;  // threads per block (simt body)
constexpr int RQ = BQ / TY;  // query rows per thread
constexpr int RK = BK / TX;  // keys per thread
constexpr int NW = BQ / 16;  // warps per block (mma body): 16 rows each
constexpr float NEG_INF = -1e30f;  // the reference's mask value

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, sq, sk, d;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal;
  int window;  // <= 0: no window
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int DV>
__global__ void __launch_bounds__(NT) flash_fwd_simt(Params p) {
  static_assert(DV % TX == 0, "value head width must be a multiple of 16");
  constexpr int CV = DV / TX;  // output columns per thread
  extern __shared__ float smem[];
  const int d = p.d;
  const int ld = d + 1;  // padded row stride of the Q and K tiles
  float* qs = smem;              // BQ x ld
  float* ks = qs + BQ * ld;      // BK x ld
  float* vs = ks + BK * ld;      // BK x DV
  float* ps = vs + BK * DV;      // BQ x (BK + 1)
  constexpr int lp = BK + 1;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * d; i += NT) {
    const int r = i / d, c = i % d;
    const int qi = q0 + r;
    qs[r * ld + c] = qi < p.sq ? to_f32(qg[qi * p.q_ss + c]) : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][CV];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[i][c] = 0.f;
  }

  const int q_last = q0 + BQ - 1;
  const int nk = (p.sk + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    // whole-tile skips, uniform over the block (the reference's `relevant`)
    if (p.causal && k0 > q_last) break;
    if (p.window > 0 && k0 + BK - 1 <= q0 - p.window) continue;

    __syncthreads();  // the previous tile's reads of ks / vs / ps are done
    for (int i = tid; i < BK * d; i += NT) {
      const int r = i / d, c = i % d;
      const int kj = k0 + r;
      ks[r * ld + c] = kj < p.sk ? to_f32(kg[kj * p.k_ss + c]) : 0.f;
    }
    for (int i = tid; i < BK * DV; i += NT) {
      const int r = i / DV, c = i % DV;
      const int kj = k0 + r;
      vs[r * DV + c] = kj < p.sk ? to_f32(vg[kj * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int jj = 0; jj < RK; ++jj) s[i][jj] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[RQ], bk[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = qs[(ty * RQ + i) * ld + c];
#pragma unroll
      for (int jj = 0; jj < RK; ++jj) bk[jj] = ks[(tx + jj * TX) * ld + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int jj = 0; jj < RK; ++jj) s[i][jj] = fmaf(a[i], bk[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty * RQ + i;
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < RK; ++jj) {
        const int kj = k0 + tx + jj * TX;
        bool ok = kj < p.sk;
        if (p.causal) ok = ok && kj <= qi;
        if (p.window > 0) ok = ok && (qi - kj) < p.window;
        s[i][jj] = ok ? s[i][jj] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, TX));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < RK; ++jj) {
        const float e = expf(s[i][jj] - m_new);
        ps[(ty * RQ + i) * lp + tx + jj * TX] = e;
        sum += e;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, TX);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CV; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float pr[RQ], vv[CV];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pr[i] = ps[(ty * RQ + i) * lp + kk];
#pragma unroll
      for (int c = 0; c < CV; ++c) vv[c] = vs[kk * DV + tx + c * TX];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CV; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty * RQ + i;
    if (qi >= p.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CV; ++c)
      store(og + qi * p.o_ss + tx + c * TX, acc[i][c] / den);
  }
}

// ------------------------------------------------------------ mma body
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Start copying rows [row0, row0 + BK) of a tile WIDTH bf16 wide from
// global (row stride `ld_g` elements) into shared memory (row stride
// `ld_s`), 16 bytes per thread and step; rows at or past `valid` are
// zero-filled.
template <int WIDTH>
__device__ __forceinline__ void issue_tile(__nv_bfloat16* dst, int ld_s,
                                           const __nv_bfloat16* src,
                                           long long ld_g, int row0, int valid) {
  constexpr int CH = WIDTH / 8;
  static_assert(BQ == BK, "Q and K/V tiles share one row count");
  for (int i = threadIdx.x; i < BK * CH; i += NW * 32) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = row0 + r < valid;
    cp_async16(dst + r * ld_s + c, ok ? src + (row0 + r) * ld_g + c : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(NW * 32) flash_fwd_mma(Params p) {
  constexpr int LD = D + 8;      // padded shared-memory row (bf16 elements)
  constexpr int KS = D / 16;     // k-steps of Q K^T
  constexpr int NS = BK / 8;     // 8-key column blocks of S per warp
  constexpr int NO = D / 8;      // 8-wide column blocks of O per warp
  // two stages of (K, V) tiles; Q is staged in stage 1's K slot until its
  // fragments are in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  auto k_tile = [&](int st) { return kv + (2 * st) * BK * LD; };
  auto v_tile = [&](int st) { return kv + (2 * st + 1) * BK * LD; };

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group / column pair
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // the key tiles this query tile needs: a contiguous range (the
  // reference's `relevant` test, solved for j)
  const int q_last = q0 + BQ - 1;
  const int nk = (p.sk + BK - 1) / BK;
  const int j_end = p.causal ? min(nk, q_last / BK + 1) : nk;
  int j_begin = 0;
  if (p.window > 0) {
    const int x = q0 - p.window - BK + 1;  // tile j is needed iff j * BK > x
    j_begin = x < 0 ? 0 : x / BK + 1;
  }

  issue_tile<D>(k_tile(1), LD, qg, p.q_ss, q0, p.sq);
  if (j_begin < j_end) {
    issue_tile<D>(k_tile(0), LD, kg, p.k_ss, j_begin * BK, p.sk);
    issue_tile<D>(v_tile(0), LD, vg, p.v_ss, j_begin * BK, p.sk);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[KS][4];  // this warp's 16 query rows as mma A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], k_tile(1) + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
  __syncthreads();  // stage 1 is free for the next tile

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row = q0 + warp * 16 + g;  // this thread's rows: row, row + 8

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * BK;
    const int st = (j - j_begin) & 1;
    if (j + 1 < j_end) {  // prefetch the next tile while this one computes
      issue_tile<D>(k_tile(st ^ 1), LD, kg, p.k_ss, k0 + BK, p.sk);
      issue_tile<D>(v_tile(st ^ 1), LD, vg, p.v_ss, k0 + BK, p.sk);
      cp_async_commit();
    }
    const __nv_bfloat16* ks = k_tile(st);
    const __nv_bfloat16* vs = v_tile(st);

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t bf[4];
        ldsm_x4(bf, ks + (n2 * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                        ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * n2], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * n2 + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale, mask, online softmax; fragment element e of column block n is
    // row (row + 8 * (e / 2)), key (k0 + 8 * n + 2 * t + e % 2)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = row + 8 * (e / 2);
        const int kj = k0 + 8 * n + 2 * t + (e % 2);
        bool ok = kj < p.sk;
        if (p.causal) ok = ok && kj <= qi;
        if (p.window > 0) ok = ok && (qi - kj) < p.window;
        s[n][e] = ok ? s[n][e] * p.scale : NEG_INF;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e / 2]);
        sum[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: the S fragments of key blocks 2kk, 2kk+1 are P's A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                          n2 * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * n2], pa, bf[0], bf[1]);
        mma_bf16(o[2 * n2 + 1], pa, bf[2], bf[3]);
      }
    }
    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... and every warp is done with this one
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    if (qi >= p.sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(og + qi * p.o_ss + 8 * n + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * r] / den, o[n][2 * r + 1] / den);
  }
}

// ------------------------------------------------------------- launches
// Above 48 KB of dynamic shared memory a kernel must opt in; each
// instantiation raises its grant once to the largest size asked for.
template <typename Kernel>
cudaError_t grant_smem(Kernel kernel, size_t bytes, size_t& granted) {
  if (bytes <= granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) granted = bytes;
  return err;
}

template <typename T, int DV>
cudaError_t launch_simt(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t(BQ) * (p.d + 1) + size_t(BK) * (p.d + 1) +
                                       size_t(BK) * DV + size_t(BQ) * (BK + 1));
  static size_t granted = 48 * 1024;
  cudaError_t err = grant_smem(flash_fwd_simt<T, DV>, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.hq, batch);
  flash_fwd_simt<T, DV><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * size_t(4 * BK) * (D + 8);
  static size_t granted = 48 * 1024;
  cudaError_t err = grant_smem(flash_fwd_mma<D>, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.hq, batch);
  flash_fwd_mma<D><<<grid, NW * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_simt(const Params& p, int batch, int dv, cudaStream_t stream) {
  switch (dv) {
    case 16: return launch_simt<T, 16>(p, batch, stream);
    case 32: return launch_simt<T, 32>(p, batch, stream);
    case 64: return launch_simt<T, 64>(p, batch, stream);
    case 128: return launch_simt<T, 128>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the mma body reads 16-byte vectors: every base pointer and stride must
// keep rows 16-byte aligned
bool vector_aligned(const Params& p) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
                         reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.o);
  const long long strides = p.q_sb | p.q_sh | p.q_ss | p.k_sb | p.k_sh | p.k_ss |
                            p.v_sb | p.v_sh | p.v_ss | p.o_sb | p.o_sh | p.o_ss;
  return ptrs % 16 == 0 && strides % 8 == 0;
}

cudaError_t dispatch_bf16(const Params& p, int batch, int dv, cudaStream_t stream) {
  if (p.d == dv && vector_aligned(p)) {
    switch (dv) {
      case 16: return launch_mma<16>(p, batch, stream);
      case 32: return launch_mma<32>(p, batch, stream);
      case 64: return launch_mma<64>(p, batch, stream);
      case 128: return launch_mma<128>(p, batch, stream);
      default: break;
    }
  }
  return dispatch_simt<__nv_bfloat16>(p, batch, dv, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Strides are in elements; the last axis of
// every tensor is contiguous. window <= 0 means no sliding window.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int device, int batch, int hq, int hkv, int sq, int sk, int d, int dv,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Params p{q,    k,    v,    o,    hq,   hkv,  sq,     sk,     d,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,   v_sh,   v_ss,
           o_sb, o_sh, o_ss, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_simt<float>(p, batch, dv, s);
  if (dtype == 1) return dispatch_bf16(p, batch, dv, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
