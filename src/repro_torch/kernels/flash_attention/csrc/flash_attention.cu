// Flash attention forward for NVIDIA Hopper (sm_90a): causal, sliding
// window and grouped-query attention with an online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/
// flash_attention.py::_flash_kernel (entry flash_attention_bhsd). It
// computes the same function: out = softmax(mask(q k^T * D^-1/2)) v with
// float32 running max, denominator and accumulator, query head h reading
// KV head h / (Hq / Hkv), positions contiguous from 0 on both axes, keys at
// or past Sk masked, and the output written in the inputs' dtype in
// (B, Sq, Hq, Dv) memory order.
//
// Layout of the work. The TPU ran a sequential grid (B, Hq, nQ, nK) and
// carried the softmax state across the nK axis in VMEM scratch. Here one
// thread block owns one (batch, query head, query tile); a loop inside the
// block walks the key tiles, so the state never leaves registers. Tiles
// that the causal mask or the sliding window empties are never loaded; the
// ragged tail is zero-filled on load and masked.
//
// What bounds it on the card: at the serving shape (B=4, Hq=16, Hkv=2,
// S=512, D=128, bf16, causal) the function moves 18.9 MB and does 4.30
// GFLOP, so the roofline is the memory side: 18.9 MB at 3.35 TB/s =
// 5.63 us (the FLOPs take 4.3 us at 989 TFLOP/s). At DeepSeek-V2's MLA
// prefill (B=4, H=128, S=512, D=192, Dv=128) it is the memory side too:
// 335.5 MB, 100.2 us, above 43.0 GFLOP at 989 TFLOP/s (43.5 us).
//
// Three bodies; the wrapper (flash_attention.py::body_for) names one and
// the entry launches exactly that one or returns an error:
//
// * flash_fwd_wgmma — bf16 with (D, Dv) in {(64, 64), (128, 128),
//   (192, 128), (64, 128)} and 16-byte aligned rows: the serving path
//   (Qwen2.5-3B, Granite, InternLM2, Hymba, Moonlight-16B-A3B; DeepSeek-V2's
//   MLA at D = qk_nope + qk_rope = 192, Dv = 128; the published Hymba's
//   Q and K of 64 with V of 128). What it does about what held
//   the Ampere-style body back:
//   1. Tensor cores: both products on wgmma. S = Q K^T is m64n128k16 with
//      Q and K read K-major from shared memory; O += P V takes P (rounded
//      to bf16, as before) as the A operand from registers and V from
//      shared memory through the descriptor's transpose bit, so each
//      64-row warpgroup reads a K/V tile once, not once per 16-row warp.
//   2. Overlap: three warpgroups. One producer thread issues TMA loads
//      into a ring of K/V stages with full/empty mbarriers while two
//      consumer warpgroups (64 query rows each, a 128-row tile per CTA)
//      compute, each in its own time, so one's softmax can run under the
//      other's products; setmaxnreg moves registers from the producer (24)
//      to the consumers (240). At D = 128: Q 32 KB + 3 x (K 32 KB + V 32 KB)
//      = 224 KB of shared memory, one CTA per SM. At D = 192, Dv = 128
//      the K tile is 48 KB and the V tile 32 KB: Q 48 KB + 2 x 80 KB =
//      208 KB; a third stage would not fit (WsSmem derives the depth).
//   3. Heavy first: the grid counts query tiles from the last, so the
//      causal tiles with the most key tiles start first: over all heads
//      for D == Dv (GQA: a K/V tile serves many query heads), within each
//      head at D = 192 (MHA over 128 wide heads: the query tiles of one
//      head run side by side and share its K/V through L2).
//   4. Masking only where needed: the causal, window and tail mask runs
//      only on tiles that cross the diagonal, the window edge or the tail,
//      as two compares against per-row bounds; the softmax is exp2 of one
//      FFMA (scale * log2 e folded in).
//   5. Pipeline: three stages (four at D = 64, two at D = 192) in flight;
//      Q, K and V land on barriers of their own, so S = Q K^T starts while
//      V is in flight; no __syncthreads runs in the key loop.
//   6. Host cost: the entry does not switch devices; it encodes three
//      tensor maps over the strided (B, H, S, D) views as given (the
//      model's (B, S, H, D) memory is read in place) and launches.
//   O is staged in the warpgroup's own Q rows (Q's region is max(D, Dv)
//   wide) and written with 16-byte stores.
//
// A sink (every body): with a window, keys [0, sink) stay visible to every
// query whatever the window (the published Hymba's meta tokens). The
// wgmma body walks the tiles that hold them first, then the window's; a
// tile with sink keys masks by c > lo || c < sink bound, every other tile
// as before. The mma body walks every tile from 0 when a sink is given.
// * flash_fwd_mma — bf16 with D == Dv in {16, 32} and aligned rows: four
//   warps of mma.sync m16n8k16 over 64 x 64 tiles, cp.async double
//   buffering (the first tensor-core body, kept for the widths the wgmma
//   body does not take).
// * flash_fwd_simt — every other case (float32, other D != Dv, unaligned
//   views): float32 FMAs on the CUDA cores from float32 tiles in shared
//   memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <cstdio>

namespace {

constexpr int BQ = 64;       // query rows per block (simt and mma bodies)
constexpr int BK = 64;       // keys per tile (simt and mma bodies)
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
  int sink;    // with a window: keys [0, sink) stay visible to every query
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

// 256 threads as a 16 x 16 grid; thread (ty, tx) owns query rows
// 4*ty .. 4*ty+3, keys tx + 16*j and output columns tx + 16*c.
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
    if (p.window > 0 && k0 + BK - 1 <= q0 - p.window && k0 >= p.sink) continue;

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
        if (p.window > 0) ok = ok && ((qi - kj) < p.window || kj < p.sink);
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
  if (p.window > 0 && p.sink <= 0) {  // with a sink every tile from 0 is walked (masked)
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
        if (p.window > 0) ok = ok && ((qi - kj) < p.window || kj < p.sink);
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


// ---------------------------------------------------------- wgmma body
// bf16, (D, Dv) in {(64, 64), (128, 128), (192, 128), (64, 128)}. One CTA owns a
// 128-row query tile of one (batch, query head) and three warpgroups:
//   WG 0, 1  consumers: each owns 64 query rows, runs S = Q K^T and
//            O += P V on wgmma and the online softmax in registers;
//   WG 2     producer: one thread issues TMA loads of Q (once) and of the
//            K/V tiles into a ring of WsSmem<D, DV>::STAGES stages.
// Shared-memory tiles are TMA boxes of 64 columns (128 bytes) x 128 rows
// in the 128-byte swizzle; a Q or K tile is D / 64 such boxes one after
// another, a V tile DV / 64. The wgmma descriptors read the same swizzle:
// Q and K K-major, V MN-major (the transpose bit), so V is never
// transposed in memory.
constexpr int WS_BQ = 128;                  // query rows per CTA
constexpr int WS_BK = 128;                  // keys per tile
constexpr int WS_THREADS = 3 * 128;         // two consumer WGs, one producer WG
constexpr int WS_CONSUMERS = 2 * 128;
constexpr uint32_t WS_BOX_BYTES = 128 * 128;  // one 64-column box of 128 rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t WS_SMEM_MAX = 232448;  // the most shared memory a block may use

// Shared-memory layout, in bytes from a 1024-aligned base: Q, then the
// ring's (K, V) stages, then the mbarriers (q, k_full[STAGES],
// v_full[STAGES], empty[STAGES]). The ring is as deep as the 227 KB a
// block may use allows (1024 bytes go to aligning the base), at most four
// stages: D = 64, 16 KB + 4 x 32 KB; D = 128, 32 KB + 3 x 64 KB; D = 192,
// Dv = 128, 48 KB + 2 x (48 + 32) KB. Each is more than half the SM's
// shared memory, so one CTA per SM: the consumers' setmaxnreg.inc can
// always be granted.
template <int D, int DV>
struct WsSmem {
  static constexpr uint32_t QK_TILE = (D / 64) * WS_BOX_BYTES;  // a Q or K tile
  static constexpr uint32_t V_TILE = (DV / 64) * WS_BOX_BYTES;
  // Q's region also stages O in the epilogue, so it is max(D, Dv) wide
  static constexpr uint32_t Q_TILE = (D > DV ? D : DV) / 64 * WS_BOX_BYTES;
  static constexpr int FIT = (WS_SMEM_MAX - 1024 - Q_TILE - 8) / (QK_TILE + V_TILE + 24);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;  // K/V ring depth
  static_assert(STAGES >= 1, "one K/V stage must fit beside Q");
  static constexpr uint32_t Q = 0;
  __host__ __device__ static constexpr uint32_t K(int st) {
    return Q_TILE + st * (QK_TILE + V_TILE);
  }
  __host__ __device__ static constexpr uint32_t V(int st) { return K(st) + QK_TILE; }
  static constexpr uint32_t BAR = Q_TILE + STAGES * (QK_TILE + V_TILE);
  static constexpr uint32_t BYTES = BAR + 8 * (1 + 3 * STAGES);
  // Grid order. Heavy first over all heads (the last query tile of every
  // (batch, head), then the one before, ...) suits GQA, where a K/V tile
  // serves many query heads. Head-major runs the query tiles of one
  // (batch, head) side by side, heaviest first, so at MHA with wide heads
  // (MLA: 128 heads, 320 KB of K and V a head at S = 512) each head's K/V
  // is read from device memory once and from L2 by the other tiles.
  static constexpr bool HEAD_MAJOR = D != DV;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64-column x 128-row box of a (D, S, H, B) tensor map into shared
// memory; rows past S arrive as zeros. Completion is counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, int col,
                                         int row, int head, int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(col), "r"(row), "r"(head), "r"(batch),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap& map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map))
               : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes of a wgmma's
// operands across the asynchronous window between issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F8(a, i)                                                                       \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]), "+f"(a[i + 4]),          \
      "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_n128_ss(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef F8

// Named barriers 1, 2: consumer warpgroup 0's, 1's own epilogue.
constexpr int WS_EPI_BAR = 1;

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One K/V tile for one consumer warpgroup: S = Q K^T, the mask where the
// tile crosses the diagonal, the window edge or the tail, the online
// softmax, and O += P V once V has landed (phase `parity` of barrier
// `v_full`).
template <int D, int DV>
__device__ __forceinline__ void consume_tile(const Params& p, float (&o)[DV / 64][32],
                                             float (&m)[2], float (&l)[2], uint32_t q_rows,
                                             uint32_t k_tile, uint32_t v_tile,
                                             uint32_t v_full, uint32_t parity, int k0,
                                             int r_first, int row0, int tq4) {
  constexpr int NCB = DV / 64;  // 64-column boxes of O and V
  const float sl2 = p.scale * LOG2E;

  // S = Q K^T: D / 16 steps of k16; within a box a step is 32 bytes on
  float s[64];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * WS_BOX_BYTES + (kk % 4) * 32;
    wgmma_n128_ss(s, smem_desc(q_rows + off, 16, 1024), smem_desc(k_tile + off, 16, 1024),
                  kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);

  // Element 4 nb + e is row row0 + 8 (e / 2), key k0 + 2 tq + c with
  // c = 8 nb + e % 2 known at compile time. Key kj is visible to row qi iff
  // kj < Sk, kj <= qi (causal) and qi - kj < window, i.e. lo < c < hi with
  // per-row bounds, so a masked tile pays two compares and a select.
  // A tile that holds sink keys (kj < sink, visible whatever the window)
  // takes a third bound, c < sink - k0 - 2 tq, beside the window's.
  const bool in_sink = p.window > 0 && k0 < p.sink;
  const bool edge = k0 + WS_BK > p.sk || (p.causal && k0 + WS_BK - 1 > r_first) ||
                    (p.window > 0 && r_first + 63 - k0 >= p.window && k0 + WS_BK > p.sink);
  if (edge) {
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rel = row0 + 8 * r - k0 - 2 * tq4;  // qi - (k0 + 2 tq)
      hi[r] = p.sk - k0 - 2 * tq4;
      if (p.causal) hi[r] = min(hi[r], rel + 1);
      lo[r] = p.window > 0 ? rel - p.window : -1;
    }
    if (in_sink) {
      const int sk_hi = p.sink - k0 - 2 * tq4;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int c = 8 * (i / 4) + (i % 2), r = (i % 4) / 2;
        s[i] = ((c > lo[r] || c < sk_hi) && c < hi[r]) ? s[i] : -INFINITY;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int c = 8 * (i / 4) + (i % 2), r = (i % 4) / 2;
        s[i] = (c > lo[r] && c < hi[r]) ? s[i] : -INFINITY;
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
  float ms[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    // a row with no visible key yet keeps p = 0 (no inf - inf)
    ms[r] = m_new == -INFINITY ? 0.f : m_new * sl2;
    corr[r] = fast_exp2(fmaf(m[r], sl2, -ms[r]));
    m[r] = m_new;
  }
  // p = 2^(s * scale * log2(e) - m * scale * log2(e)): one FFMA and one ex2
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = fast_exp2(fmaf(s[i], sl2, -ms[(i % 4) / 2]));
    sum[(i % 4) / 2] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];  // quad-partial sums
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] *= corr[(i % 4) / 2];

  // O += P V: P (bf16, the S fragments re-packed as wgmma A registers)
  // times V read MN-major through the descriptor's transpose bit; a k16
  // step is 16 key rows = 2048 bytes on
  uint32_t pa[WS_BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < WS_BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
  mbar_wait(v_full, parity);
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) fence_regs(o[cb]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WS_BK / 16; ++kk)
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
      wgmma_n64_rs(o[cb], pa[kk],
                   smem_desc(v_tile + cb * WS_BOX_BYTES + kk * 2048, WS_BOX_BYTES, 1024));
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) fence_regs(o[cb]);
#pragma unroll
  for (int kk = 0; kk < WS_BK / 16; ++kk) fence_regs(pa[kk]);
}

template <int D, int DV>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv) {
  using L = WsSmem<D, DV>;
  constexpr int NQB = D / 64;   // 64-column boxes per Q or K row
  constexpr int NCB = DV / 64;  // 64-column boxes per V or O row
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_bar = base + L::BAR;
  // K and V of a stage land on barriers of their own, so S = Q K^T can
  // start while V is still in flight
  auto k_full = [&](int st) { return base + L::BAR + 8 * (1 + st); };
  auto v_full = [&](int st) { return base + L::BAR + 8 * (1 + L::STAGES + st); };
  auto empty_bar = [&](int st) { return base + L::BAR + 8 * (1 + 2 * L::STAGES + st); };

  // heavy first: tile 0 is the last query tile, which under the causal
  // mask needs the most key tiles, so the longest CTAs start first: over
  // all heads on a (heads, query tiles) grid, or within one head on a 1-D
  // grid (L::HEAD_MAJOR). On the 2-D grid the tile and head come straight
  // from the block index: decoding them from a linear index by division
  // made the D == Dv shapes measurably slower (PERF.md §6).
  const int nq = L::HEAD_MAJOR ? (p.sq + WS_BQ - 1) / WS_BQ : gridDim.y;
  const int tile = L::HEAD_MAJOR ? blockIdx.x % nq : blockIdx.y;
  const int bh = L::HEAD_MAJOR ? blockIdx.x / nq : blockIdx.x;
  const int q0 = (nq - 1 - tile) * WS_BQ;
  const int h = bh % p.hq, b = bh / p.hq;
  const int hk = h / (p.hq / p.hkv);

  const int q_last = min(q0 + WS_BQ, p.sq) - 1;
  const int nk = (p.sk + WS_BK - 1) / WS_BK;
  const int j_end = p.causal ? min(nk, q_last / WS_BK + 1) : nk;
  int j_begin = 0;
  if (p.window > 0) {
    const int x = q0 - p.window - WS_BK + 1;  // tile j is needed iff j * BK > x
    j_begin = x < 0 ? 0 : x / WS_BK + 1;
  }
  // With a sink, the tiles [0, n_sink) that hold its keys come first, then
  // the window's [j_begin, j_end); iteration it walks tile tile_of(it).
  int n_sink = p.window > 0 && p.sink > 0 ? min((p.sink + WS_BK - 1) / WS_BK, j_end) : 0;
  if (j_begin <= n_sink) {  // the two ranges meet: one range from tile 0
    j_begin = 0;
    n_sink = 0;
  }
  const int n_it = n_sink + max(j_end - j_begin, 0);
  auto tile_of = [&](int it) { return it < n_sink ? it : j_begin + it - n_sink; };

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < L::STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty_bar(st), WS_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WS_CONSUMERS) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == WS_CONSUMERS) {
      prefetch_map(tq);
      prefetch_map(tk);
      prefetch_map(tv);
      mbar_expect_tx(q_bar, L::QK_TILE);
      for (int cb = 0; cb < NQB; ++cb)
        tma_load(base + L::Q + cb * WS_BOX_BYTES, tq, cb * 64, q0, h, b, q_bar);
      for (int it = 0; it < n_it; ++it) {
        const int j = tile_of(it), st = it % L::STAGES;
        mbar_wait(empty_bar(st), ((it / L::STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full(st), L::QK_TILE);
        for (int cb = 0; cb < NQB; ++cb)
          tma_load(base + L::K(st) + cb * WS_BOX_BYTES, tk, cb * 64, j * WS_BK, hk, b,
                   k_full(st));
        mbar_expect_tx(v_full(st), L::V_TILE);
        for (int cb = 0; cb < NCB; ++cb)
          tma_load(base + L::V(st) + cb * WS_BOX_BYTES, tv, cb * 64, j * WS_BK, hk, b,
                   v_full(st));
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;  // which 64 query rows
    const int t = threadIdx.x % 128;
    const int g = (t % 32) / 4, tq4 = t % 4;
    const int r_first = q0 + 64 * wg;          // this WG's first row
    const int row0 = r_first + 16 * (t / 32) + g;  // this thread's rows: row0, row0 + 8

    float o[NCB][32];
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_bar, 0);
    const uint32_t q_rows = base + L::Q + wg * 64 * 128;
    for (int it = 0; it < n_it; ++it) {
      const int st = it % L::STAGES;
      const int k0 = tile_of(it) * WS_BK;
      const uint32_t parity = (it / L::STAGES) & 1;
      mbar_wait(k_full(st), parity);

      consume_tile<D, DV>(p, o, m, l, q_rows, base + L::K(st), base + L::V(st), v_full(st),
                      parity, k0, r_first, row0, tq4);
      mbar_arrive(empty_bar(st));  // this stage's K and V are free again
    }

    // epilogue: O / l, staged as bf16 in this WG's (now free) Q rows in the
    // same swizzle (16-byte chunk c of row r at chunk c ^ (r % 8): the
    // fragment stores hit 32 distinct banks; O fills the first DV / 64 of
    // the rows' D / 64 boxes), then 16-byte stores in (B, Sq, Hq, Dv)
    // order, rows past Sq dropped
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    named_sync(WS_EPI_BAR + wg, 128);  // every warp is done reading its Q rows
    const int lr0 = 16 * (t / 32) + g;  // local rows lr0, lr0 + 8 (same r % 8)
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int lr = lr0 + 8 * r;
          const uint32_t a = q_rows + cb * WS_BOX_BYTES + lr * 128 + ((nb ^ g) * 16) + tq4 * 4;
          __nv_bfloat162 v2 = __floats2bfloat162_rn(o[cb][4 * nb + 2 * r] * inv[r],
                                                    o[cb][4 * nb + 2 * r + 1] * inv[r]);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a),
                       "r"(*reinterpret_cast<uint32_t*>(&v2))
                       : "memory");
        }
    named_sync(WS_EPI_BAR + wg, 128);
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
    const unsigned char* stage = base_ptr + L::Q + wg * 64 * 128;
    constexpr int CH = DV / 8;  // 16-byte chunks per output row
#pragma unroll
    for (int i = t; i < 64 * CH; i += 128) {
      const int lr = i / CH, c = i % CH;
      const int qi = r_first + lr;
      if (qi >= p.sq) continue;
      const uint4 val = *reinterpret_cast<const uint4*>(
          stage + (c / 8) * WS_BOX_BYTES + lr * 128 + (((c % 8) ^ (lr % 8)) * 16));
      *reinterpret_cast<uint4*>(og + qi * p.o_ss + c * 8) = val;
    }
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

// Error codes above any cudaError_t: a failed tensor-map encode returns
// ERR_TENSOR_MAP + its CUresult; a missing driver entry point ERR_ENTRY_POINT.
constexpr int ERR_TENSOR_MAP = 100000;
constexpr int ERR_ENTRY_POINT = 200000;

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || sym == nullptr) return ERR_ENTRY_POINT;
    cached = reinterpret_cast<EncodeTiled>(sym);
  }
  *fn = cached;
  return 0;
}

// A (B, H, S, D) bf16 view with element strides (sb, sh, ss) and a
// contiguous last axis, as a 4-D tensor map (D, S, H, B) read in boxes of
// 64 columns x 128 rows with the 128-byte swizzle. The strides are taken
// as they are: the model's (B, S, H, D) memory is read without a copy.
int encode_bhsd(EncodeTiled encode, CUtensorMap* map, const void* ptr, int batch, int heads,
                int seq, int d, long long sb, long long sh, long long ss) {
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(seq), cuuint64_t(heads),
                              cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(ss) * 2, cuuint64_t(sh) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {64, WS_BK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + static_cast<int>(res);
}

template <int D, int DV>
int launch_wgmma(const Params& p, int batch, cudaStream_t stream) {
  static_assert(WS_BQ == WS_BK, "Q and K/V tiles share one tensor-map box");
  EncodeTiled encode;
  int rc = encode_tiled(&encode);
  if (rc != 0) return rc;
  CUtensorMap tq, tk, tv;
  if ((rc = encode_bhsd(encode, &tq, p.q, batch, p.hq, p.sq, D, p.q_sb, p.q_sh, p.q_ss)) ||
      (rc = encode_bhsd(encode, &tk, p.k, batch, p.hkv, p.sk, D, p.k_sb, p.k_sh, p.k_ss)) ||
      (rc = encode_bhsd(encode, &tv, p.v, batch, p.hkv, p.sk, DV, p.v_sb, p.v_sh, p.v_ss)))
    return rc;
  const size_t smem = WsSmem<D, DV>::BYTES + 1024;  // + room to align the tiles to 1024
  static_assert(WsSmem<D, DV>::BYTES + 1024 <= WS_SMEM_MAX, "the ring must fit the block");
  static size_t granted = 48 * 1024;
  cudaError_t err = grant_smem(flash_fwd_wgmma<D, DV>, smem, granted);
  if (err != cudaSuccess) return err;
  // one CTA per (batch, head, query tile), in the order WsSmem::HEAD_MAJOR names
  const int nq = (p.sq + WS_BQ - 1) / WS_BQ;
  const dim3 grid = WsSmem<D, DV>::HEAD_MAJOR ? dim3(batch * p.hq * nq) : dim3(batch * p.hq, nq);
  flash_fwd_wgmma<D, DV><<<grid, WS_THREADS, smem, stream>>>(p, tq, tk, tv);
  return cudaGetLastError();
}

template <typename T>
int dispatch_simt(const Params& p, int batch, int dv, cudaStream_t stream) {
  switch (dv) {
    case 16: return launch_simt<T, 16>(p, batch, stream);
    case 32: return launch_simt<T, 32>(p, batch, stream);
    case 64: return launch_simt<T, 64>(p, batch, stream);
    case 128: return launch_simt<T, 128>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the tensor-core bodies read 16-byte vectors (mma) or TMA boxes (wgmma):
// every base pointer and stride must keep rows 16-byte aligned
bool vector_aligned(const Params& p) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
                         reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.o);
  const long long strides = p.q_sb | p.q_sh | p.q_ss | p.k_sb | p.k_sh | p.k_ss |
                            p.v_sb | p.v_sh | p.v_ss | p.o_sb | p.o_sh | p.o_ss;
  return ptrs % 16 == 0 && strides % 8 == 0;
}

}  // namespace

// The body is chosen by the caller (flash_attention.py::body_for):
// 0 simt (float32 or bfloat16, any D <= 256, Dv in {16, 32, 64, 128}),
// 1 mma (bfloat16, D == Dv in {16, 32}, rows 16-byte aligned),
// 2 wgmma (bfloat16, (D, Dv) in {(64, 64), (128, 128), (192, 128), (64, 128)},
//   rows 16-byte aligned).
// A body asked for a case it does not take returns cudaErrorInvalidValue;
// nothing here picks another body. dtype: 0 float32, 1 bfloat16. Strides
// are in elements; the last axis of every tensor is contiguous. window <= 0
// means no sliding window; with one, keys [0, sink) are never hidden by it. The kernel runs on the current device and the
// given stream. Returns 0 on success, else a code for
// repro_cuda_error_string.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int body,
    int batch, int hq, int hkv, int sq, int sk, int d, int dv,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, int sink, float scale, void* stream) {
  Params p{q,    k,    v,    o,    hq,   hkv,  sq,     sk,     d,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,   v_sh,   v_ss,
           o_sb, o_sh, o_ss, causal, window, sink, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tensor_core = dtype == 1 && vector_aligned(p);  // the (D, Dv) pair decides
  switch (body) {
    case 0:
      if (dtype == 0) return dispatch_simt<float>(p, batch, dv, s);
      if (dtype == 1) return dispatch_simt<__nv_bfloat16>(p, batch, dv, s);
      return cudaErrorInvalidValue;
    case 1:
      if (tensor_core && d == 16 && dv == 16) return launch_mma<16>(p, batch, s);
      if (tensor_core && d == 32 && dv == 32) return launch_mma<32>(p, batch, s);
      return cudaErrorInvalidValue;
    case 2:
      if (tensor_core && d == 64 && dv == 64) return launch_wgmma<64, 64>(p, batch, s);
      if (tensor_core && d == 128 && dv == 128) return launch_wgmma<128, 128>(p, batch, s);
      if (tensor_core && d == 192 && dv == 128) return launch_wgmma<192, 128>(p, batch, s);
      if (tensor_core && d == 64 && dv == 128) return launch_wgmma<64, 128>(p, batch, s);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  static thread_local char msg[96];
  if (err >= ERR_ENTRY_POINT) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (err >= ERR_TENSOR_MAP) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - ERR_TENSOR_MAP);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
