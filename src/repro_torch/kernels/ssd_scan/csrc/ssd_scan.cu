// Mamba2 SSD chunked scan forward for NVIDIA Hopper (sm_90a), ngroups = 1.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/ssd_scan.py::
// _ssd_kernel (entry ssd_pallas). It computes the same function: for each
// (batch b, head h) and each chunk of Q positions, with cs the inclusive
// cumulative sum of dt * A over the chunk and S the (hd x N) float32 state
// carried across chunks,
//
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//          + exp(cs_i) (C_i . S^T)
//   S'   = exp(cs_last) S + sum_j (dt_j x_j) (exp(cs_last - cs_j) B_j)^T
//
// every product in float32, y written in x's dtype and the final S in
// float32. Positions past the sequence end (the ragged tail) are loaded as
// zeros, exactly the reference's zero padding: with dt = 0 they leave cs
// and S unchanged. The causal decay is made by selection, never by a 0/1
// multiply: exp(cs_i - cs_j) is only evaluated for j <= i, where it is at
// most 1 (for j > i it can overflow to inf, and inf * 0 is NaN). x, B and C
// are read through their strides (the model hands in views of the
// convolution output), so the wrapper copies nothing.
//
// The TPU ran a sequential grid (B, NH, NC) and carried S across the chunk
// axis in VMEM scratch. Two bodies; the wrapper (ssd_scan.py::body_for)
// names one and the entry launches exactly that one or returns an error:
//
// * wgmma — bf16 at hd = 64 with N = 128 (Mamba2) or N = 16 (Hymba), chunk
//   a multiple of 64, rows 16-byte aligned (the serving paths): the
//   chunk-parallel split of the SSD algorithm in three kernels (chunk
//   states, state passing, outputs) on TMA and wgmma, C . B^T formed once
//   per CTA for a group of heads, each kernel a template on N; see the note
//   above it.
// * simt — every other case (float32, other widths, unaligned views): one
//   thread block per (b, h) walks its chunks in order, carrying S; a chunk
//   is cut into 64-row query tiles and, for query tile qi, the key tiles
//   kj <= qi (tiles above the diagonal are skipped): float32 FMAs on the
//   CUDA cores from float32 tiles in shared memory; 256 threads as a
//   16 x 16 grid, thread (ty, tx) owning rows 4*ty .. 4*ty+3 and columns
//   tx + 16*c; S in shared memory, its update riding on the last query
//   tile's key loop, which visits every key tile.
//
// What bounds it on the card: at the serving shape (B=4, S=512, NH=80,
// hd=64, N=128, Q=256, bf16 x/B/C) the function moves ~54 MB (x and y 21 MB
// each, final state 10.5 MB) and needs ~8.1 GFLOP (the causal half of the
// intra-chunk products, C . B^T once per batch row since B and C are shared
// by all heads), so its roofline is the memory side, ~16 us; at Hymba's
// (NH=50, N=16) ~27.6 MB and ~2.1 GFLOP, ~8.2 us. The wgmma body
// adds traffic of its own (the chunk states, 21 MB in float32, written and
// read again; the entering states in bf16; C and B reread per CTA, x per
// query tile) and tensor work of its own (the state products' high/low
// split, C . B^T once per group of heads, the masked half of the diagonal
// tiles); its kernels are bound by the latency of their serial chains at
// two or three CTAs per SM more than by either roofline. See PERF.md for
// the measured times and tools/ssd_ablation.py for where they go.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

namespace {

constexpr int TT = 64;       // rows per query tile and per key tile
constexpr int TX = 16;       // threads across key / output columns
constexpr int TY = 16;       // threads across rows
constexpr int NT = TX * TY;  // threads per block
constexpr int R = TT / TY;   // rows per thread
constexpr int RK = TT / TX;  // keys per thread in the score tile
constexpr int LM = TT + 1;   // padded row stride of the score tile
constexpr size_t MAX_SMEM = 232448;  // what one Hopper block may use

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* bm;
  const void* cm;
  const float* s0;  // may be null: the state starts at 0
  void* y;
  float* sfin;
  int seqlen, nh, hd, n, chunk;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long y_sb, y_ss, y_sh;
};

// shared memory in floats: cs, dt and seg over the padded chunk, the C and
// B tiles (row stride N + 1), the dt x tile, the score tile and S
__host__ __device__ inline size_t smem_floats(int chunk, int hdp, int n) {
  const size_t qp = size_t((chunk + TT - 1) / TT) * TT;
  return 3 * qp + 2 * size_t(TT) * (n + 1) + size_t(TT) * hdp + size_t(TT) * LM +
         size_t(hdp) * (n + 1);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rows [0, TT) of a `width`-wide tile into shared memory (row stride ld),
// rows at or past `valid` zero-filled.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long stride, int valid, int width) {
  for (int i = threadIdx.x; i < TT * width; i += NT) {
    const int r = i / width, c = i % width;
    dst[r * ld + c] = r < valid ? to_f32(src[r * stride + c]) : 0.f;
  }
}

// The dt x tile: row r is dt_r * x_r, columns past hd and rows at or past
// `valid` zero.
template <typename T, int HDP>
__device__ __forceinline__ void load_xdt(float* dst, const T* src, long long stride,
                                         int valid, int hd, const float* dts) {
  for (int i = threadIdx.x; i < TT * HDP; i += NT) {
    const int r = i / HDP, c = i % HDP;
    dst[i] = (r < valid && c < hd) ? to_f32(src[r * stride + c]) * dts[r] : 0.f;
  }
}

// dts[r] = dt_r for the rows [0, qp) of a chunk, 0 at or past `valid`;
// every thread of the block loads a share, so the strided loads of dt are
// in flight together.
template <int NTH>
__device__ __forceinline__ void load_dt(float* dts, const float* dtg, long long dt_ss,
                                        int valid, int qp) {
  for (int r = threadIdx.x; r < qp; r += NTH) dts[r] = r < valid ? dtg[r * dt_ss] : 0.f;
}

// Warp 0: cs[r] = inclusive sum of dt * a over rows [0, r] of the chunk,
// for r < qp. Each lane sums a run of rows in order, then the lanes'
// totals are scanned.
__device__ __forceinline__ void chunk_cumsum(float* cs, const float* dts, int qp, float a) {
  const int lane = threadIdx.x;
  const int per = (qp + 31) / 32;
  const int r0 = lane * per, r1 = min(r0 + per, qp);
  float run = 0.f;
  for (int r = r0; r < r1; ++r) {
    run += dts[r] * a;
    cs[r] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  for (int r = r0; r < r1; ++r) cs[r] += excl;
}

template <typename T, int CP>
__global__ void __launch_bounds__(NT) ssd_fwd_simt(Params p) {
  constexpr int HDP = 16 * CP;  // hd padded to the 16-column thread grid
  extern __shared__ float smem[];
  const int Q = p.chunk, N = p.n, HD = p.hd;
  const int nq = (Q + TT - 1) / TT, qp = nq * TT, ldn = N + 1;
  float* cs = smem;
  float* dts = cs + qp;
  float* seg = dts + qp;
  float* Ct = seg + qp;       // TT x ldn
  float* Bt = Ct + TT * ldn;  // TT x ldn
  float* Xt = Bt + TT * ldn;  // TT x HDP, dt x
  float* Mt = Xt + TT * HDP;  // TT x LM, scores after decay and mask
  float* St = Mt + TT * LM;   // HDP x ldn, the carried state (rows >= hd stay 0)

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = p.A[h];
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb;
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb;
  T* yg = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;
  const long long sbase = (long long)(b * p.nh + h) * HD * N;

  for (int e = tid; e < HDP * ldn; e += NT) {
    const int r = e / ldn, c = e % ldn;
    St[e] = (p.s0 != nullptr && r < HD && c < N) ? p.s0[sbase + r * N + c] : 0.f;
  }

  const int nchunks = (p.seqlen + Q - 1) / Q;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int t0 = ch * Q;
    const int rows = min(Q, p.seqlen - t0);  // positions of this chunk in the sequence
    __syncthreads();  // the previous chunk is done with cs, dts, seg and S
    load_dt<NT>(dts, dtg + t0 * p.dt_ss, p.dt_ss, rows, qp);
    __syncthreads();
    if (tid < 32) chunk_cumsum(cs, dts, qp, a);
    __syncthreads();
    const float cs_last = cs[qp - 1];  // padded rows add 0
    for (int r = tid; r < qp; r += NT) seg[r] = expf(cs_last - cs[r]);

    for (int qt = 0; qt < nq; ++qt) {
      const int i0 = qt * TT;
      const bool last = qt == nq - 1;  // this tile's key loop updates S
      __syncthreads();  // seg is written; the last tile's reads are done
      load_rows(Ct, ldn, cg + (long long)(t0 + i0) * p.c_ss, p.c_ss, rows - i0, N);
      __syncthreads();

      // inter-chunk part first: exp(cs_i) C_i . S^T, with S entering the chunk
      float acc[R][CP];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CP; ++c) acc[i][c] = 0.f;
      for (int k = 0; k < N; ++k) {
        float av[R], sv[CP];
#pragma unroll
        for (int i = 0; i < R; ++i) av[i] = Ct[(ty * R + i) * ldn + k];
#pragma unroll
        for (int c = 0; c < CP; ++c) sv[c] = St[(tx + 16 * c) * ldn + k];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < CP; ++c) acc[i][c] = fmaf(av[i], sv[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float e = expf(cs[i0 + ty * R + i]);
#pragma unroll
        for (int c = 0; c < CP; ++c) acc[i][c] *= e;
      }
      if (last) {
        __syncthreads();  // every read of S for the inter-chunk part is done
        const float dec = expf(cs_last);
        for (int e = tid; e < HD * N; e += NT) St[(e / N) * ldn + e % N] *= dec;
      }

      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * TT;
        __syncthreads();  // the previous key tile's reads are done
        load_rows(Bt, ldn, bg + (long long)(t0 + j0) * p.b_ss, p.b_ss, rows - j0, N);
        load_xdt<T, HDP>(Xt, xg + (long long)(t0 + j0) * p.x_ss, p.x_ss, rows - j0, HD,
                         dts + j0);
        __syncthreads();

        float s[R][RK];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int jj = 0; jj < RK; ++jj) s[i][jj] = 0.f;
        for (int k = 0; k < N; ++k) {
          float av[R], bv[RK];
#pragma unroll
          for (int i = 0; i < R; ++i) av[i] = Ct[(ty * R + i) * ldn + k];
#pragma unroll
          for (int jj = 0; jj < RK; ++jj) bv[jj] = Bt[(tx + jj * TX) * ldn + k];
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int jj = 0; jj < RK; ++jj) s[i][jj] = fmaf(av[i], bv[jj], s[i][jj]);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int gi = i0 + ty * R + i;
#pragma unroll
          for (int jj = 0; jj < RK; ++jj) {
            const int gj = j0 + tx + jj * TX;
            Mt[(ty * R + i) * LM + tx + jj * TX] =
                gj <= gi ? s[i][jj] * expf(cs[gi] - cs[gj]) : 0.f;
          }
        }
        __syncthreads();

        // intra-chunk part: acc += M . (dt x)
        for (int kk = 0; kk < TT; ++kk) {
          float pr[R], vv[CP];
#pragma unroll
          for (int i = 0; i < R; ++i) pr[i] = Mt[(ty * R + i) * LM + kk];
#pragma unroll
          for (int c = 0; c < CP; ++c) vv[c] = Xt[kk * HDP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int c = 0; c < CP; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
        }

        if (last) {  // S += (dt x)^T (seg . B) over this key tile
          for (int e = tid; e < HD * N; e += NT) {
            const int pp = e / N, nn = e % N;
            float u = 0.f;
            for (int jj = 0; jj < TT; ++jj)
              u = fmaf(Xt[jj * HDP + pp] * seg[j0 + jj], Bt[jj * ldn + nn], u);
            St[pp * ldn + nn] += u;
          }
        }
      }

#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int gi = i0 + ty * R + i;
        if (gi >= rows) continue;
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          const int col = tx + 16 * c;
          if (col < HD) store(yg + (long long)(t0 + gi) * p.y_ss + col, acc[i][c]);
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < HD * N; e += NT) p.sfin[sbase + e] = St[(e / N) * ldn + e % N];
}

// ------------------------------------------------------------ wgmma body
// bf16 x, B and C at hd = 64 and N in {16, 128}, chunk a multiple of 64,
// rows 16-byte aligned: the serving paths. Three kernels, launched
// one after the other on the caller's stream, in the SSD algorithm's own
// order (arXiv:2405.21060 sections 6-7; ref.py computes the same split):
//
// 1. ssd_chunk_states, one CTA per (head, chunk, batch row): the chunk's
//    cumulative sum cs of dt * A, written to scratch with dt (zero past the
//    sequence end) for phases 2 and 3, and its end state from zero,
//    S_c = sum_j (dt_j seg_j x_j) (x) B_j with seg_j = exp(cs_last - cs_j),
//    a 64 x N float32 product of depth Q on wgmma (N = 128: m64n64k16, two
//    per k-step, one per 64-column box of B; N = 16: one m64n16k16). The
//    weighted x is the A operand
//    from registers, split into a bf16 high and low part (two products),
//    so S_c keeps about 16 bits; B is read MN-major through the
//    descriptor's transpose bit. A producer warp keeps a two-stage ring of
//    (B, x) tiles in flight by TMA: 52 KB of shared memory and 123
//    registers let three CTAs share an SM at N = 128 (four stages, two
//    CTAs, were slower; so was splitting N over two CTAs).
// 2. ssd_state_passing, elementwise over (b, h) and the state's elements,
//    sequential over chunks: S_enter(c+1) = exp(cs_last(c)) S_enter(c) +
//    S_c in float32, the same recurrence in the same order as ref.py. It
//    writes each entering state rounded to bf16 (the operand of phase 3's
//    C . S^T) and the float32 final state. (Folding it into phase 1, by the
//    last CTA of each (b, h), was slower: it costs phase 1 registers.)
// 3. ssd_chunk_outputs, one CTA per (64-row query tile, chunk, batch row)
//    x a group of SCAN_G heads. The query tile's C . B^T (64 x 64 float32
//    in registers, one key tile at a time) is formed once per CTA and
//    reused by all SCAN_G heads (ngroups = 1 makes it independent of the
//    head): per head the decay exp(cs_i - cs_j) (by selection on the
//    diagonal tile), dt_j and the bf16 rounding are applied in registers,
//    then y_h += M_h . x_h on wgmma with x MN-major. y_h starts as
//    exp(cs_i) C . S_enter_h^T (a third product) where a state enters.
//    A producer warpgroup brings C, the entering states, the B tiles and
//    the x tiles by TMA into two shared-memory rings (16 KB and 8 KB
//    slots) on mbarriers; setmaxnreg moves its registers to the consumer
//    warpgroup, whose SCAN_G accumulators of y stay in registers (two CTAs
//    per SM). y leaves through the idle rings, swizzled, by one TMA store
//    per head. Heavy query tiles (most key tiles) are scheduled first.
//
// Every tile of x and y is a TMA box of 64 columns (128 bytes) x 64 rows in
// the 128-byte swizzle. The tiles of B, C and the entering states are 64
// rows x N columns (WgN below): at N = 128 two such 64-column boxes, at
// N = 16 one box of 16 columns (32-byte rows) in the 32-byte swizzle, read
// by wgmma through descriptors of the matching layout; there C . B^T and
// C . S_enter^T take one k-step. The tensor maps are built over the strided
// views as given (the model's views of the convolution output are read in
// place).
// The scratch (cs and dt, the chunk states in float32, the entering states
// in bf16) is allocated by the wrapper; no atomics, no order that depends
// on the schedule: two runs give the same bits.
constexpr int SCAN_G = 4;           // heads per phase-3 CTA
constexpr int WG_HD = 64;           // head width the body is compiled for
constexpr int WG_T = 64;            // rows of every tile
constexpr uint32_t BOX = 64 * 128;  // one 64-row x 64-column bf16 box (x, y): 8 KB
constexpr int P1_STAGES = 2;        // phase-1 ring of (B tile, x tile)
constexpr int P1_THREADS = 160;     // one consumer warpgroup and a producer warp
constexpr int P3_WIDE = 2;          // phase-3 ring of 16 KB slots (S_enter, B tiles)
constexpr int P3_NARROW = 4;        // phase-3 ring of 8 KB slots (x tiles)
constexpr int P3_THREADS = 256;     // one consumer and one producer warpgroup
constexpr int P2_THREADS = 128;     // phase 2: four state elements a thread
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PDL = 1;  // launch phases 2 and 3 with programmatic dependent launch

// The layout of a 64-row x N-column bf16 tile (B, C, an entering state)
// for the state width N the body is compiled for: TMA boxes of BOX_COLS
// columns, NBOX to a row, in the swizzle of their row width (128 bytes at
// N = 128, 32 bytes at N = 16), read by wgmma descriptors of layout type
// LAYOUT (1: B128, 3: B32) whose 8-row core matrices lie ATOM bytes apart.
template <int N>
struct WgN {
  static_assert(N == 16 || N == 128, "the wgmma body is compiled for N in {16, 128}");
  static constexpr int BOX_COLS = N < 64 ? N : 64;
  static constexpr int NBOX = N / BOX_COLS;
  static constexpr uint32_t ROW = 2 * BOX_COLS;          // bytes of a box row
  static constexpr uint32_t NBOX_BYTES = WG_T * ROW;     // one box: 8 KB or 2 KB
  static constexpr uint32_t TILE = NBOX * NBOX_BYTES;    // a tile: 16 KB or 2 KB
  static constexpr uint32_t ATOM = 8 * ROW;              // 8 rows of a box
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : 3;
  static constexpr int KSTEPS = N / 16;                  // k-steps of depth N
  static constexpr int ACC = BOX_COLS / 2;               // floats of an m64 x BOX_COLS sum
  // Shared memory, in bytes from a 1024-aligned base (+ 1024 to align).
  // Phase 1: P1_STAGES x (B tile + x box), the barriers, then dt, cs and
  // the weights dt seg over the chunk.
  static constexpr uint32_t P1_SLOT = TILE + BOX;
  static constexpr uint32_t P1_BAR = P1_STAGES * P1_SLOT;
  static constexpr uint32_t P1_FLOATS = P1_BAR + 16 * P1_STAGES;
  // Phase 3: C, the wide (entering states, B tiles) and narrow (x) rings,
  // the barriers, then cs (times log2 e) and dt of the CTA's heads over
  // the chunk.
  static constexpr uint32_t P3_WIDE_OFF = TILE;
  static constexpr uint32_t P3_NARROW_OFF = P3_WIDE_OFF + P3_WIDE * TILE;
  static constexpr uint32_t P3_BAR = P3_NARROW_OFF + P3_NARROW * BOX;
  static constexpr uint32_t P3_FLOATS = P3_BAR + 8 * (1 + 2 * P3_WIDE + 2 * P3_NARROW);
  static_assert(P1_SLOT % 1024 == 0 && TILE % 1024 == 0, "boxes stay 1024-byte aligned");
  static_assert(WG_HD * N / 4 % P2_THREADS == 0, "phase 2 covers the state in whole blocks");
};

template <int N>
inline size_t p1_smem_bytes(int chunk) {
  return 1024 + WgN<N>::P1_FLOATS + sizeof(float) * 3 * size_t(chunk);
}
template <int N>
inline size_t p3_smem_bytes(int chunk) {
  return 1024 + WgN<N>::P3_FLOATS + sizeof(float) * 2 * SCAN_G * size_t(chunk);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

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

// One 64 x 64 box of a 3-D (columns, rows, batch) or 4-D (columns, rows,
// head, batch) tensor map into shared memory; rows past the map's end
// arrive as zeros. Completion is counted on `bar`.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap& map, int col,
                                          int row, int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(col), "r"(row), "r"(batch), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap& map, int col,
                                          int row, int head, int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(col), "r"(row), "r"(head), "r"(batch),
      "r"(bar)
      : "memory");
}

// One 64-row box of shared memory out to a 4-D tensor map (bulk group of
// the issuing thread); rows past the map's end are not written.
__device__ __forceinline__ void tma_store4(const CUtensorMap& map, uint32_t src, int col, int row,
                                           int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(&map)), "r"(src), "r"(col), "r"(row), "r"(head),
      "r"(batch)
      : "memory");
}

// Make this thread's shared-memory writes visible to TMA stores.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Issue the thread's pending TMA stores and wait until they have read
// shared memory.
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap& map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map))
               : "memory");
}

// wgmma shared-memory descriptor for a swizzled operand: start address,
// leading and stride byte offsets (16-byte units), layout type (1: B128,
// 3: B32).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout = 1) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | (layout << 62);
}

// K-major operand, a 64 x N tile of WgN<N> (C, B, an entering state):
// k-step kk of 16 columns
template <int N>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using L = WgN<N>;
  constexpr int per_box = L::BOX_COLS / 16;
  return smem_desc(tile + (kk / per_box) * L::NBOX_BYTES + (kk % per_box) * 32, 16, L::ATOM,
                   L::LAYOUT);
}

// MN-major operand, one box of ROW-byte rows (x: 128; B at N = 16: 32):
// k-step kk of 16 rows
template <uint32_t ROW = 128>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t box, int kk) {
  return smem_desc(box + kk * 16 * ROW, WG_T * ROW, 8 * ROW, ROW == 128 ? 1 : 3);
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

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_n64_ss(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
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

// d (64 x 16, f32) += A (64 x 16, bf16 registers) * B (16 x 16, smem, MN-major)
__device__ __forceinline__ void wgmma_n16_rs(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef F8

// The register-A product into a 64 x NC accumulator (NC = 64 or 16)
template <int NC>
__device__ __forceinline__ void wgmma_rs(float (&d)[NC / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (NC == 64)
    wgmma_n64_rs(d, a, db);
  else
    wgmma_n16_rs(d, a, db);
}

// Named barrier 1: the consumer warpgroup alone (128 threads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// Under programmatic dependent launch a kernel may start before the one
// before it on the stream has finished: wait for it (and its writes) here.
// Without that launch attribute this returns at once.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scratch layouts (element offsets): cs and dt (B, NH, NC, Q) float32, dt
// zero past the sequence end; chunk states (B, NC, NH, hd, N) float32;
// entering states (B, NC, NH, hd, N) bf16.
__device__ __forceinline__ long long cs_at(int b, int h, int c, int nh, int nc, int q) {
  return ((long long)(b * nh + h) * nc + c) * q;
}
template <int N>
__device__ __forceinline__ long long state_at(int b, int c, int h, int nh, int nc) {
  return ((long long)(b * nc + c) * nh + h) * (WG_HD * N);
}

struct Scratch {
  float* cs;
  float* dt;
  float* states;
  __nv_bfloat16* senter;
};

// ---- phase 1: the chunk's cs and its end state from zero
template <int N>
__global__ void __launch_bounds__(P1_THREADS)
    ssd_chunk_states(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tb, Scratch sc) {
  using L = WgN<N>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  float* dts = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + L::P1_FLOATS);
  const int Q = p.chunk;
  float* cs = dts + Q;
  float* w = cs + Q;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = c * Q, rows = min(Q, p.seqlen - t0);
  const int nk = (rows + WG_T - 1) / WG_T;  // key tiles past the sequence end add 0
  auto full = [&](int st) { return base + L::P1_BAR + 8 * st; };
  auto empty = [&](int st) { return base + L::P1_BAR + 8 * (P1_STAGES + st); };

  if (threadIdx.x == 0) {
    for (int st = 0; st < P1_STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp: one thread issues every load
    if (threadIdx.x == 128) {
      prefetch_map(tx);
      prefetch_map(tb);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % P1_STAGES, row = t0 + kt * WG_T;
        const uint32_t slot = base + st * L::P1_SLOT;
        mbar_wait(empty(st), ((kt / P1_STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), L::P1_SLOT);
#pragma unroll
        for (int cb = 0; cb < L::NBOX; ++cb)
          tma_load3(slot + cb * L::NBOX_BYTES, tb, cb * L::BOX_COLS, row, b, full(st));
        tma_load4(slot + L::TILE, tx, 0, row, h, b, full(st));
      }
    }
    return;
  }

  // consumers: dt, cs (to scratch) and the weights dt_j seg_j
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh + (long long)t0 * p.dt_ss;
  load_dt<128>(dts, dtg, p.dt_ss, rows, Q);
  consumers_sync();
  if (threadIdx.x < 32) chunk_cumsum(cs, dts, Q, p.A[h]);
  consumers_sync();
  const float cs_last = cs[Q - 1];  // padded rows add 0
  const long long at = cs_at(b, h, c, p.nh, nc, Q);
  for (int r = threadIdx.x; r < Q; r += 128) {
    w[r] = dts[r] * expf(cs_last - cs[r]);
    sc.cs[at + r] = cs[r];
    sc.dt[at + r] = dts[r];
  }
  consumers_sync();

  const int lane = threadIdx.x % 32, wr = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  float acc[L::NBOX][L::ACC];
#pragma unroll
  for (int cb = 0; cb < L::NBOX; ++cb)
#pragma unroll
    for (int i = 0; i < L::ACC; ++i) acc[cb][i] = 0.f;
  // this lane's ldmatrix row within a 16-key step, and its 16-byte chunk
  // of the 64-wide x row (rows 16 wr .. of x^T, the A operand)
  const int lrow = lane % 8 + (lane / 16) * 8;
  const int lchunk = 2 * wr + (lane / 8) % 2;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % P1_STAGES;
    const uint32_t slot = base + st * L::P1_SLOT;
    mbar_wait(full(st), (kt / P1_STAGES) & 1);
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int j = ks * 16 + lrow;
      uint32_t xa[4];
      ldsm_x4_t(xa, slot + L::TILE + j * 128 + ((lchunk ^ (j & 7)) << 4));
      // element pairs of xa[r] sit at keys 2t (+1), + 8 for r >= 2
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int jj = kt * WG_T + ks * 16 + 2 * t + 8 * (r / 2);
        const float2 v = unpack_bf16(xa[r]);
        const float w0 = v.x * w[jj], w1 = v.y * w[jj + 1];
        hi[ks][r] = pack_bf16(w0, w1);
        const float2 hv = unpack_bf16(hi[ks][r]);
        lo[ks][r] = pack_bf16(w0 - hv.x, w1 - hv.y);
      }
    }
#pragma unroll
    for (int cb = 0; cb < L::NBOX; ++cb) fence_regs(acc[cb]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int cb = 0; cb < L::NBOX; ++cb) {
        const uint64_t db = mnmajor_desc<L::ROW>(slot + cb * L::NBOX_BYTES, ks);
        wgmma_rs<L::BOX_COLS>(acc[cb], hi[ks], db);
        wgmma_rs<L::BOX_COLS>(acc[cb], lo[ks], db);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < L::NBOX; ++cb) fence_regs(acc[cb]);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      fence_regs(hi[ks]);
      fence_regs(lo[ks]);
    }
    mbar_arrive(empty(st));
  }

  // element 4 nb + e of box cb: state row 16 wr + g + 8 (e / 2), column
  // BOX_COLS cb + 8 nb + 2 t + e % 2
  float* out = sc.states + state_at<N>(b, c, h, p.nh, nc);
#pragma unroll
  for (int cb = 0; cb < L::NBOX; ++cb)
#pragma unroll
    for (int nb = 0; nb < L::BOX_COLS / 8; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(out + (16 * wr + g + 8 * r) * N + L::BOX_COLS * cb + 8 * nb +
                                   2 * t) =
            make_float2(acc[cb][4 * nb + 2 * r], acc[cb][4 * nb + 2 * r + 1]);
}

// ---- phase 2: the states entering each chunk, and the final state; each
// thread carries 4 of a (b, h)'s hd x N state elements
template <int N>
__global__ void __launch_bounds__(P2_THREADS)
    ssd_state_passing(const __grid_constant__ Params p, Scratch sc, int nc) {
  grid_dependency_wait();  // phase 1's states and cs
  constexpr int E = WG_HD * N;
  const int e = (blockIdx.x * P2_THREADS + threadIdx.x) * 4;
  const int b = blockIdx.y / p.nh, h = blockIdx.y % p.nh;
  const long long bh = (long long)blockIdx.y * E;
  float4 s = p.s0 != nullptr ? *reinterpret_cast<const float4*>(p.s0 + bh + e)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const long long at = state_at<N>(b, c, h, p.nh, nc) + e;
    if (c > 0 || p.s0 != nullptr) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y), hi = __floats2bfloat162_rn(s.z, s.w);
      uint2 v;
      v.x = *reinterpret_cast<const uint32_t*>(&lo);
      v.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(sc.senter + at) = v;
    }
    const float dec = expf(sc.cs[cs_at(b, h, c, p.nh, nc, p.chunk) + p.chunk - 1]);
    const float4 d = *reinterpret_cast<const float4*>(sc.states + at);
    s = make_float4(fmaf(s.x, dec, d.x), fmaf(s.y, dec, d.y), fmaf(s.z, dec, d.z),
                    fmaf(s.w, dec, d.w));
  }
  *reinterpret_cast<float4*>(p.sfin + bh + e) = s;
}

// ---- phase 3: y for one 64-row query tile of one chunk, SCAN_G heads
template <int N>
__global__ void __launch_bounds__(P3_THREADS, 2)
    ssd_chunk_outputs(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ CUtensorMap tc,
                      const __grid_constant__ CUtensorMap ts,
                      const __grid_constant__ CUtensorMap ty, Scratch sc) {
  using L = WgN<N>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int Q = p.chunk, nq = Q / WG_T;
  float* cs2 = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + L::P3_FLOATS);
  float* dts = cs2 + SCAN_G * Q;
  const int nc = (p.seqlen + Q - 1) / Q, nhg = (p.nh + SCAN_G - 1) / SCAN_G;
  // heavy first: blockIdx.y = 0 takes the last query tile, which has the
  // most key tiles, so the longest CTAs start in the first wave
  const int qt = nq - 1 - blockIdx.y;
  const int hg = blockIdx.x % nhg, c = (blockIdx.x / nhg) % nc, b = blockIdx.x / (nhg * nc);
  const int h0 = hg * SCAN_G, ng = min(SCAN_G, p.nh - h0);
  const int t0 = c * Q, rows = min(Q, p.seqlen - t0), i0 = qt * WG_T;
  if (i0 >= rows) return;  // a query tile wholly past the sequence end
  const bool carry = c > 0 || p.s0 != nullptr;  // a state enters this chunk
  const uint32_t c_bar = base + L::P3_BAR;
  auto wide_full = [&](int st) { return base + L::P3_BAR + 8 * (1 + st); };
  auto wide_empty = [&](int st) { return base + L::P3_BAR + 8 * (1 + P3_WIDE + st); };
  auto narrow_full = [&](int st) { return base + L::P3_BAR + 8 * (1 + 2 * P3_WIDE + st); };
  auto narrow_empty = [&](int st) {
    return base + L::P3_BAR + 8 * (1 + 2 * P3_WIDE + P3_NARROW + st);
  };
  auto wide = [&](int st) { return base + L::P3_WIDE_OFF + st * L::TILE; };
  auto narrow = [&](int st) { return base + L::P3_NARROW_OFF + st * BOX; };
  // one 64 x N tile of a 3-D (B, C) or 4-D (entering state) map, box by box
  auto load_tile3 = [&](uint32_t dst, const CUtensorMap& map, int row, int batch, uint32_t bar) {
#pragma unroll
    for (int cb = 0; cb < L::NBOX; ++cb)
      tma_load3(dst + cb * L::NBOX_BYTES, map, cb * L::BOX_COLS, row, batch, bar);
  };

  if (threadIdx.x == 0) {
    mbar_init(c_bar, 1);
    for (int st = 0; st < P3_WIDE; ++st) {
      mbar_init(wide_full(st), 1);
      mbar_init(wide_empty(st), 128);
    }
    for (int st = 0; st < P3_NARROW; ++st) {
      mbar_init(narrow_full(st), 1);
      mbar_init(narrow_empty(st), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 128) {
      prefetch_map(tx);
      prefetch_map(tb);
      prefetch_map(tc);
      prefetch_map(ts);
      mbar_expect_tx(c_bar, L::TILE);
      load_tile3(base, tc, t0 + i0, b, c_bar);
      grid_dependency_wait();  // the entering states of phase 2
      int wi = 0, ni = 0;  // loads issued into each ring
      if (carry)
        for (int hh = 0; hh < ng; ++hh, ++wi) {
          const int st = wi % P3_WIDE, h = h0 + hh;
          mbar_wait(wide_empty(st), ((wi / P3_WIDE) & 1) ^ 1);
          mbar_expect_tx(wide_full(st), L::TILE);
#pragma unroll
          for (int cb = 0; cb < L::NBOX; ++cb)
            tma_load4(wide(st) + cb * L::NBOX_BYTES, ts, cb * L::BOX_COLS, 0, h, b * nc + c,
                      wide_full(st));
        }
      for (int kt = 0; kt <= qt; ++kt) {
        const int row = t0 + kt * WG_T;
        {
          const int st = wi % P3_WIDE;
          mbar_wait(wide_empty(st), ((wi / P3_WIDE) & 1) ^ 1);
          mbar_expect_tx(wide_full(st), L::TILE);
          load_tile3(wide(st), tb, row, b, wide_full(st));
          ++wi;
        }
        for (int hh = 0; hh < ng; ++hh, ++ni) {
          const int st = ni % P3_NARROW;
          mbar_wait(narrow_empty(st), ((ni / P3_NARROW) & 1) ^ 1);
          mbar_expect_tx(narrow_full(st), BOX);
          tma_load4(narrow(st), tx, 0, row, h0 + hh, b, narrow_full(st));
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  grid_dependency_wait();  // cs and dt of phase 1, through phase 2
  const int kend = (qt + 1) * WG_T;  // chunk rows this tile reads
  for (int e = threadIdx.x; e < ng * kend; e += 128) {
    const int hh = e / kend, r = e % kend, h = h0 + hh;
    const long long at = cs_at(b, h, c, p.nh, nc, Q) + r;
    cs2[hh * Q + r] = sc.cs[at] * LOG2E;
    dts[hh * Q + r] = sc.dt[at];
  }
  consumers_sync();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int lr0 = 16 * warp + g;  // this thread's tile rows: lr0, lr0 + 8
  float y[SCAN_G][32];
#pragma unroll
  for (int hh = 0; hh < SCAN_G; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) y[hh][i] = 0.f;
  mbar_wait(c_bar, 0);
  int wi = 0, ni = 0;  // loads consumed from each ring

  // inter-chunk part first: y_h = exp(cs_i) C_i . S_enter_h^T
  if (carry) {
#pragma unroll
    for (int hh = 0; hh < SCAN_G; ++hh) {
      if (hh >= ng) continue;
      const int st = wi % P3_WIDE;
      mbar_wait(wide_full(st), (wi / P3_WIDE) & 1);
      fence_regs(y[hh]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::KSTEPS; ++kk)
        wgmma_n64_ss(y[hh], kmajor_desc<N>(base, kk), kmajor_desc<N>(wide(st), kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(y[hh]);
      mbar_arrive(wide_empty(st));
      ++wi;
      const float e0 = exp2f(cs2[hh * Q + i0 + lr0]), e1 = exp2f(cs2[hh * Q + i0 + lr0 + 8]);
#pragma unroll
      for (int i = 0; i < 32; ++i) y[hh][i] *= (i % 4) / 2 ? e1 : e0;
    }
  }

  // intra-chunk part over the key tiles at or below the diagonal
  for (int kt = 0; kt <= qt; ++kt) {
    float cb[32];
    {
      const int st = wi % P3_WIDE;
      mbar_wait(wide_full(st), (wi / P3_WIDE) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::KSTEPS; ++kk)
        wgmma_n64_ss(cb, kmajor_desc<N>(base, kk), kmajor_desc<N>(wide(st), kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(cb);
      mbar_arrive(wide_empty(st));
      ++wi;
    }
    const bool diag = kt == qt;
#pragma unroll
    for (int hh = 0; hh < SCAN_G; ++hh) {
      if (hh >= ng) continue;
      const float* c2 = cs2 + hh * Q;
      const float* d = dts + hh * Q + kt * WG_T;
      const float* ck = c2 + kt * WG_T;
      const float ci[2] = {c2[i0 + lr0], c2[i0 + lr0 + 8]};
      // element 4 nb + e: tile row lr0 + 8 (e / 2), key 8 nb + 2 t + e % 2;
      // the decay by selection, times dt_j, rounded to bf16 as the A operand
      uint32_t pa[4][4];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        float m[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = 8 * nb + 2 * t + e % 2, lr = lr0 + 8 * (e / 2);
          m[e] = (!diag || kc <= lr) ? cb[4 * nb + e] * fast_exp2(ci[e / 2] - ck[kc]) * d[kc]
                                     : 0.f;
        }
        pa[nb / 2][2 * (nb % 2)] = pack_bf16(m[0], m[1]);
        pa[nb / 2][2 * (nb % 2) + 1] = pack_bf16(m[2], m[3]);
      }
      const int st = ni % P3_NARROW;
      mbar_wait(narrow_full(st), (ni / P3_NARROW) & 1);
      fence_regs(y[hh]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_T / 16; ++kk) wgmma_n64_rs(y[hh], pa[kk], mnmajor_desc(narrow(st), kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(y[hh]);
#pragma unroll
      for (int kk = 0; kk < WG_T / 16; ++kk) fence_regs(pa[kk]);
      mbar_arrive(narrow_empty(st));
      ++ni;
    }
  }

  // y in bf16: each head's tile staged in the rings, idle now, in the
  // 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8), so the
  // fragment writes hit 32 distinct banks), then one TMA store per head;
  // rows past the sequence end are clipped by the tensor map
  static_assert(SCAN_G * BOX <= L::P3_BAR - L::P3_WIDE_OFF, "y tiles fit the idle rings");
#pragma unroll
  for (int hh = 0; hh < SCAN_G; ++hh) {
    if (hh >= ng) continue;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t at = base + L::P3_WIDE_OFF + hh * BOX + (lr0 + 8 * r) * 128 + ((nb ^ g) << 4) + 4 * t;
        __nv_bfloat162 v = __floats2bfloat162_rn(y[hh][4 * nb + 2 * r], y[hh][4 * nb + 2 * r + 1]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(*reinterpret_cast<uint32_t*>(&v))
                     : "memory");
      }
  }
  fence_async_smem();
  consumers_sync();
  if (threadIdx.x == 0) {
    for (int hh = 0; hh < ng; ++hh)
      tma_store4(ty, base + L::P3_WIDE_OFF + hh * BOX, 0, t0 + i0, h0 + hh, b);
    tma_store_drain();
  }
}

// ------------------------------------------------------------- launches
// Above 48 KB of dynamic shared memory a kernel must opt in; each kernel
// raises its grant once to the largest size asked for.
template <typename Kernel>
cudaError_t grant_smem(Kernel kernel, size_t bytes, size_t& granted) {
  if (bytes <= granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) granted = bytes;
  return err;
}

template <typename T, int CP>
cudaError_t launch_simt(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.chunk, 16 * CP, p.n);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  static size_t granted = 48 * 1024;
  cudaError_t err = grant_smem(ssd_fwd_simt<T, CP>, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.nh, batch);
  ssd_fwd_simt<T, CP><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_simt(const Params& p, int batch, cudaStream_t stream) {
  if (p.hd <= 16) return launch_simt<T, 1>(p, batch, stream);
  if (p.hd <= 32) return launch_simt<T, 2>(p, batch, stream);
  if (p.hd <= 64) return launch_simt<T, 4>(p, batch, stream);
  if (p.hd <= 128) return launch_simt<T, 8>(p, batch, stream);
  return cudaErrorInvalidValue;
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

// A bf16 tensor of `rank` (3 or 4) dims, innermost first, with element
// strides for dims 1.. and a contiguous dim 0, as a tensor map read in
// boxes of `cols` columns x 64 rows: 64 columns (128-byte rows) in the
// 128-byte swizzle, 16 columns (32-byte rows) in the 32-byte swizzle. The
// strides are taken as they are: strided views are read without a copy.
int encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rank,
               const long long* dims, const long long* strides, int cols = 64) {
  cuuint64_t d[4], s[3];
  for (int i = 0; i < rank; ++i) d[i] = cuuint64_t(dims[i]);
  for (int i = 0; i + 1 < rank; ++i) s[i] = cuuint64_t(strides[i]) * 2;
  const cuuint32_t box[4] = {cuuint32_t(cols), WG_T, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                              d, s, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + static_cast<int>(res);
}

// The wgmma body's conditions at state width N: whole 64-row tiles, its
// shared memory, and 16-byte aligned rows of x, B, C and y (TMA boxes).
template <int N>
bool wgmma_takes(const Params& p) {
  if (p.hd != WG_HD || p.n != N || p.chunk % WG_T != 0) return false;
  if (p1_smem_bytes<N>(p.chunk) > MAX_SMEM || p3_smem_bytes<N>(p.chunk) > MAX_SMEM) return false;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(p.x) | reinterpret_cast<uintptr_t>(p.bm) |
                         reinterpret_cast<uintptr_t>(p.cm);
  const long long strides = p.x_sb | p.x_ss | p.x_sh | p.b_sb | p.b_ss | p.c_sb | p.c_ss;
  const long long y_strides = p.y_sb | p.y_ss | p.y_sh;
  return ptrs % 16 == 0 && strides % 8 == 0 && reinterpret_cast<uintptr_t>(p.y) % 16 == 0 &&
         y_strides % 8 == 0;
}

template <int N>
int launch_wgmma(const Params& p, const Scratch& sc, int batch, cudaStream_t stream) {
  if (!wgmma_takes<N>(p) || !sc.cs || !sc.dt || !sc.states || !sc.senter)
    return cudaErrorInvalidValue;
  constexpr int cols = WgN<N>::BOX_COLS;
  EncodeTiled encode;
  int rc = encode_tiled(&encode);
  if (rc != 0) return rc;
  const int nc = (p.seqlen + p.chunk - 1) / p.chunk;
  CUtensorMap tx, tb, tc, ts, ty;
  {
    const long long xd[4] = {WG_HD, p.seqlen, p.nh, batch}, xs[3] = {p.x_ss, p.x_sh, p.x_sb};
    const long long bd[3] = {N, p.seqlen, batch}, bs[2] = {p.b_ss, p.b_sb};
    const long long cs[2] = {p.c_ss, p.c_sb}, ys[3] = {p.y_ss, p.y_sh, p.y_sb};
    const long long sd[4] = {N, WG_HD, p.nh, (long long)batch * nc};
    const long long ss[3] = {N, WG_HD * N, (long long)p.nh * WG_HD * N};
    if ((rc = encode_map(encode, &tx, p.x, 4, xd, xs)) ||
        (rc = encode_map(encode, &tb, p.bm, 3, bd, bs, cols)) ||
        (rc = encode_map(encode, &tc, p.cm, 3, bd, cs, cols)) ||
        (rc = encode_map(encode, &ts, sc.senter, 4, sd, ss, cols)) ||
        (rc = encode_map(encode, &ty, p.y, 4, xd, ys)))
      return rc;
  }
  const size_t smem1 = p1_smem_bytes<N>(p.chunk), smem3 = p3_smem_bytes<N>(p.chunk);
  static size_t granted1 = 48 * 1024, granted3 = 48 * 1024;
  cudaError_t err = grant_smem(ssd_chunk_states<N>, smem1, granted1);
  if (err == cudaSuccess) err = grant_smem(ssd_chunk_outputs<N>, smem3, granted3);
  if (err != cudaSuccess) return err;

  ssd_chunk_states<N><<<dim3(p.nh, nc, batch), P1_THREADS, smem1, stream>>>(p, tx, tb, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // phases 2 and 3 by programmatic dependent launch: each may be scheduled
  // while the kernel before it drains, and waits for it in the kernel
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = PDL;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(WG_HD * N / 4 / P2_THREADS, batch * p.nh);
  cfg.blockDim = dim3(P2_THREADS);
  cfg.dynamicSmemBytes = 0;
  if ((err = cudaLaunchKernelEx(&cfg, ssd_state_passing<N>, p, sc, nc)) != cudaSuccess) return err;
  const int nhg = (p.nh + SCAN_G - 1) / SCAN_G;
  cfg.gridDim = dim3(batch * nc * nhg, p.chunk / WG_T);
  cfg.blockDim = dim3(P3_THREADS);
  cfg.dynamicSmemBytes = smem3;
  return cudaLaunchKernelEx(&cfg, ssd_chunk_outputs<N>, p, tx, tb, tc, ts, ty, sc);
}

}  // namespace

// The body is chosen by the caller (ssd_scan.py::body_for): 0 simt
// (float32 or bfloat16, hd <= 128, any N and chunk whose tiles fit), 1 wgmma
// (bfloat16, hd 64, N 16 or 128, chunk a multiple of 64, rows 16-byte aligned;
// needs the scratch cs and dtc (B, NH, NC, chunk) float32, states (B, NC,
// NH, hd, N) float32 and senter (B, NC, NH, hd, N) bf16). A body asked for a case it
// does not take returns cudaErrorInvalidValue; nothing here picks another
// body. dtype (of x, B, C and y): 0 float32, 1 bfloat16. dt, A, the
// initial state s0 (may be null) and the final state are float32; s0 and
// sfin are contiguous (B, NH, hd, N). Strides are in elements; the last
// axis of x, B, C and y is contiguous. Returns 0 on success, else a code
// for repro_cuda_error_string.
extern "C" int repro_ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* bm, const void* cm,
    const void* s0, void* y, void* sfin, void* cs, void* dtc, void* states, void* senter,
    int dtype,
    int body, int device, int batch, int seqlen, int nh, int hd, int n, int chunk,
    long long x_sb, long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
    long long dt_sh, long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (seqlen < 1 || chunk < 1 || n < 1 || hd < 1) return cudaErrorInvalidValue;
  Params p{x,     static_cast<const float*>(dt), static_cast<const float*>(A),
           bm,    cm,   static_cast<const float*>(s0),
           y,     static_cast<float*>(sfin),
           seqlen, nh,  hd,   n,    chunk,
           x_sb,  x_ss, x_sh, dt_sb, dt_ss, dt_sh,
           b_sb,  b_ss, c_sb, c_ss,  y_sb,  y_ss, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case 0:
      if (dtype == 0) return dispatch_simt<float>(p, batch, s);
      if (dtype == 1) return dispatch_simt<__nv_bfloat16>(p, batch, s);
      return cudaErrorInvalidValue;
    case 1: {
      if (dtype != 1) return cudaErrorInvalidValue;
      const Scratch sc{static_cast<float*>(cs), static_cast<float*>(dtc),
                       static_cast<float*>(states), static_cast<__nv_bfloat16*>(senter)};
      if (n == 128) return launch_wgmma<128>(p, sc, batch, s);
      if (n == 16) return launch_wgmma<16>(p, sc, batch, s);
      return cudaErrorInvalidValue;
    }
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
