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
// most 1 (for j > i it can overflow to inf, and inf * 0 is NaN).
//
// Layout of the work. The TPU ran a sequential grid (B, NH, NC) and carried
// S across the chunk axis in VMEM scratch; each grid step held a whole
// Q x Q score matrix (256 KB at Q = 256). Here one thread block owns one
// (b, h) and walks its chunks in order, carrying S for the whole sequence.
// A Hopper block has at most 227 KB of shared memory, so a chunk is cut
// into 64-row query tiles; for query tile qi the block loops over the key
// tiles kj <= qi only (the tiles above the diagonal are all masked and are
// skipped), forms the 64 x 64 score tile C_qi B_kj^T, applies the decay,
// and accumulates it times the 64 x hd tile of x into the query tile's
// registers. x, B and C are read through their strides (the model hands in
// views of the convolution output), so the wrapper copies nothing.
//
// Two bodies share that layout:
//
// * ssd_fwd_mma — bf16 at the Mamba2 widths (hd = 64, N = 128), chunk a
//   multiple of 64, rows 16-byte aligned (the serving path): the products
//   on the tensor cores with mma.sync m16n8k16, bf16 in and float32 out;
//   see the note above it.
// * ssd_fwd_simt — every other case (float32, other widths, unaligned
//   views): float32 FMAs on the CUDA cores from float32 tiles in shared
//   memory; 256 threads as a 16 x 16 grid, thread (ty, tx) owning rows
//   4*ty .. 4*ty+3 and columns tx + 16*c; S in shared memory, its update
//   riding on the last query tile's key loop, which visits every key tile.
//
// What bounds it on the card: at the serving shape (B=4, S=512, NH=80,
// hd=64, N=128, Q=256, bf16 x/B/C) the function moves ~54 MB (x and y 21 MB
// each, final state 10.5 MB) and needs ~8.1 GFLOP (the causal half of the
// intra-chunk products, C . B^T once per batch row since B and C are shared
// by all heads), so its roofline is the memory side, ~16 us. Both bodies
// recompute C . B^T for every head, hold one block of one (b, h) per SM
// (320 blocks at the serving shape, 2.4 waves on 132 SMs) and do not
// overlap a chunk's loads with its products, so they run far above that
// roofline; see PERF.md for the measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ------------------------------------------------------------ mma body
// bf16 x, B and C with hd = HD and N = NS (the Mamba2-2.7B widths), chunk a
// multiple of 64, rows 16-byte aligned. One block of eight warps per
// (batch, head) walks the chunks in order. A chunk's C, B and x (bf16, rows
// padded by 16 bytes so ldmatrix reads hit distinct banks) are brought into
// shared memory by cp.async, zero-filled past the sequence end. The float32
// state S (HD x NS) lives in the warps' mma accumulators for the whole
// sequence: warp w owns state rows 16 (w % 4) .. + 15 and columns
// NS/2 (w / 4) .. + NS/2. Per chunk:
//
// * S is rounded to bf16 into shared memory for the inter-chunk product;
// * the 64-row query tiles are dealt to the two groups of four warps so
//   that each group does the same number of key tiles (tiles 0 and 3 to
//   one, 1 and 2 to the other, and so on). Within a tile warp w takes rows
//   16 (w % 4) .. + 15: y starts as C . S^T scaled by exp(cs_i); then for
//   each key tile kj <= qi the scores C . B^T come out of mma.sync
//   m16n8k16 in float32 registers, are multiplied by exp(cs_i - cs_j) dt_j
//   where j <= i (selection), re-packed as the bf16 A operand (rounded
//   there, as the flash kernel rounds P), and multiplied into y with x as
//   the B operand. On the diagonal tile a warp skips the key blocks past
//   its own rows;
// * S = exp(cs_last) S + (dt seg x)^T B, with the weighted x split into a
//   bf16 high and low part (two products) so the carried state keeps about
//   16 bits: its rounding does not compound from chunk to chunk.
template <int HD, int NS>
struct MmaShape {
  static constexpr int WG = HD / 16;  // warps per group: one per 16 rows
  static constexpr int NW = 2 * WG;   // warps per block
  static constexpr int LDC = NS + 8;  // padded bf16 row of C, B and S
  static constexpr int LDX = HD + 8;  // padded bf16 row of x
};

__host__ __device__ inline size_t mma_smem_bytes(int chunk, int hd, int n) {
  return sizeof(__nv_bfloat16) * (size_t(chunk) * (2 * (n + 8) + hd + 8) + size_t(hd) * (n + 8)) +
         sizeof(float) * 3 * size_t(chunk);
}

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

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// Start copying `rows` rows WIDTH bf16 wide (row stride ld_g elements) into
// shared memory (row stride ld_s), rows at or past `valid` zero-filled.
template <int WIDTH, int NTH>
__device__ __forceinline__ void issue_rows(__nv_bfloat16* dst, int ld_s,
                                           const __nv_bfloat16* src, long long ld_g,
                                           int rows, int valid) {
  constexpr int CH = WIDTH / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NTH) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * ld_s + c, ok ? src + r * ld_g + c : src, ok);
  }
}

// Which warp group takes query tile qt: 0, 1, 1, 0, 0, 1, 1, 0, ... so the
// groups' key-tile counts (qt + 1 each) balance.
__device__ __forceinline__ int tile_group(int qt) { return (qt ^ (qt >> 1)) & 1; }

template <int HD, int NS>
__global__ void __launch_bounds__(MmaShape<HD, NS>::NW * 32, 1) ssd_fwd_mma(Params p) {
  using Sh = MmaShape<HD, NS>;
  constexpr int WG = Sh::WG, NTH = Sh::NW * 32, LDC = Sh::LDC, LDX = Sh::LDX;
  constexpr int SB = NS / 16;  // 8-wide column blocks of this warp's half of S
  constexpr int YB = HD / 8;   // 8-wide column blocks of y
  constexpr int KS = NS / 16;  // k-steps over the state width
  static_assert(HD % 16 == 0 && NS % 32 == 0, "tile shapes");
  const int Q = p.chunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // Q x LDC
  __nv_bfloat16* sB = sC + Q * LDC;                                  // Q x LDC
  __nv_bfloat16* sX = sB + Q * LDC;                                  // Q x LDX
  __nv_bfloat16* sS = sX + Q * LDX;                                  // HD x LDC
  float* cs = reinterpret_cast<float*>(sS + HD * LDC);
  float* dts = cs + Q;
  float* seg = dts + Q;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group / column pair
  const int wr = warp % WG, group = warp / WG;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = p.A[h];
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(p.x) + b * p.x_sb + h * p.x_sh;
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(p.bm) + b * p.b_sb;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(p.cm) + b * p.c_sb;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  __nv_bfloat16* yg = static_cast<__nv_bfloat16*>(p.y) + b * p.y_sb + h * p.y_sh;
  const long long sbase = (long long)(b * p.nh + h) * HD * NS;

  // this warp's part of S: element e of column block n is row
  // 16 wr + g + 8 (e / 2), column c0 + 8 n + 2 t + e % 2
  const int c0 = group * (NS / 2);
  float st[SB][4];
#pragma unroll
  for (int n = 0; n < SB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[n][e] = p.s0 == nullptr ? 0.f
                 : p.s0[sbase + (wr * 16 + g + 8 * (e / 2)) * NS + c0 + 8 * n + 2 * t + e % 2];

  const int nq = Q / TT;
  const int nchunks = (p.seqlen + Q - 1) / Q;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int t0 = ch * Q;
    const int rows = min(Q, p.seqlen - t0);
    __syncthreads();  // the previous chunk is done with every shared tile
    issue_rows<NS, NTH>(sC, LDC, cg + (long long)t0 * p.c_ss, p.c_ss, Q, rows);
    issue_rows<NS, NTH>(sB, LDC, bg + (long long)t0 * p.b_ss, p.b_ss, Q, rows);
    issue_rows<HD, NTH>(sX, LDX, xg + (long long)t0 * p.x_ss, p.x_ss, Q, rows);
    asm volatile("cp.async.commit_group;\n" ::);
    load_dt<NTH>(dts, dtg + t0 * p.dt_ss, p.dt_ss, rows, Q);
#pragma unroll
    for (int n = 0; n < SB; ++n) {  // S entering the chunk, rounded to bf16
      const int r = wr * 16 + g, c = c0 + 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(sS + r * LDC + c) = pack_bf16(st[n][0], st[n][1]);
      *reinterpret_cast<uint32_t*>(sS + (r + 8) * LDC + c) = pack_bf16(st[n][2], st[n][3]);
    }
    __syncthreads();  // dts is written
    if (warp == 0) chunk_cumsum(cs, dts, Q, a);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // cs and the tiles are in
    const float cs_last = cs[Q - 1];  // padded rows add 0
    for (int r = threadIdx.x; r < Q; r += NTH) seg[r] = expf(cs_last - cs[r]);

    const bool carry = ch > 0 || p.s0 != nullptr;  // S entering the chunk may be nonzero
    for (int qt = 0; qt < nq; ++qt) {
      if (tile_group(qt) != group) continue;
      const int r0 = qt * TT + wr * 16;  // this warp's first query row
      uint32_t cf[KS][4];                // its rows of C as A fragments
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(cf[kk], sC + (r0 + lane % 16) * LDC + kk * 16 + (lane / 16) * 8);
      const int ri[2] = {r0 + g, r0 + g + 8};

      // inter-chunk part: exp(cs_i) C_i . S^T (0 while S is still 0)
      float y[YB][4];
#pragma unroll
      for (int n = 0; n < YB; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;
      if (carry) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int n2 = 0; n2 < YB / 2; ++n2) {
            uint32_t bf[4];
            ldsm_x4(bf, sS + (n2 * 16 + lane % 8 + (lane / 16) * 8) * LDC + kk * 16 +
                            ((lane / 8) % 2) * 8);
            mma_bf16(y[2 * n2], cf[kk], bf[0], bf[1]);
            mma_bf16(y[2 * n2 + 1], cf[kk], bf[2], bf[3]);
          }
        }
        const float ey[2] = {expf(cs[ri[0]]), expf(cs[ri[1]])};
#pragma unroll
        for (int n = 0; n < YB; ++n) {
          y[n][0] *= ey[0];
          y[n][1] *= ey[0];
          y[n][2] *= ey[1];
          y[n][3] *= ey[1];
        }
      }

      // intra-chunk part over the key tiles at or below the diagonal
      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * TT;
        // key blocks of 16 this warp needs: on the diagonal, up to its rows
        const int kb = kt == qt ? wr + 1 : TT / 16;
        float s[TT / 8][4];
#pragma unroll
        for (int n = 0; n < TT / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int n2 = 0; n2 < TT / 16; ++n2) {
            if (n2 >= kb) continue;
            uint32_t bf[4];
            ldsm_x4(bf, sB + (j0 + n2 * 16 + lane % 8 + (lane / 16) * 8) * LDC + kk * 16 +
                            ((lane / 8) % 2) * 8);
            mma_bf16(s[2 * n2], cf[kk], bf[0], bf[1]);
            mma_bf16(s[2 * n2 + 1], cf[kk], bf[2], bf[3]);
          }
        }
        // decay by selection, times dt_j
#pragma unroll
        for (int n = 0; n < TT / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = ri[e / 2];
            const int j = j0 + 8 * n + 2 * t + (e % 2);
            s[n][e] = j <= i ? s[n][e] * expf(cs[i] - cs[j]) * dts[j] : 0.f;
          }
        }
        // y += M . x, M re-packed as the bf16 A operand
#pragma unroll
        for (int kk = 0; kk < TT / 16; ++kk) {
          if (kk >= kb) continue;
          const uint32_t pa[4] = {
              pack_bf16(s[2 * kk][0], s[2 * kk][1]),
              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
          };
#pragma unroll
          for (int n2 = 0; n2 < YB / 2; ++n2) {
            uint32_t bf[4];
            ldsm_x4_t(bf, sX + (j0 + kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDX +
                              n2 * 16 + (lane / 16) * 8);
            mma_bf16(y[2 * n2], pa, bf[0], bf[1]);
            mma_bf16(y[2 * n2 + 1], pa, bf[2], bf[3]);
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (ri[r] >= rows) continue;
        __nv_bfloat16* yrow = yg + (long long)(t0 + ri[r]) * p.y_ss;
#pragma unroll
        for (int n = 0; n < YB; ++n)
          *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * n + 2 * t) =
              __floats2bfloat162_rn(y[n][2 * r], y[n][2 * r + 1]);
      }
    }

    // state update: S = exp(cs_last) S + (w x)^T B with w_j = dt_j seg_j
    __syncthreads();  // seg is written
    const float dec = expf(cs_last);
#pragma unroll
    for (int n = 0; n < SB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] *= dec;
    for (int kk = 0; kk < Q / 16; ++kk) {
      const int j0 = kk * 16;
      uint32_t xa[4];  // x^T rows 16 wr .., keys j0 .. j0 + 15
      ldsm_x4_t(xa, sX + (j0 + lane % 8 + (lane / 16) * 8) * LDX + wr * 16 +
                        ((lane / 8) % 2) * 8);
      // element pairs of xa[r] sit at keys j0 + 2t (+1), + 8 for r >= 2
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + 2 * t + 8 * (r / 2);
        const float2 v = unpack_bf16(xa[r]);
        const float w0 = v.x * (dts[j] * seg[j]), w1 = v.y * (dts[j + 1] * seg[j + 1]);
        hi[r] = pack_bf16(w0, w1);
        const float2 hv = unpack_bf16(hi[r]);
        lo[r] = pack_bf16(w0 - hv.x, w1 - hv.y);
      }
#pragma unroll
      for (int n2 = 0; n2 < SB / 2; ++n2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, sB + (j0 + lane % 8 + ((lane / 8) % 2) * 8) * LDC + c0 + n2 * 16 +
                          (lane / 16) * 8);
        mma_bf16(st[2 * n2], hi, bf[0], bf[1]);
        mma_bf16(st[2 * n2 + 1], hi, bf[2], bf[3]);
        mma_bf16(st[2 * n2], lo, bf[0], bf[1]);
        mma_bf16(st[2 * n2 + 1], lo, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < SB; ++n)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      *reinterpret_cast<float2*>(p.sfin + sbase + (wr * 16 + g + 8 * (e / 2)) * NS + c0 +
                                 8 * n + 2 * t) = make_float2(st[n][e], st[n][e + 1]);
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

template <int HD, int NS>
cudaError_t launch_mma(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(p.chunk, HD, NS);
  static size_t granted = 48 * 1024;
  cudaError_t err = grant_smem(ssd_fwd_mma<HD, NS>, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.nh, batch);
  ssd_fwd_mma<HD, NS><<<grid, MmaShape<HD, NS>::NW * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// The mma body's conditions: the widths it is compiled for, whole 64-row
// tiles, its chunk in shared memory, and 16-byte aligned rows of x, B and
// C (it copies them with 16-byte cp.async) and 4-byte aligned y pairs.
bool mma_takes(const Params& p) {
  if (p.hd != 64 || p.n != 128 || p.chunk % TT != 0) return false;
  if (mma_smem_bytes(p.chunk, p.hd, p.n) > MAX_SMEM) return false;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(p.x) | reinterpret_cast<uintptr_t>(p.bm) |
                         reinterpret_cast<uintptr_t>(p.cm);
  const long long strides = p.x_sb | p.x_ss | p.x_sh | p.b_sb | p.b_ss | p.c_sb | p.c_ss;
  const long long y_strides = p.y_sb | p.y_ss | p.y_sh;
  return ptrs % 16 == 0 && strides % 8 == 0 && reinterpret_cast<uintptr_t>(p.y) % 4 == 0 &&
         y_strides % 2 == 0;
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, cudaStream_t stream) {
  if (p.hd <= 16) return launch_simt<T, 1>(p, batch, stream);
  if (p.hd <= 32) return launch_simt<T, 2>(p, batch, stream);
  if (p.hd <= 64) return launch_simt<T, 4>(p, batch, stream);
  if (p.hd <= 128) return launch_simt<T, 8>(p, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, B, C and y): 0 float32, 1 bfloat16. dt, A, the initial
// state s0 (may be null) and the final state are float32; s0 and sfin are
// contiguous (B, NH, hd, N). Strides are in elements; the last axis of x,
// B, C and y is contiguous. Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int repro_ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* bm, const void* cm,
    const void* s0, void* y, void* sfin, int dtype, int device, int batch,
    int seqlen, int nh, int hd, int n, int chunk, long long x_sb, long long x_ss,
    long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
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
  if (dtype == 0) return dispatch<float>(p, batch, s);
  if (dtype == 1) {
    if (mma_takes(p)) return launch_mma<64, 128>(p, batch, s);
    return dispatch<__nv_bfloat16>(p, batch, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
