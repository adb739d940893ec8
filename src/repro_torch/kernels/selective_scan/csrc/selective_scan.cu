// The Mamba-1 selective scan for NVIDIA Hopper (sm_90a): the SSM heads of
// the published Hymba-1.5B in prefill.
//
// Replaces no Pallas kernel: the JAX package has no Mamba-1 layer, and the
// port's SSD scan takes one scalar A a head, where Mamba-1 decays every
// (channel, state) at its own rate. For every row b and channel c, over the
// positions t of the sequence, with N = 16 states:
//
//   dt  = softplus(dt_raw + dt_bias)            (PyTorch's threshold of 20)
//   h_n = exp(dt * A_n) * h_n + (dt * x) * B_n   A_n = -exp(A_log[c, n])
//   y   = (sum_n h_n C_n + D x) * silu(z)        (float32, rounded once)
//
// and the final h, rounded to bf16, over the layer's (B, di, N) slice of the
// state cache (kernels/selective_scan/ref.py holds the plain version).
//
// What bounds it on the card. Its bytes are x, dt, z read and y written
// (8 bytes a (row, channel, position), B and C beside them are 1/100 of
// that at di = 3,200): at the cell's longest prefill (B 8, S 8,064, di
// 3,200) 1.65 GB, 0.49 ms at 3.35 TB/s. Its operations are 16 exponentials
// a (row, channel, position), one per state, which no algebra removes (A
// differs per channel and state), plus four float32 multiply-adds each:
// 3.3 G exponentials a launch, ~0.8 ms at 16 a clock on each of 132 SMs.
// It takes ~2.9 ms there: no one unit bounds it. Taken out one at a time,
// the exponentials of the states save 14 %, the loads 17 %, the stores of
// y 10 % (H100, 700 W); lanes that split a channel's states two or four
// ways (more warps to hide latency) ran no faster. What did pay was
// softplus through the fast intrinsics (__expf, __logf: 25 % of the time
// with log1pf(expf())); their relative error, ~4e-4 at dt ~ 1e-3, is ten
// times below the bf16 rounding of the dt it is computed from.
//
// The design: one warp a block, one lane a channel, 32 channels of one row;
// a lane walks the whole sequence once with its 16 states and 16 values of
// A·log2(e) in registers, so a state never leaves the SM. Positions come in
// chunks of TC: the next chunk's x, dt, z and the warp's B and C (one of the
// row's 32 values a lane) are loaded into registers while the current chunk
// computes; B and C go through shared memory to every lane as float4
// broadcasts. The decay is ex2.approx of one multiply. y is stored per
// position, coalesced over the warp's channels; the final state as two
// 16-byte stores a lane. No atomics, no synchronisation beyond the warp, no
// allocation: the wrapper allocates y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int TC = 16;  // positions a chunk holds in registers
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SOFTPLUS_THRESHOLD = 20.f;

struct Params {
  const __nv_bfloat16* x;   // (B, S, di), di contiguous
  const __nv_bfloat16* dt;  // (B, S, di) raw, before dt_bias and softplus
  const __nv_bfloat16* z;   // (B, S, di)
  const __nv_bfloat16* bm;  // (B, S, N)
  const __nv_bfloat16* cm;  // (B, S, N)
  const float* dt_bias;     // (di,)
  const float* a_log;       // (di, N)
  const float* d;           // (di,)
  __nv_bfloat16* y;         // (B, S, di), contiguous
  __nv_bfloat16* state;     // (B, di, N), contiguous
  int s, di;
  long long x_sb, x_ss, dt_sb, dt_ss, z_sb, z_ss, b_sb, b_ss, c_sb, c_ss;  // in elements
};

__device__ __forceinline__ float fast_exp2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

template <int N>
__global__ void __launch_bounds__(WARP) selective_scan_kernel(Params p) {
  static_assert(2 * N == WARP, "each lane loads one of a position's N values of B and of C");
  __shared__ __align__(16) float bc[TC][2 * N];  // a chunk's B (first N) and C (last N)

  const int lane = threadIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.x * WARP + lane;
  const bool live = c < p.di;
  const int cc = live ? c : p.di - 1;  // a lane past di loads a neighbour's and stores nothing

  float a2[N];  // A_n * log2(e): exp(dt A_n) = 2^(dt a2_n)
#pragma unroll
  for (int n = 0; n < N; ++n) a2[n] = -expf(p.a_log[static_cast<size_t>(cc) * N + n]) * LOG2E;
  const float bias = p.dt_bias[cc];
  const float dskip = p.d[cc];
  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = 0.f;

  const __nv_bfloat16* xg = p.x + b * p.x_sb + cc;
  const __nv_bfloat16* dg = p.dt + b * p.dt_sb + cc;
  const __nv_bfloat16* zg = p.z + b * p.z_sb + cc;
  const __nv_bfloat16* bcg = lane < N ? p.bm + b * p.b_sb + lane : p.cm + b * p.c_sb + (lane - N);
  const long long bc_ss = lane < N ? p.b_ss : p.c_ss;
  __nv_bfloat16* yg = p.y + static_cast<size_t>(b) * p.s * p.di + cc;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // the next chunk, in flight while the current one computes
  __nv_bfloat16 xn[TC], dn[TC], zn[TC], bn[TC];
#pragma unroll
  for (int i = 0; i < TC; ++i) {
    const bool ok = i < p.s;
    xn[i] = ok ? xg[i * p.x_ss] : zero;
    dn[i] = ok ? dg[i * p.dt_ss] : zero;
    zn[i] = ok ? zg[i * p.z_ss] : zero;
    bn[i] = ok ? bcg[i * bc_ss] : zero;
  }

  for (int t0 = 0; t0 < p.s; t0 += TC) {
    // the chunk's per-position terms first, independent of one another
    // (their latency overlaps): dt, dt·x, D·x and the gate
    float dtv[TC], uv[TC], dxv[TC], gv[TC];
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      const float xv = __bfloat162float(xn[i]);
      const float zv = __bfloat162float(zn[i]);
      float dt = __bfloat162float(dn[i]) + bias;
      dt = dt > SOFTPLUS_THRESHOLD ? dt : __logf(1.f + __expf(dt));
      dtv[i] = dt;
      uv[i] = dt * xv;
      dxv[i] = dskip * xv;
      gv[i] = __fdividef(zv, 1.f + __expf(-zv));
      bc[i][lane] = __bfloat162float(bn[i]);
    }
    __syncwarp();
    const int t1 = t0 + TC;
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      const bool ok = t1 + i < p.s;
      const long long t = t1 + i;
      xn[i] = ok ? xg[t * p.x_ss] : zero;
      dn[i] = ok ? dg[t * p.dt_ss] : zero;
      zn[i] = ok ? zg[t * p.z_ss] : zero;
      bn[i] = ok ? bcg[t * bc_ss] : zero;
    }
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      if (t0 + i >= p.s) break;  // the ragged tail; uniform over the warp
      const float4* row = reinterpret_cast<const float4*>(bc[i]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};  // four short chains, not one of N
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 bv = row[q];
        const float4 cv = row[N / 4 + q];
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cx[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = 4 * q + k;
          h[n] = fmaf(h[n], fast_exp2(dtv[i] * a2[n]), uv[i] * bb[k]);
          acc[k] = fmaf(h[n], cx[k], acc[k]);
        }
      }
      const float y = ((acc[0] + acc[1]) + (acc[2] + acc[3]) + dxv[i]) * gv[i];
      if (live) yg[static_cast<size_t>(t0 + i) * p.di] = __float2bfloat16_rn(y);
    }
    __syncwarp();  // every lane has read this chunk's B and C
  }

  if (live) {
    __align__(16) __nv_bfloat16 out[N];
#pragma unroll
    for (int n = 0; n < N; ++n) out[n] = __float2bfloat16_rn(h[n]);
    uint4* sp = reinterpret_cast<uint4*>(p.state + (static_cast<size_t>(b) * p.di + c) * N);
#pragma unroll
    for (int v = 0; v < N / 8; ++v) sp[v] = reinterpret_cast<const uint4*>(out)[v];
  }
}

}  // namespace

// One layer's scan from a zero state. x, dt, z, B, C and y are bf16 with a
// contiguous last axis (strides in elements); y is contiguous (B, S, di);
// dt_bias, A_log and D are float32; the state is bf16 (B, di, N), contiguous
// and 16-byte aligned, written in place. N must be 16, else
// cudaErrorInvalidValue. Launches on `stream` on the current device and
// synchronises nothing. Returns 0 on success, else a code for
// repro_cuda_error_string.
extern "C" int repro_selective_scan(const void* x, const void* dt, const void* z, const void* bm,
                                    const void* cm, const void* dt_bias, const void* a_log,
                                    const void* d, void* y, void* state, int batch, int s,
                                    int di, int n, long long x_sb, long long x_ss,
                                    long long dt_sb, long long dt_ss, long long z_sb,
                                    long long z_ss, long long b_sb, long long b_ss,
                                    long long c_sb, long long c_ss, void* stream) {
  if (n != 16 || batch < 1 || batch > 65535 || s < 1 || di < 1) return cudaErrorInvalidValue;
  const Params p{static_cast<const __nv_bfloat16*>(x),  static_cast<const __nv_bfloat16*>(dt),
                 static_cast<const __nv_bfloat16*>(z),  static_cast<const __nv_bfloat16*>(bm),
                 static_cast<const __nv_bfloat16*>(cm), static_cast<const float*>(dt_bias),
                 static_cast<const float*>(a_log),      static_cast<const float*>(d),
                 static_cast<__nv_bfloat16*>(y),        static_cast<__nv_bfloat16*>(state),
                 s, di, x_sb, x_ss, dt_sb, dt_ss, z_sb, z_ss, b_sb, b_ss, c_sb, c_ss};
  const dim3 grid((di + WARP - 1) / WARP, batch);
  selective_scan_kernel<16><<<grid, WARP, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
