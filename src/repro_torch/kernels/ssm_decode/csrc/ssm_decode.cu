// Mamba2's single-token decode state step for NVIDIA Hopper (sm_90a), in
// place in the bf16 state cache.
//
// Replaces no Pallas kernel: the JAX package's decode step
// (repro/models/ssm.py::mamba2_decode) is plain jnp, and so was the port's
// (kernels/ssm_decode/ref.py holds it). For every (row b, head h) of a layer:
//
//   dt   = softplus(dt_raw + dt_bias)            (PyTorch's threshold of 20)
//   dA   = exp(dt * -exp(A_log))
//   s'   = s * dA + dt * x_p * B_n               (p < hd, n < N; float32)
//   y_p  = sum_n C_n * s'_{p,n}                  (float32, unrounded s')
//   y    = y_p + x_p * D                         (the compute dtype's roundings)
//   s    = bf16(s')                              (round to nearest even)
//
// The state s is the layer's contiguous (B, nh, hd, N) slice of the bf16
// cache; it is read once and written once, and neither the widened state,
// the outer product dt x B nor the float32 s' ever reaches device memory.
// s' is computed with __fmul_rn / __fadd_rn in the plain version's order,
// with no fused multiply-add, so the stored state is the plain version's bit
// for bit; the triple product is grouped as the plain version writes it,
// (B_n dt) x_p. y's sum over N runs in this kernel's own fixed order (the
// plain version's is a float32 bmm's).
//
// What bounds it on the card: bytes. At the Mamba2-2.7B serving shape (B 32,
// nh 80, hd 64, N 128) a launch reads and writes 41.9 MB of state each, 83.9
// MB in all, 25.0 us at 3.35 TB/s; its work is 5 flops an element, 0.105 GFLOP.
// The design streams the state: one block per (b, h), 16-byte loads, each
// group of N/8 neighbouring lanes holding one state row (lanes on
// neighbouring n), every load of a thread issued before any arithmetic, so a
// block keeps its whole slice (16 KB at N = 128) in flight. dt, dA and the
// thread's B and C values live in registers; the row sums over N reduce by
// warp shuffles within the row's lanes. No shared memory, no atomics, no
// allocation and no synchronisation: the launch is captured into the serving
// engine's CUDA graph of the decode step.
//
// Instantiated on the state's (hd, N) (Mamba2-2.7B's (64, 128), Hymba-1.5B's
// (64, 16) and the reduced models' (16, 16)) and on the compute dtype of x,
// dt, B, C and y (float32 or bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;       // bf16 state elements per 16-byte load
constexpr int MAX_NT = 128;  // threads per block
constexpr float SOFTPLUS_THRESHOLD = 20.f;

template <int HD, int N>
struct Shape {
  static_assert(N % VEC == 0 && 32 % (N / VEC) == 0, "a state row spans lanes of one warp");
  static constexpr int VPR = N / VEC;                         // 16-byte vectors per state row
  static constexpr int VECS = HD * VPR;                       // per (b, h)
  static constexpr int NT = VECS < MAX_NT ? VECS : MAX_NT;    // threads per block
  static constexpr int ITERS = VECS / NT;                     // vectors per thread
  static constexpr int ROWS = NT / VPR;                       // rows per pass of the block
  static_assert(NT % 32 == 0 && VECS % NT == 0, "whole warps, whole passes");
};

struct Params {
  __nv_bfloat16* state;  // (B, nh, hd, N), contiguous
  const void* x;         // (B, nh, hd), hd contiguous
  const void* dt;        // (B, nh) raw, before dt_bias and softplus
  const void* bm;        // (B, N)
  const void* cm;        // (B, N)
  const float* dt_bias;  // (nh,)
  const float* a_log;    // (nh,)
  const float* d;        // (nh,)
  void* y;               // (B, nh, hd), contiguous
  int nh;
  long long x_sb, x_sh, dt_sb, b_sb, c_sb;  // strides, in elements
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// The compute dtype's rounding of a float32 value: the identity in float32.
template <typename T>
__device__ __forceinline__ float rounded(float v) { return v; }
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int HD, int N, typename T>
__global__ void __launch_bounds__(Shape<HD, N>::NT) ssm_decode_kernel(Params p) {
  using S = Shape<HD, N>;
  const int bh = blockIdx.x;
  const int b = bh / p.nh;
  const int h = bh - b * p.nh;
  const int t = threadIdx.x;
  const int col = t % S::VPR;  // this thread's 8 of N, the same in every pass
  const int row0 = t / S::VPR;

  // Every state load first: the slice of (b, h) is contiguous, vector
  // t + k * NT holds row row0 + k * ROWS, columns [8 col, 8 col + 8).
  uint4* sp = reinterpret_cast<uint4*>(p.state + static_cast<size_t>(bh) * HD * N);
  uint4 raw[S::ITERS];
#pragma unroll
  for (int k = 0; k < S::ITERS; ++k) raw[k] = sp[t + k * S::NT];

  const T* xp = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  float xv[S::ITERS];
#pragma unroll
  for (int k = 0; k < S::ITERS; ++k) xv[k] = widen(xp[row0 + k * S::ROWS]);
  const T* bp = static_cast<const T*>(p.bm) + b * p.b_sb + col * VEC;
  const T* cp = static_cast<const T*>(p.cm) + b * p.c_sb + col * VEC;
  float bv[VEC], cv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    bv[j] = widen(bp[j]);
    cv[j] = widen(cp[j]);
  }

  // dt and dA in registers, as the plain version's float32 ops compute them
  float dt = __fadd_rn(widen(static_cast<const T*>(p.dt)[b * p.dt_sb + h]), p.dt_bias[h]);
  dt = dt > SOFTPLUS_THRESHOLD ? dt : log1pf(expf(dt));
  const float A = -expf(p.a_log[h]);
  const float dA = expf(__fmul_rn(dt, A));
  const float dd = rounded<T>(p.d[h]);
  // dt * x_p * B_n as f[n] * x_p, f[n] = B_n dt
  float f[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) f[j] = __fmul_rn(bv[j], dt);

  T* yp = static_cast<T*>(p.y) + static_cast<size_t>(bh) * HD;
#pragma unroll
  for (int k = 0; k < S::ITERS; ++k) {
    const __nv_bfloat16* s = reinterpret_cast<const __nv_bfloat16*>(&raw[k]);
    __align__(16) __nv_bfloat16 out[VEC];
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float s1 = __fadd_rn(__fmul_rn(__bfloat162float(s[j]), dA), __fmul_rn(f[j], xv[k]));
      acc = fmaf(cv[j], s1, acc);
      out[j] = __float2bfloat16_rn(s1);
    }
    sp[t + k * S::NT] = *reinterpret_cast<const uint4*>(out);
#pragma unroll
    for (int off = S::VPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (col == 0) {
      const float skip = rounded<T>(__fmul_rn(xv[k], dd));
      yp[row0 + k * S::ROWS] = narrow<T>(__fadd_rn(rounded<T>(acc), skip));
    }
  }
}

template <int HD, int N, typename T>
cudaError_t launch(const Params& p, int blocks, cudaStream_t stream) {
  ssm_decode_kernel<HD, N, T><<<blocks, Shape<HD, N>::NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int blocks, int hd, int n, cudaStream_t stream) {
  if (hd == 64 && n == 128) return launch<64, 128, T>(p, blocks, stream);
  if (hd == 64 && n == 16) return launch<64, 16, T>(p, blocks, stream);
  if (hd == 16 && n == 16) return launch<16, 16, T>(p, blocks, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// One decode state step of one layer, in place in `state`. dtype (of x, dt,
// B, C and y): 0 float32, 1 bfloat16; the state is bf16 (B, nh, hd, N),
// contiguous and 16-byte aligned; dt_bias, A_log and D are float32 (nh,); y
// is contiguous (B, nh, hd). Strides are in elements; the last axis of x,
// dt, B and C is contiguous. (hd, N) is one of (64, 128), (64, 16), (16,
// 16), else cudaErrorInvalidValue. Launches on `stream` and does nothing a
// stream capture forbids. Returns 0 on success, else a code for
// repro_cuda_error_string.
extern "C" int repro_ssm_decode(void* state, const void* x, const void* dt, const void* bm,
                                const void* cm, const void* dt_bias, const void* a_log,
                                const void* d, void* y, int dtype, int device, int batch,
                                int nh, int hd, int n, long long x_sb, long long x_sh,
                                long long dt_sb, long long b_sb, long long c_sb, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  if (batch < 1 || nh < 1 || static_cast<long long>(batch) * nh > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Params p{static_cast<__nv_bfloat16*>(state), x, dt, bm, cm,
                 static_cast<const float*>(dt_bias), static_cast<const float*>(a_log),
                 static_cast<const float*>(d), y, nh, x_sb, x_sh, dt_sb, b_sb, c_sb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, batch * nh, hd, n, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, batch * nh, hd, n, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
