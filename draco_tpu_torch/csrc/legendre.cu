// Normalised associated Legendre functions for the spherical-harmonic
// transform, for Hopper (sm_90a).
//
//   Lambda[l - l0, c, r] = lambda_l^{m_c}(cos theta_r),   l = l0 .. L,
//
// fully normalised with the Condon-Shortley phase, from the upward
// l-recurrence
//
//   Lambda_{m,m}   = (-1)^m exp(C_m + m ln sin theta)
//   Lambda_{l,m}   = a[l,m] cos(theta) Lambda_{l-1,m} + b[l,m] Lambda_{l-2,m}
//
// with libsharp-style power-of-two rescaling: the recurrence carries a
// mantissa and an exponent e, and divides the mantissa by 2^60 (e += 1)
// whenever it grows past 2^60, so values far below the floating-point floor
// near the poles at large m come out right once they grow.  Rows l < m_c
// are exact zeros.  l0 (at most the smallest m of the block) drops the
// leading rows l < l0, which are all zeros.
//
// Replaces the JAX package's recurrence draco_tpu/ops/sht.py
// _legendre_block_core (a lax.scan over l, called by SHT._legendre_block and
// SHT.precompute_legendre_split_2f_streamed): an XLA program, not a Pallas
// kernel.  Its plain PyTorch version,
// draco_tpu_torch/ops/sht.py::_legendre_block_core, is a Python loop over l
// of some twenty tensor operations on [C, R] tensors, so at nside 1024
// (L = 3071, a chunk of C = 64 m over R = 4095 rings) it is ~61k launches a
// chunk.  Here every thread owns one (c, r) and runs the whole recurrence in
// registers.
//
// The bound.  The kernel writes (L+1-l0) C R values and reads only the
// small tables, so it is bound by the bytes it writes: a chunk of 64 m at
// nside 1024 in the two-float mode (4 + 2 bytes a value) is 4.83 GB for
// l0 = 0, 1.44 ms at 3.35 TB/s.  The arithmetic (five operations a value,
// in float64 for the float64 and two-float modes) is ~0.1 ms of the H100's
// float64 rate.  So the design only has to keep the writes coalesced and
// the card full:
//
// - threads adjacent in r, so the row of one l of one block is one
//   contiguous store of 128 values, and rows of a stride rs that the
//   wrapper pads to a multiple of 32 rings, so that each warp's stores fill
//   whole 32-byte sectors (at nside 1024 R = 4095: unpadded rows leave a
//   partial sector at both ends of every warp's store, and the kernel took
//   5.2-5.6 ms instead of 2.35);
// - one block per (128 rings, one m): C x ceil(R / 128) blocks, 2048 at a
//   chunk of 64 m at nside 1024 (a full wave of 128-thread blocks on 132
//   SMs), and the m of a block is uniform, so the l < m branch never
//   diverges;
// - a[l, c] and b[l, c] are staged through shared memory LT rows at a time,
//   read once a block per l;
// - the value written is the true one, scalbn(mantissa, 60 e), and not the
//   mantissa times exp2(60 e), which would underflow to zero one step
//   earlier.
//
// Measured on an H100 80GB HBM3 at 700 W (the first chunk at nside 1024,
// two-float): 5.2-5.6 ms against the 1.44 ms bound with unpadded rows, the
// same at 40 registers a thread (12 blocks an SM, two waves) as at 32 (one
// wave, forced by a launch bound); 2.35 ms with the rows padded.
//
// The multiplies and adds use the round-to-nearest intrinsics, which the
// compiler never contracts into fused multiply-adds, so each step rounds as
// the plain version's separate tensor operations do.
//
// Modes: float64 in and out; float32 in and out (the recurrence in float32,
// as the plain version runs it for float32 tables); two-float, a float64
// recurrence that writes hi = float32(value) and lo = bfloat16(value - hi),
// so the float64 tensor is never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // rings per block
constexpr int LT = 256;       // rows of a and b staged per step
constexpr int SCALE_BITS = 60;

enum Mode { MODE_F64 = 0, MODE_F32 = 1, MODE_2F = 2 };

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double div_(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ double fabs_(double x) { return fabs(x); }
__device__ __forceinline__ double scalbn_(double x, int e) { return scalbn(x, e); }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div_(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ float fabs_(float x) { return fabsf(x); }
__device__ __forceinline__ float scalbn_(float x, int e) { return scalbnf(x, e); }

template <typename W, int MODE>
__device__ __forceinline__ void store(W val, size_t idx, void* out, void* out_lo) {
  if constexpr (MODE == MODE_2F) {
    const float h = __double2float_rn(static_cast<double>(val));
    static_cast<float*>(out)[idx] = h;
    const double resid = static_cast<double>(val) - static_cast<double>(h);
    static_cast<__nv_bfloat16*>(out_lo)[idx] = __float2bfloat16_rn(__double2float_rn(resid));
  } else {
    static_cast<W*>(out)[idx] = val;
  }
}

// x, lnsin [R]; cm, mv [C]; a, b [L1, C]; out (and out_lo) [L1 - l0, C, rs]
// of which the first R of each row are written (rs >= R, the row stride).
template <typename W, int MODE>
__global__ void __launch_bounds__(THREADS)
legendre_kernel(const W* __restrict__ x, const W* __restrict__ lnsin, const W* __restrict__ cm,
                const W* __restrict__ a_tab, const W* __restrict__ b_tab, const int* __restrict__ mv,
                void* out, void* out_lo, int L1, int l0, int C, int R, int rs) {
  __shared__ W sa[LT];
  __shared__ W sb[LT];
  const int c = blockIdx.y;
  const int r = blockIdx.x * THREADS + threadIdx.x;
  const bool live = r < R;
  const int m = mv[c];

  const W two_b = W(0x1p60);
  const W inv_two_b = W(0x1p-60);
  // 60 ln 2 as the plain version rounds it: the float64 product, then W
  const W k_scale = W(0x1.4cb5ecf0a9650p+5);
  const W xr = live ? x[r] : W(0);

  // seed: ln |Lambda_mm| = C_m + m ln sin(theta), split into 2^(60 e0) times
  // a mantissa in [1, 2^60)
  W p_seed = W(0);
  int e0 = 0;
  if (live) {
    const W ln_seed = add(cm[c], mul(static_cast<W>(m), lnsin[r]));
    const W ef = floor_(div_(ln_seed, k_scale));
    e0 = static_cast<int>(ef);
    p_seed = exp_(sub(ln_seed, mul(ef, k_scale)));
    if (m & 1) p_seed = -p_seed;
  }

  const size_t row = static_cast<size_t>(C) * rs;
  size_t idx = static_cast<size_t>(c) * rs + r;
  W p_prev = W(0), p_curr = W(0);
  int e = 0;
  for (int lb = l0; lb < L1; lb += LT) {
    const int n = min(LT, L1 - lb);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += THREADS) {
      sa[i] = a_tab[static_cast<size_t>(lb + i) * C + c];
      sb[i] = b_tab[static_cast<size_t>(lb + i) * C + c];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n; ++i, idx += row) {
      const int l = lb + i;
      if (l < m) {
        store<W, MODE>(W(0), idx, out, out_lo);
        continue;
      }
      W p_new, p_base;
      int e_new;
      if (l == m) {
        p_new = p_seed;
        p_base = W(0);
        e_new = e0;
      } else {
        p_new = add(mul(mul(sa[i], xr), p_curr), mul(sb[i], p_prev));
        p_base = p_curr;
        e_new = e;
      }
      if (fabs_(p_new) > two_b) {
        p_new = mul(p_new, inv_two_b);
        p_base = mul(p_base, inv_two_b);
        e_new += 1;
      }
      store<W, MODE>(e_new == 0 ? p_new : scalbn_(p_new, e_new * SCALE_BITS), idx, out, out_lo);
      p_prev = p_base;
      p_curr = p_new;
      e = e_new;
    }
  }
}

template <typename W, int MODE>
int launch(const W* x, const W* lnsin, const W* cm, const W* a_tab, const W* b_tab, const int* mv, void* out,
           void* out_lo, int L1, int l0, int C, int R, int rs, void* stream) {
  if (C <= 0 || R <= 0 || L1 <= l0) return 0;
  if (rs < R) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + THREADS - 1) / THREADS, C);
  legendre_kernel<W, MODE><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, lnsin, cm, a_tab, b_tab, mv, out, out_lo, L1, l0, C, R, rs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, lnsin [R]; cm [C]; a, b [L1, C]; mv int32 [C], every m >= l0; out
// [L1 - l0, C, rs] (and lo for the two-float mode), rows of stride rs >= R:
// contiguous, on the device.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success).
int legendre_f64(const double* x, const double* lnsin, const double* cm, const double* a_tab, const double* b_tab,
                 const int* mv, double* out, int L1, int l0, int C, int R, int rs, void* stream) {
  return launch<double, MODE_F64>(x, lnsin, cm, a_tab, b_tab, mv, out, nullptr, L1, l0, C, R, rs, stream);
}

int legendre_f32(const float* x, const float* lnsin, const float* cm, const float* a_tab, const float* b_tab,
                 const int* mv, float* out, int L1, int l0, int C, int R, int rs, void* stream) {
  return launch<float, MODE_F32>(x, lnsin, cm, a_tab, b_tab, mv, out, nullptr, L1, l0, C, R, rs, stream);
}

int legendre_2f(const double* x, const double* lnsin, const double* cm, const double* a_tab, const double* b_tab,
                const int* mv, float* hi, void* lo, int L1, int l0, int C, int R, int rs, void* stream) {
  return launch<double, MODE_2F>(x, lnsin, cm, a_tab, b_tab, mv, hi, lo, L1, l0, C, R, rs, stream);
}

}  // extern "C"
