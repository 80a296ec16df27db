// Batched banded covariance for the sidereal regridder, for Hopper (sm_90a).
//
//   C[b, d, j] = sum_t R[j+d, t] * Ni[b, t] * R[j, t],   d = 0..bw
//
// i.e. every lower band diagonal of R diag(Ni_b) R^T from one pass over R.
// Entries past the band end (j > m-1-d) are written as exact zeros.
//
// Replaces the TPU kernel draco_tpu/ops/pallas_kernels.py
// banded_covariance_pallas (body _kernel_factory).  The TPU carried the t
// sum across sequential grid steps in its output block; blocks on the
// H100 run in parallel and in no order, so here the t loop runs inside
// the block and the sums never leave registers.  No atomics: the result
// is deterministic.
//
// Design: one block per (b, j-tile of TJ rows).  Per stage of TT samples
// the block copies the (TJ + bw) x TT slice of R and the Ni[b] slice into
// shared memory, R transposed so that rows are contiguous: each thread
// loads float4 runs of 4 samples and stores them as 4 row entries, with
// the row's float4 chunks XOR-swizzled by sample so that those stores and
// the float4 reads below are both free of bank conflicts.  The loads of
// the next stage are issued into registers before the current stage is
// computed, so their latency hides behind the arithmetic.  Each thread
// owns J consecutive rows: one run of float4 loads gives it the J + bw
// values R[j .. j+J-1+bw][t] its J*(bw+1) multiply-adds need, so every
// loaded float feeds several sums.  The band width is a template
// parameter, so the (j, d) accumulators live in registers with no
// predicated work.  blockIdx.x runs over b, so the blocks resident at one
// time read the same R rows through L2.
//
// What bounds it: the dense work is 2*B*(bw+1)*m*n flops (about 7.5e11 at
// the regridder's shape m=2098, n=8640, B=2080, bw=9) on the float32 CUDA
// cores, about 11 ms at the H100's 67 TFLOP/s; shared-memory reads are
// about (J+bw)/(J*(bw+1)) floats per multiply-add, and each block reads
// its R rows again from L2 (about B * |R| bytes in all).  R is a Lanczos
// interpolation band (each row has about 2*a*n/m nonzeros), so most of
// that work multiplies zeros; skipping the empty t tiles, and sharing an R
// tile across several b, are left to later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TJ = 512;             // rows j per block
constexpr int J = 4;                // consecutive rows per thread
constexpr int NTHREADS = TJ / J;    // threads per block
constexpr int NWARPS = NTHREADS / 32;
constexpr int TT = 16;              // samples t per stage: 4 float4 per row
constexpr int BWMAX = 31;           // largest band width instantiated

template <int BW>
struct Geom {
  // float4 loads per thread window of J + BW rows
  static constexpr int NV = (J + BW + 3) / 4;
  // shared row pitch in floats, a multiple of 32 that holds every window
  // after the swizzle
  static constexpr int LD = TJ + 32 * ((4 * NV + 31) / 32);
  // staging units of 8 rows x TT samples (one warp instruction each) and
  // the units each warp moves per stage
  static constexpr int RU = (TJ + BW + 7) / 8;
  static constexpr int PF = (RU + NWARPS - 1) / NWARPS;
  static constexpr size_t SMEM = (static_cast<size_t>(TT) * LD + TT) * sizeof(float);
};

// Shared layout: entry (c, r) sits at c * LD + 4 * (r/4 ^ 2*(c/4 % 4)) + r % 4.
template <int BW>
__global__ void __launch_bounds__(NTHREADS)
banded_covariance_kernel(const float* __restrict__ R,
                         const float* __restrict__ Ni,
                         float* __restrict__ out, int m, int n, bool vec) {
  constexpr int NV = Geom<BW>::NV;
  constexpr int LD = Geom<BW>::LD;
  constexpr int RU = Geom<BW>::RU;
  constexpr int PF = Geom<BW>::PF;
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;             // [TT][LD], swizzled
  float* Ns = smem + TT * LD;   // [TT]

  const int b = blockIdx.x;
  const int j0 = blockIdx.y * TJ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = lane & 7;   // row within a staging unit
  const int q = lane >> 3;  // float4 of samples within the stage
  const float* Nib = Ni + static_cast<size_t>(b) * n;

  float acc[J][BW + 1];
#pragma unroll
  for (int i = 0; i < J; ++i) {
#pragma unroll
    for (int d = 0; d <= BW; ++d) acc[i][d] = 0.0f;
  }

  // registers holding the next stage while the current one is computed
  float4 pre[PF];
  float npre = 0.0f;
  auto fetch = [&](int t0) {
    const int gc = t0 + 4 * q;
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int u = warp + NWARPS * k;
      const int r = 8 * u + p;
      const int gr = j0 + r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (u < RU && r < TJ + BW && gr < m) {
        const float* src = R + static_cast<size_t>(gr) * n + gc;
        if (vec && gc + 3 < n) {
          v = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          if (gc < n) v.x = __ldg(src);
          if (gc + 1 < n) v.y = __ldg(src + 1);
          if (gc + 2 < n) v.z = __ldg(src + 2);
          if (gc + 3 < n) v.w = __ldg(src + 3);
        }
      }
      pre[k] = v;
    }
    if (tid < TT) npre = (t0 + tid < n) ? __ldg(Nib + t0 + tid) : 0.0f;
  };

  fetch(0);
  for (int t0 = 0; t0 < n; t0 += TT) {
    __syncthreads();  // the previous stage is no longer read
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int u = warp + NWARPS * k;
      if (u < RU) {
        // samples 4q..4q+3 share the swizzle 2q
        float* dst = Rs + 4 * ((2 * u + (p >> 2)) ^ (2 * q)) + (p & 3);
        dst[(4 * q) * LD] = pre[k].x;
        dst[(4 * q + 1) * LD] = pre[k].y;
        dst[(4 * q + 2) * LD] = pre[k].z;
        dst[(4 * q + 3) * LD] = pre[k].w;
      }
    }
    if (tid < TT) Ns[tid] = npre;
    __syncthreads();
    if (t0 + TT < n) fetch(t0 + TT);

#pragma unroll
    for (int c = 0; c < TT; ++c) {
      const float* row = Rs + c * LD;
      const int sw = 2 * ((c >> 2) & 3);
      float w[4 * NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4 f = *reinterpret_cast<const float4*>(row + 4 * ((tid + v) ^ sw));
        w[4 * v] = f.x;
        w[4 * v + 1] = f.y;
        w[4 * v + 2] = f.z;
        w[4 * v + 3] = f.w;
      }
      const float ni = Ns[c];
#pragma unroll
      for (int i = 0; i < J; ++i) {
        const float base = w[i] * ni;
#pragma unroll
        for (int d = 0; d <= BW; ++d) acc[i][d] += w[i + d] * base;
      }
    }
  }

  float* ob = out + static_cast<size_t>(b) * (BW + 1) * m;
#pragma unroll
  for (int d = 0; d <= BW; ++d) {
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int j = j0 + J * tid + i;
      if (j < m) ob[static_cast<size_t>(d) * m + j] = (j + d < m) ? acc[i][d] : 0.0f;
    }
  }
}

template <int BW>
int launch(const float* R, const float* Ni, float* out, int m, int n, int B, int bw,
           cudaStream_t stream) {
  if (bw != BW) {
    if constexpr (BW < BWMAX) {
      return launch<BW + 1>(R, Ni, out, m, n, B, bw, stream);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  constexpr size_t smem = Geom<BW>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(banded_covariance_kernel<BW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(R) % 16 == 0);
  const dim3 grid(B, (m + TJ - 1) / TJ);
  banded_covariance_kernel<BW><<<grid, NTHREADS, smem, stream>>>(R, Ni, out, m, n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest band width the kernel accepts.
int banded_covariance_max_bw() { return BWMAX; }

// R [m, n], Ni [B, n], out [B, bw+1, m]: float32, contiguous, on the device.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
int banded_covariance_f32(const float* R, const float* Ni, float* out,
                          int m, int n, int B, int bw, void* stream) {
  if (bw < 0 || bw > BWMAX || m <= 0 || n <= 0 || B <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<0>(R, Ni, out, m, n, B, bw, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
