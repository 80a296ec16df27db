// Batched banded covariance for the sidereal regridder, for Hopper (sm_90a).
//
//   C[b, d, j] = sum_t R[j+d, t] * Ni[b, t] * R[j, t],   d = 0..bw
//
// i.e. every lower band diagonal of R diag(Ni_b) R^T.  Entries past the band
// end (j > m-1-d) are written as exact zeros; any bw >= 0 is taken (the
// diagonals d >= m are all zeros).  float32 and float64, each summed in its
// own type on the CUDA cores (no TF32).
//
// Replaces the TPU kernel draco_tpu/ops/pallas_kernels.py
// banded_covariance_pallas (body _kernel_factory).  The TPU carried the t
// sum across sequential grid steps in its output block; blocks on the H100
// run in parallel and in no order, so here the t loop runs inside the block
// and the sums stay in registers.  No atomics: t is summed in a fixed order
// inside one thread, so two launches give bitwise-equal output.
//
// The bound.  Summed densely over all n samples the work is
// 2*B*(bw+1)*m*n flops, about 7.5e11 at the regridder's shape (m=2098,
// n=8640, B=2080, bw=9).  The first port (one block per (b, 512-row tile),
// the band width a template over bw 0..31) did exactly that, reading its R
// values from shared memory and all of R once per b through L2 (~151 GB),
// and took 79.47 ms on an H100 against 17.36 ms for ten cuBLAS GEMMs.  But R
// is a Lanczos interpolation matrix: each row has about 2*a*n/m nonzeros in
// one run of samples, and only 0.26% of the dense (d, j, t) products are
// nonzero.  This design does about that share of the work:
//
// - Skip the zeros of R, for any R, exactly.  A product R[j+d,t] R[j,t] is
//   nonzero only where R[j,t] is, so a tile of TJ rows needs only the samples
//   between the first and the last nonzero column of its own rows.  The
//   wrapper computes those windows on the device (one pass over R, sentinel
//   (n, -1) for an empty row, so the pad rows widen nothing) and passes them
//   as int32 [tiles, 2].  Skipped terms are exact zeros, so on finite inputs
//   the sums are the dense ones in another order.  (A non-finite Ni at a
//   skipped sample would give NaN in the dense sum and not here; regridder
//   weights are finite inverse variances.)  Nothing assumes sorted samples:
//   an R with scattered nonzeros gets a full-width window and is merely as
//   slow as a dense kernel.  At TJ = 16 the smoke's windows hold 1.2% of
//   the dense work.
// - Share each staged R tile across a group of BB weight rows.  A block owns
//   (a group of BB rows b, a tile of TJ rows j, a chunk of D diagonals) and
//   stages R[j0+d0 .. j0+d0+TJ+D-2, window] and Ni[group, window] in shared
//   memory, transposed so that a thread's rows are contiguous, with cp.async
//   double buffering.  Each thread keeps a register tile of J rows x D
//   diagonals x GB batch rows: per sample it loads J+D-1 values of R, J base
//   values and GB weights as 16-byte vectors, forms the J*D products
//   R[j+d,t] R[j,t] once, and feeds each to GB multiply-adds.  R then passes
//   L2 once per group rather than once per b.
// - The band width is a runtime argument: the diagonals go in chunks of D
//   (grid z), so D = 10 covers the regridder's bw = 9 in one chunk and only
//   two kernels (float, double) are compiled.  A chunk with d0 > 0 also
//   stages the TJ base rows R[j0 .. j0+TJ-1].
//
// Predicted before the first run: ~1.5e10 useful flops at TJ = 32, under
// 1 ms at the 67 TFLOP/s float32 peak, plus 175 MB of output (0.05 ms at
// 3.35 TB/s), bound by the multiply-adds.  Measured at the smoke shape on
// an H100 80GB HBM3 at 700 W (TJ = 16): 0.62 ms in float32 and 0.63 ms in
// float64, against 17.4 and 14.7 ms for the plain version; the same kernel
// over full-width windows takes 29.2 ms, so sharing R gives 2.7x over the
// first port and skipping the zeros 47x on top.  The multiply-adds run at
// about a fifth of the float32 peak: with the per-sample work cut out, the
// staging and the output write alone take 0.41 ms, and with the write cut
// out 0.47 ms.  What bounds it is per-block latency (a block's first stage
// is exposed, and 226 registers leave two blocks per SM) and the 175 MB
// output, more than arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int TJ = 16;  // rows j per block (both types)
constexpr int D = 10;   // diagonals per chunk

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int J = 4;    // rows per thread
  static constexpr int GB = 4;   // batch rows per thread
  static constexpr int BB = 128;  // batch rows per block: 4 x 32 = 128 threads
  static constexpr int TT = 32;  // samples per stage
};
template <>
struct Cfg<double> {
  static constexpr int J = 2;
  static constexpr int GB = 4;
  static constexpr int BB = 64;   // 8 x 16 = 128 threads
  static constexpr int TT = 16;
};

constexpr int round_up(int x, int k) { return (x + k - 1) / k * k; }

template <typename T>
struct Geom {
  using C = Cfg<T>;
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  static constexpr int NTX = TJ / C::J;       // threads along j
  static constexpr int NTY = C::BB / C::GB;   // threads along b
  static constexpr int NTHREADS = NTX * NTY;
  static constexpr int NWARPS = NTHREADS / 32;
  static constexpr int ROWS = TJ + D - 1;                  // shifted rows staged
  static constexpr int NW = (C::J + D - 1 + VEC - 1) / VEC;  // vector loads of them
  // Pitches in elements: every row a thread reads (vector over-read
  // included), rounded to 32 and then VEC past it, so that a warp's staging
  // writes (8 samples x 4 rows) fall in 32 distinct banks and every vector
  // read stays aligned.
  static constexpr int LDS = round_up(TJ - C::J + NW * VEC > ROWS ? TJ - C::J + NW * VEC : ROWS, 32) + VEC;
  static constexpr int LDB = round_up(TJ, 32) + VEC;
  static constexpr int LDN = round_up(C::BB, 32) + VEC;
  static constexpr int STAGE = C::TT * (LDS + LDB + LDN);  // elements per buffer
  static constexpr size_t SMEM = 2 * static_cast<size_t>(STAGE) * sizeof(T);
  static_assert(TJ % C::J == 0 && C::BB % C::GB == 0 && NTHREADS % 32 == 0, "tile shape");
  static_assert(C::J % VEC == 0 && C::GB % VEC == 0 && C::TT % 8 == 0, "vector shape");
};

// NV 16-byte loads from 16-byte-aligned shared memory into registers.
template <int NV>
__device__ __forceinline__ void load_vecs(float* dst, const float* src) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float4 x = reinterpret_cast<const float4*>(src)[v];
    dst[4 * v] = x.x;
    dst[4 * v + 1] = x.y;
    dst[4 * v + 2] = x.z;
    dst[4 * v + 3] = x.w;
  }
}
template <int NV>
__device__ __forceinline__ void load_vecs(double* dst, const double* src) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const double2 x = reinterpret_cast<const double2*>(src)[v];
    dst[2 * v] = x.x;
    dst[2 * v + 1] = x.y;
  }
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }

// One element global -> shared, asynchronously; zero-filled where !valid.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? static_cast<int>(sizeof(T)) : 0;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + NROWS) x samples [t0, t0 + TT) of src (row pitch
// ``pitch``) into dst[t * LD + r], transposed.  Rows >= rlim and samples >=
// tlim are zero-filled.  One warp instruction moves 4 rows x 8 samples: 32 B
// runs of each row from global memory, 32 distinct banks in shared memory.
template <typename T, int NROWS, int TT, int LD, int NWARPS>
__device__ __forceinline__ void stage(T* dst, const T* src, size_t pitch, int r0, int rlim,
                                      int t0, int tlim, int warp, int lane) {
  constexpr int TU = TT / 8;
  constexpr int UNITS = (NROWS + 3) / 4 * TU;
  const int tl = lane & 7;
  const int rl = lane >> 3;
#pragma unroll
  for (int u0 = 0; u0 < UNITS; u0 += NWARPS) {
    const int u = u0 + warp;
    const int r = 4 * (u / TU) + rl;
    const int t = 8 * (u % TU) + tl;
    if (u < UNITS && r < NROWS) {
      const int gr = r0 + r;
      const int gt = t0 + t;
      const bool ok = gr < rlim && gt < tlim;
      cp_async(dst + t * LD + r, ok ? src + static_cast<size_t>(gr) * pitch + gt : src, ok);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Geom<T>::NTHREADS, 2)
banded_covariance_kernel(const T* __restrict__ R, const T* __restrict__ Ni,
                         const int* __restrict__ windows, T* __restrict__ out,
                         int m, int n, int B, int bw) {
  using C = Cfg<T>;
  using G = Geom<T>;
  constexpr int J = C::J;
  constexpr int GB = C::GB;
  constexpr int TT = C::TT;
  constexpr int VEC = G::VEC;
  constexpr int NW = G::NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int b0 = blockIdx.x * C::BB;
  const int tile = blockIdx.y;
  const int j0 = tile * TJ;
  const int d0 = blockIdx.z * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % G::NTX;
  const int ty = tid / G::NTX;

  // the tile's window, its start rounded down to 8 samples (32 B runs);
  // the samples added are zeros of every row of the tile
  const int hi = windows[2 * tile + 1];
  const int lo = windows[2 * tile] & ~7;
  const int nst = (hi > lo && d0 < m) ? (hi - lo + TT - 1) / TT : 0;

  T acc[GB][J][D];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int i = 0; i < J; ++i)
#pragma unroll
      for (int dd = 0; dd < D; ++dd) acc[g][i][dd] = T(0);

  auto fetch = [&](int s) {
    T* st = smem + (s & 1) * G::STAGE;
    const int t0 = lo + s * TT;
    stage<T, G::ROWS, TT, G::LDS, G::NWARPS>(st, R, n, j0 + d0, m, t0, hi, warp, lane);
    if (d0 > 0) {
      stage<T, TJ, TT, G::LDB, G::NWARPS>(st + TT * G::LDS, R, n, j0, m, t0, hi, warp, lane);
    }
    stage<T, C::BB, TT, G::LDN, G::NWARPS>(st + TT * (G::LDS + G::LDB), Ni, n, b0, B, t0, hi,
                                           warp, lane);
    cp_async_commit();
  };

  if (nst > 0) fetch(0);
  for (int s = 0; s < nst; ++s) {
    if (s + 1 < nst) {
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage s has landed for every thread

    const T* st = smem + (s & 1) * G::STAGE;
    const T* rs = st + J * tx;  // shifted rows j+d0+(0..J+D-2)
    const T* rb = (d0 > 0 ? st + TT * G::LDS : st) + J * tx;  // base rows j+(0..J-1)
    const int ldb = d0 > 0 ? G::LDB : G::LDS;
    const T* ns = st + TT * (G::LDS + G::LDB) + GB * ty;
#pragma unroll 1
    for (int c = 0; c < TT; ++c) {
      T w[NW * VEC];
      T base[J];
      T ni[GB];
      load_vecs<NW>(w, rs + c * G::LDS);
      load_vecs<J / VEC>(base, rb + c * ldb);
      load_vecs<GB / VEC>(ni, ns + c * G::LDN);
#pragma unroll
      for (int i = 0; i < J; ++i) {
#pragma unroll
        for (int dd = 0; dd < D; ++dd) {
          const T p = mul(w[i + dd], base[i]);
#pragma unroll
          for (int g = 0; g < GB; ++g) acc[g][i][dd] = fmadd(p, ni[g], acc[g][i][dd]);
        }
      }
    }
    __syncthreads();  // stage s is no longer read: its buffer takes stage s+2
  }

#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const int b = b0 + GB * ty + g;
    if (b >= B) continue;
    T* ob = out + static_cast<size_t>(b) * (bw + 1) * m;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      const int d = d0 + dd;
      if (d > bw) continue;
#pragma unroll
      for (int i = 0; i < J; ++i) {
        const int j = j0 + J * tx + i;
        if (j < m) ob[static_cast<size_t>(d) * m + j] = (j + d < m) ? acc[g][i][dd] : T(0);
      }
    }
  }
}

template <typename T>
int launch(const T* R, const T* Ni, const int* windows, T* out, int m, int n, int B, int bw,
           void* stream) {
  if (bw < 0 || m <= 0 || n <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  using G = Geom<T>;
  const long long groups = (static_cast<long long>(B) + Cfg<T>::BB - 1) / Cfg<T>::BB;
  const long long tiles = (static_cast<long long>(m) + TJ - 1) / TJ;
  const long long chunks = static_cast<long long>(bw) / D + 1;
  if (tiles > 65535 || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      banded_covariance_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(tiles),
                  static_cast<unsigned>(chunks));
  banded_covariance_kernel<T><<<grid, G::NTHREADS, G::SMEM, static_cast<cudaStream_t>(stream)>>>(
      R, Ni, windows, out, m, n, B, bw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows of R per tile: ``windows`` holds one [lo, hi) sample window per tile.
int banded_covariance_tile_rows() { return TJ; }

// R [m, n], Ni [B, n], windows int32 [ceil(m / TJ), 2], out [B, bw+1, m]:
// contiguous, on the device.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success).
int banded_covariance_f32(const float* R, const float* Ni, const int* windows, float* out,
                          int m, int n, int B, int bw, void* stream) {
  return launch<float>(R, Ni, windows, out, m, n, B, bw, stream);
}

int banded_covariance_f64(const double* R, const double* Ni, const int* windows, double* out,
                          int m, int n, int B, int bw, void* stream) {
  return launch<double>(R, Ni, windows, out, m, n, B, bw, stream);
}

}  // extern "C"
