// Fringe x beam planes of one baseline chunk of the fused round trip, for
// Hopper (sm_90a).
//
// For each row i of the chunk, pixel k, frequency f and polarisation p:
//
//   t          = frac(b_row . n_k)                      (turns)
//   (cos, sin) = (cos 2 pi t, sin 2 pi t)
//   re[f, i, p, k] = br cos - bi sin,   im[f, i, p, k] = br sin + bi cos
//
// with br + i bi the beam product of the row's baseline at (f, p, k).  The
// phase comes from the three-float operands of both sides (b = ba + bb + bc,
// n = va + vb + vc, the 12-bit halves' products exact) as
// draco_tpu_torch/ops/tools.py::phase_frac3 forms it, and the cosine and
// sine as ops/tools.py::sincos_turns does (the nearest quarter turn, then
// short Taylor polynomials).  On a uniform frequency grid the coefficient
// rows hold the base phase (group 0) and the per-step phase (group 1), and
// the base phasor is rotated by the step phasor once a frequency, as
// draco_tpu_torch/ops/cuda_kernels.py::_fringe_trig does; otherwise group
// f holds frequency f's own phase.  Identical dishes share one real beam
// product (uniform_real); otherwise uidx[i] selects row i's complex product.
// With the geometry dedup of the full-sphere form, row i reads coefficient
// row row0 + lidx[i] (the plain chain evaluates each geometry once and
// gathers; evaluating it per product gives the same bits).
//
// Replaces no TPU kernel: the JAX package leaves this generator to XLA,
// which fuses it (draco_tpu/telescope/roundtrip.py::_fringe_trig and the
// beam product of its chunk bodies).  The port's plain version,
// ops/cuda_kernels.py::fringe_planes_plain, is ~115 element-wise kernels a chunk, each
// reading and writing a whole [nfreq, chunk, K] plane.
//
// The bound.  The kernel reads almost nothing (nine floats a pixel, nine or
// eighteen a row, the beam table) and writes 8 bytes a (f, i, p, k): a dish
// chunk of [8, 2008, 16768] is 2.15 GB, 0.64 ms at 3.35 TB/s; a CHIME chunk
// of [1, 64, 4, 802434] is 1.64 GB, 0.49 ms.  The arithmetic, ~90
// operations a phasor (two a row and pixel on a uniform grid, then six a
// rotation) and two or six a written pair, is a third of that time at the
// card's float32 rate.  So the design keeps the stores full-width and
// coalesced and reads every input from a cache:
//
// - a thread owns V adjacent pixels (V = 4, 2 or 1: the widest that divides
//   K and that the wrapper finds every pointer aligned to), a block 128
//   threads along k and ROWS rows; the pixel vectors are loaded once into
//   registers and serve the block's rows;
// - the row's coefficients and indices are read at addresses uniform over
//   the block, which the L1 serves as broadcasts (staging them in shared
//   memory would add a barrier and save no traffic);
// - frequencies and polarisations loop in registers; every (f, i, p) row is
//   a V-wide streaming store along k, so a warp writes 128 V contiguous
//   bytes;
// - the row blocks of one run of k are adjacent in launch order, so they run
//   together and the run of the beam table they read comes from memory once
//   and from L2 for the others (a CHIME chunk's table, 77 MB, outgrows L2);
// - padded pixels (zero vectors and zero beam) and padded rows run the same
//   arithmetic as the plain version and give its values.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 2b): a dish
// chunk 0.70-0.72 ms (1.09-1.12x its bound), a CHIME chunk 0.92-0.94 ms
// (1.9x: the complex beam's loads), and 1.25 ms with the runs of k
// innermost in launch order, when each row block fetched its run of the
// table from memory.  72-80 registers a thread at V = 4, 48-56 at V = 2, 32
// at V = 1; nothing spilled.
//
// Every multiply and add is a round-to-nearest intrinsic, which the
// compiler never contracts into a fused multiply-add, in the order of the
// plain version's tensor operations; rintf is torch.round (nearest, ties to
// even).  Its constants are the float32 values the plain version's Python
// scalars become on the card, and x / 362880 is x times the float32
// reciprocal, as PyTorch's CUDA division by a scalar computes it.  So the
// planes are bit-equal to the plain chain run on the card.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // pixel groups along k per block
constexpr int ROWS = 8;       // chunk rows per block

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// ops/tools.py::phase_frac3 for one (row, pixel): a, b, c the row's three
// parts by axis, va, vb, vc the pixel's
__device__ __forceinline__ float phase_frac3(const float (&a)[3], const float (&b)[3], const float (&c)[3],
                                             const float* va, const float* vb, const float* vc) {
  float y = 0.0f;
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    const float paa = mul(a[x], va[x]);
    const float pab = mul(a[x], vb[x]);
    const float pba = mul(b[x], va[x]);
    float r = add(sub(paa, rintf(paa)), sub(pab, rintf(pab)));
    r = add(r, sub(pba, rintf(pba)));
    const float small =
        add(add(mul(b[x], vb[x]), add(mul(a[x], vc[x]), mul(c[x], va[x]))), add(mul(b[x], vc[x]), mul(c[x], vb[x])));
    float rc = add(r, small);
    rc = sub(rc, rintf(rc));
    y = x == 0 ? rc : add(y, rc);
  }
  return sub(y, rintf(y));
}

// ops/tools.py::sincos_turns in float32
__device__ __forceinline__ void sincos_turns(float t, float& cos_v, float& sin_v) {
  constexpr float two_pi = static_cast<float>(2 * 3.141592653589793);
  constexpr float c2 = -0.5f;
  constexpr float c4 = static_cast<float>(1.0 / 24);
  constexpr float c6 = static_cast<float>(-1.0 / 720);
  constexpr float c8 = static_cast<float>(1.0 / 40320);
  constexpr float s3 = static_cast<float>(-1.0 / 6);
  constexpr float s5 = static_cast<float>(1.0 / 120);
  constexpr float s7 = static_cast<float>(-1.0 / 5040);
  constexpr float s9 = 1.0f / 362880.0f;
  const float q = rintf(mul(4.0f, t));
  const float x = mul(two_pi, sub(t, mul(0.25f, q)));
  const float x2 = mul(x, x);
  const float c = add(1.0f, mul(x2, add(c2, mul(x2, add(c4, mul(x2, add(c6, mul(x2, c8))))))));
  const float s = mul(x, add(1.0f, mul(x2, add(s3, mul(x2, add(s5, mul(x2, add(s7, mul(x2, s9)))))))));
  const float qm = sub(q, mul(4.0f, floorf(mul(q, 0.25f))));
  const bool odd = qm == 1.0f || qm == 3.0f;
  const bool neg_c = qm == 1.0f || qm == 2.0f;
  const bool neg_s = qm == 2.0f || qm == 3.0f;
  const float cv = odd ? s : c;
  const float sv = odd ? c : s;
  cos_v = neg_c ? -cv : cv;
  sin_v = neg_s ? -sv : sv;
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = t.x, r[1] = t.y, r[2] = t.z, r[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    r[0] = t.x, r[1] = t.y;
  } else {
    r[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&r)[V]) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(r[0], r[1], r[2], r[3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(r[0], r[1]));
  } else {
    __stcs(p, r[0]);
  }
}

// the coefficients of group g, row `row` of ba/bb/bc [G, nrow, 3], by axis
__device__ __forceinline__ void coeff(const float* ba, const float* bb, const float* bc, long long nrow, int g,
                                      long long row, float (&a)[3], float (&b)[3], float (&c)[3]) {
  const long long o = (g * nrow + row) * 3;
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    a[x] = __ldg(ba + o + x);
    b[x] = __ldg(bb + o + x);
    c[x] = __ldg(bc + o + x);
  }
}

// ba/bb/bc [G, nrow, 3]; va/vb/vc [K, 3]; u_re/u_im [nfreq, nuniq, npol, K];
// uidx, lidx [C] (lidx may be null, uidx is not read when UNIFORM_REAL);
// out_re/out_im [nfreq, C, npol, K].  A one-dimensional grid of
// ceil(C / ROWS) x ceil(K / (THREADS V)) blocks, the row blocks innermost.
template <int V, bool UNIFORM_FREQ, bool UNIFORM_REAL>
__global__ void __launch_bounds__(THREADS)
fringe_kernel(const float* __restrict__ ba, const float* __restrict__ bb, const float* __restrict__ bc,
              long long nrow, const float* __restrict__ va, const float* __restrict__ vb,
              const float* __restrict__ vc, const float* __restrict__ u_re, const float* __restrict__ u_im,
              const long long* __restrict__ uidx, const long long* __restrict__ lidx, long long row0,
              float* __restrict__ out_re, float* __restrict__ out_im, int nfreq, int C, int npol, int K,
              int nuniq) {
  // the row blocks of one run of k are adjacent in launch order, so they
  // run together and share that run of the beam table in L2
  const int nrowblk = (C + ROWS - 1) / ROWS;
  const int k0 = ((blockIdx.x / nrowblk) * THREADS + threadIdx.x) * V;
  if (k0 >= K) return;
  const int i0 = (blockIdx.x % nrowblk) * ROWS;
  const int i1 = min(i0 + ROWS, C);

  float pa[V][3], pb[V][3], pc[V][3];
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      pa[v][x] = __ldg(va + 3 * (k0 + v) + x);
      pb[v][x] = __ldg(vb + 3 * (k0 + v) + x);
      pc[v][x] = __ldg(vc + 3 * (k0 + v) + x);
    }
  }

  const size_t plane = static_cast<size_t>(K);
  for (int i = i0; i < i1; ++i) {
    const long long row = row0 + (lidx ? lidx[i] : i);
    const long long u = UNIFORM_REAL ? 0 : uidx[i];
    float a[3], b[3], c[3];
    float cf[V], sf[V], cd[V], sd[V];
    if constexpr (UNIFORM_FREQ) {
      coeff(ba, bb, bc, nrow, 0, row, a, b, c);
#pragma unroll
      for (int v = 0; v < V; ++v) sincos_turns(phase_frac3(a, b, c, pa[v], pb[v], pc[v]), cf[v], sf[v]);
      if (nfreq > 1) {
        coeff(ba, bb, bc, nrow, 1, row, a, b, c);
#pragma unroll
        for (int v = 0; v < V; ++v) sincos_turns(phase_frac3(a, b, c, pa[v], pb[v], pc[v]), cd[v], sd[v]);
      }
    }
    for (int f = 0; f < nfreq; ++f) {
      if constexpr (UNIFORM_FREQ) {
        if (f > 0) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float cn = sub(mul(cf[v], cd[v]), mul(sf[v], sd[v]));
            const float sn = add(mul(cf[v], sd[v]), mul(sf[v], cd[v]));
            cf[v] = cn;
            sf[v] = sn;
          }
        }
      } else {
        coeff(ba, bb, bc, nrow, f, row, a, b, c);
#pragma unroll
        for (int v = 0; v < V; ++v) sincos_turns(phase_frac3(a, b, c, pa[v], pb[v], pc[v]), cf[v], sf[v]);
      }
      const size_t obase = (static_cast<size_t>(f) * C + i) * npol;
      const size_t ubase = (static_cast<size_t>(f) * nuniq + u) * npol;
#pragma unroll 4
      for (int p = 0; p < npol; ++p) {
        const size_t o = (obase + p) * plane + k0;
        const size_t ub = (ubase + p) * plane + k0;
        float br[V], re[V], im[V];
        load<V>(u_re + ub, br);
        if constexpr (UNIFORM_REAL) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            re[v] = mul(br[v], cf[v]);
            im[v] = mul(br[v], sf[v]);
          }
        } else {
          float bi[V];
          load<V>(u_im + ub, bi);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            re[v] = sub(mul(br[v], cf[v]), mul(bi[v], sf[v]));
            im[v] = add(mul(br[v], sf[v]), mul(bi[v], cf[v]));
          }
        }
        store<V>(out_re + o, re);
        store<V>(out_im + o, im);
      }
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*, long long, const float*, const float*,
                        const float*, const float*, const float*, const long long*, const long long*, long long,
                        float*, float*, int, int, int, int, int);

template <int V>
Kernel pick(bool uniform_freq, bool uniform_real) {
  if (uniform_freq) return uniform_real ? &fringe_kernel<V, true, true> : &fringe_kernel<V, true, false>;
  return uniform_real ? &fringe_kernel<V, false, true> : &fringe_kernel<V, false, false>;
}

}  // namespace

extern "C" {

// ba/bb/bc [G, nrow, 3] (G = 2 on a uniform grid, else nfreq); va/vb/vc
// [K, 3]; u_re/u_im [nfreq, nuniq, npol, K]; uidx [C] int64 (not read when
// uniform_real); lidx [C] int64 or null; out_re/out_im [nfreq, C, npol, K]:
// float32, contiguous, on the device, the beam and output pointers aligned
// to 4 vec bytes and K a multiple of vec (1, 2 or 4).  Row i reads
// coefficient row row0 + lidx[i] (row0 + i without lidx), which must lie
// in [0, nrow), and beam product uidx[i] in [0, nuniq).  Launches on
// ``stream`` and returns cudaGetLastError() (0 on success).
int fringe_planes_f32(const float* ba, const float* bb, const float* bc, long long nrow, const float* va,
                      const float* vb, const float* vc, const float* u_re, const float* u_im, const long long* uidx,
                      const long long* lidx, long long row0, float* out_re, float* out_im, int nfreq, int C, int npol,
                      int K, int nuniq, int uniform_freq, int uniform_real, int vec, void* stream) {
  if (nfreq <= 0 || C <= 0 || npol <= 0 || K <= 0) return 0;
  if ((vec != 1 && vec != 2 && vec != 4) || K % vec) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>((K / vec + THREADS - 1) / THREADS) * ((C + ROWS - 1) / ROWS);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Kernel kernel = vec == 4   ? pick<4>(uniform_freq, uniform_real)
                        : vec == 2 ? pick<2>(uniform_freq, uniform_real)
                                   : pick<1>(uniform_freq, uniform_real);
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ba, bb, bc, nrow, va, vb, vc, u_re, u_im, uidx, lidx, row0, out_re, out_im, nfreq, C, npol, K, nuniq);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
