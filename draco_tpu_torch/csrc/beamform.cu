// Source beamforming: the fringestopped, weighted sum over products of a
// drift-scan visibility stream along each source's hour-angle track.
//
// Replaces the three XLA programs of the JAX package that form beams,
// draco_tpu/ops/interferometry.py::_beamform_sources_jit (:161),
// ::_beamform_sources_ha_jit (:241) and ::_beamform_kernel_jit (:80), which
// in turn replaced the Cython ``beamform`` of the reference
// (draco/util/_fast_tools.pyx:211).  Those programs gather every source's RA
// window into a [freq, source, HA, product] complex phase tensor; this kernel
// makes nothing of that size.
//
// For one polarisation's stacks, with r = ra_idx[s, h] and the distance
// d = u[f, p] a[s, h] + v[f, p] b[s, h] in turns
// (a = cos(dec) sin(H), b = cos(lat) sin(dec) - sin(lat) cos(dec) cos(H)),
// it writes for every (f, s, h)
//   F = sum_p sw[f, r, p] (Re vis[f, r, p] cos(2 pi d) + Im vis[f, r, p] sin(2 pi d)),
//   W = sum_p sw[f, r, p],
//   Q = sum_p sw[f, r, p]^2 invert_no_zero(vw[f, r, p])   (natural weights only).
// The primary-beam weighting, the HA collapse and the normalisation act on
// these [f, s, h] arrays in torch, as the JAX programs write them.
//
// Layout: vis [nfreq, nra, nprod] complex64 (interleaved float2), sw and vw
// [nfreq, nra, nprod] float32, a and b [S * nha] float32, u and v [nfreq,
// nprod] float32; F, W, Q [nfreq, S * nha] float32.  The work comes as a row
// plan that the wrapper builds on the device (ops/cuda_kernels.py::
// beamform_plan): the (s, h) pairs j = s * nha + h stably sorted by their RA
// row, cut into work items of at most max_pairs pairs of one row (item_row,
// item_start into the sorted pairs, item_count).  Every array is contiguous;
// the wrapper checks types, shapes and the RA indices, and allocates the
// outputs.
//
// Bound on the H100 (3.35 TB/s; 132 SMs x 16 special-function results a
// clock): each (f, r) row that some window touches is needed once, 16 bytes
// a product (8 of vis, 4 each of sw and vw), against a sine and a cosine for
// every (f, s, h, p) term.  A whole catalogue (8192 sources x 85 HA x 16
// channels x 1789 products) is bound by those operations, ~17x over its
// bytes; a batch of 32 sources (~2000 rows for 2720 pairs) by its bytes.
//
// Design: one block per (work item, channel), eight warps, at most four
// blocks an SM (64 registers a thread).  The block stages its row in shared
// memory once, for every pair of the item: cp.async puts u, v and vis of
// each product in place as (u, v, Re, Im) and sw (and vw) beside them, all
// the tile's copies in flight at once; each thread then folds sw into its
// own products' vis (x = sw vis) and sums the row's W and Q, which depend
// on the row alone.  A tile holds at most TILE products; a longer row
// streams through it.  The warps split the item's pairs in contiguous runs;
// a warp takes up to GROUP pairs at once, its lanes striding the products,
// so one 16-byte read of shared memory serves GROUP terms (splitting a
// pair's products among idle warps, where a row has fewer pairs than warps,
// gained 2% at a batch of 32 and lost 10% at 512 sources: not kept).  A
// term is d, its reduction to turns (two adds: rintf is a
// conversion, and beside the sine and cosine it held the kernel at 1.8x
// its bound), the hardware sine and cosine of 2 pi times that, and two
// FMAs.  A fixed shuffle tree reduces the lane sums, a warp adds them to its
// pairs' partials in shared memory tile by tile, and the block writes each
// pair's F, W and Q: one writer an output and a fixed order of sums, no
// atomics, so a rerun gives the same bits.  Loads overlap computation
// across the blocks resident on an SM, not by a ring inside the block.
//
// The distance is formed from two rounded products and a rounded sum (no
// fused multiply-add), as the plain torch version forms it, and reduced to
// turns first: the phase then carries the rounding of d alone (|d| <= |u| +
// |v|, ~2e-4 rad at |d| ~ 300 turns), beside which the hardware
// approximations' ~5e-7 on [-pi, pi] are small.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 2048;  // products staged in shared memory at a time
constexpr int GROUP = 4;    // pairs a warp sums in one pass over the tile
constexpr float TWO_PI = 6.283185307179586f;

struct __align__(16) Prod {
    float u, v, xr, xi;
};

__device__ __forceinline__ float inv_no_zero(float x) {
    return fabsf(x) < FLT_MIN ? 0.0f : 1.0f / x;
}

__device__ __forceinline__ float warp_sum(float x) {
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    return x;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if (bytes == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d - rint(d), exactly, for |d| < 2^23 turns: adding and taking away 2^23 of
// d's sign rounds d to the nearest integer (ties to even) in two full-rate
// adds, where rintf is a conversion.  Past 2^23 a float32 d is an integer,
// and this gives a whole number of turns.
__device__ __forceinline__ float turns(float d) {
    const float m = copysignf(8388608.0f, d);
    return __fsub_rn(d, __fsub_rn(__fadd_rn(d, m), m));
}

// F partials of the G pairs pairs[k..k+G) over the tile's np products, added
// by lane 0 to part[k..k+G).
template <int G>
__device__ __forceinline__ void sum_pairs(const Prod* __restrict__ tile, int np, int lane,
                                          const int* __restrict__ pairs, int k, const float* __restrict__ a,
                                          const float* __restrict__ b, float* part) {
    float aa[G], bb[G], acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
        const int idx = pairs[k + j];
        aa[j] = a[idx];
        bb[j] = b[idx];
        acc[j] = 0.0f;
    }
    for (int p = lane; p < np; p += 32) {
        const Prod q = tile[p];
#pragma unroll
        for (int j = 0; j < G; ++j) {
            const float d = __fadd_rn(__fmul_rn(q.u, aa[j]), __fmul_rn(q.v, bb[j]));
            float sn, cs;
            __sincosf(TWO_PI * turns(d), &sn, &cs);
            acc[j] = fmaf(q.xi, sn, fmaf(q.xr, cs, acc[j]));
        }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
        const float s = warp_sum(acc[j]);
        if (lane == 0) part[k + j] += s;
    }
}

template <bool NATURAL>
__global__ void __launch_bounds__(THREADS, 4) beamform_rows(
    const float2* __restrict__ vis, const float* __restrict__ sw, const float* __restrict__ vw,
    const int* __restrict__ pairs, const int* __restrict__ item_row, const int* __restrict__ item_start,
    const int* __restrict__ item_count, const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ u, const float* __restrict__ v, float* __restrict__ F, float* __restrict__ W,
    float* __restrict__ Q, int nra, int nprod, int npairs) {
    extern __shared__ float4 smem[];
    const int ntile = min(nprod, TILE);
    Prod* tile = reinterpret_cast<Prod*>(smem);
    float* sws = reinterpret_cast<float*>(tile + ntile);  // the tile's sw, then its vw
    float* vws = sws + ntile;
    float* part = vws + (NATURAL ? ntile : 0);
    __shared__ float red[2][WARPS];

    const int item = blockIdx.x;
    const int f = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int* my = pairs + item_start[item];
    const int n = item_count[item];
    // this warp's run of the item's pairs
    const int lo = n * warp / WARPS;
    const int hi = n * (warp + 1) / WARPS;
    const size_t row = ((size_t)f * nra + item_row[item]) * nprod;
    const float* uf = u + (size_t)f * nprod;
    const float* vf = v + (size_t)f * nprod;

    for (int k = threadIdx.x; k < n; k += THREADS) part[k] = 0.0f;
    float ws = 0.0f, qs = 0.0f;
    for (int p0 = 0; p0 < nprod; p0 += TILE) {
        const int np = min(TILE, nprod - p0);
        __syncthreads();  // the last tile is consumed (the first time: part is zeroed)
        // every load of the tile in flight at once: u, v and vis straight
        // into their places in the tile, sw and vw beside it
        for (int p = threadIdx.x; p < np; p += THREADS) {
            const size_t g = row + p0 + p;
            cp_async(&tile[p].u, uf + p0 + p, 4);
            cp_async(&tile[p].v, vf + p0 + p, 4);
            cp_async(&tile[p].xr, vis + g, 8);
            cp_async(sws + p, sw + g, 4);
            if (NATURAL) cp_async(vws + p, vw + g, 4);
        }
        cp_async_wait_all();
        // fold sw into vis: a thread its own copies, so no barrier before
        for (int p = threadIdx.x; p < np; p += THREADS) {
            const float w = sws[p];
            ws += w;
            if (NATURAL) qs += w * w * inv_no_zero(vws[p]);
            tile[p].xr *= w;
            tile[p].xi *= w;
        }
        __syncthreads();
        int k = lo;
        for (; k + GROUP <= hi; k += GROUP) sum_pairs<GROUP>(tile, np, lane, my, k, a, b, part);
        switch (hi - k) {
            case 3: sum_pairs<3>(tile, np, lane, my, k, a, b, part); break;
            case 2: sum_pairs<2>(tile, np, lane, my, k, a, b, part); break;
            case 1: sum_pairs<1>(tile, np, lane, my, k, a, b, part); break;
            default: break;
        }
    }

    // the row's W and Q: lane sums, then the warps' sums in warp order
    ws = warp_sum(ws);
    if (NATURAL) qs = warp_sum(qs);
    if (lane == 0) {
        red[0][warp] = ws;
        red[1][warp] = qs;
    }
    __syncthreads();  // also publishes every warp's part[] sums
    float wr = 0.0f, qr = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        wr += red[0][w];
        if (NATURAL) qr += red[1][w];
    }
    for (int k = threadIdx.x; k < n; k += THREADS) {
        const size_t o = (size_t)f * npairs + my[k];
        F[o] = part[k];
        W[o] = wr;
        if (NATURAL) Q[o] = qr;
    }
}

}  // namespace

extern "C" int beamform_rows_f32(const void* vis, const void* sw, const void* vw, const void* pairs,
                                 const void* item_row, const void* item_start, const void* item_count, const void* a,
                                 const void* b, const void* u, const void* v, void* F, void* W, void* Q, int nfreq,
                                 int nra, int nprod, int npairs, int nitems, int max_pairs, int natural,
                                 void* stream) {
    if (nfreq <= 0 || nitems <= 0) return 0;
    if (nfreq > 65535 || max_pairs <= 0 || nprod < 0) return (int)cudaErrorInvalidConfiguration;
    // the tile and its sw (and vw), then a partial sum for each of an item's pairs
    const size_t ntile = nprod < TILE ? nprod : TILE;
    const size_t smem = ntile * (sizeof(Prod) + (natural ? 2 : 1) * sizeof(float)) + (size_t)max_pairs * sizeof(float);
    void (*kernel)(const float2*, const float*, const float*, const int*, const int*, const int*, const int*,
                   const float*, const float*, const float*, const float*, float*, float*, float*, int, int, int) =
        natural ? &beamform_rows<true> : &beamform_rows<false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(nitems, nfreq), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(vis), static_cast<const float*>(sw), static_cast<const float*>(vw),
        static_cast<const int*>(pairs), static_cast<const int*>(item_row), static_cast<const int*>(item_start),
        static_cast<const int*>(item_count), static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(u), static_cast<const float*>(v), static_cast<float*>(F), static_cast<float*>(W),
        static_cast<float*>(Q), nra, nprod, npairs);
    return (int)cudaGetLastError();
}
