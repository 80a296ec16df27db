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
// [nfreq, nra, nprod] float32, ra_idx [S, nha] int32, a and b [S, nha]
// float32, u and v [nfreq, nprod] float32; F, W, Q [nfreq, S, nha] float32.
// Every array is contiguous; the wrapper checks types, shapes and the RA
// indices, and allocates the outputs.
//
// Design (simple and right first): one block per (s, f), eight warps; each
// warp takes every eighth HA row of the track, and its lanes stride the
// products, so the loads of a row of vis, sw and vw are coalesced in the
// product-contiguous layout.  The lane sums are combined by a shuffle tree in
// a fixed order: no atomics, and the sums are the same from run to run.  The
// distance is formed from two rounded products and a rounded sum (no fused
// multiply-add), as the plain torch version forms it, and reduced to
// d - rint(d) turns before sincospif: the phase then carries the rounding of
// d alone (|d| <= |u| + |v|), where float32 exp(-2 pi i d) of the unreduced d
// also loses 2 pi d's rounding (1.2e-4 rad at |2 pi d| ~ 2000).
//
// Bound on the H100 (3.35 TB/s; 132 SMs x 16 special-function results a
// clock): each (f, r) row that some source's window touches is needed once,
// 16 bytes a product (8 of vis, 4 each of sw and vw), against two
// special-function evaluations, a sine and a cosine, for every (f, s, h, p)
// term.  What the simple design leaves on the table: a row is read again by
// every source whose window covers it (85 HA samples of a 900 s track on a
// 4096-sample day: neighbouring sources share most of their windows), so it
// moves the terms' 16 bytes each, not the unique rows' bytes.  Sources sorted
// by RA could share a window tile staged in shared memory, each row loaded
// once for all the sources of the tile; that is a later redesign.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float inv_no_zero(float x) {
    return fabsf(x) < FLT_MIN ? 0.0f : 1.0f / x;
}

__device__ __forceinline__ float warp_sum(float x) {
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    return x;
}

template <bool NATURAL>
__global__ void __launch_bounds__(WARPS * 32) beamform_kernel(
    const float2* __restrict__ vis, const float* __restrict__ sw, const float* __restrict__ vw,
    const int* __restrict__ ra_idx, const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ u, const float* __restrict__ v,
    float* __restrict__ F, float* __restrict__ W, float* __restrict__ Q,
    int nra, int nprod, int S, int nha) {
    const int s = blockIdx.x;
    const int f = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float* uf = u + (size_t)f * nprod;
    const float* vf = v + (size_t)f * nprod;

    for (int h = warp; h < nha; h += WARPS) {
        const size_t sh = (size_t)s * nha + h;
        const int r = ra_idx[sh];
        const float ah = a[sh];
        const float bh = b[sh];
        const size_t row = ((size_t)f * nra + r) * nprod;
        float fs = 0.0f, ws = 0.0f, qs = 0.0f;
        for (int p = lane; p < nprod; p += 32) {
            const float d = __fadd_rn(__fmul_rn(uf[p], ah), __fmul_rn(vf[p], bh));
            const float t = d - rintf(d);
            float sn, cs;
            sincospif(2.0f * t, &sn, &cs);
            const float2 x = vis[row + p];
            const float w = sw[row + p];
            fs += w * (x.x * cs + x.y * sn);
            ws += w;
            if (NATURAL) qs += w * w * inv_no_zero(vw[row + p]);
        }
        fs = warp_sum(fs);
        ws = warp_sum(ws);
        if (NATURAL) qs = warp_sum(qs);
        if (lane == 0) {
            const size_t o = ((size_t)f * S + s) * nha + h;
            F[o] = fs;
            W[o] = ws;
            if (NATURAL) Q[o] = qs;
        }
    }
}

}  // namespace

extern "C" int beamform_f32(const void* vis, const void* sw, const void* vw, const void* ra_idx, const void* a,
                            const void* b, const void* u, const void* v, void* F, void* W, void* Q, int nfreq,
                            int nra, int nprod, int S, int nha, int natural, void* stream) {
    if (nfreq <= 0 || S <= 0 || nha <= 0) return 0;
    if (nfreq > 65535) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid(S, nfreq);
    const dim3 block(WARPS * 32);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float2* vis2 = static_cast<const float2*>(vis);
    if (natural) {
        beamform_kernel<true><<<grid, block, 0, st>>>(
            vis2, static_cast<const float*>(sw), static_cast<const float*>(vw), static_cast<const int*>(ra_idx),
            static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(u),
            static_cast<const float*>(v), static_cast<float*>(F), static_cast<float*>(W), static_cast<float*>(Q),
            nra, nprod, S, nha);
    } else {
        beamform_kernel<false><<<grid, block, 0, st>>>(
            vis2, static_cast<const float*>(sw), nullptr, static_cast<const int*>(ra_idx),
            static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(u),
            static_cast<const float*>(v), static_cast<float*>(F), static_cast<float*>(W), nullptr, nra, nprod, S,
            nha);
    }
    return (int)cudaGetLastError();
}
