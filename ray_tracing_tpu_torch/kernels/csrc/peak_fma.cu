// FP32 fused multiply-add peak of the card, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tracing_tpu/utils/flops.py::_peak_kernel
// (launched by measured_vpu_peak). What it computes, per element i of `a`:
// eight chains x_k = a[i] + 0.01*k, each iterated x <- x*x + a[i] `iters`
// times, and out[i] = the chains' sum (x_0 + x_1) + x_2 + ... + x_7. The
// recurrence is quadratic in the carry and reads a per-element input, so the
// compiler can neither fold the loop nor reduce it to a closed form, and the
// stored sum depends on every chain.
//
// What bounds it: operations, by design. Each thread reads 4 bytes and
// writes 4 and does 2 * 8 * iters float operations; at the sizes the peak
// measurement uses (a (4096, 128) input, iters >= 16384) that is 2^17 float
// operations per byte, so the time is that of the FMA pipes and the result,
// divided into 2 * 8 * n * iters, is the FP32 rate the card reaches.
//
// What the design does about it:
//   * one thread per element, eight independent chains in registers: a
//     warp scheduler always has an FMA whose operands are ready (the FMA
//     latency is 4 cycles; 8 chains times the resident warps hide it);
//   * the 64-step body is unrolled, so the loop's counter, compare and
//     branch are 3 instructions per 512 FMAs;
//   * __fmaf_rn: the port's libraries are built with --fmad=false (the
//     megakernels must round a*b+c twice, as PyTorch does), which would turn
//     x*x + a into FMUL + FADD and halve the measured rate. The intrinsic is
//     one FFMA whatever that flag says (chip_smoke.py counts the FFMA
//     instructions in the library's SASS). Its result rounds once, so it
//     differs from the plain PyTorch recurrence (kernels/peak.py), which
//     rounds the product first, in the last bits.
//
// For a[i] a little above 0.25 the chains run off to +inf after enough
// iterations (the TPU kernel's too); an FFMA on inf costs what any other
// FFMA costs, so the timing is unaffected.

#include <cuda_runtime.h>

namespace {

constexpr int CHAINS = 8;
constexpr int UNROLL = 64;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
peak_fma_kernel(const float* __restrict__ a, float* __restrict__ out, int n, int trips) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const float av = a[i];
    float x[CHAINS];
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) x[k] = av + (float)(0.01 * k);
    for (int t = 0; t < trips; ++t) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
            for (int k = 0; k < CHAINS; ++k) x[k] = __fmaf_rn(x[k], x[k], av);
        }
    }
    float s = x[0];
#pragma unroll
    for (int k = 1; k < CHAINS; ++k) s = s + x[k];
    out[i] = s;
}

}  // namespace

// out[i] for i < n after `iters` steps; iters must be a multiple of 64 (the
// wrapper checks it). Returns the launch's cudaError_t.
extern "C" int rt_peak_fma(const float* a, float* out, int n, int iters, void* stream) {
    const int blocks = (n + THREADS - 1) / THREADS;
    peak_fma_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a, out, n, iters / UNROLL);
    return (int)cudaGetLastError();
}

// Text of a cudaError_t, for the wrapper's exception.
extern "C" const char* rt_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
