// Backward path-tracing megakernel for NVIDIA Hopper (sm_90a), "fetch".
//
// Replaces the TPU kernel ray_tracing_tpu/kernels/megakernel.py::
// _bwd_kernel_fetch (launched by _run_bwd, fetch arm).
//
// The kernel is rt_backward.cuh's bwd_kernel (what it computes, its two
// phases, its routing) with the winners of the trace calls read from the
// winner-index planes the recording forward stored (one int32 plane per
// trace call: which object each primary and each shadow ray hit, -1 for
// none). Nothing loops over the objects.
//
// What bounds it on this card: bytes. A pixel needs the three radiance
// cotangents when its path hits anything, the six sky cotangents when it
// leaves the scene (the tenth plane is never read), one primary index per
// bounce it is alive in and one shadow index per accepted sample; the kernel
// loads exactly these, so a path that leaves at once costs 28 bytes, not the
// 40 + 4*n_rec of its planes. It writes N*16+16 floats in all. Float work
// (replay plus adjoint, a few hundred operations per live bounce) is far
// below the card's rate. As it stands the kernel is limited by neither: by
// the divergence between paths of different lengths, the integer work of the
// generator, local-memory traffic of the saved states and contention on the
// atomics. It is a first version that is right.

#include "rt_device.cuh"
#include "rt_backward.cuh"

using namespace rt;

namespace {

// The winner of trace call `index` is the forward's index plane `index`.
struct FetchWinners {
    const int* rec;
    size_t plane, pix;

    __device__ FetchWinners(const int* r, size_t pl, size_t px) : rec(r), plane(pl), pix(px) {}

    __device__ __forceinline__ void begin_sweep() {}

    __device__ __forceinline__ int primary(const float*, const Params& p, int b, V3, V3) const {
        return rec[(size_t)(b * (1 + p.ns)) * plane + pix];
    }

    __device__ __forceinline__ int shadow(const float*, const Params& p, int b, int s, V3,
                                          V3) const {
        return rec[(size_t)(b * (1 + p.ns) + 1 + s) * plane + pix];
    }
};

}  // namespace

// Launches the fetch backward kernel on `stream`. scene: (n_objects,16)
// float32, cam: 16 float32, cot: (10,height,width) float32 cotangents, rec:
// (bounces*(1+ns),height,width) int32 winner indices, g_scene: (n_objects,16)
// and g_cam: 16 float32, both ZERO at launch (the kernel adds into them);
// primal: (10,height,width) float32 or null (non-null: the kernel also writes
// the planes its forward walk arrives at). All device pointers. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int rt_megakernel_bwd(const float* scene, const float* cam, const float* cot,
                                 const int* rec, float* g_scene, float* g_cam, float* primal,
                                 RT_PARAM_ARGS, void* stream) {
    RT_FILL_PARAMS(p);
    return launch_bwd<FetchWinners>(scene, cam, cot, rec, g_scene, g_cam, primal, p, stream);
}

// Text of a cudaError_t, for the wrapper's exception.
extern "C" const char* rt_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
