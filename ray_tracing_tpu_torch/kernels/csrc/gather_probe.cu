// Table gather for NVIDIA Hopper (sm_90a): out[i] = table[idx[i]].
//
// Replaces the TPU kernel benchmarks/vmem_gather_probe.py::kernel (launched
// by `run`), a probe of how fast a lookup into a small table can go when the
// table sits in fast memory: on the TPU a 256 KB int32 table was kept whole
// in VMEM and 2M indices were gathered from it. The same question stands
// behind the sparse sky cache (ops/cubemap.py::sparse_sky_lookup): is a
// texel gather dear enough to be worth avoiding?
//
// What bounds it on this card: bytes. Each index is read once and each
// result written once (8 bytes per index, 16.8 MB at 2M indices), the table
// once (256 KB); there is no arithmetic. At 3.35 TB/s that is about 5 us.
//
// The TPU's design cannot be copied: a Hopper block gets at most 227 KB of
// shared memory, less than the table. This kernel is the simple one: one
// thread per index, coalesced index loads and result stores, the table read
// through the read-only data path (__ldg), where the 50 MB L2 keeps it
// resident after the first touch (and each SM's L1 the lines it reuses).
// An index outside the table stops the kernel (__trap), as PyTorch's own
// gathers assert on the device; the error surfaces at the next
// synchronisation.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gather_kernel(const int* __restrict__ table, const int* __restrict__ idx, int* __restrict__ out,
              long long n, int table_size) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const int k = idx[i];
    if ((unsigned)k >= (unsigned)table_size) __trap();
    out[i] = __ldg(table + k);
}

}  // namespace

// out[i] = table[idx[i]] for i < n. Returns the launch's cudaError_t.
extern "C" int rt_gather(const int* table, int table_size, const int* idx, int* out, long long n,
                         void* stream) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    gather_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(table, idx, out, n,
                                                                          table_size);
    return (int)cudaGetLastError();
}

// Text of a cudaError_t, for the wrapper's exception.
extern "C" const char* rt_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
