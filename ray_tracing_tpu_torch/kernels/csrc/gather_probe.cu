// Table gather for NVIDIA Hopper (sm_90a): out[i] = table[idx[i]].
//
// Replaces the TPU kernel benchmarks/vmem_gather_probe.py::kernel (launched
// by `run`), a probe of how fast a lookup into a small table can go when the
// table sits in fast memory: on the TPU a 256 KB int32 table was kept whole
// in VMEM and 2M indices were gathered from it. The same question stands
// behind the JAX package's sparse sky lookup: is a texel gather dear enough
// to be worth avoiding?
//
// What bounds it on this card: bytes. Each index is read once and each
// result written once (8 bytes per index, 16.8 MB at 2M indices), the table
// once (256 KB); there is no arithmetic. At 3.35 TB/s that is about 5 us.
//
// The TPU's design does not carry over whole: a block gets at most 227 KB
// of shared memory, less than the probe's table. Read through L1 and L2,
// each of a warp's 32 random reads touches a line of its own, and 2M of them
// took 16.5 us on an H100 whatever the loads in flight (PERF.md, section 6).
// So a table of at most 2 * STAGED entries that at least as many indices
// read as it has entries has its first STAGED entries (224 KB, 7/8 of the
// probe's table) copied into the shared memory of one block per SM
// (gather_staged_kernel), where a warp's reads cost a few bank cycles; the
// rest, and any larger table (the sky's 100 MB cubemap: gather_kernel),
// is read through the read-only path with the evict-last hint, so that its
// lines stay in L1 ahead of the indices, which are loaded without L1
// allocation. gather_kernel asks for no shared memory and prefers L1. Each
// index costs an index load and then a dependent table load, so in both
// kernels every thread takes UNROLL 16-byte vectors of VEC indices at once,
// issues all their table loads before any store and writes 16-byte vectors
// (__stcs). The grids are sized to the card, each block looping over tiles:
// BLOCKS_PER_SM blocks of THREADS on every SM, or one block of
// STAGED_THREADS. What was tried and lost (a cluster's distributed shared
// memory, the staging multicast by the Tensor Memory Accelerator) is in
// PERF.md.
//
// Ragged inputs stay in these kernels: the indices before idx reaches a
// 16-byte boundary (a view with a storage offset) and the last (n - head)
// mod VEC are gathered one per thread. out must have idx's offset from a
// 16-byte boundary, so that both reach one after the same head (the wrapper
// allocates it so).
//
// An index outside the table stops the kernel (__trap), as PyTorch's own
// gathers assert on the device; the error surfaces at the next
// synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;            // int32 indices in a 16-byte vector
constexpr int UNROLL = 2;         // vectors per thread and pass
constexpr int BLOCKS_PER_SM = 8;  // 2,048 threads: a whole SM
constexpr int MAX_DEVICES = 64;
// The table's first STAGED entries (224 KB) in the shared memory of one
// block of STAGED_THREADS per SM.
constexpr int STAGED = 56 * 1024;
constexpr int STAGED_THREADS = 1024;

__device__ __forceinline__ void check(int k, int table_size) {
    if ((unsigned)k >= (unsigned)table_size) __trap();
}

// 16 bytes of indices, read once: not kept in L1, where they would push
// table lines out.
__device__ __forceinline__ int4 load_once(const int4* p) {
#ifdef __CUDA_ARCH__
    int4 v;
    asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
#else
    return *p;
#endif
}

// A table entry, kept in L1 ahead of other lines.
__device__ __forceinline__ int load_kept(const int* p) {
#ifdef __CUDA_ARCH__
    int v;
    asm("ld.global.nc.L1::evict_last.s32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
#else
    return *p;
#endif
}

// out[i] = fetch(idx[i]) over the indices this block takes: the `head`
// indices before idx + head and out + head, which lie on a 16-byte
// boundary, then UNROLL 16-byte vectors per thread and pass, all their
// table loads issued before any store, then the last (n - head) mod VEC.
template <int BLOCK, class Fetch>
__device__ __forceinline__ void gather_tiles(const int* __restrict__ idx, int* __restrict__ out,
                                             long long n, int head, Fetch fetch) {
    const long long tid = (long long)blockIdx.x * BLOCK + threadIdx.x;
    const long long threads = (long long)gridDim.x * BLOCK;
    if (tid < head) out[tid] = fetch(idx[tid]);
    const long long nv = (n - head) / VEC;
    const int4* iv = reinterpret_cast<const int4*>(idx + head);
    int4* ov = reinterpret_cast<int4*>(out + head);
    for (long long base = (long long)blockIdx.x * BLOCK * UNROLL; base < nv;
         base += threads * UNROLL) {
        int4 k[UNROLL], v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long j = base + u * BLOCK + threadIdx.x;
            k[u] = j < nv ? load_once(iv + j) : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long j = base + u * BLOCK + threadIdx.x;
            if (j < nv) {
                v[u] = make_int4(fetch(k[u].x), fetch(k[u].y), fetch(k[u].z), fetch(k[u].w));
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long j = base + u * BLOCK + threadIdx.x;
            if (j < nv) __stcs(ov + j, v[u]);
        }
    }
    const long long rest = head + nv * VEC;  // fewer than VEC indices follow
    if (tid < n - rest) out[rest + tid] = fetch(idx[rest + tid]);
}

// The table read from device memory through L1 and L2.
__global__ void __launch_bounds__(THREADS)
gather_kernel(const int* __restrict__ table, const int* __restrict__ idx, int* __restrict__ out,
              long long n, int table_size, int head) {
    gather_tiles<THREADS>(idx, out, n, head, [&](int k) {
        check(k, table_size);
        return load_kept(table + k);
    });
}

// The table's first `staged` entries copied into shared memory, 16 bytes
// a thread where the table is 16-byte aligned, the rest read through L1 and
// L2.
__global__ void __launch_bounds__(STAGED_THREADS, 1)
gather_staged_kernel(const int* __restrict__ table, const int* __restrict__ idx,
                     int* __restrict__ out, long long n, int table_size, int head, int staged) {
    extern __shared__ int4 s_staged[];
    const int* s_table = reinterpret_cast<const int*>(s_staged);
    int i = threadIdx.x;
    if (((uintptr_t)table & 15u) == 0) {
        for (; i < staged / VEC; i += STAGED_THREADS) {
            s_staged[i] = __ldg(reinterpret_cast<const int4*>(table) + i);
        }
        i = staged / VEC * VEC + threadIdx.x;
    }
    for (; i < staged; i += STAGED_THREADS) reinterpret_cast<int*>(s_staged)[i] = __ldg(table + i);
    __syncthreads();
    gather_tiles<STAGED_THREADS>(idx, out, n, head, [&](int k) {
        check(k, table_size);
        return k < staged ? s_table[k] : load_kept(table + k);
    });
}

// The SMs of each device, read once, and the kernels' shared memory set
// once per device: none for gather_kernel, which prefers L1; the staged
// entries for gather_staged_kernel.
int sms_of(int device, cudaError_t* err) {
    static int sms[MAX_DEVICES];
    if (device < 0 || device >= MAX_DEVICES) {
        *err = cudaErrorInvalidDevice;
        return 0;
    }
    if (sms[device] == 0) {
        int count = 0;
        *err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
        if (*err != cudaSuccess) return 0;
        *err = cudaFuncSetAttribute(gather_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    0);
        if (*err != cudaSuccess) return 0;
        *err = cudaFuncSetAttribute(gather_staged_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    STAGED * (int)sizeof(int));
        if (*err != cudaSuccess) return 0;
        sms[device] = count;
    }
    return sms[device];
}

}  // namespace

// out[i] = table[idx[i]] for i < n; out at idx's offset from a 16-byte
// boundary (else cudaErrorInvalidValue). A table of at most 2 * STAGED
// entries that at least as many indices read as it has entries (each entry
// read once or more on average) has its first STAGED entries staged in
// shared memory (gather_staged_kernel); any other is read through L1 and L2
// (gather_kernel). Returns the launch's cudaError_t (0 with nothing
// launched for n = 0).
extern "C" int rt_gather(const int* table, int table_size, const int* idx, int* out, long long n,
                         void* stream) {
    if (n <= 0) return 0;
    int device;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    const int sms = sms_of(device, &err);
    if (err != cudaSuccess) return (int)err;
    const uintptr_t phase = (uintptr_t)idx & 15u;
    if (phase != ((uintptr_t)out & 15u)) return (int)cudaErrorInvalidValue;
    const long long h = (long long)((16u - phase) & 15u) / 4;
    const int head = (int)(h < n ? h : n);
    const long long vectors = (n - head) / VEC;
    if (table_size <= 2 * STAGED && n >= table_size) {
        const int staged = table_size < STAGED ? table_size : STAGED;
        const long long per_pass = (long long)STAGED_THREADS * UNROLL;
        long long blocks = (vectors + per_pass - 1) / per_pass;
        if (blocks > sms) blocks = sms;
        if (blocks < 1) blocks = 1;
        gather_staged_kernel<<<(unsigned)blocks, STAGED_THREADS, staged * sizeof(int),
                               (cudaStream_t)stream>>>(table, idx, out, n, table_size, head,
                                                       staged);
        return (int)cudaGetLastError();
    }
    const long long per_pass = (long long)THREADS * UNROLL;
    long long blocks = (vectors + per_pass - 1) / per_pass;
    if (blocks > (long long)sms * BLOCKS_PER_SM) blocks = (long long)sms * BLOCKS_PER_SM;
    if (blocks < 1) blocks = 1;
    gather_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(table, idx, out, n,
                                                                          table_size, head);
    return (int)cudaGetLastError();
}

// Text of a cudaError_t, for the wrapper's exception.
extern "C" const char* rt_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
