// K2 gather_sizes: out[i] = sizes[idx[i]], exact int32 values.  Replaces the
// TPU kernel gather_bytes_pallas (_gather_bytes_kernel) of
// biograph_tpu/ops/rank4.py.
//
// What it reads and writes, an index: the 8-byte index, read once; one
// 4-byte size at a random place of the table; the 4-byte result, written
// once.  Its bound: those 16 bytes over the device-memory rate (3.35 TB/s on
// an H100 SXM), 4.6 us at 960 000 indices.  What holds it there: a size read
// at a random place moves a whole 32-byte sector from L2 (a seqset's size
// table, 4 bytes an entry, sits in L2 at the sizes the port serves), so
// random indices cost eight times the bytes the bound counts, and sorted
// ones a little over half the time of random ones.  The caller clamps idx into
// [0, n); an index outside it is the caller's error and fails a device-side
// assert, as PyTorch's own indexing kernels do.
//
// What the design does about it: a thread takes four consecutive indices
// with two 16-byte loads on the read-only path without L1 allocation (the
// indices are read once), tests all four against n with one branch, starts
// its four size reads before it uses any of them, and writes the four
// results with one 16-byte streaming store, so a warp moves 1 KB of indices
// and 512 B of results in four instructions and keeps 128 gathers in
// flight.  The grid covers at most a few waves of the card's SMs and loops
// over the rest.  The vector body needs the indices at a 16-byte boundary
// and the results at one: the wrapper's tensors start at one unless they
// are views, so a head of up to three indices is done one by one to reach
// it, and the B % 4 indices after the last group likewise; where no head
// aligns both, every index is done one by one.  Side by side on an H100
// (scripts/torch_k2_variants.py; PERF.md), this design is a few per cent
// slower than one or two indices a thread at 960 000 random indices and
// faster than torch.index_select; eight a thread is slower still.
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

constexpr int THREADS = 256;
constexpr int WAVES = 4;  // resident grids the launch covers, at most

__device__ __forceinline__ longlong2 load_indices(const longlong2* p) {
    longlong2 v;
    asm("ld.global.nc.L1::no_allocate.v2.s64 {%0, %1}, [%2];"
        : "=l"(v.x), "=l"(v.y)
        : "l"(p));
    return v;
}

__device__ __forceinline__ bool inside(long long at, long long n) {
    return (unsigned long long)at < (unsigned long long)n;  // and at >= 0
}

// groups: the 4-index groups of the vector body, which starts at index
// `head`; the indices before it and the B - head - 4 * groups after it are
// done one by one
__global__ void __launch_bounds__(THREADS)
gather_sizes_kernel(const int* __restrict__ sizes,
                    const long long* __restrict__ idx, int* __restrict__ out,
                    long long n, long long B, long long head,
                    long long groups) {
    const long long stride = (long long)gridDim.x * THREADS;
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    const longlong2* idx2 = (const longlong2*)(idx + head);
    int4* out4 = (int4*)(out + head);
    for (long long g = t; g < groups; g += stride) {
        const longlong2 lo = load_indices(idx2 + 2 * g);
        const longlong2 hi = load_indices(idx2 + 2 * g + 1);
        // one test and one branch for the four
        assert(inside(lo.x, n) & inside(lo.y, n) & inside(hi.x, n) &
               inside(hi.y, n));
        const int4 v = make_int4(__ldg(sizes + lo.x), __ldg(sizes + lo.y),
                                 __ldg(sizes + hi.x), __ldg(sizes + hi.y));
        __stcs(out4 + g, v);
    }
    const long long tail = head + 4 * groups;
    const long long scalars = head + (B - tail);
    for (long long s = t; s < scalars; s += stride) {
        const long long i = s < head ? s : tail + (s - head);
        const long long at = idx[i];
        assert(inside(at, n));
        out[i] = __ldg(sizes + at);
    }
}

extern "C" int bgt_gather_sizes(const void* sizes, const void* idx, void* out,
                                long long n, long long B, void* stream) {
    if (B > 0) {
        static int sms = 0;
        if (sms == 0) {
            int device = 0;
            cudaError_t err = cudaGetDevice(&device);
            if (err == cudaSuccess)
                err = cudaDeviceGetAttribute(
                    &sms, cudaDevAttrMultiProcessorCount, device);
            if (err != cudaSuccess) return (int)err;
        }
        // the head that puts idx and out on a 16-byte boundary together, if
        // there is one: idx moves 8 bytes an index, out 4
        const uintptr_t ia = (uintptr_t)idx, oa = (uintptr_t)out;
        const long long h = (long long)(((16 - (oa & 15)) & 15) / 4);
        const bool aligned = ia % 8 == 0 && oa % 4 == 0 &&
                             (ia + 8 * (uintptr_t)h) % 16 == 0;
        const long long head = aligned ? (h < B ? h : B) : B;
        const long long groups = (B - head) / 4;
        const long long scalars = B - 4 * groups;
        const long long work = groups > scalars ? groups : scalars;
        long long grid = (work + THREADS - 1) / THREADS;
        const long long cap = (long long)sms * (2048 / THREADS) * WAVES;
        if (grid > cap) grid = cap;
        gather_sizes_kernel<<<(unsigned)grid, THREADS, 0,
                              (cudaStream_t)stream>>>(
            (const int*)sizes, (const long long*)idx, (int*)out, n, B, head,
            groups);
    }
    return (int)cudaGetLastError();
}
