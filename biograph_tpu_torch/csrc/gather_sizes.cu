// K2 gather_sizes: out[i] = sizes[idx[i]], exact int32 values.  Replaces the
// TPU kernel gather_bytes_pallas (_gather_bytes_kernel) of
// biograph_tpu/ops/rank4.py.
//
// One thread per index.  The caller clamps idx into [0, n); an index outside
// it is the caller's error and fails a device-side assert, as PyTorch's own
// indexing kernels do.  Bound by bytes: one 8-byte index read, one random
// 4-byte read and one 4-byte write per element.
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

__global__ void gather_sizes_kernel(const int* __restrict__ sizes,
                                    const long long* __restrict__ idx,
                                    int* __restrict__ out, long long n,
                                    long long B) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    const long long at = idx[i];
    assert(at >= 0 && at < n);
    out[i] = sizes[at];
}

extern "C" int bgt_gather_sizes(const void* sizes, const void* idx, void* out,
                                long long n, long long B, void* stream) {
    if (B > 0) {
        const int threads = 256;
        long long blocks = (B + threads - 1) / threads;
        gather_sizes_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
            (const int*)sizes, (const long long*)idx, (int*)out, n, B);
    }
    return (int)cudaGetLastError();
}
