// K3 chain_window: `depth` sequential push_front steps per lane.  Replaces
// the TPU kernel chain_window_pallas (_chain_window_kernel) of
// biograph_tpu/ops/rank4.py.
//
// Lane q pushes base win[q, s] at step s once s >= depth - m[q]; the state
// (begin, end, size) starts at (0, n, 0).  Per step:
//   valid = begin < end
//   nb/ne = fixed[b] + rank_b(begin/end)
//   first = clamp(nb, 0, n-1);  kick = nb < ne && sizes[first] < size + 1
//   started &&  valid -> (nb + kick, ne, size + 1)
//   started && !valid -> end = begin
//   otherwise unchanged
//
// One thread per lane, the whole chain in registers, depth a runtime loop
// bound.  Each step is a dependent chain of random reads (two ranks, one
// size), so the kernel is bound by memory latency and the bytes gathered;
// the structure is small enough to be served from L2 after first touch.
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ long long rank_b(const uint32_t* __restrict__ words,
                                            const long long* __restrict__ cum,
                                            long long nw, int b, long long p) {
    if (p < 0) p = 0;  // never read before the structure
    long long w = p >> 5;
    uint32_t mask = (1u << (uint32_t)(p & 31)) - 1u;
    if (w >= nw) {
        w = nw - 1;
        mask = 0xFFFFFFFFu;
    }
    long long at = (long long)b * nw + w;
    return cum[at] + __popc(words[at] & mask);
}

__global__ void chain_window_kernel(
    const uint32_t* __restrict__ words, const long long* __restrict__ cum,
    const int* __restrict__ sizes, const long long* __restrict__ fixed,
    const uint8_t* __restrict__ win, const int* __restrict__ m,
    long long* __restrict__ out_begin, long long* __restrict__ out_end,
    int* __restrict__ out_size, long long nw, long long n, long long P,
    int depth) {
    long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= P) return;
    const uint8_t* row = win + q * depth;
    int first_step = depth - m[q];
    long long begin = 0, end = n;
    int size = 0;
    for (int s = first_step < 0 ? 0 : first_step; s < depth; ++s) {
        if (begin >= end) {
            end = begin;
            continue;
        }
        int b = row[s] & 3;
        long long fb = fixed[b];
        long long nb = fb + rank_b(words, cum, nw, b, begin);
        long long ne = fb + rank_b(words, cum, nw, b, end);
        long long first = nb < 0 ? 0 : (nb > n - 1 ? n - 1 : nb);
        if (nb < ne && sizes[first] < size + 1) nb += 1;
        begin = nb;
        end = ne;
        size += 1;
    }
    out_begin[q] = begin;
    out_end[q] = end;
    out_size[q] = size;
}

extern "C" int bgt_chain_window(const void* words, const void* cum,
                                const void* sizes, const void* fixed,
                                const void* win, const void* m,
                                void* out_begin, void* out_end, void* out_size,
                                long long nw, long long n, long long P,
                                int depth, void* stream) {
    if (P > 0) {
        const int threads = 128;
        long long blocks = (P + threads - 1) / threads;
        chain_window_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
            (const uint32_t*)words, (const long long*)cum, (const int*)sizes,
            (const long long*)fixed, (const uint8_t*)win, (const int*)m,
            (long long*)out_begin, (long long*)out_end, (int*)out_size, nw, n,
            P, depth);
    }
    return (int)cudaGetLastError();
}
