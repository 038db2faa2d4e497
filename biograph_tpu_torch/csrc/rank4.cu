// K1 rank4: all-four-bases rank at each position.  Replaces the TPU kernel
// rank4_pallas (_rank4_kernel) of biograph_tpu/ops/rank4.py.
//
//   out[q, b] = cum[b, w] + popc(words[b, w] & mask),  w = min(pos >> 5, nw-1)
//
// mask keeps the low (pos & 31) bits, or the whole word when pos >> 5 >= nw
// (an end position equal to 32*nw counts the last word fully).
//
// One thread per position: eight independent loads (four words, four cums)
// and four __popc.  The work is bound by bytes gathered, not by arithmetic.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void rank4_kernel(const uint32_t* __restrict__ words,
                             const long long* __restrict__ cum,
                             const long long* __restrict__ pos,
                             int* __restrict__ out, long long nw, long long B) {
    long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= B) return;
    long long p = pos[q];
    if (p < 0) p = 0;  // never read before the structure
    long long w = p >> 5;
    uint32_t mask = (1u << (uint32_t)(p & 31)) - 1u;
    if (w >= nw) {
        w = nw - 1;
        mask = 0xFFFFFFFFu;
    }
    int4 r;
    r.x = (int)(cum[w] + __popc(words[w] & mask));
    r.y = (int)(cum[nw + w] + __popc(words[nw + w] & mask));
    r.z = (int)(cum[2 * nw + w] + __popc(words[2 * nw + w] & mask));
    r.w = (int)(cum[3 * nw + w] + __popc(words[3 * nw + w] & mask));
    reinterpret_cast<int4*>(out)[q] = r;
}

extern "C" int bgt_rank4(const void* words, const void* cum, const void* pos,
                         void* out, long long nw, long long B, void* stream) {
    if (B > 0) {
        const int threads = 256;
        long long blocks = (B + threads - 1) / threads;
        rank4_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)words, (const long long*)cum,
            (const long long*)pos, (int*)out, nw, B);
    }
    return (int)cudaGetLastError();
}
