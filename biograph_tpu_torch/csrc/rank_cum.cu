// K4 rank_cum: exclusive prefix popcount of 32-bit words.  Replaces the TPU
// kernel rank_cum_pallas (_popcount_cum_kernel) of
// biograph_tpu/ops/pallas_rank.py.
//
// Blocks run in no order, so the scan is three launches:
//   1. block_scan:   each block popcounts BLOCK words, scans them in shared
//                    memory (warp shuffles), writes the in-block exclusive
//                    prefix and its block total;
//   2. totals_scan:  ONE block turns the block totals into exclusive block
//                    offsets, walking them BLOCK at a time with a carry;
//   3. add_offsets:  every word adds its block's offset.
// Bound by bytes: each word is read once and each prefix written once (the
// second and third pass re-touch the int32 output, which a single-pass
// decoupled look-back scan would avoid).
#include <cstdint>
#include <cuda_runtime.h>

#define BLOCK 1024

// Exclusive scan of one value per thread across a BLOCK-thread block;
// *total receives the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
    __shared__ int warp_sums[BLOCK / 32];
    __shared__ int block_sum;
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = v;
    for (int d = 1; d < 32; d <<= 1) {
        int up = __shfl_up_sync(0xFFFFFFFFu, inc, d);
        if (lane >= d) inc += up;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int ws = warp_sums[lane];
        int winc = ws;
        for (int d = 1; d < 32; d <<= 1) {
            int up = __shfl_up_sync(0xFFFFFFFFu, winc, d);
            if (lane >= d) winc += up;
        }
        warp_sums[lane] = winc - ws;  // exclusive prefix of the warp sums
        if (lane == 31) block_sum = winc;
    }
    __syncthreads();
    int result = inc - v + warp_sums[warp];
    *total = block_sum;
    __syncthreads();  // the shared arrays are reused by the next call
    return result;
}

__global__ void block_scan_kernel(const uint32_t* __restrict__ words,
                                  int* __restrict__ out,
                                  int* __restrict__ block_totals,
                                  long long nw) {
    long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
    int pc = i < nw ? __popc(words[i]) : 0;
    int total;
    int exc = block_exclusive_scan(pc, &total);
    if (i < nw) out[i] = exc;
    if (threadIdx.x == 0) block_totals[blockIdx.x] = total;
}

__global__ void totals_scan_kernel(int* __restrict__ block_totals,
                                   long long nblocks) {
    int carry = 0;
    for (long long base = 0; base < nblocks; base += BLOCK) {
        long long i = base + threadIdx.x;
        int v = i < nblocks ? block_totals[i] : 0;
        int total;
        int exc = block_exclusive_scan(v, &total);
        if (i < nblocks) block_totals[i] = exc + carry;
        carry += total;
    }
}

__global__ void add_offsets_kernel(int* __restrict__ out,
                                   const int* __restrict__ block_offsets,
                                   long long nw) {
    long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (i < nw) out[i] += block_offsets[blockIdx.x];
}

extern "C" int bgt_rank_cum_block() { return BLOCK; }

extern "C" int bgt_rank_cum(const void* words, void* out, void* block_totals,
                            long long nw, void* stream) {
    if (nw > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        long long nblocks = (nw + BLOCK - 1) / BLOCK;
        block_scan_kernel<<<(unsigned)nblocks, BLOCK, 0, s>>>(
            (const uint32_t*)words, (int*)out, (int*)block_totals, nw);
        totals_scan_kernel<<<1, BLOCK, 0, s>>>((int*)block_totals, nblocks);
        add_offsets_kernel<<<(unsigned)nblocks, BLOCK, 0, s>>>(
            (int*)out, (const int*)block_totals, nw);
    }
    return (int)cudaGetLastError();
}
