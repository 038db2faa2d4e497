// K1 rank4 and rank: the rank of a seqset position, for all four bases or for
// one.  Replaces the TPU kernel rank4_pallas (_rank4_kernel) of
// biograph_tpu/ops/rank4.py.
//
//   rank4: out[q, b] = rank_b(pos[q])                int32 [B, 4]
//   rank:  out[q]    = rank_{b[q]}(pos[q])           int64 [B]
//          (and, in the same launch, of a second position per query: the two
//          ends of a range that push_front ranks)
//
// What bounds it: 32-byte sectors requested, through L2 while the structure
// fits there and from device memory past it; the arithmetic (three masked
// 64-bit popcounts a rank) is nothing beside that.  Read from the structure as
// stored, a four-base rank asks for eight sectors in eight places (a word and
// a count a base) to use 48 bytes.
//
// What the design does about it: both kernels read the rank-block table
// (rank_blocks.cuh), where one sector answers one rank and the four bases'
// sectors of a position are one aligned 128-byte line.  rank4 gives a query
// four lanes, one a base: one load of a warp then asks for the whole lines of
// eight queries, a lane holds one block and 18 registers, and the warp writes
// 128 contiguous bytes.  (Measured on an H100 on the same inputs: one thread
// a query, with four blocks in flight, took 1.75 times as long with the
// structure in L2 and 1.55 times past it; with base b's blocks lying together,
// so that a query's sectors are four scattered ones, the kernel took 1.66
// times as long in L2 and 2.58 times past it.)
#include <cstdint>
#include <cuda_runtime.h>

#include "rank_blocks.cuh"

constexpr int THREADS = 256;

// rank4: thread t answers base t % 4 of query t / 4
__global__ void __launch_bounds__(THREADS)
rank4_kernel(const ulonglong2* __restrict__ blocks,
             const long long* __restrict__ pos, int* __restrict__ out,
             long long nblk, long long B) {
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long q = t >> 2;
    if (q >= B) return;
    uint32_t k, r;
    locate_in_blocks(pos[q], nblk * BLOCK_WORDS - 1, &k, &r);
    const ulonglong2* at = block_at(blocks, (int)(t & 3), k);
    out[t] = (int)rank_in_block(at[0], at[1], r);
}

// rank: one thread a query; with pos1, both ends of a range, the second end
// reusing the first one's sector when they share a block
__global__ void __launch_bounds__(THREADS)
rank_kernel(const ulonglong2* __restrict__ blocks,
            const long long* __restrict__ base,
            const long long* __restrict__ pos0,
            const long long* __restrict__ pos1, long long* __restrict__ out0,
            long long* __restrict__ out1, long long nblk, long long B) {
    const long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (q >= B) return;
    const long long last_word = nblk * BLOCK_WORDS - 1;
    const int b = (int)(base[q] & 3);
    uint32_t k0, r0;
    locate_in_blocks(pos0[q], last_word, &k0, &r0);
    const ulonglong2* at0 = block_at(blocks, b, k0);
    const ulonglong2 a0 = at0[0], c0 = at0[1];
    out0[q] = rank_in_block(a0, c0, r0);
    if (pos1 == nullptr) return;
    uint32_t k1, r1;
    locate_in_blocks(pos1[q], last_word, &k1, &r1);
    ulonglong2 a1 = a0, c1 = c0;
    if (k1 != k0) {
        const ulonglong2* at1 = block_at(blocks, b, k1);
        a1 = at1[0];
        c1 = at1[1];
    }
    out1[q] = rank_in_block(a1, c1, r1);
}

extern "C" int bgt_rank4_block_words() { return BLOCK_WORDS; }

extern "C" int bgt_rank4(const void* blocks, const void* pos, void* out,
                         long long nblk, long long B, void* stream) {
    if (B > 0) {
        const long long grid = (4 * B + THREADS - 1) / THREADS;
        rank4_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
            (const ulonglong2*)blocks, (const long long*)pos, (int*)out, nblk,
            B);
    }
    return (int)cudaGetLastError();
}

extern "C" int bgt_rank(const void* blocks, const void* base, const void* pos0,
                        const void* pos1, void* out0, void* out1,
                        long long nblk, long long B, void* stream) {
    if (B > 0) {
        const long long grid = (B + THREADS - 1) / THREADS;
        rank_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
            (const ulonglong2*)blocks, (const long long*)base,
            (const long long*)pos0, (const long long*)pos1, (long long*)out0,
            (long long*)out1, nblk, B);
    }
    return (int)cudaGetLastError();
}
