// K2's single-base entry, fused: one push_front step of a batch of seqset
// ranges in one launch.  Replaces the TPU kernel gather_bytes_pallas
// (_gather_bytes_kernel) of biograph_tpu/ops/rank4.py where the seqset's
// push_front uses it, the kick test of Seqset.push_front
// (biograph_tpu/index/seqset.py), together with that function's two ranks and
// the tensor code around them.  The single-base counterpart of push4.cu.
//
//   nb = fixed[b] + rank_b(begin),  ne = fixed[b] + rank_b(end)
//   nb += (nb < ne) & (entry_sizes[min(nb, n - 1)] < size + 1)      (the kick)
//   out = begin < end ? (nb, ne, size + 1) : (begin, begin, size)
//
// What it reads and writes, a lane: begin, end and b (8 bytes each) and size
// (4), read once; base b's 32-byte block of the rank-block table for begin,
// and another for end when end lies in another block; one 4-byte entry size
// when the pushed range is not empty; begin, end (8 bytes each) and size (4)
// written once.  What bounds it: those bytes, 48 of input and output and up
// to 68 gathered, over the device-memory rate (3.35 TB/s on an H100 SXM), or,
// while the table and the sizes sit in L2, the sectors asked for at random;
// the arithmetic (two block lookups, three masked 64-bit popcounts a rank) is
// nothing beside that.  Unfused, the same step was the rank kernel and a
// dozen tensor operations, each writing its [B] result to memory and the
// next reading it back.
//
// What the design does about it: one thread a lane, as the rank kernel of
// rank4.cu.  Both sectors are asked for before either is used (the second
// load depends on the block indices only, not on the first sector), so a
// lane has both in flight at once; the second is skipped when both ends
// share a block.  The size is gathered only for a range that is not empty.
// The lane's inputs are read once and its outputs written once and read by
// another kernel: both go around the cache's keep-list (__ldcs, __stcs), so
// the table and the sizes stay resident.  b must lie in [0, 4): a device-side
// assert, as gather_sizes asserts its indices.
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

#include "rank_blocks.cuh"

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
push_front_kernel(const ulonglong2* __restrict__ blocks,
                  const int* __restrict__ entry_sizes,
                  const long long* __restrict__ fixed,
                  const long long* __restrict__ begin,
                  const long long* __restrict__ end,
                  const int* __restrict__ size,
                  const long long* __restrict__ base,
                  long long* __restrict__ out_begin,
                  long long* __restrict__ out_end, int* __restrict__ out_size,
                  long long nblk, long long n, long long B) {
    const long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (q >= B) return;
    const long long s = __ldcs(begin + q), e = __ldcs(end + q);
    const int sz = __ldcs(size + q);
    const long long b = __ldcs(base + q);
    assert(b >= 0 && b < 4);
    if (s >= e) {  // an invalid range stays where it is, empty
        __stcs(out_begin + q, s);
        __stcs(out_end + q, s);
        __stcs(out_size + q, sz);
        return;
    }
    const long long last_word = nblk * BLOCK_WORDS - 1;
    uint32_t k0, r0, k1, r1;
    locate_in_blocks(s, last_word, &k0, &r0);
    locate_in_blocks(e, last_word, &k1, &r1);
    const ulonglong2* at0 = block_at(blocks, (int)b, k0);
    const ulonglong2* at1 = block_at(blocks, (int)b, k1);
    const ulonglong2 a0 = at0[0], c0 = at0[1];
    ulonglong2 a1 = a0, c1 = c0;
    if (k1 != k0) {
        a1 = at1[0];
        c1 = at1[1];
    }
    const long long first = fixed[b];
    long long nb = first + rank_in_block(a0, c0, r0);
    const long long ne = first + rank_in_block(a1, c1, r1);
    if (nb < ne) {  // an empty child needs no kick
        const long long at = nb < n - 1 ? nb : n - 1;
        nb += entry_sizes[at] < sz + 1;
    }
    __stcs(out_begin + q, nb);
    __stcs(out_end + q, ne);
    __stcs(out_size + q, sz + 1);
}

extern "C" int bgt_push_front_block_words() { return BLOCK_WORDS; }

extern "C" int bgt_push_front(const void* blocks, const void* entry_sizes,
                              const void* fixed, const void* begin,
                              const void* end, const void* size,
                              const void* base, void* out_begin, void* out_end,
                              void* out_size, long long nblk, long long n,
                              long long B, void* stream) {
    if (B > 0) {
        const long long grid = (B + THREADS - 1) / THREADS;
        push_front_kernel<<<(unsigned)grid, THREADS, 0,
                            (cudaStream_t)stream>>>(
            (const ulonglong2*)blocks, (const int*)entry_sizes,
            (const long long*)fixed, (const long long*)begin,
            (const long long*)end, (const int*)size, (const long long*)base,
            (long long*)out_begin, (long long*)out_end, (int*)out_size, nblk,
            n, B);
    }
    return (int)cudaGetLastError();
}
