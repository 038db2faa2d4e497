// K2 redesigned as push4: the children of a seqset range for all four pushed
// bases, in one launch.  Replaces the TPU kernel gather_bytes_pallas
// (_gather_bytes_kernel) of biograph_tpu/ops/rank4.py where it is used, the
// kick test inside _SeqsetDevice.push4 (biograph_tpu/index/seqset.py), together
// with the rank4 call and the tensor code around the two.
//
//   begin4[q, b], end4[q, b] = push_front((begin[q], end[q], size[q]), b)
//
//   nb = fixed[b] + rank_b(begin),  ne = fixed[b] + rank_b(end)
//   nb += (nb < ne) & (entry_sizes[min(nb, n - 1)] < size + 1)      (the kick)
//   a range with begin >= end comes back as (begin, begin) in every column
//
// What bounds it: 32-byte sectors requested, as for rank4 (rank4.cu).  A range
// asks for the 128-byte line of begin's four blocks, the line of end's when
// end lies in another block, its 20 bytes of input, its 64 bytes of output,
// and one sector of entry_sizes for every child that is not empty.  As three
// kernels and a dozen tensor operations the same work also wrote and read
// back the stacked positions, the [2B, 4] ranks, the clamped indices, the
// gathered sizes and the masks; one launch replaces sixteen.
//
// What the design does about it: four lanes a range, one a base, as in rank4
// (a warp's load covers the whole lines of eight ranges and its stores are
// 256 contiguous bytes); the second rank reuses the first one's block when
// both ends share it, as rank does for a range's two ends; a lane gathers its
// size only when its child is not empty, which in the beam wavefront is one
// child of four.  The 64 bytes a range writes are its largest item, written
// once and read by another kernel, and its 20 bytes of input are read once: both
// go around the cache's keep-list (__stcs, __ldcs), so the table and the
// sizes stay resident.  (Side by side on an H100 at 240 000 ranges, 128
// threads a block with these hints were about a tenth faster than 256 threads
// with plain loads and stores; two or four ranges a thread, for more loads in
// flight, were slower by a fifth and by a half: 60 and 111 registers.)
#include <cstdint>
#include <cuda_runtime.h>

#include "rank_blocks.cuh"

constexpr int THREADS = 128;

// thread t answers base t % 4 of range t / 4
__global__ void __launch_bounds__(THREADS)
push4_kernel(const ulonglong2* __restrict__ blocks,
             const int* __restrict__ entry_sizes,
             const long long* __restrict__ fixed,
             const long long* __restrict__ begin,
             const long long* __restrict__ end, const int* __restrict__ size,
             long long* __restrict__ begin4, long long* __restrict__ end4,
             long long nblk, long long n, long long B) {
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long q = t >> 2;
    if (q >= B) return;
    const long long s = __ldcs(begin + q), e = __ldcs(end + q);
    const int new_size = __ldcs(size + q) + 1;
    if (s >= e) {  // an invalid range stays where it is, empty
        __stcs(begin4 + t, s);
        __stcs(end4 + t, s);
        return;
    }
    const int b = (int)(t & 3);
    const long long last_word = nblk * BLOCK_WORDS - 1;
    uint32_t k0, r0, k1, r1;
    locate_in_blocks(s, last_word, &k0, &r0);
    locate_in_blocks(e, last_word, &k1, &r1);
    const ulonglong2* at0 = block_at(blocks, b, k0);
    const ulonglong2 a0 = at0[0], c0 = at0[1];
    ulonglong2 a1 = a0, c1 = c0;
    if (k1 != k0) {
        const ulonglong2* at1 = block_at(blocks, b, k1);
        a1 = at1[0];
        c1 = at1[1];
    }
    const long long first = fixed[b];
    long long nb = first + rank_in_block(a0, c0, r0);
    const long long ne = first + rank_in_block(a1, c1, r1);
    if (nb < ne) {  // an empty child needs no kick
        const long long at = nb < n - 1 ? nb : n - 1;
        nb += entry_sizes[at] < new_size;
    }
    __stcs(begin4 + t, nb);
    __stcs(end4 + t, ne);
}

extern "C" int bgt_push4_block_words() { return BLOCK_WORDS; }

extern "C" int bgt_push4(const void* blocks, const void* entry_sizes,
                         const void* fixed, const void* begin, const void* end,
                         const void* size, void* begin4, void* end4,
                         long long nblk, long long n, long long B,
                         void* stream) {
    if (B > 0) {
        const long long grid = (4 * B + THREADS - 1) / THREADS;
        push4_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
            (const ulonglong2*)blocks, (const int*)entry_sizes,
            (const long long*)fixed, (const long long*)begin,
            (const long long*)end, (const int*)size, (long long*)begin4,
            (long long*)end4, nblk, n, B);
    }
    return (int)cudaGetLastError();
}
