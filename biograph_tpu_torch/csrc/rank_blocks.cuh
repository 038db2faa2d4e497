// The rank-block table as the kernels read it (ops/rank4.py,
// build_rank_blocks): the one device form of a seqset's rank structure.
//
// A block is one aligned 32-byte sector: the int64 count of the set bits
// before the block, then six 32-bit words (192 entries).  The four bases'
// blocks of one stretch of entries lie side by side: block k of base b is
// sector 4k + b, so the four sectors a four-base rank needs are one aligned
// 128-byte line and a single-base rank still asks for one sector.  Words past
// the structure are zero and the blocks there carry the totals, so a position
// equal to 32*nw is answered like any other; a word index past the table is
// clamped to its last word, a negative position to 0.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

constexpr int BLOCK_WORDS = 6;  // 32-bit words in a rank block

// Where position `pos` lies: its block *k, and the bit *r (0 <= r < 192) inside
// the block below which its rank counts.  last_word = nblk * BLOCK_WORDS - 1.
__device__ __forceinline__ void locate_in_blocks(long long pos,
                                                 long long last_word,
                                                 uint32_t* k, uint32_t* r) {
    if (pos < 0) pos = 0;  // never read before the table
    long long w = pos >> 5;
    if (w > last_word) w = last_word;  // past the table: the totals
    *k = (uint32_t)w / BLOCK_WORDS;
    *r = ((uint32_t)w - *k * BLOCK_WORDS) * 32u + (uint32_t)(pos & 31);
}

// The two 16-byte halves of base b's block k; the memory system merges the two
// loads into one sector.
__device__ __forceinline__ const ulonglong2* block_at(
    const ulonglong2* __restrict__ blocks, int b, uint32_t k) {
    return blocks + 2 * (4 * (long long)k + b);
}

// Set bits below bit r (0 <= r < 192) of the block (a, c), plus its count.
// a = {count, words 0-1}, c = {words 2-3, words 4-5}, little-endian pairs.
__device__ __forceinline__ long long rank_in_block(ulonglong2 a, ulonglong2 c,
                                                   uint32_t r) {
    const unsigned long long all = ~0ull;
    unsigned long long m0 = r >= 64 ? all : (1ull << r) - 1ull;
    unsigned long long m1 =
        r >= 128 ? all : (r > 64 ? (1ull << (r - 64)) - 1ull : 0ull);
    unsigned long long m2 = r > 128 ? (1ull << (r - 128)) - 1ull : 0ull;
    return (long long)a.x + __popcll(a.y & m0) + __popcll(c.x & m1) +
           __popcll(c.y & m2);
}
