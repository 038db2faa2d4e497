// K5 rank4_tiled: all-four-bases rank against the tiled rank table, queries
// bucketed by tile.  Replaces the TPU kernel rank4_hbm_pallas
// (_rank4_hbm_kernel) of biograph_tpu/ops/rank4.py.
//
// The table (ops/rank4.py, build_rank4_tiles) cuts the rank structure into
// tiles of TILE_W word columns.  A column holds the four bases' words side by
// side (16 bytes) and their counts rebased to the tile's first column (four
// int16, 8 bytes); base[tile] holds the four int64 counts the tile starts
// from.  Columns past the structure hold a zero word and the totals, so an
// end position equal to 32*nw needs no special case.
//
//   out[perm[q], b] = base[t, b] + rel[col, b] + popc(words[col, b] & mask)
//
// The wrapper sorts the queries by tile and cuts each tile's bucket into
// blocks of Q_BLOCK queries; bt[block] names the block's tile (the TPU
// kernel's scalar-prefetched tile id).  A block whose bucket is dense copies
// its tile (24 KB, coalesced) into shared memory once and serves its queries
// from there; a sparse one reads the two sectors of each query's column
// directly.  Results go straight to the queries' original places through
// perm.  Bound by bytes: the table's touched tiles read once, 8 + 8 bytes of
// position and permutation in and 16 bytes out per query.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int TILE_W = 1024;     // word columns per tile
constexpr int THREADS = 256;
constexpr int Q_BLOCK = 1024;    // queries per block
constexpr int STAGE_MIN = 256;   // stage the tile from this many queries on

__global__ void __launch_bounds__(THREADS)
rank4_tiled_kernel(const uint4* words, const uint2* rel,
                   const long long* __restrict__ base,
                   const long long* __restrict__ pos_sorted,
                   const long long* __restrict__ perm,
                   const int* __restrict__ bt,
                   const long long* __restrict__ blk_first,
                   const long long* __restrict__ q_first,
                   const long long* __restrict__ q_count,
                   int* __restrict__ out, long long n_tiles) {
    __shared__ uint4 s_words[TILE_W];
    __shared__ uint2 s_rel[TILE_W];

    const long long t = bt[blockIdx.x];
    if (t >= n_tiles) return;  // a block past the last bucket
    const long long k = (long long)blockIdx.x - blk_first[t];
    const long long start = q_first[t] + k * Q_BLOCK;
    long long n = q_count[t] - k * Q_BLOCK;
    if (n > Q_BLOCK) n = Q_BLOCK;

    const uint4* wp = words + t * TILE_W;
    const uint2* rp = rel + t * TILE_W;
    if (n >= STAGE_MIN) {  // the same for every thread of the block
        for (int i = threadIdx.x; i < TILE_W; i += THREADS) {
            s_words[i] = wp[i];
            s_rel[i] = rp[i];
        }
        __syncthreads();
        wp = s_words;
        rp = s_rel;
    }
    const long long b0 = base[4 * t], b1 = base[4 * t + 1];
    const long long b2 = base[4 * t + 2], b3 = base[4 * t + 3];
    const long long col0 = t * TILE_W;

    for (long long j = threadIdx.x; j < n; j += THREADS) {
        const long long q = start + j;
        long long p = pos_sorted[q];
        if (p < 0) p = 0;  // never read before the table
        long long lw = (p >> 5) - col0;
        if (lw > TILE_W - 1) lw = TILE_W - 1;  // past the table: the totals
        const uint32_t mask = (1u << (uint32_t)(p & 31)) - 1u;
        const uint4 w = wp[lw];
        const uint2 c = rp[lw];
        int4 r;
        r.x = (int)(b0 + (c.x & 0xFFFFu) + __popc(w.x & mask));
        r.y = (int)(b1 + (c.x >> 16) + __popc(w.y & mask));
        r.z = (int)(b2 + (c.y & 0xFFFFu) + __popc(w.z & mask));
        r.w = (int)(b3 + (c.y >> 16) + __popc(w.w & mask));
        reinterpret_cast<int4*>(out)[perm[q]] = r;
    }
}

extern "C" int bgt_rank4_tiled_tile_w() { return TILE_W; }
extern "C" int bgt_rank4_tiled_q_block() { return Q_BLOCK; }

extern "C" int bgt_rank4_tiled(const void* words, const void* rel,
                               const void* base, const void* pos_sorted,
                               const void* perm, const void* bt,
                               const void* blk_first, const void* q_first,
                               const void* q_count, void* out,
                               long long n_tiles, long long n_blocks,
                               void* stream) {
    if (n_blocks > 0) {
        rank4_tiled_kernel<<<(unsigned)n_blocks, THREADS, 0,
                             (cudaStream_t)stream>>>(
            (const uint4*)words, (const uint2*)rel, (const long long*)base,
            (const long long*)pos_sorted, (const long long*)perm,
            (const int*)bt, (const long long*)blk_first,
            (const long long*)q_first, (const long long*)q_count, (int*)out,
            n_tiles);
    }
    return (int)cudaGetLastError();
}
