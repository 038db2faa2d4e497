// K5 rank4_tiled: all-four-bases rank against the tiled rank table, queries
// bucketed by tile.  Replaces the TPU kernel rank4_hbm_pallas
// (_rank4_hbm_kernel) of biograph_tpu/ops/rank4.py, and the sort of the
// queries by tile that the TPU version leaves to XLA.
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
// One C entry point queues four kernels on the caller's stream:
//   (a) tile_histogram: q_count[t] = queries whose column lies in tile t;
//   (b) tile_scan (one block): q_first = exclusive scan of q_count,
//       blk_first = exclusive scan of ceil(q_count / Q_BLOCK), cursor =
//       q_first, and bt[block] = the block's tile (n_tiles for the blocks
//       past the last bucket);
//   (c) tile_scatter: each query takes a slot of its tile's bucket and
//       leaves one 8-byte record there: its position inside the tile (15
//       bits) above its original index (32 bits);
//   (d) rank4_tiled_kernel: a block serves up to Q_BLOCK queries of one
//       tile.  A dense bucket copies its tile (24 KB, coalesced) into shared
//       memory once and serves its queries from there; a sparse one reads
//       the two sectors of each query's column directly.  Results go
//       straight to the queries' original places, so the order inside a
//       bucket, which the atomics of (c) leave to chance, does not show in
//       the output.
// The block map has the fixed size ceil(B / Q_BLOCK) + n_tiles, so nothing
// waits for the device.  All scratch is one int32 buffer of the caller's:
// q_count, q_first, blk_first [3, n_tiles], the working counters of (a) and
// (c) [2, COUNTER_STRIDE * n_tiles], bt [n_blocks], then, 8-byte aligned,
// the records [B]; the counters of (a) are zeroed here.
//
// Bound by bytes: the table's touched tiles read once, 8 bytes of position
// in and 16 bytes out per query; the bucketing adds two more reads of the
// positions and 8 bytes written and read per query.  What the bucketing
// really pays for is scattered 8-byte writes and atomics on few counters.
// With up to SMEM_TILES tiles a block of (a) and (c) therefore counts in
// shared memory and touches each global counter once, neighbouring threads
// on neighbouring counters; (c) also puts its queries in bucket order in
// shared memory first, so that each tile's run leaves as one contiguous
// write.  With more tiles a block's queries hardly ever share a tile, and
// they go to the global counters directly.  Two things keep those atomics
// apart there: the lanes of a warp that hit the same tile (sorted positions)
// send one atomic for all of them, and the counters lie COUNTER_STRIDE ints
// apart, one to a 32-byte sector, because atomics on one sector are served
// one after the other.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int TILE_W = 1024;       // word columns per tile
constexpr int TILE_POS = 32 * TILE_W;  // positions per tile
constexpr int THREADS = 256;
constexpr int Q_BLOCK = 1024;      // queries per block of the rank kernel
constexpr int STAGE_MIN = 256;     // stage the tile from this many queries on
constexpr int SMEM_TILES = 2048;   // count in shared memory up to this many tiles
constexpr int ITEMS = 8;           // queries per thread of (a) and (c)
constexpr int CHUNK = THREADS * ITEMS;
constexpr int TILES_PER_THREAD = SMEM_TILES / THREADS;
constexpr int COUNTER_STRIDE = 8;  // ints between global counters past SMEM_TILES tiles
constexpr int SCAN_THREADS = 1024;
constexpr int SERIAL_FILL = 4;     // a thread maps up to this many blocks of its tile alone

// A position's tile and its place inside the tile.  Positions before the
// table read as 0; positions past it as its last one (a zero word and the
// totals).
__device__ __forceinline__ void split(long long p, long long ncol, int& tile,
                                      uint32_t& local) {
    if (p < 0) p = 0;
    if (p > ncol * 32 - 1) p = ncol * 32 - 1;
    tile = (int)(p / TILE_POS);
    local = (uint32_t)(p % TILE_POS);
}

// Exclusive scan of one value per thread across a block of WARPS warps;
// `carry` is the running total before this round and is advanced by the
// round's sum.  s_warp holds WARPS ints.
template <int WARPS>
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int& carry) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xFFFFFFFFu, inc, d);
        if (lane >= d) inc += up;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int w = lane < WARPS ? s_warp[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(0xFFFFFFFFu, w, d);
            if (lane >= d) w += up;
        }
        if (lane < WARPS) s_warp[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int before = carry + (warp ? s_warp[warp - 1] : 0) + inc - v;
    carry += s_warp[WARPS - 1];
    __syncthreads();  // s_warp is free for the next round
    return before;
}

// The lanes of the warp whose query lies in tile t (t < 0: no query), as a
// mask, and whether this lane speaks for them.
__device__ __forceinline__ unsigned same_tile(int t, bool& leader) {
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, t);
    leader = t >= 0 && (__ffs(peers) - 1) == (int)(threadIdx.x & 31);
    return peers;
}

// (a) histogram of the queries' tiles.  count is zero on entry; its
// counters lie `stride` ints apart.
__global__ void __launch_bounds__(THREADS)
tile_histogram(const long long* __restrict__ pos, int* __restrict__ count,
               long long B, long long ncol, int n_tiles, int stride) {
    __shared__ int s_count[SMEM_TILES];
    const bool local = n_tiles <= SMEM_TILES;  // the same for every thread
    if (local) {
        for (int t = threadIdx.x; t < n_tiles; t += THREADS) s_count[t] = 0;
        __syncthreads();
    }
    const long long first = (long long)blockIdx.x * CHUNK;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const long long i = first + k * THREADS + threadIdx.x;
        int t = -1;
        uint32_t at;
        if (i < B) split(pos[i], ncol, t, at);
        if (local) {
            if (t >= 0) atomicAdd(&s_count[t], 1);
        } else {
            bool leader;
            const unsigned peers = same_tile(t, leader);
            if (leader) atomicAdd(&count[(long long)t * stride], __popc(peers));
        }
    }
    if (local) {
        __syncthreads();
        for (int t = threadIdx.x; t < n_tiles; t += THREADS)
            if (s_count[t]) atomicAdd(&count[(long long)t * stride], s_count[t]);
    }
}

// (b) one block: bucket starts, block starts, cursors and the block map.
__global__ void __launch_bounds__(SCAN_THREADS)
tile_scan(const int* __restrict__ count, int* __restrict__ q_count,
          int* __restrict__ q_first, int* __restrict__ blk_first,
          int* __restrict__ cursor, int* __restrict__ bt, int n_tiles,
          int n_blocks, int stride) {
    __shared__ int s_warp[SCAN_THREADS / 32];
    int q_carry = 0, b_carry = 0;
    // one tile a thread and round, so that the block's loads and stores lie
    // side by side (eight tiles a thread took twice as long on an H100)
    for (int t0 = 0; t0 < n_tiles; t0 += SCAN_THREADS) {
        const int t = t0 + threadIdx.x;
        const int c = t < n_tiles ? count[(long long)t * stride] : 0;
        const int nb = (c + Q_BLOCK - 1) / Q_BLOCK;
        const int qf = block_exclusive_scan<SCAN_THREADS / 32>(c, s_warp, q_carry);
        const int bf = block_exclusive_scan<SCAN_THREADS / 32>(nb, s_warp, b_carry);
        if (t < n_tiles) {
            q_count[t] = c;
            q_first[t] = qf;
            cursor[(long long)t * stride] = qf;
            blk_first[t] = bf;
            if (nb <= SERIAL_FILL)
                for (int k = 0; k < nb; ++k) bt[bf + k] = t;
        }
        // a bucket of many blocks (all queries in few tiles): the warp maps
        // its blocks together, side by side
        unsigned big = __ballot_sync(0xFFFFFFFFu, t < n_tiles && nb > SERIAL_FILL);
        while (big) {
            const int src = __ffs(big) - 1;
            big &= big - 1;
            const int bt_t = __shfl_sync(0xFFFFFFFFu, t, src);
            const int bt_first = __shfl_sync(0xFFFFFFFFu, bf, src);
            const int bt_n = __shfl_sync(0xFFFFFFFFu, nb, src);
            for (int k = threadIdx.x & 31; k < bt_n; k += 32) bt[bt_first + k] = bt_t;
        }
    }
    // blocks past the last bucket
    for (int i = b_carry + threadIdx.x; i < n_blocks; i += SCAN_THREADS)
        bt[i] = n_tiles;
}

// (c) scatter of the queries' records into the buckets.
__global__ void __launch_bounds__(THREADS)
tile_scatter(const long long* __restrict__ pos, int* __restrict__ cursor,
             unsigned long long* __restrict__ recs, long long B,
             long long ncol, int n_tiles, int stride) {
    __shared__ int s_count[SMEM_TILES];  // a tile's queries in this block, then where its run starts
    __shared__ int s_delta[SMEM_TILES];  // the run's first bucket slot less where it starts
    __shared__ unsigned long long s_rec[CHUNK];  // the block's records in bucket order
    __shared__ int s_slot[CHUNK];                // and the slot of each
    __shared__ int s_warp[THREADS / 32];
    const long long first = (long long)blockIdx.x * CHUNK;
    unsigned long long rec[ITEMS];
    int t[ITEMS], r[ITEMS];

    if (n_tiles > SMEM_TILES) {  // the same for every thread
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
            const long long i = first + k * THREADS + threadIdx.x;
            int tile = -1;
            uint32_t at = 0;
            if (i < B) split(pos[i], ncol, tile, at);
            // the warp's queries of one tile take neighbouring slots
            bool leader;
            const unsigned peers = same_tile(tile, leader);
            int slot = 0;
            if (leader)
                slot = atomicAdd(&cursor[(long long)tile * stride], __popc(peers));
            slot = __shfl_sync(0xFFFFFFFFu, slot, __ffs(peers) - 1) +
                   __popc(peers & ((1u << (threadIdx.x & 31)) - 1u));
            if (tile >= 0)
                recs[slot] = (unsigned long long)at << 32 | (uint32_t)i;
        }
        return;
    }

    for (int j = threadIdx.x; j < n_tiles; j += THREADS) s_count[j] = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const long long i = first + k * THREADS + threadIdx.x;
        if (i < B) {
            uint32_t at;
            split(pos[i], ncol, t[k], at);
            rec[k] = (unsigned long long)at << 32 | (uint32_t)i;
            r[k] = atomicAdd(&s_count[t[k]], 1);  // its place in the tile's run
        }
    }
    __syncthreads();
    // The runs follow each other in the order (thread, j) of the tiles
    // j * THREADS + thread: any order serves, and in this one neighbouring
    // threads take their bucket slots from neighbouring cursors.
    int c[TILES_PER_THREAD], mine = 0;
#pragma unroll
    for (int j = 0; j < TILES_PER_THREAD; ++j) {
        const int tile = j * THREADS + threadIdx.x;
        c[j] = tile < n_tiles ? s_count[tile] : 0;
        mine += c[j];
    }
    int carry = 0;
    int start = block_exclusive_scan<THREADS / 32>(mine, s_warp, carry);
#pragma unroll
    for (int j = 0; j < TILES_PER_THREAD; ++j) {
        const int tile = j * THREADS + threadIdx.x;
        if (c[j]) {
            s_count[tile] = start;
            s_delta[tile] = atomicAdd(&cursor[(long long)tile * stride], c[j]) - start;
            start += c[j];
        }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const long long i = first + k * THREADS + threadIdx.x;
        if (i < B) {
            const int at = s_count[t[k]] + r[k];
            s_rec[at] = rec[k];
            s_slot[at] = s_delta[t[k]] + at;
        }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < carry; j += THREADS) recs[s_slot[j]] = s_rec[j];
}

// (d) the rank of one block's queries.
__global__ void __launch_bounds__(THREADS)
rank4_tiled_kernel(const uint4* words, const uint2* rel,
                   const long long* __restrict__ base,
                   const unsigned long long* __restrict__ recs,
                   const int* __restrict__ bt,
                   const int* __restrict__ blk_first,
                   const int* __restrict__ q_first,
                   const int* __restrict__ q_count, int* __restrict__ out,
                   int n_tiles) {
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

    for (long long j = threadIdx.x; j < n; j += THREADS) {
        const unsigned long long rec = recs[start + j];
        const uint32_t at = (uint32_t)(rec >> 32);  // position inside the tile
        const uint32_t mask = (1u << (at & 31)) - 1u;
        const uint4 w = wp[at >> 5];
        const uint2 c = rp[at >> 5];
        int4 r;
        r.x = (int)(b0 + (c.x & 0xFFFFu) + __popc(w.x & mask));
        r.y = (int)(b1 + (c.x >> 16) + __popc(w.y & mask));
        r.z = (int)(b2 + (c.y & 0xFFFFu) + __popc(w.z & mask));
        r.w = (int)(b3 + (c.y >> 16) + __popc(w.w & mask));
        reinterpret_cast<int4*>(out)[(uint32_t)rec] = r;
    }
}

extern "C" int bgt_rank4_tiled_tile_w() { return TILE_W; }
extern "C" int bgt_rank4_tiled_q_block() { return Q_BLOCK; }

// The parts of the caller's scratch buffer (see the note at the top).
struct Scratch {
    int *q_count, *q_first, *blk_first, *count, *cursor, *bt;
    unsigned long long* recs;
    Scratch(void* scratch, long long n_tiles, long long n_blocks) {
        int* s = (int*)scratch;
        q_count = s;
        q_first = s + n_tiles;
        blk_first = s + 2 * n_tiles;
        count = s + 3 * n_tiles;
        cursor = count + COUNTER_STRIDE * n_tiles;
        bt = cursor + COUNTER_STRIDE * n_tiles;
        const long long used = (3 + 2 * COUNTER_STRIDE) * n_tiles + n_blocks;
        recs = (unsigned long long*)(s + used + (used & 1));
    }
};

extern "C" int bgt_rank4_tiled_counter_ints() { return 3 + 2 * COUNTER_STRIDE; }

// The bucketing: (a), (b), (c).
static void launch_buckets(const void* pos, const Scratch& s, long long B,
                           long long ncol, int n_tiles, int n_blocks,
                           cudaStream_t stream) {
    const int stride = n_tiles > SMEM_TILES ? COUNTER_STRIDE : 1;
    cudaMemsetAsync(s.count, 0, sizeof(int) * n_tiles * stride, stream);
    const unsigned grid = (unsigned)((B + CHUNK - 1) / CHUNK);
    tile_histogram<<<grid, THREADS, 0, stream>>>(
        (const long long*)pos, s.count, B, ncol, n_tiles, stride);
    tile_scan<<<1, SCAN_THREADS, 0, stream>>>(s.count, s.q_count, s.q_first,
                                              s.blk_first, s.cursor, s.bt,
                                              n_tiles, n_blocks, stride);
    tile_scatter<<<grid, THREADS, 0, stream>>>(
        (const long long*)pos, s.cursor, s.recs, B, ncol, n_tiles, stride);
}

// The bucketing alone, for checks and timing.
extern "C" int bgt_tile_buckets(const void* pos, void* scratch, long long B,
                                long long ncol, long long n_tiles,
                                long long n_blocks, void* stream) {
    if (B > 0)
        launch_buckets(pos, Scratch(scratch, n_tiles, n_blocks), B, ncol,
                       (int)n_tiles, (int)n_blocks, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

extern "C" int bgt_rank4_tiled(const void* words, const void* rel,
                               const void* base, const void* pos,
                               void* scratch, void* out, long long B,
                               long long ncol, long long n_tiles,
                               long long n_blocks, void* stream) {
    if (B > 0) {
        const Scratch s(scratch, n_tiles, n_blocks);
        launch_buckets(pos, s, B, ncol, (int)n_tiles, (int)n_blocks,
                       (cudaStream_t)stream);
        rank4_tiled_kernel<<<(unsigned)n_blocks, THREADS, 0,
                             (cudaStream_t)stream>>>(
            (const uint4*)words, (const uint2*)rel, (const long long*)base,
            s.recs, s.bt, s.blk_first, s.q_first, s.q_count, (int*)out,
            (int)n_tiles);
    }
    return (int)cudaGetLastError();
}
