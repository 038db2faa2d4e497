// K4 rank_cum: exclusive prefix popcount of 32-bit words, row by row.
// Replaces the TPU kernel rank_cum_pallas (_popcount_cum_kernel) of
// biograph_tpu/ops/pallas_rank.py.
//
//   out[r, i] = sum over j < i of popcount(words[r, j])        int32 [R, nw]
//
// What bounds it: at a seqset's size (some 10^5 words a row) launches, and
// past that bytes: every word read once, every prefix written once.  The TPU
// kernel walks its blocks in order and carries the sum; blocks here run in no
// order, and a scan in three launches (block scans, a scan of the block
// totals, a pass adding the offsets) pays two launch boundaries and touches
// the output twice.
//
// What the design does about it: one launch, one pass, every row in it: a scan
// with decoupled look-back.  A block takes a ticket from a counter, so that
// tiles are handed out in the order blocks start: ticket t is tile t % T of
// row t / T, and whoever holds a lower ticket is already running.  It scans
// its TILE_WORDS words in registers (16-byte loads, warp shuffles, one
// exchange of warp totals through shared memory), publishes its total as an
// AGGREGATE, and its first warp looks back over the row's earlier tiles, 32
// descriptors at a time, adding aggregates until it meets an INCLUSIVE prefix
// (or the row's start); then it publishes its own inclusive prefix and the
// block writes its prefixes, 16 bytes a thread.  A descriptor is one 64-bit
// word, flag above value, written and read whole, so no fence is needed and
// counts up to 2^32 - 1 pass through.  A predecessor publishes its aggregate
// before it waits for anything, so no block spins on one that cannot run.
//
// A row need not start on a 16-byte boundary (nw is odd as often as not): a
// row's tiles are laid over the 16-byte groups of memory it touches, the
// words of a group outside the row masked, so the loads and stores of whole
// groups stay aligned whatever nw is.  That needs `words` and `out` aligned
// alike, which holds when both are whole allocations; otherwise the kernel
// reads and writes word by word.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 4;                       // 16-byte groups a thread takes
constexpr int WARP_WORDS = 32 * 4 * ROUNDS;     // 512: a warp's contiguous run
constexpr int TILE_WORDS = WARPS * WARP_WORDS;  // 4096
constexpr unsigned long long AGGREGATE = 1ull << 32;
constexpr unsigned long long INCLUSIVE = 2ull << 32;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
rank_cum_kernel(const uint32_t* __restrict__ words, int* __restrict__ out,
                unsigned long long* __restrict__ scratch, long long nw,
                long long tiles_per_row, int lead) {
    __shared__ long long s_ticket;
    __shared__ int s_warp_total[WARPS];
    __shared__ int s_prefix;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) s_ticket = (long long)atomicAdd(scratch, 1ull);
    __syncthreads();
    const long long row = s_ticket / tiles_per_row;
    const long long tile = s_ticket - row * tiles_per_row;
    volatile unsigned long long* desc = scratch + 1 + row * tiles_per_row;

    // Word i of the row is word row * nw + i of the buffers.  The row's groups
    // of four start at the group its first word lies in: `lead` words to the
    // left of the buffers' own start when that is not on a 16-byte boundary.
    const long long row_lo = row * nw, row_hi = row_lo + nw;
    const long long first_group = ((row_lo + lead) & ~3ll) - lead;
    const long long warp_lo =
        first_group + tile * TILE_WORDS + (long long)warp * WARP_WORDS;

    uint32_t w[ROUNDS][4];
    int before[ROUNDS];  // set bits of the warp's run before this thread's group
    int carry = 0;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const long long g = warp_lo + r * 128 + lane * 4;
        if (VEC && g >= row_lo && g + 4 <= row_hi) {
            const uint4 v = *reinterpret_cast<const uint4*>(words + g);
            w[r][0] = v.x; w[r][1] = v.y; w[r][2] = v.z; w[r][3] = v.w;
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                w[r][j] = (g + j >= row_lo && g + j < row_hi) ? words[g + j] : 0u;
        }
        const int mine =
            __popc(w[r][0]) + __popc(w[r][1]) + __popc(w[r][2]) + __popc(w[r][3]);
        int inc = mine;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(0xFFFFFFFFu, inc, d);
            if (lane >= d) inc += up;
        }
        before[r] = carry + inc - mine;
        carry += __shfl_sync(0xFFFFFFFFu, inc, 31);
    }
    if (lane == 0) s_warp_total[warp] = carry;
    __syncthreads();

    int warp_before = 0, total = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
        if (i < warp) warp_before += s_warp_total[i];
        total += s_warp_total[i];
    }

    if (warp == 0) {
        int prefix = 0;
        if (tile > 0) {
            if (lane == 0) desc[tile] = AGGREGATE | (uint32_t)total;
            for (long long look = tile - 1;; look -= 32) {
                const long long at = look - lane;  // lane 0 reads the nearest
                unsigned long long d = INCLUSIVE;  // left of the row: nothing
                if (at >= 0) {
                    do {
                        d = desc[at];
                    } while ((d >> 32) == 0);
                }
                const unsigned ends =
                    __ballot_sync(0xFFFFFFFFu, (d >> 32) == 2);
                const int last = ends ? __ffs(ends) - 1 : 31;
                int v = lane <= last ? (int)(uint32_t)d : 0;
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
                prefix += v;
                if (ends) break;
            }
        }
        if (lane == 0) {
            desc[tile] = INCLUSIVE | (uint32_t)(prefix + total);
            s_prefix = prefix;
        }
    }
    __syncthreads();

    const int base = s_prefix + warp_before;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const long long g = warp_lo + r * 128 + lane * 4;
        int4 v;
        v.x = base + before[r];
        v.y = v.x + __popc(w[r][0]);
        v.z = v.y + __popc(w[r][1]);
        v.w = v.z + __popc(w[r][2]);
        if (VEC && g >= row_lo && g + 4 <= row_hi) {
            *reinterpret_cast<int4*>(out + g) = v;
        } else {
            const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (g + j >= row_lo && g + j < row_hi) out[g + j] = e[j];
        }
    }
}

extern "C" int bgt_rank_cum_tile_words() { return TILE_WORDS; }

// words, out: [rows, nw]; scratch: 1 + rows * tiles_per_row 64-bit words, where
// tiles_per_row = ceil((nw + 3) / TILE_WORDS) (a row's first group may start up
// to three words before the row).
extern "C" int bgt_rank_cum(const void* words, void* out, void* scratch,
                            long long rows, long long nw,
                            long long tiles_per_row, void* stream) {
    if (rows > 0 && nw > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        const long long blocks = rows * tiles_per_row;
        cudaMemsetAsync(scratch, 0, (size_t)(1 + blocks) * 8, s);
        const uintptr_t in_at = reinterpret_cast<uintptr_t>(words);
        const uintptr_t out_at = reinterpret_cast<uintptr_t>(out);
        const bool vec = in_at % 16 == out_at % 16;
        const int lead = (int)((in_at % 16) / 4);
        auto kernel = vec ? rank_cum_kernel<true> : rank_cum_kernel<false>;
        kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
            (const uint32_t*)words, (int*)out, (unsigned long long*)scratch, nw,
            tiles_per_row, lead);
    }
    return (int)cudaGetLastError();
}
