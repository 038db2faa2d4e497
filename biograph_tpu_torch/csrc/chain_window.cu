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
// What bounds it: 32-byte sectors requested through L1/L2, not device-memory
// bytes and not arithmetic.  The rank structure and the entry sizes of a
// seqset sit in L2, every lane's chain is a string of dependent random reads,
// and enough lanes are resident to hide their latency, so the time follows
// the number of sectors a step asks for.  Against the structure as stored a
// step asks for five (a word and a count for each range end, and a size).
//
// What the design does about it: the kernel reads the rank structure only
// through the rank-block table (ops/rank4.py, build_rank_blocks).  A block
// is one aligned 32-byte sector: an int64 count of the set bits before the
// block, then six 32-bit words (192 entries); the layout is rank_blocks.cuh's.
// rank_b(p) needs block p / 192 and nothing else, so a step asks for one
// sector for `begin`, one for `end` and none when both fall in one block
// (after a dozen pushes the range is narrow and they nearly always do), and
// one for the size: two or three instead of five.  Words past the structure
// are zero and the blocks there carry the totals, so p == 32*nw needs no
// special case; a word index past the table is clamped to its last word.
//
// One thread per lane, the whole chain in registers, depth a run-time bound.
// The window row is fetched 16 bytes at a time (one load per 16 steps) when
// rows start on 16-byte boundaries, and byte by byte otherwise.  A lane whose
// range has become empty leaves the loop.
#include <cstdint>
#include <cuda_runtime.h>

#include "rank_blocks.cuh"

constexpr int THREADS = 128;

template <bool VEC16>
__global__ void __launch_bounds__(THREADS)
chain_window_kernel(const ulonglong2* __restrict__ blocks,
                    const int* __restrict__ sizes,
                    const long long* __restrict__ fixed,
                    const uint8_t* __restrict__ win, const int* __restrict__ m,
                    long long* __restrict__ out_begin,
                    long long* __restrict__ out_end, int* __restrict__ out_size,
                    long long nblk, long long n, long long P, int depth) {
    __shared__ long long s_fixed[4];
    if (threadIdx.x < 4) s_fixed[threadIdx.x] = fixed[threadIdx.x];
    __syncthreads();
    const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= P) return;
    const uint8_t* row = win + q * depth;
    int first_step = depth - m[q];
    if (first_step < 0) first_step = 0;
    const long long last_word = nblk * BLOCK_WORDS - 1;
    long long begin = 0, end = n;
    int size = 0;
    bool alive = true;

    for (int s0 = first_step & ~15; alive && s0 < depth; s0 += 16) {
        uint32_t chunk[4] = {0u, 0u, 0u, 0u};  // 16 window bases, one a byte
        if (VEC16) {
            const uint4 v = *reinterpret_cast<const uint4*>(row + s0);
            chunk[0] = v.x; chunk[1] = v.y; chunk[2] = v.z; chunk[3] = v.w;
        } else {
#pragma unroll
            for (int i = 0; i < 16; ++i)
                if (s0 + i < depth)
                    chunk[i >> 2] |= (uint32_t)row[s0 + i] << (8 * (i & 3));
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int s = s0 + i;
            if (s < first_step || s >= depth) continue;
            if (begin >= end) {
                end = begin;
                alive = false;
                break;
            }
            const int b = (chunk[i >> 2] >> (8 * (i & 3))) & 3;
            uint32_t kb, ke, rb, re;
            locate_in_blocks(begin, last_word, &kb, &rb);
            locate_in_blocks(end, last_word, &ke, &re);
            const ulonglong2* at_b = block_at(blocks, b, kb);
            const ulonglong2 ab = at_b[0], cb = at_b[1];
            ulonglong2 ae = ab, ce = cb;
            if (ke != kb) {  // otherwise both ends share the sector just read
                const ulonglong2* at_e = block_at(blocks, b, ke);
                ae = at_e[0];
                ce = at_e[1];
            }
            const long long fb = s_fixed[b];
            long long nb = fb + rank_in_block(ab, cb, rb);
            const long long ne = fb + rank_in_block(ae, ce, re);
            const long long first = nb < 0 ? 0 : (nb > n - 1 ? n - 1 : nb);
            if (nb < ne && sizes[first] < size + 1) nb += 1;
            begin = nb;
            end = ne;
            size += 1;
        }
    }
    out_begin[q] = begin;
    out_end[q] = end;
    out_size[q] = size;
}

extern "C" int bgt_chain_window_block_words() { return BLOCK_WORDS; }

extern "C" int bgt_chain_window(const void* blocks, const void* sizes,
                                const void* fixed, const void* win,
                                const void* m, void* out_begin, void* out_end,
                                void* out_size, long long nblk, long long n,
                                long long P, int depth, void* stream) {
    if (P > 0) {
        const long long grid = (P + THREADS - 1) / THREADS;
        const bool vec16 =
            depth % 16 == 0 && reinterpret_cast<uintptr_t>(win) % 16 == 0;
        auto kernel =
            vec16 ? chain_window_kernel<true> : chain_window_kernel<false>;
        kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
            (const ulonglong2*)blocks, (const int*)sizes,
            (const long long*)fixed, (const uint8_t*)win, (const int*)m,
            (long long*)out_begin, (long long*)out_end, (int*)out_size, nblk,
            n, P, depth);
    }
    return (int)cudaGetLastError();
}
