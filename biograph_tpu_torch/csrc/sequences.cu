// The pop-chain walk of a batch of seqset entries in one launch: the first
// max_len bases of each entry, as Seqset.d.sequences gives them.  Replaces no
// TPU kernel: the JAX package walks the same chain as a lax.fori_loop
// (Seqset.sequences, biograph_tpu/index/seqset.py), which XLA fuses; the
// port's eager loop had been about eleven PyTorch operations a step.
//
//   out[q, i] = (e >= fixed[1]) + (e >= fixed[2]) + (e >= fixed[3]),
//   e = pop_sel[e] after each base,  e = entries[q] at i = 0
//
// With lengths, out[q, i] = 0 for i >= lengths[q] and the lane's walk stops
// there; without, every lane walks max_len bases, past its entry's end as the
// plain version does.
//
// What it reads and writes, a lane: its entry (8 bytes) and length (4), read
// once; one 8-byte pop_sel value a base but the last, each at a place only the
// value before it names; max_len bytes written once.  What bounds it: the
// gathers.  pop_sel, 8 bytes an entry, is larger than the 50 MB L2 at the
// sizes the port serves, so each gather moves a 32-byte sector from device
// memory, and each waits on the one before it.  933,334 reads of 150 bases
// are 140 M gathers, 4.5 GB of sectors and 140 MB of output: 1.4 ms at 3.35
// TB/s (H100 SXM), if enough chains are in flight to cover the latency.  The
// comparisons are nothing beside that.
//
// What the design does about it: one thread a lane and every lane in one
// launch, so that as many chains as the card holds wait at once; fixed's
// three bounds are held in registers.  A lane with a length stops gathering
// there.  The bases are collected in shared memory, a tile of LANES rows of
// the block's lanes, laid out as their rows of the output, and the tile is
// written out with 16-byte stores by neighbouring threads to neighbouring
// addresses: the block's rows are contiguous in the output.  A row longer
// than the tile allows (max_len > MAX_TILE / LANES) is walked in column
// chunks, each chunk's row pieces written byte by byte.  A gathered index
// outside [0, n) fails a device-side assert, as PyTorch's own indexing
// kernels do.
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

constexpr int LANES = 128;              // lanes (threads) a block
constexpr int MAX_TILE = 48 * 1024;     // bytes of the staging tile, at most

__device__ __forceinline__ bool inside(long long at, long long n) {
    return (unsigned long long)at < (unsigned long long)n;  // and at >= 0
}

// W: the columns a chunk, max_len itself wherever the tile holds a whole row
__global__ void __launch_bounds__(LANES)
sequences_kernel(const long long* __restrict__ pop_sel,
                 const long long* __restrict__ fixed,
                 const long long* __restrict__ entries,
                 const int* __restrict__ lengths,
                 unsigned char* __restrict__ out, long long n, long long B,
                 int max_len, int W) {
    extern __shared__ __align__(16) unsigned char tile[];  // [rows, w]
    const long long q0 = (long long)blockIdx.x * LANES;
    const int rows = (int)min((long long)LANES, B - q0);
    const int lane = threadIdx.x;
    const long long f1 = __ldg(fixed + 1), f2 = __ldg(fixed + 2),
                    f3 = __ldg(fixed + 3);
    long long e = 0;
    int len = 0;
    if (lane < rows) {
        e = __ldcs(entries + q0 + lane);
        len = lengths ? min(max(__ldcs(lengths + q0 + lane), 0), max_len)
                      : max_len;
    }
    for (int c0 = 0; c0 < max_len; c0 += W) {
        const int w = min(W, max_len - c0);
        unsigned char* row = tile + lane * w;
        for (int j = 0; j < w; ++j) {
            const int i = c0 + j;
            unsigned char base = 0;
            if (i < len) {
                base = (unsigned char)((e >= f1) + (e >= f2) + (e >= f3));
                if (i + 1 < len) {
                    assert(inside(e, n));
                    e = __ldg(pop_sel + e);
                }
            }
            if (lane < rows) row[j] = base;
        }
        __syncthreads();
        unsigned char* dst = out + q0 * max_len + c0;
        const int bytes = rows * w;
        if (w == max_len && ((uintptr_t)dst & 15) == 0) {
            // whole rows: the block's part of the output is one run
            const int vecs = bytes >> 4;
            for (int v = lane; v < vecs; v += LANES)
                __stcs((uint4*)dst + v, ((const uint4*)tile)[v]);
            for (int f = (vecs << 4) + lane; f < bytes; f += LANES)
                dst[f] = tile[f];
        } else {
            for (int f = lane; f < bytes; f += LANES)
                dst[(long long)(f / w) * max_len + f % w] = tile[f];
        }
        __syncthreads();
    }
}

extern "C" int bgt_sequences(const void* pop_sel, const void* fixed,
                             const void* entries, const void* lengths,
                             void* out, long long n, long long B, int max_len,
                             void* stream) {
    if (B > 0 && max_len > 0) {
        const int W = max_len < MAX_TILE / LANES ? max_len : MAX_TILE / LANES;
        const long long grid = (B + LANES - 1) / LANES;
        sequences_kernel<<<(unsigned)grid, LANES, LANES * W,
                           (cudaStream_t)stream>>>(
            (const long long*)pop_sel, (const long long*)fixed,
            (const long long*)entries, (const int*)lengths,
            (unsigned char*)out, n, B, max_len, W);
    }
    return (int)cudaGetLastError();
}
