// Discovery's beam step, a block of them in one launch: every lane of a beam
// group advanced by `steps` wavefront steps.  Replaces no TPU kernel: the JAX
// package ran the step as plain array code, which XLA fused into one device
// loop (biograph_tpu/variants/discover.py, the wavefront's while_loop and its
// block-fused programs).  The port stepped the same code one operator at a
// time from the host, some 88 device operations a step (the rank kernel
// push4, a flip, a stable argsort, the trunc-table gathers, two searchsorted
// and about twenty selects), and the card waited on the host.  This kernel is
// _wavefront_body (variants/discover.py) for `steps` steps, bit for bit:
//
//   children   push4's four children of the lane's range, with the kick
//   choice     columns flipped into alt-base order; W = end - begin a column;
//              n_viable = #(W >= min_w); the stable descending order of W,
//              the policy's bit (policy >> min(n_junction, 30)) & 1 taking
//              the second where n_viable > 1; ext = !done & W[best] >= min_w
//   update     n_junction, begin/end/size, path[lane, step] (one byte, only
//              where ext), path_len, support, roll, done
//   truncate   a range past probe_ctx widened through prev_lt / next_lt
//              (_SeqsetDevice.trunc_gather), done lanes included
//   rejoin     lower bound of roll in K, then of (run << 32 | min_local) in
//              key2; found below n_packed, on the same k-mer, inside the
//              2^pos_bits window; newly rejoined lanes set rejoin, out_len,
//              out_support and done
//
// The lane's state lives in registers over the block's steps: read once at
// the start, written back once, in place, into the state's own tensors (the
// port updates in place where the JAX package returned new arrays).  A done
// lane is truncated once if its size is past probe_ctx and is then a fixed
// point of the step, so its quad leaves the loop.
//
// What bounds it: a chain of dependent loads, not bytes or arithmetic.  A
// step of a lane asks for the rank lines of both range ends, then the kick's
// entry size, then two trunc-table entries, then two searches over span
// tables of up to 2^21 rows, each load waiting on the one before; at some
// hundreds of nanoseconds a load out of L2 or device memory a step costs some
// microseconds, whatever the lane count, up to the 16 384 lanes of a group
// (65 536 threads, all resident at once on the 132 SMs).
//
// What the design does about it: four threads a lane, one a pushed base, as
// push4.cu: the four children are ranked in parallel and warp shuffles inside
// the quad give every thread all four widths, so each picks `best` in the
// body's stable order without another load.  The quad searches K and key2
// together, 4 * PROBES keys a round spread evenly over the interval that is
// left: a (4 * PROBES + 1)-way search, 7 rounds over 2^21 rows where a binary
// search takes 21.  The trunc-table loads are issued before the searches and
// used after them, so their latency hides under the search's.  One thread of
// the quad writes; path costs one byte a lane a step.
#include <cstdint>
#include <cuda_runtime.h>

#include "rank_blocks.cuh"

constexpr int THREADS = 128;
constexpr int PROBES = 2;  // keys a thread reads in one round of a search
constexpr int SPLIT = 4 * PROBES + 1;

struct BeamArgs {
    const ulonglong2* blocks;
    const int* entry_sizes;
    const long long* fixed;
    const long long* prev_lt;
    const long long* next_lt;
    const long long* K;
    const long long* key2;
    const long long* n_packed;
    long long* begin;
    long long* end;
    int* size;
    unsigned char* path;
    int* path_len;
    long long* support;
    int* n_junction;
    long long* roll;
    bool* done;
    const int* policy;
    const long long* min_local;
    long long* rejoin;
    int* out_len;
    long long* out_support;
    long long nblk, n, npk, lanes, step0, steps, maxp, k, min_w, probe_ctx,
        pos_bits;
};

// The first row i of table[0, rows) with table[i] >= x (rows if none), as
// torch.searchsorted gives it.  The four threads of a quad (t its thread,
// `mask` its bits in the warp) search together: probe g = 4i + t of a round
// lies at lo + len * (g + 1) / SPLIT, non-decreasing in g, so the probes
// below x are the first c of them and the answer lies past probe c - 1 and at
// or before probe c.
__device__ __forceinline__ long long quad_lower_bound(
    const long long* __restrict__ table, long long rows, long long x, int t,
    unsigned mask, int shift) {
    long long lo = 0, hi = rows;
    while (lo < hi) {
        const long long len = hi - lo;
        int c = 0;
#pragma unroll
        for (int i = 0; i < PROBES; ++i) {
            const long long p = lo + len * (4 * i + t + 1) / SPLIT;
            const bool below = table[p] < x;
            c += __popc((__ballot_sync(mask, below) >> shift) & 0xFu);
        }
        const long long next_lo = c > 0 ? lo + len * c / SPLIT + 1 : lo;
        if (c < 4 * PROBES) hi = lo + len * (c + 1) / SPLIT;
        lo = next_lo;
    }
    return lo;
}

// thread t works on base t % 4 of lane t / 4
__global__ void __launch_bounds__(THREADS) beam_steps_kernel(BeamArgs a) {
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long q = t >> 2;
    if (q >= a.lanes) return;  // the whole quad leaves
    const int b = (int)(t & 3);
    const int shift = threadIdx.x & 28;  // the quad's first thread in the warp
    const unsigned mask = 0xFu << shift;
    const long long last_word = a.nblk * BLOCK_WORDS - 1;
    const long long kmask = (long long)((1ull << (2 * a.k)) - 1ull);
    const long long window = 1ll << a.pos_bits;
    const long long n_packed = *a.n_packed;
    const long long fixed_b = a.fixed[b];
    const int policy = a.policy[q];
    const long long min_local = a.min_local[q];
    long long q_low = min_local < 0 ? 0 : min_local;
    if (q_low > 0xFFFFFFFFll) q_low = 0xFFFFFFFFll;

    long long begin = a.begin[q], end = a.end[q], support = a.support[q];
    long long roll = a.roll[q], rejoin = a.rejoin[q], out_support = a.out_support[q];
    int size = a.size[q], path_len = a.path_len[q], n_junction = a.n_junction[q];
    int out_len = a.out_len[q];
    bool done = a.done[q];

    for (long long step = a.step0; step < a.step0 + a.steps; ++step) {
        if (done) {
            // nothing but the truncation moves a done lane; after it the lane
            // is a fixed point of the step
            if (size > a.probe_ctx) {
                const long long wb = a.prev_lt[begin < 0 ? 0 : (begin < a.n ? begin : a.n - 1)];
                end = end >= a.n ? a.n : a.next_lt[end < 0 ? 0 : end];
                begin = wb < 0 ? 0 : wb;
                size = (int)a.probe_ctx;
            }
            break;
        }
        // child of base b (push4_kernel's arithmetic)
        long long nb = begin, ne = begin;
        if (begin < end) {
            uint32_t k0, r0, k1, r1;
            locate_in_blocks(begin, last_word, &k0, &r0);
            locate_in_blocks(end, last_word, &k1, &r1);
            const ulonglong2* at0 = block_at(a.blocks, b, k0);
            const ulonglong2 a0 = at0[0], c0 = at0[1];
            ulonglong2 a1 = a0, c1 = c0;
            if (k1 != k0) {
                const ulonglong2* at1 = block_at(a.blocks, b, k1);
                a1 = at1[0];
                c1 = at1[1];
            }
            nb = fixed_b + rank_in_block(a0, c0, r0);
            ne = fixed_b + rank_in_block(a1, c1, r1);
            if (nb < ne) {
                const long long at = nb < a.n - 1 ? nb : a.n - 1;
                nb += a.entry_sizes[at] < size + 1;
            }
        }
        // column j holds base 3 - j: thread 3 - j of the quad
        long long W[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            W[j] = __shfl_sync(mask, ne - nb, shift + 3 - j, 32);
        int n_viable = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) n_viable += W[j] >= a.min_w;
        // the stable descending order's first two columns: ties go to the
        // lower column
        int first = 0;
#pragma unroll
        for (int j = 1; j < 4; ++j)
            if (W[j] > W[first]) first = j;
        int second = first == 0 ? 1 : 0;
#pragma unroll
        for (int j = 1; j < 4; ++j)
            if (j != first && W[j] > W[second]) second = j;
        const int nj = n_junction < 30 ? n_junction : 30;
        const int take = n_viable > 1 ? (policy >> nj) & 1 : 0;
        const int best = take ? second : first;
        const long long bw = W[best];
        const bool ext = bw >= a.min_w;
        n_junction += n_viable > 1;
        const int base = ext ? best : 0;
        const long long cb = __shfl_sync(mask, nb, shift + 3 - base, 32);
        const long long ce = __shfl_sync(mask, ne, shift + 3 - base, 32);
        if (ext) {
            begin = cb;
            end = ce;
            size += 1;
        }
        // truncation: its loads are used only after the searches below
        const bool need = size > a.probe_ctx;
        long long wb = 0, we = 0;
        if (need) {
            wb = a.prev_lt[begin < 0 ? 0 : (begin < a.n ? begin : a.n - 1)];
            we = end >= a.n ? a.n : a.next_lt[end < 0 ? 0 : end];
        }
        if (ext) {
            if (b == 0) a.path[q * a.maxp + step] = (unsigned char)base;
            path_len = (int)step + 1;
            support = bw < support ? bw : support;
            roll = ((roll << 2) | base) & kmask;
        } else {
            done = true;
        }
        if (ext && path_len > a.k) {
            const long long run = quad_lower_bound(a.K, a.npk, roll, b, mask, shift);
            const long long idx =
                quad_lower_bound(a.key2, a.npk, (run << 32) | q_low, b, mask, shift);
            const long long idxc = idx < a.npk - 1 ? idx : a.npk - 1;
            const long long jpos = a.key2[idxc] & 0xFFFFFFFFll;
            const long long ahead =
                (long long)((unsigned long long)jpos - (unsigned long long)min_local);
            const bool found = idx < n_packed && a.K[idxc] == roll && ahead < window;
            if (found && rejoin < 0) {
                done = true;
                rejoin = jpos;
                out_len = path_len;
                out_support = support;
            }
        }
        if (need) {
            begin = wb < 0 ? 0 : wb;
            end = we;
            size = (int)a.probe_ctx;
        }
    }
    if (b != 0) return;
    a.begin[q] = begin;
    a.end[q] = end;
    a.size[q] = size;
    a.path_len[q] = path_len;
    a.support[q] = support;
    a.n_junction[q] = n_junction;
    a.roll[q] = roll;
    a.done[q] = done;
    a.rejoin[q] = rejoin;
    a.out_len[q] = out_len;
    a.out_support[q] = out_support;
}

extern "C" int bgt_beam_steps_block_words() { return BLOCK_WORDS; }

extern "C" int bgt_beam_steps(
    const void* blocks, const void* entry_sizes, const void* fixed,
    const void* prev_lt, const void* next_lt, const void* K, const void* key2,
    const void* n_packed, void* begin, void* end, void* size, void* path,
    void* path_len, void* support, void* n_junction, void* roll, void* done,
    const void* policy, const void* min_local, void* rejoin, void* out_len,
    void* out_support, long long nblk, long long n, long long npk,
    long long lanes, long long step0, long long steps, long long maxp,
    long long k, long long min_w, long long probe_ctx, long long pos_bits,
    void* stream) {
    if (lanes > 0 && steps > 0) {
        BeamArgs a{(const ulonglong2*)blocks, (const int*)entry_sizes,
                   (const long long*)fixed, (const long long*)prev_lt,
                   (const long long*)next_lt, (const long long*)K,
                   (const long long*)key2, (const long long*)n_packed,
                   (long long*)begin, (long long*)end, (int*)size,
                   (unsigned char*)path, (int*)path_len, (long long*)support,
                   (int*)n_junction, (long long*)roll, (bool*)done,
                   (const int*)policy, (const long long*)min_local,
                   (long long*)rejoin, (int*)out_len, (long long*)out_support,
                   nblk, n, npk, lanes, step0, steps, maxp, k, min_w, probe_ctx,
                   pos_bits};
        const long long grid = (4 * lanes + THREADS - 1) / THREADS;
        beam_steps_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(a);
    }
    return (int)cudaGetLastError();
}
