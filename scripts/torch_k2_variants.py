"""K2's two entries on one GPU: gather_sizes designs side by side, and where
the host time of a push_front call goes.

    python3 scripts/torch_k2_variants.py [OUT.json]

(1) The size gather at the main path's shape (960 000 indices into the
3 981 146 entry sizes of chip_smoke.py's scaled store; sizes and indices
made from seed 12345) by: the package's ``gather_sizes`` wrapper; kernels
compiled here that take 1 (the first port's design: one plain 8-byte load,
one gather, one 4-byte store), 2, 4 or 8 indices a thread, at 128 or 256
threads a block; and ``torch.index_select``.  Indices uniformly random and sorted.  Each variant
is checked equal to ``gather_sizes_plain`` first, then timed with CUDA
events over 50 launches queued behind a stall, the variants in turns
(forwards, then backwards) twice.  (2) The host cost of one ``push_front``,
``push4`` and ``rank`` wrapper call at 4096 ranges, and of push_front's
parts (the argument checks, the output allocations, the launch and the
pieces of it), each the mean of 2000 calls on the host clock.  The card's name
and power limit come first; one JSON line follows (also written to
OUT.json when given).
"""

import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ longlong2 load_indices(const longlong2* p) {
    longlong2 v;
    asm("ld.global.nc.L1::no_allocate.v2.s64 {%0, %1}, [%2];"
        : "=l"(v.x), "=l"(v.y) : "l"(p));
    return v;
}

__global__ void one_kernel(const int* __restrict__ sizes,
                           const long long* __restrict__ idx,
                           int* __restrict__ out, long long B) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < B) out[i] = sizes[idx[i]];
}

template <int PER>
__global__ void vec_kernel(const int* __restrict__ sizes,
                           const long long* __restrict__ idx,
                           int* __restrict__ out, long long groups) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         g < groups; g += stride) {
        long long at[PER];
#pragma unroll
        for (int j = 0; j < PER; j += 2) {
            const longlong2 v =
                load_indices((const longlong2*)(idx + g * PER + j));
            at[j] = v.x;
            at[j + 1] = v.y;
        }
        int v[PER];
#pragma unroll
        for (int j = 0; j < PER; ++j) v[j] = __ldg(sizes + at[j]);
        if (PER == 2) {
            __stcs((int2*)(out + g * PER), make_int2(v[0], v[1]));
        } else {
#pragma unroll
            for (int j = 0; j < PER; j += 4)
                __stcs((int4*)(out + g * PER + j),
                       make_int4(v[j], v[j + 1], v[j + 2], v[j + 3]));
        }
    }
}

extern "C" int launch_one(const void* sizes, const void* idx, void* out,
                          long long B, int threads, void* stream) {
    one_kernel<<<(unsigned)((B + threads - 1) / threads), threads, 0,
                 (cudaStream_t)stream>>>((const int*)sizes,
                                         (const long long*)idx, (int*)out, B);
    return (int)cudaGetLastError();
}

#define LAUNCH_VEC(PER)                                                      \
    extern "C" int launch_vec##PER(const void* sizes, const void* idx,       \
                                   void* out, long long B, int threads,      \
                                   void* stream) {                           \
        const long long groups = B / PER;                                    \
        vec_kernel<PER><<<(unsigned)((groups + threads - 1) / threads),      \
                          threads, 0, (cudaStream_t)stream>>>(               \
            (const int*)sizes, (const long long*)idx, (int*)out, groups);   \
        return (int)cudaGetLastError();                                      \
    }
LAUNCH_VEC(2)
LAUNCH_VEC(4)
LAUNCH_VEC(8)
"""


def build():
    from biograph_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "k2_variants.cu")
    lib = os.path.join(_build.BUILD_DIR, "libk2_variants.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src], check=True)
    return ctypes.CDLL(lib)


def main():
    import torch

    import chip_smoke as cs
    from biograph_tpu_torch.ops import _build, rank4 as rank4_ops
    from biograph_tpu_torch.ops import rank_cum as rank_cum_ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build_all()
    lib = build()
    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    n, B = 3_981_146, 960_000
    sizes = torch.randint(1, 101, (n,), device=dev, dtype=torch.int32, generator=g)
    stall = cs.make_stall(dev)
    out = {"card": card, "n": n, "indices": B, "bound_ms": B * 16 / cs.PEAK_BYTES_PER_S * 1e3}

    def variant(symbol, threads):
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]

        def run(idx):
            res = torch.empty(B, dtype=torch.int32, device=dev)
            code = fn(_build.ptr(sizes), _build.ptr(idx), _build.ptr(res), B, threads, ctypes.c_void_p(stream))
            if code:
                raise RuntimeError(f"{symbol}: error {code}")
            return res

        return run

    variants = {
        "wrapper": lambda idx: rank4_ops.gather_sizes(sizes, idx),
        "one_256": variant("launch_one", 256),
        "vec2_256": variant("launch_vec2", 256),
        "vec4_256": variant("launch_vec4", 256),
        "vec4_128": variant("launch_vec4", 128),
        "vec8_256": variant("launch_vec8", 256),
        "vec8_128": variant("launch_vec8", 128),
        "index_select": lambda idx: torch.index_select(sizes, 0, idx),
    }
    for kind in ("random", "sorted"):
        idx = torch.randint(0, n, (B,), device=dev, generator=g)
        if kind == "sorted":
            idx = idx.sort().values
        want = rank4_ops.gather_sizes_plain(sizes, idx)
        for name, fn in variants.items():
            cs.require_equal(f"{name} {kind}", fn(idx), want)
        times = {name: [] for name in variants}
        order = list(variants)
        for turn in (order, order[::-1], order, order[::-1]):
            for name in turn:
                times[name].append(cs.event_ms(lambda: variants[name](idx), 50, stall=stall))
        out[kind] = {name: {"ms": sorted(t)[len(t) // 2], "all_ms": t} for name, t in times.items()}

    # the host cost of a push_front and a push4 call, and of push_front's
    # parts, at 4096 ranges: a launch's device time is far below its host
    # time, so the queue never fills and the host clock sees the host's work
    nw = 124_412
    words = torch.randint(-(1 << 31), 1 << 31, (4, nw), dtype=torch.int32, device=dev, generator=g)
    cum = rank_cum_ops.rank_cum(words).to(torch.int64)
    blocks = rank4_ops.build_rank_blocks(words, cum)
    fixed = torch.tensor([0, n // 4, n // 2, 3 * n // 4, n], device=dev)
    R = 4096
    begin = torch.randint(0, n, (R,), device=dev, generator=g)
    end = (begin + torch.randint(0, 50, (R,), device=dev, generator=g)).clamp(max=n)
    size = torch.randint(0, 100, (R,), device=dev, dtype=torch.int32, generator=g)
    b = torch.randint(0, 4, (R,), device=dev, generator=g)
    args = (blocks, sizes, fixed, begin, end, size, b)
    cs.require_equal("push_front", rank4_ops.push_front(*args), rank4_ops.push_front_blocks_plain(*args))
    outs = (torch.empty_like(begin), torch.empty_like(end), torch.empty_like(size))
    tensors = (*args, *outs)
    argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    fn = _build.function("push_front", "bgt_push_front", argtypes)
    index = dev.index or 0
    ptrs = [_build.ptr(t) for t in tensors]
    stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ints = [t.data_ptr() for t in tensors]
    stream_int = torch.cuda.current_stream(dev).cuda_stream

    def host_us(fn, calls=2000):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        return seconds / calls * 1e6

    def launch_only():
        _build.launch("push_front", "bgt_push_front", argtypes[:-1], dev, *(_build.ptr(t) for t in tensors),
                      blocks.shape[0], n, R)

    def checks_only():
        rank4_ops._check_push("push_front", *args)
        {t.device.type for t in args}
        rank4_ops._check_cuda("push_front", begin, blocks, sizes, fixed, end, size, b)

    def device_context():
        with torch.cuda.device(dev):
            pass

    out["host_us"] = {
        "ranges": R,
        "push_front_call": host_us(lambda: rank4_ops.push_front(*args)),
        "push4_call": host_us(lambda: rank4_ops.push4(*args[:6])),
        "rank_call": host_us(lambda: rank4_ops.rank(blocks, b, begin, end)),
        "push_front_checks": host_us(checks_only),
        "push_front_allocs": host_us(lambda: (torch.empty_like(begin), torch.empty_like(end), torch.empty_like(size))),
        "push_front_launch": host_us(launch_only),
        "cuda_device_context": host_us(device_context),
        "current_device": host_us(torch.cuda.current_device),
        "stream_public": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
        "stream_raw": host_us(lambda: torch._C._cuda_getCurrentRawStream(index)),
        "ptr_objects": host_us(lambda: [_build.ptr(t) for t in tensors]),
        "data_ptr_ints": host_us(lambda: [t.data_ptr() for t in tensors]),
        "c_call_ptr_objects": host_us(lambda: fn(*ptrs, blocks.shape[0], n, R, stream_ptr)),
        "c_call_ints": host_us(lambda: fn(*ints, blocks.shape[0], n, R, stream_int)),
        "empty_launch_loop": host_us(lambda: None),
    }
    print(json.dumps(out), flush=True)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
