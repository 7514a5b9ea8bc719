// K7: the RG-LRU diagonal linear recurrence h_t = a_t ⊙ h_{t-1} + b_t over
// a, b [B, S, C] (f32 or bf16, the same for both), from h0 [B, C] (f32; zero
// when absent), f32 inside, h [B, S, C] written in a's dtype.
//
// Replaces: src/repro/kernels/rglru_scan.py:_rglru_kernel (Pallas, TPU).
//
// The Pallas kernel walks time blocks in order per (batch, channel block)
// with the state vector in VMEM scratch: one read of a and b and one write
// of h.  Every step here is one correctly rounded multiply and one
// correctly rounded add (__fmul_rn, __fadd_rn: no contraction into an
// FMA), in the order of the plain version (ref.rglru_scan_ref), so a
// sequence of one chunk equals it bit for bit.
//
// Bound on the H100: bytes.  Two f32 operations per element against 12
// bytes (a and b read, h written once, f32): at the recurrentgemma-2b
// prefill (B 1, S 32768, C 2560) 1.01 GB, 0.30 ms at 3.35 TB/s; the
// operations (0.17 GFLOP) are nothing beside that.
//
// Design: one launch, a chained single-pass scan that reads a and b once
// and writes h once.  The channels are independent, so a tile is one chunk
// of L tokens x one slab of W channels (one thread each, W = blockDim.x;
// the wrapper's plan takes 128, so at L 128 in f32 a tile is 128 KB and
// each SM holds one) x one batch row.  A block:
//   1. takes its tile from an atomic ticket, not from blockIdx: tickets go
//      chunk by chunk, so the tile before it in its slab (chunk k - 1) was
//      handed to a running block before it, and the wait in 3 cannot
//      deadlock whatever order the card starts blocks in;
//   2. copies its tile of a and b into shared memory once (16-byte
//      cp.async in LRU_GROUPS groups of tokens, so the walk starts on the
//      first group while the rest arrive; a scalar copy where C or the
//      pointers are not on 16 bytes);
//   3. per channel, walks the chunk from a zero state to its end state
//      and product of a, waits for the state leaving chunk k - 1 (the
//      chain), and publishes the state leaving chunk k, carry <- prod *
//      carry + end: the step and order of the former carry pass, so h
//      equals the former three-launch kernel (chunk states, carry pass,
//      chunk outputs, a and b read twice) bit for bit at the same L;
//   4. walks the chunk again from shared memory, from the entering state,
//      and writes h.
// A state is published as one 64-bit word: the call's epoch in the high
// half, the f32 state's bits in the low, stored and polled at gpu scope,
// so a value and its flag arrive together and a word left by an earlier
// call (an older epoch) is never taken.  Each thread waits only for its
// own channel: no barrier in the chain.  The wrapper passes a new epoch
// per call, and the block that draws the last ticket sets the ticket back
// to zero, so calls need no memset between them.  A wait that outlasts
// LRU_SPIN_CYCLES traps (a launch failure) instead of hanging the card.
// The scratch is (NC - 1) x B x C state words and the ticket.  A ragged S
// (a short last chunk) and C (idle threads) are masked.
// tools/k7_ablation.py times each choice taken back (slab, chunk, load
// groups, TMA bulk copies, the wait) beside the three-launch kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define LRU_MAX_THREADS 256
#define LRU_GROUPS 4
#define LRU_SPIN_CYCLES (1LL << 35)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Until at most LRU_GROUPS - 1 - g groups of this thread's copies are in
// flight, i.e. groups 0..g have landed.
static_assert(LRU_GROUPS >= 1 && LRU_GROUPS <= 4, "wait_groups' cases");
__device__ __forceinline__ void wait_groups(int g) {
    switch (LRU_GROUPS - 1 - g) {
        case 0: cp_wait<0>(); break;
        case 1: cp_wait<1>(); break;
        case 2: cp_wait<2>(); break;
        default: cp_wait<3>(); break;
    }
}

__device__ __forceinline__ unsigned long long poll_word(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ void publish_word(unsigned long long* p,
                                             unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n"
                 :: "l"(p), "l"(v) : "memory");
}

// Whether a state word was published by this call.
__device__ __forceinline__ bool fresh(unsigned long long v, unsigned epoch) {
    return (unsigned)(v >> 32) == epoch;
}

// The state leaving chunk k - 1 of this (batch row, channel), once the
// word carries this call's epoch.
__device__ __forceinline__ float wait_state(const unsigned long long* w,
                                            unsigned epoch) {
    unsigned long long v = poll_word(w);
    if (!fresh(v, epoch)) {
        const long long start = clock64();
        do {
            if (clock64() - start > LRU_SPIN_CYCLES) __trap();
            v = poll_word(w);
        } while (!fresh(v, epoch));
    }
    return __uint_as_float((unsigned)v);
}

// Grid: one block per tile; blockDim.x = W channels; dynamic shared
// memory 2 * L * W elements of T (the tile's a, then its b).
template <typename T>
__global__ void __launch_bounds__(LRU_MAX_THREADS)
lru_chained(const T* __restrict__ a, const T* __restrict__ b,
            const float* __restrict__ h0, T* __restrict__ h,
            unsigned long long* __restrict__ words,
            unsigned* __restrict__ ticket, int B, int S, int C, int L,
            int n_slabs, unsigned epoch, int vec) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ unsigned s_tile;
    const int W = blockDim.x, tid = threadIdx.x;
    T* sa = reinterpret_cast<T*>(smem);
    T* sb = sa + (long long)L * W;
    if (tid == 0) {
        const unsigned t = atomicAdd(ticket, 1u);
        if (t == gridDim.x - 1) atomicExch(ticket, 0u);
        s_tile = t;
    }
    __syncthreads();
    const int per_chunk = B * n_slabs;
    const int k = (int)(s_tile / per_chunk);
    const int rem = (int)(s_tile % per_chunk);
    const int bb = rem / n_slabs, c0 = (rem % n_slabs) * W;
    const int c = c0 + tid;
    const bool active = c < C;
    const long long t0 = (long long)k * L;
    const int n = (int)min((long long)L, (long long)S - t0);
    const long long base = ((long long)bb * S + t0) * C;
    const int per_group = (L + LRU_GROUPS - 1) / LRU_GROUPS;

    if (vec) {
        // Thread tid copies the 16-byte column v of rows tid / lanes,
        // + W / lanes, ...: a warp covers whole rows of the slab.
        constexpr int V = 16 / sizeof(T);
        const int lanes = W / V, v = (tid % lanes) * V;
        const bool in_c = c0 + v < C;
        for (int g = 0; g < LRU_GROUPS; ++g) {
            const int r1 = min(n, (g + 1) * per_group);
            for (int r = g * per_group + tid / lanes; in_c && r < r1;
                 r += W / lanes) {
                const long long src = base + (long long)r * C + c0 + v;
                cp_async16(sa + r * W + v, a + src);
                cp_async16(sb + r * W + v, b + src);
            }
            cp_commit();
        }
    } else if (active) {
        for (int r = 0; r < n; ++r) {
            sa[r * W + tid] = a[base + (long long)r * C + c];
            sb[r * W + tid] = b[base + (long long)r * C + c];
        }
    }

    float end = 0.0f, prod = 1.0f;
    for (int g = 0; g < LRU_GROUPS; ++g) {
        wait_groups(g);
        __syncthreads();
        if (!active) continue;
        const int r1 = min(n, (g + 1) * per_group);
#pragma unroll 8
        for (int r = g * per_group; r < r1; ++r) {
            const float at = to_f32(sa[r * W + tid]);
            end = __fadd_rn(__fmul_rn(at, end), to_f32(sb[r * W + tid]));
            prod = __fmul_rn(prod, at);
        }
    }
    if (!active) return;

    float x;
    if (k == 0) {
        x = h0 != nullptr ? h0[(long long)bb * C + c] : 0.0f;
    } else {
        x = wait_state(words + ((long long)(k - 1) * B + bb) * C + c, epoch);
    }
    if (t0 + L < S) {
        const float out = __fadd_rn(__fmul_rn(prod, x), end);
        publish_word(words + ((long long)k * B + bb) * C + c,
                     ((unsigned long long)epoch << 32) | __float_as_uint(out));
    }

    T* hp = h + base + c;
#pragma unroll 8
    for (int r = 0; r < n; ++r) {
        x = __fadd_rn(__fmul_rn(to_f32(sa[r * W + tid]), x),
                      to_f32(sb[r * W + tid]));
        hp[(long long)r * C] = from_f32<T>(x);
    }
}

template <typename T>
static int launch(const void* a, const void* b, const void* h0, void* h,
                  void* words, void* ticket, int B, int S, int C, int L,
                  int W, unsigned epoch, cudaStream_t stream) {
    const int NC = (S + L - 1) / L;
    const int n_slabs = (C + W - 1) / W;
    const long long tiles = (long long)NC * B * n_slabs;
    const size_t smem = 2 * (size_t)L * W * sizeof(T);
    if (W < 32 || W > LRU_MAX_THREADS || W % 32 != 0 || tiles > 0x7fffffff)
        return (int)cudaErrorInvalidValue;
    static size_t smem_set = 48 * 1024;
    if (smem > smem_set) {
        cudaError_t err = cudaFuncSetAttribute(
            lru_chained<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    const int vec = C % (16 / (int)sizeof(T)) == 0
        && ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
    lru_chained<T><<<(unsigned)tiles, W, smem, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<const float*>(h0), static_cast<T*>(h),
        static_cast<unsigned long long*>(words),
        static_cast<unsigned*>(ticket), B, S, C, L, n_slabs, epoch, vec);
    return (int)cudaGetLastError();
}

// a, b, h: [B, S, C] contiguous; h0: [B, C] f32 or null; words: B *
// ceil(S / L) * C 64-bit state words, each zero or left by a call of an
// older epoch; ticket: one 32-bit counter, zero between calls; W: the
// slab's channels (threads per block, a multiple of 32, at most 256);
// epoch: non-zero, new for every call on these words.
extern "C" int rglru_scan_launch(const void* a, const void* b,
                                 const void* h0, void* h, void* words,
                                 void* ticket, int B, int S, int C, int L,
                                 int W, unsigned epoch, int bf16,
                                 void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    return bf16 ? launch<__nv_bfloat16>(a, b, h0, h, words, ticket, B, S,
                                        C, L, W, epoch, s)
                : launch<float>(a, b, h0, h, words, ticket, B, S, C, L, W,
                                epoch, s);
}
