// K7 as it stood before its single-pass redesign: three launches (chunk
// states, carry pass, chunk outputs), a and b read twice. Kept only as the
// parent arm of tools/k7_ablation.py and as the bit-for-bit yardstick of the
// chained kernel (csrc/rglru_scan.cu) at the same chunk; nothing on the
// port's path builds it.
//
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
// Design: the channels are independent, so each thread owns one channel
// and a warp reads 32 neighbouring channels of one token (coalesced along
// C).  Walking all S tokens in order per channel would give
// B * C / 128 blocks (20 at batch 1 and C 2560) for 132 SMs, so the walk
// is cut into chunks of L tokens (the two-pass form):
//   1. lru_chunk_state, grid (C/128, NC, B): each chunk walked from a zero
//      state, writing its end state and the product of its a's;
//   2. lru_carry_pass, grid (C/128, B): per channel, a walk over the NC
//      chunks in order, writing the state ENTERING each chunk
//      (carry <- prod * carry + end, from h0);
//   3. lru_chunk_out, grid (C/128, NC, B): each chunk walked again from its
//      true entering state, writing h.
// a and b are read twice and h written once (about 1.7 GB at the prefill
// shape, ~1.7x the single-pass bound); the scratch is 3 x B x NC x C
// floats.  The loads of a chunk do not depend on the state, so the
// unrolled walks keep several tokens' loads in flight per thread.  A
// ragged S (a short last chunk) and C (idle threads) are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define LRU_THREADS 128

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

// Pass 1: grid (ceil(C / 128), NC, B).
template <typename T>
__global__ void __launch_bounds__(LRU_THREADS)
lru_chunk_state(const T* __restrict__ a, const T* __restrict__ b,
                float* __restrict__ hend, float* __restrict__ prod, int S,
                int C, int L, int NC) {
    const int c = blockIdx.x * LRU_THREADS + threadIdx.x;
    const int k = blockIdx.y, bb = blockIdx.z;
    if (c >= C) return;
    const long long t0 = (long long)k * L;
    const int n = (int)min((long long)L, (long long)S - t0);
    const long long base = ((long long)bb * S + t0) * C + c;
    const T* ap = a + base;
    const T* bp = b + base;
    float h = 0.0f, p = 1.0f;
#pragma unroll 8
    for (int t = 0; t < n; ++t) {
        const float at = to_f32(ap[(long long)t * C]);
        const float bt = to_f32(bp[(long long)t * C]);
        h = __fadd_rn(__fmul_rn(at, h), bt);
        p = __fmul_rn(p, at);
    }
    const long long o = ((long long)bb * NC + k) * C + c;
    hend[o] = h;
    prod[o] = p;
}

// Pass 2: grid (ceil(C / 128), B).
__global__ void __launch_bounds__(LRU_THREADS)
lru_carry_pass(const float* __restrict__ hend,
               const float* __restrict__ prod, const float* __restrict__ h0,
               float* __restrict__ hin, int C, int NC) {
    const int c = blockIdx.x * LRU_THREADS + threadIdx.x;
    const int bb = blockIdx.y;
    if (c >= C) return;
    float carry = h0 != nullptr ? h0[(long long)bb * C + c] : 0.0f;
    const long long base = (long long)bb * NC * C + c;
#pragma unroll 8
    for (int k = 0; k < NC; ++k) {
        const long long o = base + (long long)k * C;
        hin[o] = carry;
        carry = __fadd_rn(__fmul_rn(prod[o], carry), hend[o]);
    }
}

// Pass 3: grid (ceil(C / 128), NC, B).
template <typename T>
__global__ void __launch_bounds__(LRU_THREADS)
lru_chunk_out(const T* __restrict__ a, const T* __restrict__ b,
              const float* __restrict__ hin, T* __restrict__ h, int S, int C,
              int L, int NC) {
    const int c = blockIdx.x * LRU_THREADS + threadIdx.x;
    const int k = blockIdx.y, bb = blockIdx.z;
    if (c >= C) return;
    const long long t0 = (long long)k * L;
    const int n = (int)min((long long)L, (long long)S - t0);
    const long long base = ((long long)bb * S + t0) * C + c;
    const T* ap = a + base;
    const T* bp = b + base;
    T* hp = h + base;
    float x = hin[((long long)bb * NC + k) * C + c];
#pragma unroll 8
    for (int t = 0; t < n; ++t) {
        const float at = to_f32(ap[(long long)t * C]);
        const float bt = to_f32(bp[(long long)t * C]);
        x = __fadd_rn(__fmul_rn(at, x), bt);
        hp[(long long)t * C] = from_f32<T>(x);
    }
}

template <typename T>
static int launch(const void* a, const void* b, const void* h0, void* h,
                  float* hend, float* prod, float* hin, int B, int S, int C,
                  int L, cudaStream_t stream) {
    const int NC = (S + L - 1) / L;
    const int cb = (C + LRU_THREADS - 1) / LRU_THREADS;
    const T* ta = static_cast<const T*>(a);
    const T* tb = static_cast<const T*>(b);
    lru_chunk_state<T><<<dim3(cb, NC, B), LRU_THREADS, 0, stream>>>(
        ta, tb, hend, prod, S, C, L, NC);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lru_carry_pass<<<dim3(cb, B), LRU_THREADS, 0, stream>>>(
        hend, prod, static_cast<const float*>(h0), hin, C, NC);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lru_chunk_out<T><<<dim3(cb, NC, B), LRU_THREADS, 0, stream>>>(
        ta, tb, hin, static_cast<T*>(h), S, C, L, NC);
    return (int)cudaGetLastError();
}

// a, b, h: [B, S, C] contiguous; h0: [B, C] f32 or null; hend, prod, hin:
// scratch of B * ceil(S / L) * C floats each.
extern "C" int rglru_scan_launch(const void* a, const void* b,
                                 const void* h0, void* h, void* hend,
                                 void* prod, void* hin, int B, int S, int C,
                                 int L, int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    float* e = static_cast<float*>(hend);
    float* p = static_cast<float*>(prod);
    float* i = static_cast<float*>(hin);
    return bf16 ? launch<__nv_bfloat16>(a, b, h0, h, e, p, i, B, S, C, L, s)
                : launch<float>(a, b, h0, h, e, p, i, B, S, C, L, s);
}
