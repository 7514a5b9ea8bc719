// K1: per-channel fake quantization (paper Eq. 3), quantize-clip-dequantize.
//
// Replaces: src/repro/kernels/fake_quant.py:fake_quant_kernel (Pallas, TPU).
//
// x is [R, C] f32, bf16 or f16 with the channel axis last, unit channel stride
// and a row stride ld >= C (a row-sliced view is read in place); the
// output is a fresh [R, C] tensor of x's dtype.  The dynamic range of
// channel c is reduced over all R rows.  Per channel:
//   span = max(max - min, 1e-8);  s = n / ((min + span) - min)
//   z = floor(s * min) + 2^(b-1);  q = clip(floor(s * x - z), -n, n)
//   xq = (q + z + 0.5) / s        with n = 2^b - 1, b = clip(bits, 1, 31)
// all in f32 on x converted exactly to f32.  The output is xq, or, in the
// straight-through mode, xf + (xq - xf): the forward value of the STE of
// core/quantization.py::fake_quant (the JAX package's too), each step one
// correctly rounded f32 op, then rounded once to x's dtype, as the TPU
// kernel writes out.astype(o_ref.dtype).  bits >= 32 copies x.  The
// arithmetic is that of the port's plain versions (kernels/ref.py::
// fake_quant_ref and fake_quant_ste_ref), written with the _rn intrinsics
// so nvcc cannot contract s * x - z into an FMA: floor() turns a one-ulp
// difference into a whole quantization step.  Build without
// --use_fast_math and without -ftz (subnormals are kept, as in PyTorch).
//
// Bound on the H100: bytes.  The function reads each element and writes
// each once: 8 bytes per element in f32, 4 in bf16 or f16, against 10 f32
// operations (12 straight-through); at [32768, 896] bf16 that is 117 MB,
// 35 us at 3.35 TB/s.  The correctly rounded division takes most of the
// instructions, which at these sizes comes near the SMs' issue rate.
//
// Design: the grid tiles x into (row slab x channel tile) blocks, the
// channel tile fastest, sized by kernels/fake_quant.py::plan: a tile is
// FQ_LANES threads of 16 bytes (32 f32 or 64 bf16 / f16 channels, one
// 128-byte line per row), so a 256-thread block walks 32 rows per step
// and keeps FQ_AHEAD steps of loads in flight before it uses any.  Enough
// slabs are cut to put several blocks on every SM, capped so that the
// fold below reads at most an eighth of a slab's own bytes.
//   pass 1 (fq_minmax): each block reduces min and max per channel over
//     its slab (shuffles, then the block's 8 warps through shared memory)
//     and writes them to a [2, n_slabs, C] f32 scratch;
//   pass 2 (fq_apply), the same grid: each block folds its channels'
//     partials (min and max are exact in any order, so the result is bit-
//     equal to the plain version), derives n, s, z per channel and
//     quantizes its slab, reading it again: from L2 where x fits (the
//     blocks run in reverse order, so the first ones find what pass 1
//     read last), else from device memory (12 bytes per f32 element, 6
//     per bf16, against the 8 and 4 of the bound).
// A plan with one slab (a few rows: decode's activations) takes one
// launch, fq_fused, that reduces in shared memory and quantizes the same
// rows.  16-byte vector loads need C and ld multiples of the vector and
// x on 16 bytes; any other view takes the scalar path of the same kernels
// (kernels/fake_quant.py decides per call).
//
// Policy slots (the batched validation, K policies at once; what vmap
// makes of the TPU kernel, which reads each policy's traced bits): x is
// [K, R, C] with a slot stride sld, and each slot is an independent
// instance of the function above: its own range over its own R rows, its
// own bits (clipped to [1, 31]; >= 32 copies the slot), written to slot k
// of a contiguous [K, R, C] output.  The K bits travel by value in the
// kernels' parameters (SlotBits, at most FQ_MAX_SLOTS), so the launch
// needs no device copy.  The grid gains a slot axis (blockIdx.y), so K
// slots fill the card where one slab grid of a single slot did not.  A
// slot stride of 0 means one tensor, a weight, shared by every slot: its
// range is the same for all of them, so pass 1 runs once (the smallest
// bits stand for all: only whether any slot quantizes matters there) and
// pass 2 applies it K times at each slot's bits.  A single [R, C] tensor
// is the case K = 1; a launch of one slot (or pass 1 of a shared range)
// takes one int (OneBits), so its kernels are the one-tensor kernels,
// with no table to carry and no slot to find.
//
// Device bits (the fused engine's epoch graph, whose policies never leave
// the card; what the TPU kernel does with its bits_ref): the K bits are
// a [K] int32 array on the card that each block reads for its slot
// (DevBits).  The host knows nothing of their values, so what the
// host-bits entry decides from them comes from the shapes alone: the
// grid is plan(R, C, itemsize, K)'s, the scratch is sized for the worst
// case (every slot quantizing), a shared range is always reduced, and a
// slot at >= 32 bits is copied by the kernel itself (pass 1 skips it,
// pass 2 or the fused kernel copies it).  The arithmetic and the grid are
// those of the slot form, so the two entries agree bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#define FQ_THREADS 256
#define FQ_LANES 8                          // threads per row segment
#define FQ_ROWS (FQ_THREADS / FQ_LANES)     // rows per block step: 32
#define FQ_WARPS (FQ_THREADS / 32)
#define FQ_AHEAD 4                          // block steps loaded ahead
#define FQ_MAX_SLOTS 64                     // policy slots per launch

// The bits of each slot, passed by value in the kernel's parameters: one
// int where the launch has one slot (or one range to reduce), else a
// table of FQ_MAX_SLOTS.
struct OneBits {
    static constexpr bool ONE = true;       // one slot: blockIdx.y is 0
    int b;
    __device__ __forceinline__ int operator[](int) const { return b; }
};
struct SlotBits {
    static constexpr bool ONE = false;
    int b[FQ_MAX_SLOTS];
    __device__ __forceinline__ int operator[](int k) const { return b[k]; }
};

struct DevBits {
    static constexpr bool ONE = false;
    const int* p;                           // [K] int32 on the card
    __device__ __forceinline__ int operator[](int k) const { return p[k]; }
};

template <typename T> struct Vec;           // elements of T in 16 bytes
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct Vec<__half> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
    *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_f32(float v, __half* o) {
    *o = __float2half_rn(v);
}

// A thread's N consecutive channels of one row, raw.  VEC: one 16-byte
// load (the caller guarantees alignment and that the N channels are all
// live or all dead); else one load per live channel.
template <typename T, bool VEC>
struct Row {
    static constexpr int N = Vec<T>::N;
    alignas(16) T v[N];
    __device__ __forceinline__ void load(const T* __restrict__ p, int live) {
        if (VEC) {
            *reinterpret_cast<uint4*>(v) =
                __ldg(reinterpret_cast<const uint4*>(p));
        } else {
#pragma unroll
            for (int i = 0; i < N; ++i)
                if (i < live) v[i] = p[i];
        }
    }
    __device__ __forceinline__ void store(T* __restrict__ p, int live) const {
        if (VEC) {
            *reinterpret_cast<uint4*>(p) =
                *reinterpret_cast<const uint4*>(v);
        } else {
#pragma unroll
            for (int i = 0; i < N; ++i)
                if (i < live) p[i] = v[i];
        }
    }
};

// Where a block and its thread sit: channel tile, row slab, first
// channel and live channel count of the thread, first row.
struct Place {
    int c0, live, r0, r1, row;
};

template <typename T>
__device__ __forceinline__ Place place(int block, int n_ctiles, int R,
                                       int C, int slab_rows) {
    constexpr int N = Vec<T>::N;
    Place p;
    const int ct = block % n_ctiles, slab = block / n_ctiles;
    p.c0 = ct * FQ_LANES * N + (threadIdx.x % FQ_LANES) * N;
    p.live = max(0, min(N, C - p.c0));
    p.r0 = slab * slab_rows;
    p.r1 = min(R, p.r0 + slab_rows);
    p.row = p.r0 + threadIdx.x / FQ_LANES;
    return p;
}

// min and max of each of the thread's channels over its rows of the
// slab, FQ_AHEAD steps of loads in flight.
template <typename T, bool VEC>
__device__ __forceinline__ void slab_minmax(const T* __restrict__ x,
                                            long long ld, const Place& p,
                                            float* mn, float* mx) {
    constexpr int N = Vec<T>::N;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        mn[i] = INFINITY;
        mx[i] = -INFINITY;
    }
    if (p.live == 0) return;
    for (int r = p.row; r < p.r1; r += FQ_ROWS * FQ_AHEAD) {
        Row<T, VEC> v[FQ_AHEAD];
#pragma unroll
        for (int a = 0; a < FQ_AHEAD; ++a)
            if (r + a * FQ_ROWS < p.r1)
                v[a].load(x + (size_t)(r + a * FQ_ROWS) * ld + p.c0, p.live);
#pragma unroll
        for (int a = 0; a < FQ_AHEAD; ++a)
            if (r + a * FQ_ROWS < p.r1)
#pragma unroll
                for (int i = 0; i < N; ++i)
                    if (i < p.live) {
                        const float f = to_f32(v[a].v[i]);
                        mn[i] = fminf(mn[i], f);
                        mx[i] = fmaxf(mx[i], f);
                    }
    }
}

// Fold the block's per-thread min / max into lo[] / hi[] (one per channel
// of the tile, in shared memory): lanes of one channel within a warp by
// shuffles, then the warps through shared memory.
template <typename T>
__device__ __forceinline__ void block_minmax(float* mn, float* mx,
                                             float (*s_mn)[FQ_LANES * 8],
                                             float (*s_mx)[FQ_LANES * 8],
                                             float* lo, float* hi) {
    constexpr int N = Vec<T>::N;
    constexpr int TILE = FQ_LANES * N;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int off = FQ_LANES; off < 32; off *= 2) {
            mn[i] = fminf(mn[i], __shfl_xor_sync(0xffffffffu, mn[i], off));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
        }
    if (lane < FQ_LANES)
#pragma unroll
        for (int i = 0; i < N; ++i) {
            s_mn[warp][lane * N + i] = mn[i];
            s_mx[warp][lane * N + i] = mx[i];
        }
    __syncthreads();
    if (threadIdx.x < TILE) {
        float a = s_mn[0][threadIdx.x], b = s_mx[0][threadIdx.x];
        for (int w = 1; w < FQ_WARPS; ++w) {
            a = fminf(a, s_mn[w][threadIdx.x]);
            b = fmaxf(b, s_mx[w][threadIdx.x]);
        }
        lo[threadIdx.x] = a;
        hi[threadIdx.x] = b;
    }
}

// n, s, z of each channel of the tile from its range (in place: lo[]
// becomes s, hi[] becomes z), in the plain version's order.
template <typename T>
__device__ __forceinline__ void channel_scales(float* lo, float* hi,
                                               int bits) {
    constexpr int TILE = FQ_LANES * Vec<T>::N;
    if (threadIdx.x < TILE) {
        const int b = bits < 1 ? 1 : (bits > 31 ? 31 : bits);
        const float n = __fsub_rn(exp2f((float)b), 1.0f);  // exact
        const float half = exp2f((float)(b - 1));
        const float mn = lo[threadIdx.x], mx = hi[threadIdx.x];
        const float span = fmaxf(__fsub_rn(mx, mn), 1e-8f);
        const float s = __fdiv_rn(n, __fsub_rn(__fadd_rn(mn, span), mn));
        lo[threadIdx.x] = s;
        hi[threadIdx.x] = __fadd_rn(floorf(__fmul_rn(s, mn)), half);
    }
    __syncthreads();
}

__device__ __forceinline__ float quantize(float xf, float s, float z,
                                          float n, int ste) {
    float q = floorf(__fsub_rn(__fmul_rn(s, xf), z));
    q = fminf(fmaxf(q, -n), n);
    const float xq = __fdiv_rn(__fadd_rn(__fadd_rn(q, z), 0.5f), s);
    return ste ? __fadd_rn(xf, __fsub_rn(xq, xf)) : xq;
}

// Quantize the thread's rows of the slab with the tile's s[] / z[]
// (bits >= 32: copy).
template <typename T, bool VEC>
__device__ __forceinline__ void slab_apply(const T* __restrict__ x,
                                           T* __restrict__ out, long long ld,
                                           int C, const Place& p,
                                           const float* s_s,
                                           const float* s_z, int bits,
                                           int ste) {
    constexpr int N = Vec<T>::N;
    if (p.live == 0) return;
    const bool copy = bits >= 32;
    const int b = bits < 1 ? 1 : (bits > 31 ? 31 : bits);
    const float n = __fsub_rn(exp2f((float)b), 1.0f);
    const int cl = p.c0 % (FQ_LANES * N);
    float s[N], z[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        s[i] = copy ? 1.0f : s_s[cl + i];
        z[i] = copy ? 0.0f : s_z[cl + i];
    }
    for (int r = p.row; r < p.r1; r += FQ_ROWS * FQ_AHEAD) {
        Row<T, VEC> v[FQ_AHEAD];
#pragma unroll
        for (int a = 0; a < FQ_AHEAD; ++a)
            if (r + a * FQ_ROWS < p.r1)
                v[a].load(x + (size_t)(r + a * FQ_ROWS) * ld + p.c0, p.live);
#pragma unroll
        for (int a = 0; a < FQ_AHEAD; ++a) {
            if (r + a * FQ_ROWS >= p.r1) continue;
            if (!copy)
#pragma unroll
                for (int i = 0; i < N; ++i)
                    from_f32(quantize(to_f32(v[a].v[i]), s[i], z[i], n, ste),
                             &v[a].v[i]);
            v[a].store(out + (size_t)(r + a * FQ_ROWS) * C + p.c0, p.live);
        }
    }
}

// Pass 1: per (slab, channel tile) min and max of slot blockIdx.y, into
// part[slot][2][n_slabs][C].  A slot whose bits are >= 32 needs none.
template <typename T, bool VEC, typename Bits>
__global__ void __launch_bounds__(FQ_THREADS)
fq_minmax(const T* __restrict__ x, float* __restrict__ part, long long ld,
          long long sld, int R, int C, int n_ctiles, int slab_rows,
          const Bits bits) {
    constexpr int N = Vec<T>::N, TILE = FQ_LANES * N;
    __shared__ float s_mn[FQ_WARPS][FQ_LANES * 8], s_mx[FQ_WARPS][FQ_LANES * 8];
    __shared__ float lo[TILE], hi[TILE];
    const int slot = Bits::ONE ? 0 : blockIdx.y;
    if (bits[slot] >= 32) return;
    x += slot * sld;
    const int n_slabs = gridDim.x / n_ctiles;
    part += (size_t)slot * 2 * n_slabs * C;
    const Place p = place<T>(blockIdx.x, n_ctiles, R, C, slab_rows);
    float mn[N], mx[N];
    slab_minmax<T, VEC>(x, ld, p, mn, mx);
    block_minmax<T>(mn, mx, s_mn, s_mx, lo, hi);
    const int slab = blockIdx.x / n_ctiles;
    const int c = (blockIdx.x % n_ctiles) * TILE + threadIdx.x;
    if (threadIdx.x < TILE && c < C) {
        part[(size_t)slab * C + c] = lo[threadIdx.x];
        part[(size_t)(n_slabs + slab) * C + c] = hi[threadIdx.x];
    }
}

// Pass 2: fold the slot's partials (slot 0's where the range is shared)
// and quantize its slab at its own bits (>= 32: copy).
template <typename T, bool VEC, typename Bits>
__global__ void __launch_bounds__(FQ_THREADS)
fq_apply(const T* __restrict__ x, T* __restrict__ out,
         const float* __restrict__ part, long long ld, long long sld, int R,
         int C, int n_ctiles, int slab_rows, const Bits bits,
         int shared_range, int ste) {
    constexpr int N = Vec<T>::N, TILE = FQ_LANES * N;
    __shared__ float s_s[TILE], s_z[TILE];
    // pass 1's last blocks first, slots too
    const int slot = Bits::ONE ? 0 : gridDim.y - 1 - blockIdx.y;
    const int block = gridDim.x - 1 - blockIdx.x;
    const int b = bits[slot];
    x += slot * sld;
    out += (size_t)slot * R * C;
    const Place p = place<T>(block, n_ctiles, R, C, slab_rows);
    if (b < 32) {
        const int n_slabs = gridDim.x / n_ctiles;
        const int c0 = (block % n_ctiles) * TILE;
        part += (size_t)(shared_range ? 0 : slot) * 2 * n_slabs * C;
        // Fold every slab's partials of the tile's channels: min by the
        // first TILE threads, max by the next TILE (TILE <= 128).
        const int which = threadIdx.x / TILE, cc = threadIdx.x % TILE;
        if (which < 2 && c0 + cc < C) {
            const float* src = part + (size_t)which * n_slabs * C + c0 + cc;
            float v = src[0];
#pragma unroll 4
            for (int sl = 1; sl < n_slabs; ++sl) {
                const float w = src[(size_t)sl * C];
                v = which ? fmaxf(v, w) : fminf(v, w);
            }
            (which ? s_z : s_s)[cc] = v;
        }
        __syncthreads();
        channel_scales<T>(s_s, s_z, b);
    }
    slab_apply<T, VEC>(x, out, ld, C, p, s_s, s_z, b, ste);
}

// One slab per slot: reduce and quantize in one launch (>= 32: copy).
template <typename T, bool VEC, typename Bits>
__global__ void __launch_bounds__(FQ_THREADS)
fq_fused(const T* __restrict__ x, T* __restrict__ out, long long ld,
         long long sld, int R, int C, int n_ctiles, int slab_rows,
         const Bits bits, int ste) {
    constexpr int N = Vec<T>::N, TILE = FQ_LANES * N;
    __shared__ float s_mn[FQ_WARPS][FQ_LANES * 8], s_mx[FQ_WARPS][FQ_LANES * 8];
    __shared__ float lo[TILE], hi[TILE];
    const int slot = Bits::ONE ? 0 : blockIdx.y, b = bits[slot];
    x += slot * sld;
    out += (size_t)slot * R * C;
    const Place p = place<T>(blockIdx.x, n_ctiles, R, C, slab_rows);
    if (Bits::ONE || b < 32) {   // one slot is fused only below 32
        float mn[N], mx[N];
        slab_minmax<T, VEC>(x, ld, p, mn, mx);
        block_minmax<T>(mn, mx, s_mn, s_mx, lo, hi);
        __syncthreads();
        channel_scales<T>(lo, hi, b);
    }
    slab_apply<T, VEC>(x, out, ld, C, p, lo, hi, b, ste);
}

template <typename T, bool VEC, typename Bits>
static void launch_bits(const T* x, T* out, float* part, long long ld,
                        long long sld, int K, int R, int C, const Bits& tab,
                        int least, int ste, int n_slabs, int slab_rows,
                        int fused, cudaStream_t stream) {
    const int tile = FQ_LANES * Vec<T>::N;
    const int n_ctiles = (C + tile - 1) / tile;
    const dim3 grid(n_ctiles * n_slabs, K);
    const int shared_range = sld == 0;
    if (least >= 32) {
        fq_apply<T, VEC, Bits><<<grid, FQ_THREADS, 0, stream>>>(
            x, out, nullptr, ld, sld, R, C, n_ctiles, slab_rows, tab, 1, ste);
    } else if (fused) {
        fq_fused<T, VEC, Bits><<<grid, FQ_THREADS, 0, stream>>>(
            x, out, ld, sld, R, C, n_ctiles, slab_rows, tab, ste);
    } else {
        // a shared range is reduced once, under the smallest bits
        if (shared_range)
            fq_minmax<T, VEC, OneBits><<<grid.x, FQ_THREADS, 0, stream>>>(
                x, part, ld, sld, R, C, n_ctiles, slab_rows, OneBits{least});
        else
            fq_minmax<T, VEC, Bits><<<grid, FQ_THREADS, 0, stream>>>(
                x, part, ld, sld, R, C, n_ctiles, slab_rows, tab);
        fq_apply<T, VEC, Bits><<<grid, FQ_THREADS, 0, stream>>>(
            x, out, part, ld, sld, R, C, n_ctiles, slab_rows, tab,
            shared_range, ste);
    }
}

template <typename T, bool VEC>
static int launch(const void* x, void* out, float* part, long long ld,
                  long long sld, int K, int R, int C, const int* bits,
                  int ste, int n_slabs, int slab_rows, int fused,
                  cudaStream_t stream) {
    if (K < 1 || K > FQ_MAX_SLOTS) return (int)cudaErrorInvalidValue;
    int least = 32;
    for (int k = 0; k < K; ++k) least = bits[k] < least ? bits[k] : least;
    if (least < 32 && fused && n_slabs != 1)
        return (int)cudaErrorInvalidValue;
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    if (K == 1) {
        launch_bits<T, VEC>(xt, ot, part, ld, sld, K, R, C, OneBits{bits[0]},
                            least, ste, n_slabs, slab_rows, fused, stream);
    } else {
        SlotBits tab;
        for (int k = 0; k < K; ++k) tab.b[k] = bits[k];
        launch_bits<T, VEC>(xt, ot, part, ld, sld, K, R, C, tab, least, ste,
                            n_slabs, slab_rows, fused, stream);
    }
    return (int)cudaGetLastError();
}

// x [K, R, C] (slot stride sld, row stride ld elements; sld 0: one tensor
// shared by every slot) f32 (dtype 0), bf16 (1) or f16 (2); out [K, R, C]
// contiguous, same dtype; bits: K host ints (K <= FQ_MAX_SLOTS); part:
// (sld ? K : 1) * 2 * n_slabs * C floats of scratch (unused with one slab
// or every bits >= 32).  vec: x on 16 bytes, C, ld and sld multiples of
// the 16-byte vector.  fused: one launch (n_slabs == 1).
template <typename T>
static int launch_as(const void* x, void* out, float* part, long long ld,
                     long long sld, int K, int R, int C, const int* bits,
                     int ste, int n_slabs, int slab_rows, int vec, int fused,
                     cudaStream_t s) {
    return vec ? launch<T, true>(x, out, part, ld, sld, K, R, C, bits, ste,
                                 n_slabs, slab_rows, fused, s)
               : launch<T, false>(x, out, part, ld, sld, K, R, C, bits, ste,
                                  n_slabs, slab_rows, fused, s);
}

extern "C" int fake_quant_slots_launch(const void* x, void* out, float* part,
                                       long long ld, long long sld, int K,
                                       int R, int C, const int* bits,
                                       int dtype, int ste, int n_slabs,
                                       int slab_rows, int vec, int fused,
                                       void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case 0: return launch_as<float>(x, out, part, ld, sld, K, R, C, bits,
                                        ste, n_slabs, slab_rows, vec, fused,
                                        s);
        case 1: return launch_as<__nv_bfloat16>(x, out, part, ld, sld, K, R,
                                                C, bits, ste, n_slabs,
                                                slab_rows, vec, fused, s);
        case 2: return launch_as<__half>(x, out, part, ld, sld, K, R, C, bits,
                                         ste, n_slabs, slab_rows, vec, fused,
                                         s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Device bits: x, out, part, ld, sld, K, R, C as fake_quant_slots_launch;
// bits: a [K] int32 array on the card (any K the grid's y axis holds);
// part: (sld ? K : 1) * 2 * n_slabs * C floats unless fused (n_slabs 1).
template <typename T, bool VEC>
static int launch_dev(const void* x, void* out, float* part, long long ld,
                      long long sld, int K, int R, int C, const int* bits,
                      int ste, int n_slabs, int slab_rows, int fused,
                      cudaStream_t stream) {
    if (K < 1 || K > 65535 || (fused && n_slabs != 1))
        return (int)cudaErrorInvalidValue;
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    const int tile = FQ_LANES * Vec<T>::N;
    const int n_ctiles = (C + tile - 1) / tile;
    const dim3 grid(n_ctiles * n_slabs, K);
    const DevBits tab{bits};
    if (fused) {
        fq_fused<T, VEC, DevBits><<<grid, FQ_THREADS, 0, stream>>>(
            xt, ot, ld, sld, R, C, n_ctiles, slab_rows, tab, ste);
    } else {
        const int shared_range = sld == 0;
        if (shared_range)   // one range for every slot, whatever its bits
            fq_minmax<T, VEC, OneBits><<<grid.x, FQ_THREADS, 0, stream>>>(
                xt, part, ld, sld, R, C, n_ctiles, slab_rows, OneBits{1});
        else
            fq_minmax<T, VEC, DevBits><<<grid, FQ_THREADS, 0, stream>>>(
                xt, part, ld, sld, R, C, n_ctiles, slab_rows, tab);
        fq_apply<T, VEC, DevBits><<<grid, FQ_THREADS, 0, stream>>>(
            xt, ot, part, ld, sld, R, C, n_ctiles, slab_rows, tab,
            shared_range, ste);
    }
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_dev_as(const void* x, void* out, float* part, long long ld,
                         long long sld, int K, int R, int C, const int* bits,
                         int ste, int n_slabs, int slab_rows, int vec,
                         int fused, cudaStream_t s) {
    return vec ? launch_dev<T, true>(x, out, part, ld, sld, K, R, C, bits,
                                     ste, n_slabs, slab_rows, fused, s)
               : launch_dev<T, false>(x, out, part, ld, sld, K, R, C, bits,
                                      ste, n_slabs, slab_rows, fused, s);
}

extern "C" int fake_quant_slots_dev_launch(const void* x, void* out,
                                           float* part, long long ld,
                                           long long sld, int K, int R,
                                           int C, const int* bits,
                                           int dtype, int ste, int n_slabs,
                                           int slab_rows, int vec, int fused,
                                           void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case 0: return launch_dev_as<float>(x, out, part, ld, sld, K, R, C,
                                            bits, ste, n_slabs, slab_rows,
                                            vec, fused, s);
        case 1: return launch_dev_as<__nv_bfloat16>(x, out, part, ld, sld, K,
                                                    R, C, bits, ste, n_slabs,
                                                    slab_rows, vec, fused, s);
        case 2: return launch_dev_as<__half>(x, out, part, ld, sld, K, R, C,
                                             bits, ste, n_slabs, slab_rows,
                                             vec, fused, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// One [R, C] tensor: the case K = 1.
extern "C" int fake_quant_launch(const void* x, void* out, float* part,
                                 long long ld, int R, int C, int bits,
                                 int dtype, int ste, int n_slabs,
                                 int slab_rows, int vec, int fused,
                                 void* stream) {
    return fake_quant_slots_launch(x, out, part, ld, 0, 1, R, C, &bits,
                                   dtype, ste, n_slabs, slab_rows, vec,
                                   fused, stream);
}
