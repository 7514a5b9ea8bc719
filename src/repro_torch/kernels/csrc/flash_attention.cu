// K6: GQA attention with an online softmax (flash attention), causal,
// bidirectional or sliding-window, over q [B, H, S, D] and k, v
// [B, KV, S, D]; q head h reads kv head h / G with G = H / KV.
//
// Replaces: src/repro/kernels/flash_attention.py:_flash_kernel (Pallas, TPU).
//
// Per row of q, over tiles of keys in order (m the running max, l the
// running sum, acc the output accumulator, all f32):
//   s = (q . k) * scale, masked to NEG_INF where kpos >= S, or (causal)
//       kpos > qpos, or (window > 0) kpos <= qpos - window
//   m' = max(m, max s);  alpha = exp(m - m');  p = exp(s - m')
//   l = l * alpha + sum p;  acc = acc * alpha + round_v(p) . v;  m = m'
//   out = acc / max(l, 1e-30), rounded to the input dtype
// as the Pallas kernel computes it: scores in f32, p rounded to v's dtype
// before the P.V product (p.astype(v.dtype)), l summed from the unrounded
// p.  NEG_INF is the finite -1e30 of the Pallas kernel, never -INFINITY:
// a row whose tile is wholly masked gets p = exp(0) = 1 there while m
// stays -1e30, and the first tile with a real key has alpha =
// exp(-1e30 - m') = 0, which wipes that exactly; with -inf the same row
// would compute exp(-inf + inf) = NaN.  Tiles that lie wholly above the
// diagonal (causal) or wholly before every row's window are skipped: for
// a row that has seen a real key they add p = 0 exactly, and for one that
// has not, their contribution is wiped by alpha = 0 as above, so the
// result is the same as visiting them.
//
// Bound on the H100: operations.  Causal attention does 2*B*H*D*S^2 f32
// FMA-flops (half of Q.K^T plus half of P.V): 1.93 TFLOP per call at
// qwen2-0.5b's prefill (B 1, H 14, KV 2, S 32768, D 64), 1.95 ms at the
// 989 TFLOP/s bf16 tensor-core peak; it reads q, k, v and writes the
// output once, ~134 MB in bf16, 0.04 ms at 3.35 TB/s.  With a window only
// the kept pairs count: 0.67 TFLOP at recurrentgemma-2b's (B 1, H 10, KV
// 1, S 32768, D 256, window 2048), 0.68 ms.
//
// Design: one block of 128 threads per (BQ-row q tile, q head, batch),
// BQ x BK = 64 x 64 up to D 128 and 32 x 32 at D 256 (FaTile).  The q
// tile and each BK-key K and V tile are staged in shared memory as f32
// (read with element strides, so q/k/v may be the [B,S,H,D] layer layout
// seen through a transpose, and the ragged S edge is masked, no padding).
// Thread (ty, tx), ty < 8, tx < 16, holds the scores of rows ty + 8i
// (i < RI = BQ/8) x keys tx + 16j (j < KJ = BK/16) and the output of rows
// ty + 8i x columns tx*D/16 .. +D/16: an RIxKJ register micro-tile of f32
// FMAs for Q.K^T and an RIx(D/16) one for P.V, with the rounded P tile
// passed through shared memory.  At D 256 the 64 x 64 tiles would stage
// 220 KB (one block per SM) and hold 128 f32 accumulators per thread
// (spilled); the 32 x 32 tiles stage 104 KB (two blocks per SM) and hold
// 64.  Row statistics reduce over the 16 lanes of a
// half-warp with shuffles.  Row strides of the f32 tiles (D + 4, 80) keep
// the float4 reads free of bank conflicts.  Causal grids start with the
// q tiles that have the most keys.  The products run on the CUDA cores,
// not the tensor cores (mma.sync / wgmma and TMA are later work), so the
// kernel cannot come near the bf16 bound: 67 TFLOP/s is the f32 ceiling.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#define FA_THREADS 128
#define FA_NEG_INF (-1e30f)

struct Strides {
    long long b, h, s, d;
};

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

template <int D> struct FaTile {
    static constexpr int BQ = D > 128 ? 32 : 64;   // q rows per block
    static constexpr int BK = D > 128 ? 32 : 64;   // keys per tile
    static constexpr int RI = BQ / 8;              // q rows per thread
    static constexpr int KJ = BK / 16;             // keys per thread
    static constexpr int LD = D + 4;
    static constexpr int LDP = BK + 16;
    static constexpr int FLOATS = (BQ + 2 * BK) * LD + BQ * LDP;
};

template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          Strides st, int s0, int S) {
    constexpr int LD = D + 4;
    for (int i = threadIdx.x; i < ROWS * D; i += FA_THREADS) {
        const int r = i / D, c = i % D;
        const int s = s0 + r;
        dst[r * LD + c] = s < S ? to_f32(src[s * st.s + c * st.d]) : 0.0f;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides qs, Strides ks, Strides vs, Strides os, int G,
                       int S, float scale, int causal, int window) {
    using Tile = FaTile<D>;
    constexpr int BQ = Tile::BQ, BK = Tile::BK, RI = Tile::RI, KJ = Tile::KJ;
    constexpr int LD = Tile::LD;
    constexpr int LDP = Tile::LDP;
    constexpr int NC = D / 16;
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;
    float* Ks = Qs + BQ * LD;
    float* Vs = Ks + BK * LD;
    float* Ps = Vs + BK * LD;

    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int h = blockIdx.y, b = blockIdx.z;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + (h / G) * ks.h;
    const T* vb = v + b * vs.b + (h / G) * vs.h;
    T* ob = o + b * os.b + h * os.h;

    load_tile<T, D, BQ>(Qs, qb, qs, q0, S);

    float m[RI], l[RI], acc[RI][NC];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        m[i] = FA_NEG_INF;
        l[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
    }

    const int k_end = causal ? min(S, q0 + BQ) : S;
    const int k_begin =
        window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;

    for (int k0 = k_begin; k0 < k_end; k0 += BK) {
        __syncthreads();   // the previous tile's readers are done
        load_tile<T, D, BK>(Ks, kb, ks, k0, S);
        load_tile<T, D, BK>(Vs, vb, vs, k0, S);
        __syncthreads();

        float s[RI][KJ];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < KJ; ++j) s[i][j] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            float4 kf[KJ];
#pragma unroll
            for (int j = 0; j < KJ; ++j)
                kf[j] = *reinterpret_cast<const float4*>(
                    &Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
            for (int i = 0; i < RI; ++i) {
                const float4 qf = *reinterpret_cast<const float4*>(
                    &Qs[(ty + 8 * i) * LD + d]);
#pragma unroll
                for (int j = 0; j < KJ; ++j) {
                    float a = s[i][j];
                    a = fmaf(qf.x, kf[j].x, a);
                    a = fmaf(qf.y, kf[j].y, a);
                    a = fmaf(qf.z, kf[j].z, a);
                    a = fmaf(qf.w, kf[j].w, a);
                    s[i][j] = a;
                }
            }
        }

#pragma unroll
        for (int i = 0; i < RI; ++i) {
            const int qpos = q0 + ty + 8 * i;
            float mx = FA_NEG_INF;
#pragma unroll
            for (int j = 0; j < KJ; ++j) {
                const int kpos = k0 + tx + 16 * j;
                bool ok = kpos < S;
                if (causal) ok = ok && kpos <= qpos;
                if (window > 0) ok = ok && kpos > qpos - window;
                s[i][j] = ok ? s[i][j] * scale : FA_NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float rs = 0.0f;
#pragma unroll
            for (int j = 0; j < KJ; ++j) {
                const float p = expf(s[i][j] - m_new);
                rs += p;
                Ps[(ty + 8 * i) * LDP + tx + 16 * j] =
                    to_f32(from_f32<T>(p));
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[i] = l[i] * alpha + rs;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();

#pragma unroll 2
        for (int kk = 0; kk < BK; kk += 4) {
            float4 pf[RI];
#pragma unroll
            for (int i = 0; i < RI; ++i)
                pf[i] = *reinterpret_cast<const float4*>(
                    &Ps[(ty + 8 * i) * LDP + kk]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float vv[NC];
                const float* vrow = &Vs[(kk + e) * LD + tx * NC];
                if constexpr (NC % 4 == 0) {
#pragma unroll
                    for (int c = 0; c < NC; c += 4) {
                        const float4 t =
                            *reinterpret_cast<const float4*>(vrow + c);
                        vv[c] = t.x; vv[c + 1] = t.y;
                        vv[c + 2] = t.z; vv[c + 3] = t.w;
                    }
                } else {
#pragma unroll
                    for (int c = 0; c < NC; ++c) vv[c] = vrow[c];
                }
#pragma unroll
                for (int i = 0; i < RI; ++i) {
                    const float p = e == 0 ? pf[i].x : e == 1 ? pf[i].y
                                  : e == 2 ? pf[i].z : pf[i].w;
#pragma unroll
                    for (int c = 0; c < NC; ++c)
                        acc[i][c] = fmaf(p, vv[c], acc[i][c]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
        const int qpos = q0 + ty + 8 * i;
        if (qpos >= S) continue;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int c = 0; c < NC; ++c)
            ob[qpos * os.s + (tx * NC + c) * os.d] =
                from_f32<T>(acc[i][c] / den);
    }
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, void* o,
                  const long long* st, int B, int H, int KV, int S,
                  float scale, int causal, int window, cudaStream_t stream) {
    const int smem = FaTile<D>::FLOATS * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const Strides qs{st[0], st[1], st[2], st[3]};
    const Strides ks{st[4], st[5], st[6], st[7]};
    const Strides vs{st[8], st[9], st[10], st[11]};
    const Strides os{st[12], st[13], st[14], st[15]};
    constexpr int BQ = FaTile<D>::BQ;
    dim3 grid((S + BQ - 1) / BQ, H, B);
    flash_attention_kernel<T, D><<<grid, FA_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os,
        H / KV, S, scale, causal, window);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(const void* q, const void* k, const void* v, void* o,
                    const long long* st, int B, int H, int KV, int S, int D,
                    float scale, int causal, int window, cudaStream_t s) {
    switch (D) {
        case 16: return launch<T, 16>(q, k, v, o, st, B, H, KV, S, scale,
                                      causal, window, s);
        case 32: return launch<T, 32>(q, k, v, o, st, B, H, KV, S, scale,
                                      causal, window, s);
        case 64: return launch<T, 64>(q, k, v, o, st, B, H, KV, S, scale,
                                      causal, window, s);
        case 128: return launch<T, 128>(q, k, v, o, st, B, H, KV, S, scale,
                                        causal, window, s);
        case 256: return launch<T, 256>(q, k, v, o, st, B, H, KV, S, scale,
                                        causal, window, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// strides: 16 element strides, (b, h, s, d) of q, k, v and the output.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B, int H,
                                      int KV, int S, int D, int bf16,
                                      float scale, int causal, int window,
                                      void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, strides, B, H, KV, S,
                                          D, scale, causal, window, s)
                : launch_d<float>(q, k, v, o, strides, B, H, KV, S, D, scale,
                                  causal, window, s);
}
