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
// Bound on the H100: operations.  Causal attention does 2*B*H*D*S^2
// flops (half of Q.K^T plus half of P.V): 1.93 TFLOP per call at
// qwen2-0.5b's prefill (B 1, H 14, KV 2, S 32768, D 64), 1.95 ms at the
// 989 TFLOP/s bf16 tensor-core peak; it reads q, k, v and writes the
// output once, ~134 MB in bf16, 0.04 ms at 3.35 TB/s.  With a window only
// the kept pairs count: 0.67 TFLOP at recurrentgemma-2b's (B 1, H 10, KV
// 1, S 32768, D 256, window 2048), 0.68 ms.
//
// Design: two routes, chosen by the wrapper (kernels/flash_attention.py,
// `route`) by dtype and head dim:
//
// "tc" -- bf16 at D 64, 80, 128, 256 (the head dims of every full-width
// config served), flash_attention_tc_kernel below: both products on the
// tensor cores with wgmma, K/V tiles fed by TMA, warp-specialised.  A
// D 80 row (160 bytes) is two boxes: 64 columns with the 128-byte
// swizzle and 16 with the 32-byte one.
//
// "simt" -- f32 at every head dim, and bf16 at D 16 and 32 (which occur
// only in the JAX tests' shapes), flash_attention_kernel: both products
// as f32 FMAs on the CUDA cores.  The tensor cores take f32 only as TF32
// (about 3 decimal digits), which would break the f32 parity of 2e-5, so
// f32 stays here; bf16 D 16 and 32 would need their own tile shapes for a
// route that no served model takes.  One block of 128 threads per
// (BQ-row q tile, q head, batch), BQ x BK = 64 x 64 up to D 128 and
// 32 x 32 at D 256 (FaTile).  The q tile and each BK-key K and V tile are
// staged in shared memory as f32 (read with element strides, so q/k/v
// may be the [B,S,H,D] layer layout seen through a transpose, and the
// ragged S edge is masked, no padding).  Thread (ty, tx), ty < 8,
// tx < 16, holds the scores of rows ty + 8i (i < RI = BQ/8) x keys
// tx + 16j (j < KJ = BK/16) and the output of rows ty + 8i x columns
// tx*D/16 .. +D/16: an RIxKJ register micro-tile of f32 FMAs for Q.K^T
// and an RIx(D/16) one for P.V, with the rounded P tile passed through
// shared memory.  Row statistics reduce over the 16 lanes of a half-warp
// with shuffles.  Row strides of the f32 tiles (D + 4, 80) keep the
// float4 reads free of bank conflicts (at D 80, 84 floats: eight rows
// land on eight distinct 4-bank groups).  At D 80 (f32) a thread's
// D/16 = 5 output columns are not a float4, so its P.V reads V by
// scalars.  Causal grids start with the q tiles that have the most keys.
// 67 TFLOP/s is this route's ceiling.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <type_traits>

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

// bf16 takes this route at D 16 and 32 only: at 64, 80, 128 and 256 it
// takes the tensor cores (fa_tc below), so no bf16 instantiation exists
// there.
template <typename T>
static int launch_d(const void* q, const void* k, const void* v, void* o,
                    const long long* st, int B, int H, int KV, int S, int D,
                    float scale, int causal, int window, cudaStream_t s) {
    switch (D) {
        case 16: return launch<T, 16>(q, k, v, o, st, B, H, KV, S, scale,
                                      causal, window, s);
        case 32: return launch<T, 32>(q, k, v, o, st, B, H, KV, S, scale,
                                      causal, window, s);
        default: break;
    }
    if constexpr (std::is_same<T, float>::value) {
        switch (D) {
            case 64: return launch<T, 64>(q, k, v, o, st, B, H, KV, S, scale,
                                          causal, window, s);
            case 80: return launch<T, 80>(q, k, v, o, st, B, H, KV, S, scale,
                                          causal, window, s);
            case 128: return launch<T, 128>(q, k, v, o, st, B, H, KV, S,
                                            scale, causal, window, s);
            case 256: return launch<T, 256>(q, k, v, o, st, B, H, KV, S,
                                            scale, causal, window, s);
            default: break;
        }
    }
    return (int)cudaErrorInvalidValue;
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

// ---------------------------------------------------------------------------
// The "tc" route: bf16 at D 64, 80, 128, 256 on the tensor cores.
//
// One block per (BM-row q tile, q head, batch) of NC + 1 warpgroups
// (NC = 3 at D 64 and 80, 2 at D 128 and 256; BM = 64 NC):
//   - warpgroup 0, the producer: gives up registers (setmaxnreg, 24 or
//     32 left) and one thread issues every TMA load -- the q tile once,
//     then the K and V tiles of BN keys through rings of STAGES buffers,
//     in the order the consumers take them (K of tile j, then V of tile
//     j - 1).  Each buffer has a "full" mbarrier (the TMA's byte count
//     completes it) and an "empty" one (every consumer thread arrives
//     when it has read the buffer: K when S is done, V when P.V is);
//   - warpgroups 1 .. NC, the consumers, 64 q rows each (up to 240 or
//     160 registers).  Per key tile: S = Q.K^T with wgmma m64nBNk16 from
//     shared memory (both operands K-major), the online softmax on the
//     f32 accumulator fragment, then O += P.V with wgmma m64nNk16, A = P
//     from registers (the S fragment packed in place into bf16 A
//     fragments: no trip through shared memory), B = V from shared memory
//     as MN-major (the transpose bit of 16-bit types: no transposed copy
//     of V).  S of tile j and P.V of tile j - 1 are in flight together,
//     and the softmax of j runs while P.V of j - 1 does; the consumers
//     issue their products in turn (round robin on named barriers), so
//     one's wgmma run beside the others' softmax.
//
// Tensor maps: 4-D maps for q, k, v and the output over (d, s, head,
// batch) with the tensors' own element strides, so the layer's [B,S,H,D]
// memory seen as [B,H,S,D] is read in place.  A tile of R rows is CH =
// D / 64 boxes of [R][64] (128-byte rows, the 128-byte swizzle) and, at
// D 80, one box of [R][16] (32-byte rows, the 32-byte swizzle) from a
// second map of each tensor, its columns 64 .. 79: 160-byte rows fit no
// one swizzled box, and padding them to 96 or 128 columns would cost
// 20-60% more MMA work and shared memory.  Each box is based on a
// multiple of its swizzle's period (1,024 and 256 bytes).  S at D 80 is
// 5 k-steps: 4 on the 64-column box, the 5th on the 16-column one; P.V
// is m64n64k16 into O's 64 columns and m64n16k16 into a second
// accumulator of 8 f32 a thread for the other 16.  TMA zero-fills rows
// past S (loads) and drops them (the output store); kpos < S still
// masks the scores.
//
// Fragment layout (m64nNk16, f32 accumulator, per warpgroup thread t,
// warp w = t / 32, lane l): d[4j + 2i + c] is row 16w + l/4 + 8i, column
// 8j + 2(l%4) + c.  So each thread holds two rows, each row lies on the
// four lanes of a quad (shuffles by 1 and 2 reduce it), and d[8kk ..
// 8kk+7] of the scores are exactly the bf16 A fragment of keys 16kk ..
// 16kk+15 for P.V.
//
// Softmax in base 2: scores are scaled by scale * log2(e) and exp2
// replaces exp; m, the mask's -1e30 and alpha carry over unchanged (a
// wholly masked row still gets exp2(0) = 1 and is wiped by alpha =
// exp2(-1e30 - m') = 0).  l is summed per thread over its own columns
// and reduced over the quad once, at the end.
//
// Work skipping as in the simt route: key tiles wholly above the
// diagonal or wholly before every row's window are never loaded.  A tile
// wholly masked for one consumer's 64 rows only (the last causal tile of
// the first consumer at BN 64, the first windowed tile of a later one)
// is computed: it adds p = 0 where a row has seen a key, and is wiped by
// alpha = 0 where not, as above.  Only tiles that straddle the diagonal,
// the window's edge or S are masked; interior tiles are only scaled.
// The grid walks heads fastest (the G q heads of one kv head run side by
// side, so its K/V tiles are read from L2), then q tiles from the
// heaviest (most keys) down.
//
// Tiles: BN = 128 keys at D 64 and 128, 96 at D 80, 64 at D 256 (its O
// accumulator is already 128 f32 registers a thread).  At D 80 a
// consumer's 160 registers hold S (48 f32 at BN 96), P (24) and O (40);
// at BN 128 (64 + 32 + 40) ptxas spills and serialises the wgmma.
// Shared memory: q 24 / 30 / 32 / 64 KB, K and V rings of 3 / 3 / 3 / 2
// stages, 96 / 90 / 192 / 128 KB; one block per SM.  The output goes
// through the consumer's own q rows in shared memory (its last read of
// them is done) and out by TMA stores, one a box.
#include <cuda.h>      // CUtensorMap and its enums (types only: no -lcuda)
#include <stdint.h>

namespace fa_tc {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int ENCODE_ERROR = 2000;   // + CUresult of a failed encode
constexpr int NO_ENCODE_ENTRY = 1999;

template <int D> struct Cfg {
    static constexpr int NC = D == 64 || D == 80 ? 3 : 2;  // consumer warpgroups
    static constexpr int BM = 64 * NC;              // q rows per block
    static constexpr int THREADS = 128 * (NC + 1);  // + the producer
    static constexpr int CONSUMERS = 128 * NC;
    // setmaxnreg: the producer gives registers to the consumers, within
    // the SM's 65,536 (launch: 65,536 / THREADS each)
    static constexpr int REG_PRODUCER = NC == 2 ? 24 : 32;
    static constexpr int REG_CONSUMER = NC == 2 ? 240 : 160;
    static constexpr int BN = D > 128 ? 64 : D == 80 ? 96 : 128;  // keys a tile
    static constexpr int STAGES = D > 128 ? 2 : 3;   // K/V ring depth
    static constexpr int CH = D / 64;               // 64-column boxes
    static constexpr int TAIL = D % 64;             // + one 16-column box
    static_assert(TAIL == 0 || TAIL == 16, "D: 64 k or 64 k + 16");
    static constexpr int Q_BYTES = BM * D * 2;
    static constexpr int KV_BYTES = BN * D * 2;     // one K or one V tile
    // + 256 for the mbarriers, + 1024 to round the base up to the
    // 1024-byte period of the 128-byte swizzle
    static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 256 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("{\n.reg .b64 st;\n"
                 "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("{\n.reg .b64 st;\n"
                 "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
                 :: "r"(bar) : "memory");
}

// Wait for the phase of `parity` to complete (the poll loop inside one
// asm block, as CUTLASS's ClusterBarrier::wait: a loop in C++ would be a
// branch the compiler cannot prove warp-uniform, and wgmma after it would
// be serialized).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile("{\n.reg .pred p;\n"
                 "LAB_WAIT:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
                 "@!p bra.uni LAB_WAIT;\n}\n"
                 :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int s, int h,
                                         int b) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d),
           "r"(s), "r"(h), "r"(b) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int d, int s, int h, int b) {
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
        " [%0, {%2, %3, %4, %5}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(d), "r"(s),
           "r"(h), "r"(b) : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, all in 16-byte units, and the swizzle in bits 62-63 (SW128,
// SW32).  128-byte swizzle, K-major (q, k): the leading offset is unused,
// the stride offset 1024 (8 rows of 128 bytes); MN-major (v): leading =
// the distance between 64-column boxes, stride = 1024 (8 keys).  32-byte
// swizzle (D 80's 16-column box): K-major stride 256 (8 rows of 32
// bytes); MN-major stride 256 (8 keys), and its 16 columns are one
// swizzle atom, so the leading offset is never stepped (the offsets of
// CUTLASS's make_gmma_desc for Layout_K_SW32_Atom / Layout_MN_SW32_Atom).
constexpr uint64_t SW128 = 1, SW32 = 3;
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swz) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
           | (static_cast<uint64_t>(lbo >> 4) << 16)
           | (static_cast<uint64_t>(sbo >> 4) << 32) | (swz << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving accumulator registers across the
// asynchronous wgmma (as CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// Each of a thread's two rows of an accumulator fragment times f[row].
template <int N>
__device__ __forceinline__ void scale_rows(float (&d)[N], const float (&f)[2]) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            d[4 * j + 2 * i] *= f[i];
            d[4 * j + 2 * i + 1] *= f[i];
        }
}

__device__ __forceinline__ void named_sync(uint32_t id, uint32_t threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(uint32_t id, uint32_t threads) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// 2^x on the special-function unit, subnormal results flushed to 0 (a p
// that small is 0 in bf16 as well).
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

template <int N> struct Mma;
template <> struct Mma<16> {
    // D (64 x 16, f32) += P (64 x 16, registers) . V (16 x 16, MN-major)
    __device__ __forceinline__ static void rs(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7 "
            "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};
template <> struct Mma<64> {
    // D (64 x 64, f32) (+)= Q (64 x 16) . K^T (16 x 64), both smem, K-major
    __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
            "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
            "%28, %29, %30, %31 "
            "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
              "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
              "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "l"(a), "l"(b), "r"(scale_d));
    }
    // D (64 x 64, f32) += P (64 x 16, registers) . V (16 x 64, MN-major)
    __device__ __forceinline__ static void rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
            "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
            "%28, %29, %30, %31 "
            "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
              "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
              "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};
template <> struct Mma<96> {
    // D (64 x 96, f32) (+)= Q (64 x 16) . K^T (16 x 96), both smem, K-major
    __device__ __forceinline__ static void ss(float (&d)[48], uint64_t a,
                                              uint64_t b, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
            "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
            "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
            "%41, %42, %43, %44, %45, %46, %47 "
            "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
              "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
              "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
              "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
              "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};
template <> struct Mma<128> {
    // D (64 x 128, f32) (+)= Q (64 x 16) . K^T (16 x 128), both smem, K-major
    __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
            "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
            "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
            "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
            "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
            "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
              "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
              "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
              "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
              "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
              "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
              "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(a), "l"(b), "r"(scale_d));
    }
    // D (64 x 128, f32) += P (64 x 16, registers) . V (16 x 128, MN-major)
    __device__ __forceinline__ static void rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
            "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
            "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
            "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
            "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
            "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
              "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
              "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
              "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
              "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
              "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
              "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};
template <> struct Mma<256> {
    // D (64 x 256, f32) += P (64 x 16, registers) . V (16 x 256, MN-major)
    __device__ __forceinline__ static void rs(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
            "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
            "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
            "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
            "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
            "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
            "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
            "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
            "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
            "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
            "%127 "
            "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
              "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
              "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
              "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
              "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
              "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
              "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
              "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
              "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
              "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
              "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
              "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
              "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
              "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
              "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
              "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
              "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
              "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
              "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
              "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
              "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
              "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap omap,
                          const __grid_constant__ CUtensorMap qtail,
                          const __grid_constant__ CUtensorMap ktail,
                          const __grid_constant__ CUtensorMap vtail,
                          const __grid_constant__ CUtensorMap otail, int H,
                          int G, int S, int n_qt, float scale_log2,
                          int causal, int window) {
    using C = Cfg<D>;
    constexpr int BM = C::BM, NC = C::NC, BN = C::BN, ST = C::STAGES;
    constexpr int CH = C::CH, TAIL = C::TAIL;
    constexpr float NEG = FA_NEG_INF;
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* const sQ_ptr = smem_raw + (base - raw);
    // A tile of R rows: CH boxes [R][64], then (TAIL) one [R][16] box at
    // CH * R * 128 bytes.
    const uint32_t sQ = base;                       // a tile of BM rows
    const uint32_t sK = sQ + C::Q_BYTES;            // ST tiles of BN rows
    const uint32_t sV = sK + ST * C::KV_BYTES;
    const uint32_t bar = sV + ST * C::KV_BYTES;
    const uint32_t q_full = bar;
    auto full_k = [&](int s) { return bar + 8u * (1 + s); };
    auto full_v = [&](int s) { return bar + 8u * (1 + ST + s); };
    auto empty_k = [&](int s) { return bar + 8u * (1 + 2 * ST + s); };
    auto empty_v = [&](int s) { return bar + 8u * (1 + 3 * ST + s); };

    const int bid = blockIdx.x;
    const int h = bid % H;
    const int qt = n_qt - 1 - (bid / H) % n_qt;     // heaviest tiles first
    const int b = bid / (H * n_qt);
    const int q0 = qt * BM;
    const int k_end = causal ? min(S, q0 + BM) : S;
    const int k_begin =
        window > 0 ? (max(0, q0 - window + 1) / BN) * BN : 0;
    const int n_kt = (k_end - k_begin + BN - 1) / BN;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < ST; ++s) {
            mbar_init(full_k(s), 1);
            mbar_init(full_v(s), 1);
            mbar_init(empty_k(s), C::CONSUMERS);
            mbar_init(empty_v(s), C::CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // The warpgroup index through a shuffle, so the compiler sees the role
    // branch as warp-uniform (setmaxnreg and wgmma need that).
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (wg == 0) {
        // ---- producer warpgroup: one thread issues every TMA load ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(C::REG_PRODUCER));
        if (threadIdx.x == 0) {
            const int kvh = h / G;
            // the tile of `rows` rows from s0: its CH boxes, then its tail
            auto load_tile = [&](uint32_t dst, const CUtensorMap* map,
                                 const CUtensorMap* tail, uint32_t full,
                                 int rows, int s0, int hh) {
#pragma unroll
                for (int c = 0; c < CH; ++c)
                    tma_load(dst + c * rows * 128, map, full, c * 64, s0, hh,
                             b);
                if constexpr (TAIL > 0)
                    tma_load(dst + CH * rows * 128, tail, full, CH * 64, s0,
                             hh, b);
            };
            mbar_expect_tx(q_full, C::Q_BYTES);
            load_tile(sQ, &qmap, &qtail, q_full, BM, q0, h);
            // In the order the consumers take them: K of tile it, then V
            // of tile it - 1 (P.V of it - 1 runs beside S of it).
            auto load = [&](const CUtensorMap* map, const CUtensorMap* tail,
                            uint32_t tiles, uint32_t full, uint32_t empty,
                            int it) {
                const int s = it % ST;
                mbar_wait(empty + 8u * s, ((it / ST) & 1) ^ 1);
                mbar_expect_tx(full + 8u * s, C::KV_BYTES);
                load_tile(tiles + s * C::KV_BYTES, map, tail, full + 8u * s,
                          BN, k_begin + it * BN, kvh);
            };
            for (int it = 0; it < n_kt; ++it) {
                load(&kmap, &ktail, sK, full_k(0), empty_k(0), it);
                if (it > 0)
                    load(&vmap, &vtail, sV, full_v(0), empty_v(0), it - 1);
            }
            load(&vmap, &vtail, sV, full_v(0), empty_v(0), n_kt - 1);
        }
    } else {
        // ---- consumer warpgroups: 64 q rows each ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(C::REG_CONSUMER));
        const int cw = wg - 1;
        const int t = threadIdx.x % 128;
        const int lane = t % 32;
        const int r_in = 16 * (t / 32) + lane / 4;  // first of the two rows
        const int qc = 2 * (lane % 4);              // first column of pairs
        const int row_lo = q0 + 64 * cw;            // the warpgroup's rows
        const int row_hi = row_lo + 63;
        const int qpos[2] = {row_lo + r_in, row_lo + r_in + 8};
        const uint32_t sQw = sQ + 64 * cw * 128;    // its rows of box 0
        const uint32_t sQt = sQ + CH * BM * 128 + 64 * cw * 32;  // of the tail
        float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};   // per row, base 2
        float o[(D - TAIL) / 2];        // O's columns in the 64-column boxes
        float ot[TAIL > 0 ? TAIL / 2 : 1];  // and in the tail box
#pragma unroll
        for (int i = 0; i < (D - TAIL) / 2; ++i) o[i] = 0.0f;
#pragma unroll
        for (int i = 0; i < TAIL / 2; ++i) ot[i] = 0.0f;
        float sc[BN / 2], alpha[2];     // scores, then p; alpha per row
        uint32_t pa[BN / 16][4];        // p in bf16: P.V's A fragments

        // S = Q . K^T of stage s, issued (not waited for).  The q
        // descriptors are rebuilt behind an empty asm each time, so the
        // compiler does not hoist D/16 of them into live registers.
        auto issue_qk = [&](int s) {
            uint64_t qd = smem_desc(sQw, 16, 1024, SW128);
            asm volatile("" : "+l"(qd));
            const uint32_t sKs = sK + s * C::KV_BYTES;
            const uint64_t kd = smem_desc(sKs, 16, 1024, SW128);
            wg_fence();
#pragma unroll
            for (int ks = 0; ks < 4 * CH; ++ks)
                Mma<BN>::ss(sc, qd + (ks / 4) * BM * 8 + (ks % 4) * 2,
                            kd + (ks / 4) * BN * 8 + (ks % 4) * 2, ks > 0);
            if constexpr (TAIL > 0) {
                uint64_t qtd = smem_desc(sQt, 16, 256, SW32);
                asm volatile("" : "+l"(qtd));
                Mma<BN>::ss(sc, qtd,
                            smem_desc(sKs + CH * BN * 128, 16, 256, SW32), 1);
            }
            wg_commit();
        };
        // O += P . V of stage s, issued (not waited for).
        auto issue_pv = [&](int s) {
            const uint32_t sVs = sV + s * C::KV_BYTES;
            const uint64_t vd = smem_desc(sVs, BN * 128, 1024, SW128);
            const uint64_t vtd =
                smem_desc(sVs + CH * BN * 128, BN * 32, 256, SW32);
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
                Mma<D - TAIL>::rs(o, pa[kk], vd + kk * 128);  // 16 keys: 2 KB
                if constexpr (TAIL > 0)
                    Mma<TAIL>::rs(ot, pa[kk], vtd + kk * 32);  // 512 B
            }
            wg_commit();
        };
        auto fence_o = [&]() {
            fence_regs(o);
            if constexpr (TAIL > 0) fence_regs(ot);
        };
        // The online softmax of tile k0 on the scores in sc, in base 2:
        // leaves p (unrounded) in sc, updates m and l, sets alpha.
        // Interior tiles fold the scale into one FFMA; tiles on the
        // diagonal, the window's edge or S scale, then mask.
        auto softmax = [&](int k0) {
            const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > row_lo)
                              || (window > 0 && k0 <= row_hi - window);
            float mx[2] = {NEG, NEG};
            if (edge) {
#pragma unroll
                for (int j = 0; j < BN / 8; ++j)
#pragma unroll
                    for (int i = 0; i < 2; ++i)
#pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            float& x = sc[4 * j + 2 * i + c];
                            const int kpos = k0 + 8 * j + qc + c;
                            bool ok = kpos < S;
                            if (causal) ok = ok && kpos <= qpos[i];
                            if (window > 0) ok = ok && kpos > qpos[i] - window;
                            x = ok ? x * scale_log2 : NEG;
                            mx[i] = fmaxf(mx[i], x);
                        }
            } else {
#pragma unroll
                for (int j = 0; j < BN / 8; ++j)
#pragma unroll
                    for (int i = 0; i < 2; ++i)
                        mx[i] = fmaxf(mx[i], fmaxf(sc[4 * j + 2 * i],
                                                   sc[4 * j + 2 * i + 1]));
            }
            float mn[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
                // raw scores: scaling by scale_log2 > 0 keeps the max
                mn[i] = fmaxf(m[i], edge ? mx[i] : mx[i] * scale_log2);
                alpha[i] = ex2(m[i] - mn[i]);
                m[i] = mn[i];
            }
            if (edge) {
#pragma unroll
                for (int j = 0; j < BN / 8; ++j)
#pragma unroll
                    for (int i = 0; i < 2; ++i)
#pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            float& x = sc[4 * j + 2 * i + c];
                            x = ex2(x - mn[i]);
                            rs[i] += x;
                        }
            } else {
#pragma unroll
                for (int j = 0; j < BN / 8; ++j)
#pragma unroll
                    for (int i = 0; i < 2; ++i)
#pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            float& x = sc[4 * j + 2 * i + c];
                            x = ex2(fmaf(x, scale_log2, -mn[i]));
                            rs[i] += x;
                        }
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
        };
        // p rounded to bf16, packed as the A fragments of P . V
        auto pack = [&]() {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    pa[j / 2][(j % 2) * 2 + i] =
                        pack_bf16(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]);
        };
        // The consumers' products take turns, round robin (named barriers
        // NC + 1 .. 2 NC, 256 threads each: the one that waits and the one
        // that passes): one warpgroup's wgmma run while the others'
        // softmax does.  The last warpgroup lets warpgroup 0 go first,
        // and owes it no turn after its own last tile, so every bar.arrive
        // meets a bar.sync.
        const uint32_t my_turn = NC + 1 + cw;
        const uint32_t their_turn = NC + 1 + (cw + 1) % NC;
        if (cw == NC - 1) named_arrive(NC + 1, 256);
        auto pass_turn = [&](int it) {
            if (cw < NC - 1 || it < n_kt - 1) named_arrive(their_turn, 256);
        };

        mbar_wait(q_full, 0);

        // Tile 0: S, softmax, P.  Then per tile it: S of it and P.V of
        // it - 1 in flight together; the softmax of it runs while P.V
        // of it - 1 does; the stage of it - 1 is released when P.V is
        // done, O rescaled, P of it packed.
        mbar_wait(full_k(0), 0);
        named_sync(my_turn, 256);
        issue_qk(0);
        pass_turn(0);
        wg_wait<0>();
        fence_regs(sc);
        mbar_arrive(empty_k(0));
        softmax(k_begin);
        pack();
        for (int it = 1; it < n_kt; ++it) {
            const int s = it % ST, sp = (it - 1) % ST;
            mbar_wait(full_k(s), (it / ST) & 1);
            named_sync(my_turn, 256);
            issue_qk(s);
            mbar_wait(full_v(sp), ((it - 1) / ST) & 1);
            issue_pv(sp);
            pass_turn(it);
            wg_wait<1>();
            fence_regs(sc);
            mbar_arrive(empty_k(s));
            softmax(k_begin + it * BN);
            wg_wait<0>();
            fence_o();
            mbar_arrive(empty_v(sp));
            scale_rows(o, alpha);
            if constexpr (TAIL > 0) scale_rows(ot, alpha);
            pack();
        }
        {
            const int sp = (n_kt - 1) % ST;
            mbar_wait(full_v(sp), ((n_kt - 1) / ST) & 1);
            wg_fence();
            issue_pv(sp);
            wg_wait<0>();
            fence_o();
            mbar_arrive(empty_v(sp));
        }

        // ---- epilogue: out = o / max(l, 1e-30) in bf16, by TMA store ----
        float inv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
            inv[i] = 1.0f / fmaxf(l[i], 1e-30f);
        }
        // The warpgroup's own q rows (its last wgmma read of them is done)
        // take the output tile, in the swizzles the stores read: 16-byte
        // chunk j of row r at j ^ (r % 8) in a 128-byte row, at
        // j ^ (r / 4 % 2) in a 32-byte one.
        uint8_t* const dst = sQ_ptr + 64 * cw * 128;
#pragma unroll
        for (int j = 0; j < (D - TAIL) / 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int r = r_in + 8 * i;
                const int off = (j / 8) * BM * 128 + r * 128
                                + (((j % 8) ^ (r % 8)) * 16) + qc * 2;
                *reinterpret_cast<__nv_bfloat162*>(dst + off) =
                    __floats2bfloat162_rn(o[4 * j + 2 * i] * inv[i],
                                          o[4 * j + 2 * i + 1] * inv[i]);
            }
        if constexpr (TAIL > 0) {
            uint8_t* const dst_t = sQ_ptr + (sQt - sQ);
#pragma unroll
            for (int j = 0; j < TAIL / 8; ++j)
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int r = r_in + 8 * i;
                    const int off = r * 32 + ((j ^ ((r / 4) % 2)) * 16)
                                    + qc * 2;
                    *reinterpret_cast<__nv_bfloat162*>(dst_t + off) =
                        __floats2bfloat162_rn(ot[4 * j + 2 * i] * inv[i],
                                              ot[4 * j + 2 * i + 1] * inv[i]);
                }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(1 + cw, 128);
        if (t == 0 && row_lo < S) {
#pragma unroll
            for (int c = 0; c < CH; ++c)
                tma_store(&omap, sQw + c * BM * 128, c * 64, row_lo, h, b);
            if constexpr (TAIL > 0)
                tma_store(&otail, sQt, CH * 64, row_lo, h, b);
            asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
            asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links no libcuda.
static EncodeTiled encode_fn() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
            return nullptr;
        fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A 4-D map over (d, s, head, batch) of a bf16 [B, NH, S, D] view with
// element strides st = (b, h, s, d), d-stride 1 (the wrapper checks it),
// moving [rows, box_d] boxes with the given swizzle (box_d * 2 bytes at
// most its span).  A dim of size 1 never moves its coordinate off 0, so
// its stride is any legal one.
static int encode(CUtensorMap* map, const void* ptr, const long long* st,
                  int B, int NH, int S, int rows, int D, int box_d,
                  CUtensorMapSwizzle swizzle) {
    EncodeTiled fn = encode_fn();
    if (fn == nullptr) return NO_ENCODE_ENTRY;
    const long long ext[3] = {S, NH, B};
    const long long el[3] = {st[2], st[1], st[0]};
    unsigned long long span = 16;
    for (int i = 0; i < 3; ++i) {
        const unsigned long long e = 2ull * el[i] * ext[i];
        span = e > span ? e : span;
    }
    span = (span + 15) / 16 * 16;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)NH,
                                (cuuint64_t)B};
    cuuint64_t strides[3];
    for (int i = 0; i < 3; ++i)
        strides[i] = ext[i] == 1 ? span : (cuuint64_t)(2 * el[i]);
    const cuuint32_t box[4] = {(cuuint32_t)box_d, (cuuint32_t)rows, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* o,
                  const long long* st, int B, int H, int KV, int S,
                  float scale, int causal, int window, cudaStream_t stream) {
    using C = Cfg<D>;
    // q, k, v, o: the 64-column maps, then the 16-column ones (D 80; at
    // other D copies the kernel never reads)
    CUtensorMap maps[8];
    const void* ptrs[4] = {q, k, v, o};
    const int heads[4] = {H, KV, KV, H};
    const int rows[4] = {C::BM, C::BN, C::BN, 64};
    for (int t = 0; t < 4; ++t) {
        int err = encode(&maps[t], ptrs[t], st + 4 * t, B, heads[t], S,
                         rows[t], D, 64, CU_TENSOR_MAP_SWIZZLE_128B);
        if (err) return err;
        maps[4 + t] = maps[t];
        if (C::TAIL > 0) {
            err = encode(&maps[4 + t], ptrs[t], st + 4 * t, B, heads[t], S,
                         rows[t], D, C::TAIL, CU_TENSOR_MAP_SWIZZLE_32B);
            if (err) return err;
        }
    }
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    const int n_qt = (S + C::BM - 1) / C::BM;
    flash_attention_tc_kernel<D><<<n_qt * H * B, C::THREADS, C::SMEM,
                                   stream>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6],
        maps[7], H, H / KV, S, n_qt, scale * LOG2E, causal, window);
    return (int)cudaGetLastError();
}

}  // namespace fa_tc

// The tensor-core route: bf16 q, k, v at D 64, 80, 128 or 256, each with
// d-stride 1, the other strides multiples of 8 elements and a 16-byte
// aligned base (TMA's terms; the wrapper checks them).  strides: 16
// element strides, (b, h, s, d) of q, k, v and the output.  Returns 0, a
// cudaError_t, or fa_tc::ENCODE_ERROR + the CUresult of a failed tensor
// map encode (fa_tc::NO_ENCODE_ENTRY: the driver has no encoder).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o,
                                         const long long* strides, int B,
                                         int H, int KV, int S, int D,
                                         float scale, int causal, int window,
                                         void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (D) {
        case 64: return fa_tc::launch<64>(q, k, v, o, strides, B, H, KV, S,
                                          scale, causal, window, s);
        case 80: return fa_tc::launch<80>(q, k, v, o, strides, B, H, KV, S,
                                          scale, causal, window, s);
        case 128: return fa_tc::launch<128>(q, k, v, o, strides, B, H, KV, S,
                                            scale, causal, window, s);
        case 256: return fa_tc::launch<256>(q, k, v, o, strides, B, H, KV, S,
                                            scale, causal, window, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
