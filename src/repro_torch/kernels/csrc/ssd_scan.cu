// K8: the Mamba-2 chunked SSD scan (state-space duality, arXiv:2405.21060
// listing 1) over x [B, S, H, P] (dt-scaled inputs), dA [B, S, H] (log
// decays), Bm and Cm [B, S, N] (one group, shared by every head), all
// f32. Returns y [B, S, H, P] and the final state [B, H, P, N], from a
// zero initial state.
//
// Replaces: src/repro/kernels/ssd_scan.py:_ssd_kernel (Pallas, TPU).
//
// Per (batch, head), over chunks of L tokens in order (the Pallas kernel
// walks them sequentially with the [P, N] state in VMEM):
//   A_cs = cumsum(dA) within the chunk
//   Y    = (C Bᵀ ⊙ Lmat) X + exp(A_cs) ⊙ (C stateᵀ),
//          Lmat[i][j] = exp(A_cs[i] - A_cs[j]) for i >= j, else 0
//   state = exp(A_cs[-1]) state + Xᵀ (B ⊙ exp(A_cs[-1] - A_cs))
// exp is taken only on and below the diagonal, where A_cs[i] - A_cs[j]
// <= 0 for decays dA <= 0; the positive upper entries would overflow.
//
// Bound on the H100: operations.  At the mamba2-780m prefill (B 1, S
// 32768, H 48, P 64, N 128, L 256: 128 chunks) the causal work is, per
// chunk, C Bᵀ on the lower triangle once (shared by the heads) and, per
// (chunk, head), the masked product with X on the triangle, C stateᵀ and
// the chunk state: ~78.5 GFLOP, 1.17 ms at 67 TFLOP/s in f32 on the CUDA
// cores.  On the tensor cores each product runs three times in TF32
// (below): 236 GFLOP, 0.48 ms at 495 TFLOP/s.  The bytes (x and y 403 MB
// each, dA, B, C and the state) take ~0.25 ms at 3.35 TB/s.
//
// Design: the two-pass form, so that the card is filled at batch 1 (one
// block per (batch, head), the Pallas grid's sequential axis, would give
// 48 blocks for 132 SMs): chunk states, a sequential pass over them,
// then each chunk's output from the state entering it.  Two routes,
// chosen by the wrapper (kernels/ssd_scan.py, `route`) by shape alone:
//
// "tc" -- head dim P 64, state N 64 or 128, chunk a multiple of 64 (the
// mamba2 family's full-width shapes), namespace ssd_tc below: the
// per-head products (98% of the work) on the tensor cores with wgmma in
// split TF32, tiles fed by TMA.  TF32 keeps 10 mantissa bits, which alone
// misses K8's 2e-4; each f32 operand is split as hi = tf32(x), lo =
// tf32(x - hi), and the products accumulate hi·hi + hi·lo + lo·hi in f32
// (lo·lo, ~2^-22 relative, is dropped; the tensor cores' own truncating
// accumulation is flushed into f32 adds every 4 k-steps, see
// mma_split).  TF32 wgmma reads only K-major operands from shared
// memory, so X, whose products reduce over tokens, is transposed (and
// split) by the threads into a K-major tile; the other operand of each
// product comes from registers, where any layout is free.  Four
// launches:
//   ssd_tc_cb: C Bᵀ once per (batch, chunk) for all heads, one block per
//     64 x 64 tile on or below the diagonal, in f32 FMAs on the CUDA
//     cores (where C_t·B_t cancels, the tensor cores' truncation was too
//     coarse: see the kernel), into scratch `cb` in the order the output
//     pass's threads hold it (thread-major, 16 KB a tile; 21 MB at the
//     prefill, which stays in the 50 MB L2).
//   ssd_tc_state: one block per (chunk, head, batch): the chunk's A_cs
//     (a warp scan, written to `acs`), its decay and its state,
//     stateᵀ [N, P] = (B ⊙ decay)ᵀ X over 32-token slices, B and X
//     slices arriving by TMA into a two-stage ring (mbarriers) while
//     the current slice is multiplied.
//   ssd_state_pass: as on the other route (the sequential carry).
//   ssd_tc_out: one block per (64-row tile, head, chunk, batch), row
//     tiles of one (chunk, head) adjacent so that their shared state and
//     X tiles come from L2: C stateᵀ (C rows split in registers, the
//     state split in shared memory), scaled by exp(A_cs); then for each
//     column tile on or below the diagonal the C Bᵀ tile from `cb`,
//     masked and scaled by exp(A_cs[i] - A_cs[j]) in registers, is the
//     A operand of the product with the transposed X tile; X tiles
//     arrive by TMA two ahead.  The score accumulator's register layout
//     is not TF32's A-fragment layout, so the X tile's tokens are
//     permuted within each group of 8 as it is transposed, which makes
//     the two agree without a shuffle.
// One warpgroup (128 threads) per block but in ssd_tc_cb (256); thread 0
// issues the TMA loads.  What holds the route back (tools/k8_ablation.py,
// PERF.md): the output pass's per-tile CUDA-core work (the transpose, the
// exps and splits of the scores, the flushes) runs between its products
// in one warpgroup, so the tensor cores idle most of the time.
//
// "simt" -- every other shape (the JAX tests' small ones), ssd_chunk_state
// and ssd_chunk_out below: f32 FMAs on the CUDA cores.
//   1. ssd_chunk_state: one block per (chunk, head, batch) computes the
//      chunk's A_cs (a warp scan; written to `acs` for pass 3), its decay
//      exp(A_cs[-1]) and its state contribution Xᵀ (B ⊙ decay) [P, N].
//   2. ssd_state_pass: one thread per (batch, head, p, n) walks the
//      chunks in order, replacing each chunk's contribution with the
//      state ENTERING it (s ← contribution + decay · s) and writing the
//      final state.  This is the only sequential part: 128 steps at the
//      prefill, over P·N·H elements in parallel.
//   3. ssd_chunk_out: one block per (64-row tile of a chunk, head,
//      batch).  Its C rows stay in shared memory; the inter-chunk term
//      C · stateᵀ scaled by exp(A_cs) starts the accumulator, then for
//      each 64-column tile on or below the diagonal: the score tile C Bᵀ,
//      masked and scaled by exp(A_cs[i] - A_cs[j]), through shared memory
//      into the product with the X tile.  64-row tiles keep a block at
//      ~102 KB of shared memory at N 128 (2 per SM).
// 256 threads (16 x 16): thread (ty, tx) holds rows ty + 16a (a < 4) x
// columns tx + 16j (j < 4) of each 64 x 64 tile, a 4 x 4 register
// micro-tile of f32 FMAs; row strides N + 4 keep its float4 reads of the
// C and B rows free of bank conflicts.  C Bᵀ is recomputed per head.
// A ragged S is masked in the kernel on both routes (rows past S read as
// zeros, which is what padding the sequence with zeros gives).  P <= 64,
// N <= 256 with N a multiple of 4, 1 <= L <= 1024 (the wrapper checks).
#include <cuda_runtime.h>
#include <math.h>

#define SSD_T 64
#define SSD_THREADS 256
#define SSD_XLD 64
#define SSD_SLD 68

struct RowStrides {
    long long b, s;   // element strides of Bm / Cm over batch and token
};

// Pass 1: grid (NC, H, B).
__global__ void __launch_bounds__(SSD_THREADS)
ssd_chunk_state(const float* __restrict__ x, const float* __restrict__ dA,
                const float* __restrict__ Bm, RowStrides bs,
                float* __restrict__ acs, float* __restrict__ decay,
                float* __restrict__ st, int S, int H, int P, int N, int L,
                int NC) {
    extern __shared__ __align__(16) float smem[];
    float* a_s = smem;                                 // [L]
    float* Xs = a_s + ((L + 3) / 4) * 4;               // [T][XLD]
    float* Bs = Xs + SSD_T * SSD_XLD;                  // [T][N]
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const long long s0 = (long long)c * L;
    const int Lc = (int)min((long long)L, S - s0);

    if (tid < 32) {                                    // inclusive warp scan
        float carry = 0.0f;
        for (int base = 0; base < Lc; base += 32) {
            const int l = base + tid;
            float v = l < Lc ? dA[((long long)b * S + s0 + l) * H + h] : 0.0f;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float t = __shfl_up_sync(0xffffffffu, v, off);
                if (tid >= off) v += t;
            }
            v += carry;
            if (l < Lc) {
                a_s[l] = v;
                acs[((long long)b * H + h) * S + s0 + l] = v;
            }
            carry = __shfl_sync(0xffffffffu, v, 31);
        }
    }
    __syncthreads();
    const float a_last = a_s[Lc - 1];
    if (tid == 0) decay[((long long)b * H + h) * NC + c] = expf(a_last);

    float acc[4][16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = 0.0f;

    for (int l0 = 0; l0 < Lc; l0 += SSD_T) {
        const int rows = min(SSD_T, Lc - l0);
        __syncthreads();                   // the previous tile's readers
        for (int i = tid; i < SSD_T * SSD_XLD; i += SSD_THREADS) {
            const int r = i / SSD_XLD, p = i % SSD_XLD;
            Xs[i] = (r < rows && p < P)
                ? x[(((long long)b * S + s0 + l0 + r) * H + h) * P + p]
                : 0.0f;
        }
        for (int i = tid; i < SSD_T * N; i += SSD_THREADS) {
            const int r = i / N, n = i % N;
            Bs[i] = r < rows
                ? Bm[b * bs.b + (s0 + l0 + r) * bs.s + n]
                      * expf(a_last - a_s[l0 + r])
                : 0.0f;
        }
        __syncthreads();
        for (int r = 0; r < rows; ++r) {
            float xv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) xv[i] = Xs[r * SSD_XLD + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                if (16 * j < N) {
                    const float bv = tx + 16 * j < N ? Bs[r * N + tx + 16 * j]
                                                     : 0.0f;
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc[i][j] = fmaf(xv[i], bv, acc[i][j]);
                }
            }
        }
    }

    float* out = st + (((long long)b * NC + c) * H + h) * P * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int p = ty + 16 * i;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int n = tx + 16 * j;
            if (n < N) out[p * N + n] = acc[i][j];
        }
    }
}

// Pass 2: one thread per (b, h, p·N + n).  In place: st[b, c, h] becomes
// the state entering chunk c.  The loads of SSD_CARRY_AHEAD chunks are
// issued before their stores (a load after a store to the same array
// would wait for it), so that many are in flight per thread.
#define SSD_CARRY_AHEAD 16
__global__ void ssd_state_pass(float* __restrict__ st,
                               const float* __restrict__ decay,
                               float* __restrict__ fin, int B, int H, int PN,
                               int NC) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)B * H * PN) return;
    const int e = (int)(idx % PN);
    const int h = (int)((idx / PN) % H);
    const int b = (int)(idx / ((long long)PN * H));
    const float* dec = decay + ((long long)b * H + h) * NC;
    float* col = st + ((long long)b * NC * H + h) * PN + e;
    const long long step = (long long)H * PN;      // one chunk further
    float s = 0.0f;
    for (int c0 = 0; c0 < NC; c0 += SSD_CARRY_AHEAD) {
        float u[SSD_CARRY_AHEAD];
#pragma unroll
        for (int k = 0; k < SSD_CARRY_AHEAD; ++k)
            if (c0 + k < NC) u[k] = col[(c0 + k) * step];
#pragma unroll
        for (int k = 0; k < SSD_CARRY_AHEAD; ++k)
            if (c0 + k < NC) {
                col[(c0 + k) * step] = s;
                s = u[k] + dec[c0 + k] * s;
            }
    }
    fin[idx] = s;
}

// out[a][j] = sum_n A[ty + 16a][n] * M[tx + 16j][n], rows of stride ld.
__device__ __forceinline__ void tile_dot(const float* A, const float* M,
                                         int N, int ld, int ty, int tx,
                                         float out[4][4]) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[a][j] = 0.0f;
    for (int n = 0; n < N; n += 4) {
        float4 av[4], mv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
            av[a] = *reinterpret_cast<const float4*>(&A[(ty + 16 * a) * ld + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            mv[j] = *reinterpret_cast<const float4*>(&M[(tx + 16 * j) * ld + n]);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float t = out[a][j];
                t = fmaf(av[a].x, mv[j].x, t);
                t = fmaf(av[a].y, mv[j].y, t);
                t = fmaf(av[a].z, mv[j].z, t);
                t = fmaf(av[a].w, mv[j].w, t);
                out[a][j] = t;
            }
    }
}

// Pass 3: grid (NT * NC, H, B), NT = ceil(L / 64) row tiles per chunk.
__global__ void __launch_bounds__(SSD_THREADS, 2)
ssd_chunk_out(const float* __restrict__ x, const float* __restrict__ Bm,
              RowStrides bs, const float* __restrict__ Cm, RowStrides cs,
              const float* __restrict__ acs, const float* __restrict__ st,
              float* __restrict__ y, int S, int H, int P, int N, int L,
              int NC, int NT) {
    extern __shared__ __align__(16) float smem[];
    const int ld = N + 4;
    float* Cs = smem;                        // [T][ld] C rows of the tile
    float* Ms = Cs + SSD_T * ld;             // [T][ld] state, then B tiles
    float* Xs = Ms + SSD_T * ld;             // [T][XLD]
    float* Ss = Xs + SSD_T * SSD_XLD;        // [T][SLD] masked scores
    float* ar = Ss + SSD_T * SSD_SLD;        // [T] A_cs of the rows
    float* ac = ar + SSD_T;                  // [T] A_cs of the columns

    const int c = blockIdx.x / NT, it = blockIdx.x % NT;
    const int h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const long long s0 = (long long)c * L;
    const int Lc = (int)min((long long)L, S - s0);
    const int r0 = it * SSD_T;
    if (r0 >= Lc) return;
    const float* a_bh = acs + ((long long)b * H + h) * S + s0;

    if (tid < SSD_T) ar[tid] = r0 + tid < Lc ? a_bh[r0 + tid] : 0.0f;
    for (int i = tid; i < SSD_T * N; i += SSD_THREADS) {
        const int r = i / N, n = i % N;
        Cs[r * ld + n] = r0 + r < Lc
            ? Cm[b * cs.b + (s0 + r0 + r) * cs.s + n] : 0.0f;
    }
    const float* prev = st + (((long long)b * NC + c) * H + h) * P * N;
    for (int i = tid; i < SSD_T * N; i += SSD_THREADS) {
        const int p = i / N, n = i % N;
        Ms[p * ld + n] = p < P ? prev[p * N + n] : 0.0f;
    }
    __syncthreads();

    // Inter-chunk term: exp(A_cs[i]) * (C stateᵀ)[i][p].
    float acc[4][4];
    tile_dot(Cs, Ms, N, ld, ty, tx, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const float e = expf(ar[ty + 16 * a]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] *= e;
    }

    // Intra-chunk term over the column tiles on or below the diagonal.
    for (int jt = 0; jt <= it; ++jt) {
        const int c0 = jt * SSD_T;
        __syncthreads();                   // Ms / Xs / Ss readers are done
        if (tid < SSD_T) ac[tid] = c0 + tid < Lc ? a_bh[c0 + tid] : 0.0f;
        for (int i = tid; i < SSD_T * N; i += SSD_THREADS) {
            const int r = i / N, n = i % N;
            Ms[r * ld + n] = c0 + r < Lc
                ? Bm[b * bs.b + (s0 + c0 + r) * bs.s + n] : 0.0f;
        }
        for (int i = tid; i < SSD_T * SSD_XLD; i += SSD_THREADS) {
            const int r = i / SSD_XLD, p = i % SSD_XLD;
            Xs[i] = (c0 + r < Lc && p < P)
                ? x[(((long long)b * S + s0 + c0 + r) * H + h) * P + p]
                : 0.0f;
        }
        __syncthreads();
        float sc[4][4];
        tile_dot(Cs, Ms, N, ld, ty, tx, sc);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const int rl = r0 + ty + 16 * a;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int cl = c0 + tx + 16 * j;
                const bool keep = cl <= rl && rl < Lc;
                Ss[(ty + 16 * a) * SSD_SLD + tx + 16 * j] =
                    keep ? sc[a][j] * expf(ar[ty + 16 * a] - ac[tx + 16 * j])
                         : 0.0f;
            }
        }
        __syncthreads();
        for (int k = 0; k < SSD_T; k += 4) {
            float4 sv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a)
                sv[a] = *reinterpret_cast<const float4*>(
                    &Ss[(ty + 16 * a) * SSD_SLD + k]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float xv[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    xv[j] = Xs[(k + e) * SSD_XLD + tx + 16 * j];
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                    const float s = e == 0 ? sv[a].x : e == 1 ? sv[a].y
                                  : e == 2 ? sv[a].z : sv[a].w;
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[a][j] = fmaf(s, xv[j], acc[a][j]);
                }
            }
        }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int rl = r0 + ty + 16 * a;
        if (rl >= Lc) continue;
        float* yrow = y + (((long long)b * S + s0 + rl) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int p = tx + 16 * j;
            if (p < P) yrow[p] = acc[a][j];
        }
    }
}

// strides: the (batch, token) element strides of Bm, then of Cm (their
// last dim is contiguous).  acs [B, H, S], decay [B, H, NC] and st
// [B, NC, H, P, N] are scratch from the caller.
extern "C" int ssd_scan_launch(const void* x, const void* dA, const void* Bm,
                               const void* Cm, const long long* strides,
                               void* y, void* fin, void* acs, void* decay,
                               void* st, int B, int S, int H, int P, int N,
                               int L, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (P < 1 || P > 64 || N < 4 || N > 256 || N % 4 || L < 1 || L > 1024)
        return (int)cudaErrorInvalidValue;
    const int NC = (S + L - 1) / L;
    const int NT = (L + SSD_T - 1) / SSD_T;
    const RowStrides bs{strides[0], strides[1]}, cs{strides[2], strides[3]};

    const int smem1 = (((L + 3) / 4) * 4 + SSD_T * SSD_XLD + SSD_T * N)
                      * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_state, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_state<<<dim3(NC, H, B), SSD_THREADS, smem1, s>>>(
        (const float*)x, (const float*)dA, (const float*)Bm, bs, (float*)acs,
        (float*)decay, (float*)st, S, H, P, N, L, NC);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const long long total = (long long)B * H * P * N;
    ssd_state_pass<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        (float*)st, (const float*)decay, (float*)fin, B, H, P * N, NC);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int smem3 = (2 * SSD_T * (N + 4) + SSD_T * SSD_XLD
                       + SSD_T * SSD_SLD + 2 * SSD_T) * (int)sizeof(float);
    err = cudaFuncSetAttribute(
        ssd_chunk_out, cudaFuncAttributeMaxDynamicSharedMemorySize, smem3);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_out<<<dim3(NT * NC, H, B), SSD_THREADS, smem3, s>>>(
        (const float*)x, (const float*)Bm, bs, (const float*)Cm, cs,
        (const float*)acs, (const float*)st, (float*)y, S, H, P, N, L, NC,
        NT);
    return (int)cudaGetLastError();
}

// ===========================================================================
// The tensor-core route
// ===========================================================================
#include <cuda.h>      // CUtensorMap and its enums (types only: no -lcuda)
#include <stdint.h>

namespace ssd_tc {

constexpr int T = 64;              // tokens per tile; also the head dim P
constexpr int THREADS = 128;       // one warpgroup
constexpr int ENCODE_ERROR = 2000;     // + CUresult of a failed encode
constexpr int NO_ENCODE_ENTRY = 1999;
constexpr int X_TILE = T * T * 4;      // an X tile or a transposed one

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

// Wait for the phase of `parity` to complete (the poll loop inside one
// asm block, so the compiler sees no divergent branch before a wgmma).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile("{\n.reg .pred p;\n"
                 "LAB_WAIT:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
                 "@!p bra.uni LAB_WAIT;\n}\n"
                 :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
           "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
           "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// Shared-memory writes by the threads made visible to wgmma and TMA (the
// async proxy); a barrier among the threads follows.
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of element (r, k) in a K-major f32 tile of R rows under the
// 128-byte swizzle, as TMA writes it with 32-column boxes: box k / 32 of
// R rows x 128 bytes, the 16-byte unit of k within its row XORed with
// r % 8 (the tile starts on 1024 bytes).
__device__ __forceinline__ uint32_t sw_off(int r, int k, int R) {
    return (uint32_t)((k >> 5) * (R * 128) + r * 128
                      + ((((k & 31) >> 2) ^ (r & 7)) << 4) + ((k & 3) << 2));
}

// wgmma descriptor of such a tile (64 rows): start address, leading byte
// offset 16 (unused when K-major), stride byte offset 1024 (8 rows of 128
// bytes), 128-byte swizzle; all offsets in 16-byte units.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
           | (static_cast<uint64_t>(16 >> 4) << 16)
           | (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
// The descriptor of k-step ks (8 TF32 columns, 32 bytes) of a 64-row tile:
// four steps per 128-byte box row, then the next box (64 x 128 bytes).
__device__ __forceinline__ uint64_t kstep(uint64_t desc, int ks) {
    return desc + (uint64_t)((ks >> 2) * (T * 128 / 16) + (ks & 3) * 2);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most W committed wgmma groups are in flight.
template <int W>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(W) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The split: hi = tf32(x), lo = tf32(x - hi), both rounded to nearest.
__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
}

// D (64 x 64, f32) += A (64 x 8, TF32 registers) . B (8 x 64, K-major
// shared memory).  A's fragment: a[0] (row g, col t), a[1] (g + 8, t),
// a[2] (g, t + 4), a[3] (g + 8, t + 4) of the warp's 16 rows, g = lane / 4,
// t = lane % 4.  D: d[4j + 2i + c] is row g + 8i, column 8j + 2t + c.
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                    uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// acc[g % A] += A . B over G groups of 4 k-steps of 8 in split TF32
// (k-steps 4g .. 4g + 3 of B, or with SAME_K k-steps 0 .. 3 for every
// group: then each group is its own product, e.g. one per m-tile).  The
// tensor cores' own f32 accumulation truncates the addends it aligns (no
// rounding), so a sum carried through many wgmma grows an error of
// several ulps of its size per instruction (1.7e-3 at the slow-decay
// check, where y reaches ~10^2).  So hi·hi of each group goes into a
// fresh accumulator that round-to-nearest adds on the CUDA cores flush
// into acc, two groups in flight; lo·hi and hi·lo, 2^-11 of the size,
// share one accumulator per acc of their own (with APART; otherwise
// they go into the group's, which costs 8 more truncations of a sum of
// 32 products: what pass 1 does, to stay within its registers).
// frag(g, kk, hi, lo) gives the A registers of k-step kk of group g,
// which stay untouched until their group is done; dh, dl are B's hi and
// lo tiles.
template <int G, int A, bool SAME_K, bool APART, class Frag>
__device__ __forceinline__ void mma_split(float (&acc)[A][32], Frag frag,
                                          uint64_t dh, uint64_t dl) {
    constexpr int NS = APART ? A : 1;
    float part[2][32], small[NS][32];
    uint32_t ah[2][4][4], al[2][4][4];
#pragma unroll
    for (int a = 0; a < NS; ++a) zero(small[a]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const int s = g & 1;
        zero(part[s]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) frag(g, kk, ah[s][kk], al[s][kk]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const int ks = SAME_K ? kk : 4 * g + kk;
            const uint64_t bh = kstep(dh, ks), bl = kstep(dl, ks);
            float (&lo_acc)[32] = APART ? small[g % NS] : part[s];
            mma(lo_acc, al[s][kk], bh);
            mma(lo_acc, ah[s][kk], bl);
            mma(part[s], ah[s][kk], bh);
        }
        wg_commit();
        if (g > 0) {
            wg_wait<1>();
            fence_regs(part[s ^ 1]);
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[(g - 1) % A][i] += part[s ^ 1][i];
        }
    }
    wg_wait<0>();
    fence_regs(part[(G - 1) & 1]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[(G - 1) % A][i] += part[(G - 1) & 1][i];
    if (APART) {
#pragma unroll
        for (int a = 0; a < NS; ++a) {
            fence_regs(small[a]);
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[a][i] += small[a][i];
        }
    }
}

// A raw f32 tile in shared memory -> hi in place, lo into `lo` (the same
// layout: the split is elementwise).
__device__ __forceinline__ void split_tile(uint8_t* raw, uint8_t* lo,
                                           int bytes) {
    for (int i = 16 * threadIdx.x; i < bytes; i += 16 * THREADS) {
        const float4 v = *reinterpret_cast<const float4*>(raw + i);
        uint4 h, l;
        split(v.x, h.x, l.x);
        split(v.y, h.y, l.y);
        split(v.z, h.z, l.z);
        split(v.w, h.w, l.w);
        *reinterpret_cast<uint4*>(raw + i) = h;
        *reinterpret_cast<uint4*>(lo + i) = l;
    }
}

// An X tile as TMA leaves it ([R tokens][64 p], two 32-column boxes)
// -> its transpose [64 p][R tokens], K-major, split into hi and lo.
// With `perm` the tokens of each group of 8 are stored in the order
// 0 2 4 6 1 3 5 7: slot s of a k-step holds token 2s (s < 4) or
// 2(s - 4) + 1, which is where a score accumulator holds the A operand's
// columns t and t + 4 (as its columns 2t and 2t + 1).
template <int R>
__device__ __forceinline__ void transpose_x(const uint8_t* xraw, uint8_t* hi,
                                            uint8_t* lo, bool perm) {
#pragma unroll 4
    for (int it = 0; it < R / 8; ++it) {
        const int idx = threadIdx.x + THREADS * it;   // (4 p, token) pairs
        const int l = idx % R, p = 4 * (idx / R);
        const float4 v =
            *reinterpret_cast<const float4*>(xraw + sw_off(l, p, R));
        const int k = perm ? ((l & ~7) | ((l & 1) << 2) | ((l & 7) >> 1)) : l;
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            uint32_t h, w;
            split(e[q], h, w);
            const uint32_t off = sw_off(p + q, k, T);
            *reinterpret_cast<uint32_t*>(hi + off) = h;
            *reinterpret_cast<uint32_t*>(lo + off) = w;
        }
    }
}

// acc += Crows (64 x N, raw f32 tile, split here in registers) . Mᵀ,
// M (64 x N) split in shared memory (hi at m_hi, lo at m_lo).
template <int N>
__device__ __forceinline__ void mma_rows(float (&acc)[1][32], const uint8_t* c,
                                         uint32_t m_hi, uint32_t m_lo) {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r = 16 * w + lane / 4, t = lane % 4;
    const float* cf = reinterpret_cast<const float*>(c);
    mma_split<N / 32, 1, false, true>(acc, [&](int g, int kk, uint32_t (&h)[4],
                                         uint32_t (&l)[4]) {
        const int k = 8 * (4 * g + kk) + t;
        split(cf[sw_off(r, k, T) / 4], h[0], l[0]);
        split(cf[sw_off(r + 8, k, T) / 4], h[1], l[1]);
        split(cf[sw_off(r, k + 4, T) / 4], h[2], l[2]);
        split(cf[sw_off(r + 8, k + 4, T) / 4], h[3], l[3]);
    }, tile_desc(m_hi), tile_desc(m_lo));
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
    const uint32_t a = smem_u32(raw);
    return raw + (((a + 1023u) & ~1023u) - a);
}

// C Bᵀ, one 64 x 64 tile (it, jt), jt <= it, per block; grid (NT (NT + 1)
// / 2, NC, B), 256 threads.  In f32 FMAs on the CUDA cores, in the order
// of the other route (tile_dot), not on the tensor cores: where C_t·B_t
// cancels to a small part of |C_t||B_t| (0.065 of 10.9 at a mamba2
// prefill row), the tensor cores' truncating accumulation moved that
// row's output by 2.4e-3 of its norm, past K8_ROW_TOL (2^-10); this is
// 1.3 of the prefill's ~78 GFLOP.  Out: cb[b][c][tile][thread][32], the
// tile as each thread of ssd_tc_out holds its accumulator.
__global__ void __launch_bounds__(SSD_THREADS)
ssd_tc_cb(const float* __restrict__ Bm, RowStrides bs,
          const float* __restrict__ Cm, RowStrides cs, float* __restrict__ cb,
          int S, int N, int L, int NC, int NTT) {
    extern __shared__ __align__(16) float smem[];
    const int ld = N + 4;
    float* const Cs = smem;                  // [T][ld] rows of tile it
    float* const Bs = Cs + T * ld;           // [T][ld] rows of tile jt
    const int tile = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    int it = 0;
    while ((it + 1) * (it + 2) / 2 <= tile) ++it;
    const int jt = tile - it * (it + 1) / 2;
    const long long s0 = (long long)c * L;
    for (int i = tid; i < T * N; i += SSD_THREADS) {
        const int r = i / N, n = i % N;
        const long long sc = s0 + it * T + r, sb = s0 + jt * T + r;
        Cs[r * ld + n] = sc < S ? Cm[b * cs.b + sc * cs.s + n] : 0.0f;
        Bs[r * ld + n] = sb < S ? Bm[b * bs.b + sb * bs.s + n] : 0.0f;
    }
    __syncthreads();
    float out[4][4];
    tile_dot(Cs, Bs, N, ld, ty, tx, out);
    float* dst = cb + (((long long)b * NC + c) * NTT + tile) * (T * T);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            // (row 16w + g + 8i, column 8jj + 2t + cc) is register
            // 4jj + 2i + cc of thread 32w + 4g + t
            const int r = ty + 16 * a, q = tx + 16 * j;
            const int w = r >> 4, i = (r >> 3) & 1, g = r & 7;
            const int jj = q >> 3, t = (q & 7) >> 1, cc = q & 1;
            dst[(32 * w + 4 * g + t) * 32 + 4 * jj + 2 * i + cc] = out[a][j];
        }
}

// Chunk states; grid (NC, H, B).  st[b][c][h] = the chunk's contribution
// [P][N], computed as stateᵀ [N][P] = (B ⊙ dec)ᵀ X over slices of SL
// tokens (32: a block then fits twice on an SM, so one block's
// transposes overlap the other's products), the slices arriving by TMA
// into a ring of SL_STAGES.
constexpr int SL = 32;
constexpr int SL_STAGES = 2;
template <int N>
__host__ __device__ constexpr int state_smem(int L) {
    // the ring of (B, X) slices, the transposed X slice (hi, lo), A_cs
    // and the decays [L] each, the mbarriers, the 1024-byte alignment
    return SL_STAGES * (SL * N * 4 + SL * T * 4) + 2 * SL * T * 4 + 8 * L
           + 8 * SL_STAGES + 1024;
}

template <int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_tc_state(const __grid_constant__ CUtensorMap bmap,
             const __grid_constant__ CUtensorMap xmap,
             const float* __restrict__ dA, float* __restrict__ acs,
             float* __restrict__ decay, float* __restrict__ st, int S, int H,
             int L, int NC) {
    constexpr int B_SLICE = SL * N * 4;
    constexpr int X_SLICE = SL * T * 4;
    constexpr int STAGE = B_SLICE + X_SLICE;
    constexpr int MT = N / 64;          // 64-row m-tiles of stateᵀ
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* const ring = aligned_smem(smem_raw);   // SL_STAGES x (B, X)
    uint8_t* const xt_hi = ring + SL_STAGES * STAGE;
    uint8_t* const xt_lo = xt_hi + X_SLICE;
    float* const a_s = reinterpret_cast<float*>(xt_lo + X_SLICE);  // [L]
    float* const dec = a_s + L;                                     // [L]
    const uint32_t bars = smem_u32(dec + L);                // SL_STAGES
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int s0 = c * L;
    const int Lc = min(L, S - s0);
    const int n_sl = (Lc + SL - 1) / SL;
    auto issue = [&](int k) {
        const int s = k % SL_STAGES;
        const uint32_t dst = smem_u32(ring + s * STAGE);
        mbar_expect_tx(bars + 8 * s, STAGE);
#pragma unroll
        for (int q = 0; q < N / 32; ++q)
            tma_load3(dst + q * SL * 128, &bmap, bars + 8 * s, 32 * q,
                      s0 + k * SL, b);
#pragma unroll
        for (int q = 0; q < 2; ++q)
            tma_load4(dst + B_SLICE + q * SL * 128, &xmap, bars + 8 * s,
                      32 * q, h, s0 + k * SL, b);
    };
    if (tid == 0) {
        for (int s = 0; s < SL_STAGES; ++s) mbar_init(bars + 8 * s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int k = 0; k < SL_STAGES && k < n_sl; ++k) issue(k);
    }
    // The chunk's decays by all threads at once (a strided read), then an
    // inclusive warp scan over them in place.
    for (int l = tid; l < Lc; l += THREADS)
        a_s[l] = dA[((long long)b * S + s0 + l) * H + h];
    __syncthreads();
    if (tid < 32) {
        float carry = 0.0f;
        for (int base = 0; base < Lc; base += 32) {
            const int l = base + tid;
            float v = l < Lc ? a_s[l] : 0.0f;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float t = __shfl_up_sync(0xffffffffu, v, off);
                if (tid >= off) v += t;
            }
            v += carry;
            if (l < Lc) {
                a_s[l] = v;
                acs[((long long)b * H + h) * S + s0 + l] = v;
            }
            carry = __shfl_sync(0xffffffffu, v, 31);
        }
    }
    __syncthreads();
    const float a_last = a_s[Lc - 1];
    if (tid == 0) decay[((long long)b * H + h) * NC + c] = expf(a_last);
    for (int l = tid; l < n_sl * SL; l += THREADS)
        dec[l] = l < Lc ? expf(a_last - a_s[l]) : 0.0f;
    __syncthreads();

    const int w = tid / 32, lane = tid % 32;
    const int r = 16 * w + lane / 4, t = lane % 4;
    float acc[MT][32];
#pragma unroll
    for (int m = 0; m < MT; ++m) zero(acc[m]);
    const uint64_t dh = tile_desc(smem_u32(xt_hi));
    const uint64_t dl = tile_desc(smem_u32(xt_lo));
#pragma unroll 1
    for (int k = 0; k < n_sl; ++k) {
        const int s = k % SL_STAGES;
        const uint8_t* bsl = ring + s * STAGE;
        mbar_wait(bars + 8 * s, (k / SL_STAGES) & 1);
        transpose_x<SL>(bsl + B_SLICE, xt_hi, xt_lo, false);
        fence_async_smem();
        __syncthreads();
        const float* bf = reinterpret_cast<const float*>(bsl);
        const float* dk = dec + k * SL;
        // Group m: A[n][l] = B[l][n] · dec[l], rows n = 64m + r (+8).
        mma_split<MT, MT, true, false>(acc, [&](int m, int ks, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
            const int l = 8 * ks + t, n = 64 * m + r;
            split(bf[sw_off(l, n, SL) / 4] * dk[l], hi[0], lo[0]);
            split(bf[sw_off(l, n + 8, SL) / 4] * dk[l], hi[1], lo[1]);
            split(bf[sw_off(l + 4, n, SL) / 4] * dk[l + 4], hi[2], lo[2]);
            split(bf[sw_off(l + 4, n + 8, SL) / 4] * dk[l + 4], hi[3],
                  lo[3]);
        }, dh, dl);
        __syncthreads();          // stage s and the transposed slice are free
        if (tid == 0 && k + SL_STAGES < n_sl) issue(k + SL_STAGES);
    }

    float* out = st + (((long long)b * NC + c) * H + h) * T * N;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int cc = 0; cc < 2; ++cc) {
                    const int n = 64 * m + r + 8 * i, p = 8 * j + 2 * t + cc;
                    out[p * N + n] = acc[m][4 * j + 2 * i + cc];
                }
}

// ssd_tc_out's second region: the state split (hi, lo) while C stateᵀ
// runs, then the transposed X tile (hi, lo) and two X stages.
template <int N>
__host__ __device__ constexpr int out_region() {
    return 2 * T * N * 4 > 4 * X_TILE ? 2 * T * N * 4 : 4 * X_TILE;
}

// The output; grid (NT * H * NC * B): row tile fastest (the last, with
// the most column tiles, first), then head, chunk, batch.
template <int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_tc_out(const __grid_constant__ CUtensorMap cmap,
           const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap smap,
           const float* __restrict__ cb, const float* __restrict__ acs,
           float* __restrict__ y, int S, int H, int L, int NC, int NT,
           int NTT) {
    constexpr int TILE = T * N * 4;
    constexpr int R1 = out_region<N>();
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* const sC = aligned_smem(smem_raw);        // C rows, raw
    uint8_t* const r1 = sC + TILE;  // state hi, lo; then X^T hi, lo, 2 X
    uint8_t* const xt_hi = r1;
    uint8_t* const xt_lo = r1 + X_TILE;
    uint8_t* const xs = r1 + 2 * X_TILE;                // 2 stages
    float* const a_c = reinterpret_cast<float*>(r1 + R1);         // [L]
    const uint32_t bars = smem_u32(a_c + L);    // C and state; X stages 2
    const int tid = threadIdx.x;
    int rest = blockIdx.x;
    const int it = NT - 1 - rest % NT;
    rest /= NT;
    const int h = rest % H;
    rest /= H;
    const int c = rest % NC, b = rest / NC;
    const int s0 = c * L;
    const int Lc = min(L, S - s0);
    const int r0 = it * T;
    if (r0 >= Lc) return;
    auto issue_x = [&](int jt) {
        const uint32_t bar = bars + 8 * (1 + (jt & 1));
        const uint32_t dst = smem_u32(xs + (jt & 1) * X_TILE);
        mbar_expect_tx(bar, X_TILE);
#pragma unroll
        for (int q = 0; q < 2; ++q)
            tma_load4(dst + q * T * 128, &xmap, bar, 32 * q, h,
                      s0 + jt * T, b);
    };
    if (tid == 0) {
        for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        mbar_expect_tx(bars, 2 * TILE);
        const int sidx = ((b * NC) + c) * H + h;
#pragma unroll
        for (int q = 0; q < N / 32; ++q) {
            tma_load3(smem_u32(sC) + q * T * 128, &cmap, bars, 32 * q,
                      s0 + r0, b);
            tma_load3(smem_u32(r1) + q * T * 128, &smap, bars, 32 * q, 0,
                      sidx);
        }
    }
    const float* a_bh = acs + ((long long)b * H + h) * S + s0;
    const int n_a = min(Lc, r0 + T);
    for (int l = tid; l < n_a; l += THREADS) a_c[l] = a_bh[l];
    __syncthreads();
    mbar_wait(bars, 0);
    split_tile(r1, r1 + TILE, TILE);
    fence_async_smem();
    __syncthreads();

    // Inter-chunk term: exp(A_cs[i]) * (C stateᵀ)[i][p].
    float acc[1][32];
    zero(acc[0]);
    mma_rows<N>(acc, sC, smem_u32(r1), smem_u32(r1 + TILE));
    fence_async_smem();
    __syncthreads();                      // the state tiles are free
    if (tid == 0) {
        issue_x(0);
        if (it > 0) issue_x(1);
    }
    const int w = tid / 32, lane = tid % 32;
    const int rw = 16 * w + lane / 4, t = lane % 4;
    float ar[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int il = r0 + rw + 8 * i;
        ar[i] = il < Lc ? a_c[il] : 0.0f;
        const float e = expf(ar[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            acc[0][4 * j + 2 * i] *= e;
            acc[0][4 * j + 2 * i + 1] *= e;
        }
    }

    // Intra-chunk term over the column tiles on or below the diagonal.
    const uint64_t dh = tile_desc(smem_u32(xt_hi));
    const uint64_t dl = tile_desc(smem_u32(xt_lo));
    const float* cb_c = cb + (((long long)b * NC + c) * NTT + it * (it + 1) / 2)
                        * (T * T) + tid * 32;
#pragma unroll 1
    for (int jt = 0; jt <= it; ++jt) {
        float sc[32];
        const float4* src = reinterpret_cast<const float4*>(cb_c + jt * T * T);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            const float4 v = src[q];
            sc[4 * q] = v.x;
            sc[4 * q + 1] = v.y;
            sc[4 * q + 2] = v.z;
            sc[4 * q + 3] = v.w;
        }
        mbar_wait(bars + 8 * (1 + (jt & 1)), (jt >> 1) & 1);
        transpose_x<T>(xs + (jt & 1) * X_TILE, xt_hi, xt_lo, true);
        fence_async_smem();
        __syncthreads();
        if (tid == 0 && jt + 2 <= it) issue_x(jt + 2);
        {
            // A operand: the masked, decayed scores, k-step by k-step (so
            // a group's exps overlap the previous group's products).
            // Column 2t + cc of k-step j is the A fragment's column t + 4cc
            // (the tokens' permutation in transpose_x).
            mma_split<2, 1, false, true>(acc, [&](int g, int kk,
                                                  uint32_t (&hi)[4],
                                                  uint32_t (&lo)[4]) {
                const int j = 4 * g + kk;
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int cc = 0; cc < 2; ++cc) {
                        const int il = r0 + rw + 8 * i;
                        const int jl = jt * T + 8 * j + 2 * t + cc;
                        const float v = jl <= il && il < Lc
                            ? sc[4 * j + 2 * i + cc] * expf(ar[i] - a_c[jl])
                            : 0.0f;
                        split(v, hi[i + 2 * cc], lo[i + 2 * cc]);
                    }
            }, dh, dl);
        }
        __syncthreads();                  // the transposed tile is free
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int il = r0 + rw + 8 * i;
        if (il >= Lc) continue;
        float* yrow = y + (((long long)b * S + s0 + il) * H + h) * T;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float2*>(yrow + 8 * j + 2 * t) =
                make_float2(acc[0][4 * j + 2 * i], acc[0][4 * j + 2 * i + 1]);
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

// An f32 map of `rank` dims (innermost first: sizes `dims`, element
// strides `el` of dims 1.., dim 0 contiguous) moving boxes of 32 columns
// x `rows` rows of dim `row_dim` (1 in every other dim) under the
// 128-byte swizzle; out-of-range rows read as zeros.  A dim of size 1 is never stepped, so its stride is
// any legal one.
static int encode(CUtensorMap* map, const void* ptr, int rank,
                  const long long* dims, const long long* el, int row_dim,
                  int rows) {
    EncodeTiled fn = encode_fn();
    if (fn == nullptr) return NO_ENCODE_ENTRY;
    unsigned long long span = 16;
    for (int i = 1; i < rank; ++i) {
        const unsigned long long e = 4ull * el[i - 1] * dims[i];
        span = e > span ? e : span;
    }
    span = (span + 15) / 16 * 16;
    cuuint64_t size[5], stride[4];
    cuuint32_t box[5], unit[5];
    for (int i = 0; i < rank; ++i) {
        size[i] = (cuuint64_t)dims[i];
        box[i] = i == 0 ? 32 : i == row_dim ? (cuuint32_t)rows : 1;
        unit[i] = 1;
    }
    for (int i = 1; i < rank; ++i)
        stride[i - 1] = dims[i] == 1 ? span : (cuuint64_t)(4 * el[i - 1]);
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                          const_cast<void*>(ptr), size, stride, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

template <int N>
static int launch(const void* x, const void* dA, const void* Bm,
                  const void* Cm, const long long* strides, void* y,
                  void* fin, void* acs, void* decay, void* st, void* cb,
                  int B, int S, int H, int L, cudaStream_t stream) {
    const int NC = (S + L - 1) / L, NT = L / T, NTT = NT * (NT + 1) / 2;
    CUtensorMap cmap, xmap, smap, bmap_sl, xmap_sl;
    const long long bc_dims[3] = {N, S, B};
    const long long b_el[2] = {strides[1], strides[0]};
    const long long c_el[2] = {strides[3], strides[2]};
    const long long x_dims[4] = {T, H, S, B};
    const long long x_el[3] = {T, (long long)H * T, (long long)S * H * T};
    const long long s_dims[3] = {N, T, (long long)B * NC * H};
    const long long s_el[2] = {N, (long long)T * N};
    int err = encode(&cmap, Cm, 3, bc_dims, c_el, 1, T);
    if (!err) err = encode(&xmap, x, 4, x_dims, x_el, 2, T);
    if (!err) err = encode(&smap, st, 3, s_dims, s_el, 1, T);
    if (!err) err = encode(&bmap_sl, Bm, 3, bc_dims, b_el, 1, SL);
    if (!err) err = encode(&xmap_sl, x, 4, x_dims, x_el, 2, SL);
    if (err) return err;

    const int tile = T * N * 4;
    const int smem_cb = 2 * T * (N + 4) * (int)sizeof(float);
    const int smem_st = state_smem<N>(L);
    const int smem_out = tile + out_region<N>() + 4 * L + 1024 + 64;
    cudaError_t e = cudaFuncSetAttribute(
        ssd_tc_cb, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_cb);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(ssd_tc_state<N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_st);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(ssd_tc_out<N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_out);
    if (e != cudaSuccess) return (int)e;

    const RowStrides bs{strides[0], strides[1]}, cs{strides[2], strides[3]};
    ssd_tc_cb<<<dim3(NTT, NC, B), SSD_THREADS, smem_cb, stream>>>(
        (const float*)Bm, bs, (const float*)Cm, cs, (float*)cb, S, N, L, NC,
        NTT);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ssd_tc_state<N><<<dim3(NC, H, B), THREADS, smem_st, stream>>>(
        bmap_sl, xmap_sl, (const float*)dA, (float*)acs, (float*)decay, (float*)st,
        S, H, L, NC);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long total = (long long)B * H * T * N;
    ssd_state_pass<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        (float*)st, (const float*)decay, (float*)fin, B, H, T * N, NC);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ssd_tc_out<N><<<(unsigned)(NT * H * NC * B), THREADS, smem_out,
                    stream>>>(cmap, xmap, smap, (const float*)cb,
                              (const float*)acs, (float*)y, S, H, L, NC, NT,
                              NTT);
    return (int)cudaGetLastError();
}

}  // namespace ssd_tc

// The tensor-core route: P 64, N 64 or 128, L a multiple of 64 up to 1024;
// x contiguous with a 16-byte aligned base, Bm / Cm with their (batch,
// token) element strides in multiples of 4 and 16-byte aligned bases
// (TMA's terms; the wrapper checks them).  strides and the scratch acs,
// decay, st as ssd_scan_launch; cb [B, NC, NT (NT + 1) / 2, 64 * 64] f32.
// Returns 0, a cudaError_t, or ssd_tc::ENCODE_ERROR + the CUresult of a
// failed tensor map encode (ssd_tc::NO_ENCODE_ENTRY: the driver has no
// encoder).
extern "C" int ssd_scan_tc_launch(const void* x, const void* dA,
                                  const void* Bm, const void* Cm,
                                  const long long* strides, void* y,
                                  void* fin, void* acs, void* decay,
                                  void* st, void* cb, int B, int S, int H,
                                  int P, int N, int L, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (P != ssd_tc::T || L < ssd_tc::T || L % ssd_tc::T || L > 1024 ||
        S < 1)
        return (int)cudaErrorInvalidValue;
    switch (N) {
        case 64: return ssd_tc::launch<64>(x, dA, Bm, Cm, strides, y, fin,
                                           acs, decay, st, cb, B, S, H, L, s);
        case 128: return ssd_tc::launch<128>(x, dA, Bm, Cm, strides, y, fin,
                                             acs, decay, st, cb, B, S, H, L,
                                             s);
        default: return (int)cudaErrorInvalidValue;
    }
}
