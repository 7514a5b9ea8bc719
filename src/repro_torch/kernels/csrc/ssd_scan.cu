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
// the chunk state: ~78.5 GFLOP, 1.17 ms at 67 TFLOP/s (f32 on CUDA
// cores; TF32 would miss the reference's 2e-4).  The bytes (x and y 403
// MB each, dA, B, C and the state) take ~0.25 ms at 3.35 TB/s.
//
// Design: the two-pass form, so that the card is filled at batch 1 (one
// block per (batch, head), the Pallas grid's sequential axis, would give
// 48 blocks for 132 SMs):
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
//      into the product with the X tile.  The Pallas kernel keeps the
//      whole L x L chunk (~0.6 MB at L 256) in VMEM; here 64-row tiles
//      keep a block at ~102 KB of shared memory at N 128 (2 per SM).
// 256 threads (16 x 16): thread (ty, tx) holds rows ty + 16a (a < 4) x
// columns tx + 16j (j < 4) of each 64 x 64 tile, a 4 x 4 register
// micro-tile of f32 FMAs; row strides N + 4 keep its float4 reads of the
// C and B rows free of bank conflicts.  C Bᵀ is recomputed per head (not
// shared across heads) and nothing runs on the tensor cores: later work.
// A ragged S is masked in the kernel (rows past S read as zeros, which is
// what padding the sequence with zeros gives).  P <= 64, N <= 256 with N
// a multiple of 4, 1 <= L <= 1024 (the wrapper checks).
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
// the state entering chunk c.
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
    float s = 0.0f;
    for (int c = 0; c < NC; ++c) {
        const long long o = (((long long)b * NC + c) * H + h) * PN + e;
        const float u = st[o];
        st[o] = s;
        s = u + dec[c] * s;
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
