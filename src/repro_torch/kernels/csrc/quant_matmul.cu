// K4 / K5: quantized matmul with the asymmetric dequant epilogue.
//   K4: int8 codes x int8 codes.
//   K5: int8 codes x packed int4 codes (two per byte along K).
//
// Replaces: src/repro/kernels/quant_matmul.py:int8_matmul_kernel (K4) and
// int4_matmul_kernel (K5), with their _dequant_epilogue and unpack_int4
// (Pallas, TPU; launched from quant_matmul, pallas_call at :148).
//
// xq [M, K] int8 (K contiguous); wq [K, N] int8, or for K5 wp [K/2, N]
// int8 with row 2i in the low nibble of byte i and row 2i+1 in the high
// nibble, both sign-extended; sx, zx [M] f32; sw, zw [N] f32; out [M, N]
// f32. Zero offsets are ADDED back (x = sx*(xq + zx), w = sw*(wq + zw)):
//   acc[m,n]  = sum_k xq[m,k] * wq[k,n]          (int32, exact)
//   rowsum[m] = sum_k xq[m,k],  colsum[n] = sum_k wq[k,n]
//   corr = ((acc + zx*colsum) + zw*rowsum) + (k_true*zx)*zw
//   out  = (sx*sw) * corr
// The epilogue runs in f32 with __fmul_rn / __fadd_rn in the plain
// version's order (kernels/ref.py::int8_matmul_ref), so nvcc cannot
// contract it into FMAs and the kernel equals its plain version bit for
// bit. k_true counts only the unpadded K: padded zero codes add nothing
// to acc or the sums, but would overcount the k_true*zx*zw term.
//
// Bound on the H100: bytes = M*K + K*N (K*N/2 packed) + 4*M*N + 8*(M+N)
// over 3.35 TB/s, against 2*M*N*K int8 operations over 1,979 TOP/s. At
// 256^3 that is bytes (0.39 MB, 0.12 us); at these sizes a launch costs
// more than the work.
//
// Design: one block of 256 threads owns one 64 x 64 output tile; the
// ragged M and N edges are masked, not padded (16 blocks on 132 SMs at
// 256^3). The block loops over K in chunks of 64, staged in shared memory
// with K contiguous for both operands: each thread issues all of a
// chunk's global loads into registers at once (unconditional loads from
// clamped indices), stores them, and issues the next chunk's loads before
// multiplying this one. The w chunk is transposed on the way in, and for
// K5 unpacked from its nibbles at the same time, so the product loop is
// the same for both. Each thread keeps a 4 x 4 int32 micro-tile and
// accumulates it with __dp4a on four codes at a time; in the same K loop
// 64 threads accumulate the code row sums of xq and 64 the column sums of
// wq (__dp4a against 0x01010101). Tensor cores (mma.sync / wgmma), TMA,
// wider loads and more blocks per output are later work.
#include <cuda_runtime.h>

#define QM_BM 64
#define QM_BN 64
#define QM_BK 64
#define QM_WORDS (QM_BK / 4)
#define QM_STRIDE (QM_WORDS + 1)      // int32 words per staged row (+1 pad)
#define QM_THREADS 256
#define QM_XPER (QM_BM * QM_BK / QM_THREADS)    // x codes staged per thread
#define QM_WPER (QM_BK * QM_BN / QM_THREADS)    // w codes staged per thread

// Global loads of one K chunk into registers: every load is issued
// unconditionally from a clamped index (the select comes after), so all
// of a thread's loads are in flight at once.
template <bool PACKED>
__device__ __forceinline__ void load_chunk(
        const signed char* __restrict__ xq, const signed char* __restrict__ wq,
        int M, int N, int K, int m0, int n0, int k0, int tid,
        signed char (&xv)[QM_XPER], signed char (&wv)[QM_WPER]) {
#pragma unroll
    for (int u = 0; u < QM_XPER; ++u) {
        const int i = tid + u * QM_THREADS;
        const int m = m0 + i / QM_BK, k = k0 + i % QM_BK;
        const bool in = m < M && k < K;
        const signed char v = xq[in ? (size_t)m * K + k : 0];
        xv[u] = in ? v : 0;
    }
    if (PACKED) {                // packed rows k0/2 .. k0/2 + QM_BK/2
#pragma unroll
        for (int u = 0; u < QM_WPER / 2; ++u) {
            const int i = tid + u * QM_THREADS;
            const int kp = k0 / 2 + i / QM_BN, gn = n0 + i % QM_BN;
            const bool in = kp < K / 2 && gn < N;
            const signed char v = wq[in ? (size_t)kp * N + gn : 0];
            wv[u] = in ? v : 0;
        }
    } else {
#pragma unroll
        for (int u = 0; u < QM_WPER; ++u) {
            const int i = tid + u * QM_THREADS;
            const int k = k0 + i / QM_BN, gn = n0 + i % QM_BN;
            const bool in = k < K && gn < N;
            const signed char v = wq[in ? (size_t)k * N + gn : 0];
            wv[u] = in ? v : 0;
        }
    }
}

template <bool PACKED>
__global__ void quant_matmul_kernel(const signed char* __restrict__ xq,
                                    const signed char* __restrict__ wq,
                                    const float* __restrict__ sx,
                                    const float* __restrict__ zx,
                                    const float* __restrict__ sw,
                                    const float* __restrict__ zw,
                                    float* __restrict__ out, int M, int N,
                                    int K, int k_true) {
    __shared__ int xs[QM_BM][QM_STRIDE];     // xs[m][k/4]: 4 codes a word
    __shared__ int ws[QM_BN][QM_STRIDE];     // ws[n][k/4]: w transposed
    __shared__ int s_rowsum[QM_BM];
    __shared__ int s_colsum[QM_BN];
    signed char* xb = reinterpret_cast<signed char*>(&xs[0][0]);
    signed char* wb = reinterpret_cast<signed char*>(&ws[0][0]);
    const int SB = QM_STRIDE * 4;            // bytes per staged row

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const int m0 = blockIdx.y * QM_BM, n0 = blockIdx.x * QM_BN;
    int acc[4][4] = {};
    int sum = 0;                 // row sum (tid < 64) or column sum (< 128)

    signed char xv[QM_XPER], wv[QM_WPER];
    if (K > 0)                   // (element 0 exists only when K > 0)
        load_chunk<PACKED>(xq, wq, M, N, K, m0, n0, 0, tid, xv, wv);
    for (int k0 = 0; k0 < K; k0 += QM_BK) {
#pragma unroll
        for (int u = 0; u < QM_XPER; ++u) {
            const int i = tid + u * QM_THREADS;
            xb[(i / QM_BK) * SB + i % QM_BK] = xv[u];
        }
        if (PACKED) {            // unpack: the low nibble is the even row
#pragma unroll
            for (int u = 0; u < QM_WPER / 2; ++u) {
                const int i = tid + u * QM_THREADS;
                const int pk = i / QM_BN, n = i % QM_BN;
                const int b = wv[u];
                wb[n * SB + 2 * pk] = (signed char)(((b & 0xF) ^ 8) - 8);
                wb[n * SB + 2 * pk + 1] = (signed char)(b >> 4);
            }
        } else {
#pragma unroll
            for (int u = 0; u < QM_WPER; ++u) {
                const int i = tid + u * QM_THREADS;
                wb[(i % QM_BN) * SB + i / QM_BN] = wv[u];
            }
        }
        __syncthreads();
        // the next chunk's loads fly while this one is multiplied
        if (k0 + QM_BK < K)
            load_chunk<PACKED>(xq, wq, M, N, K, m0, n0, k0 + QM_BK, tid,
                               xv, wv);

        if (tid < QM_BM) {
            for (int w = 0; w < QM_WORDS; ++w)
                sum = __dp4a(xs[tid][w], 0x01010101, sum);
        } else if (tid < QM_BM + QM_BN) {
            for (int w = 0; w < QM_WORDS; ++w)
                sum = __dp4a(ws[tid - QM_BM][w], 0x01010101, sum);
        }
#pragma unroll
        for (int w = 0; w < QM_WORDS; ++w) {
            int a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][w];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = ws[tx + 16 * j][w];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

    if (tid < QM_BM) s_rowsum[tid] = sum;
    else if (tid < QM_BM + QM_BN) s_colsum[tid - QM_BM] = sum;
    __syncthreads();

    const float kf = (float)k_true;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + 16 * i;
        if (m >= M) continue;
        const float sxm = sx[m], zxm = zx[m];
        const float rs = __int2float_rn(s_rowsum[ty + 16 * i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx + 16 * j;
            if (n >= N) continue;
            const float zwn = zw[n];
            const float cs = __int2float_rn(s_colsum[tx + 16 * j]);
            float corr = __fadd_rn(__int2float_rn(acc[i][j]),
                                   __fmul_rn(zxm, cs));
            corr = __fadd_rn(corr, __fmul_rn(zwn, rs));
            corr = __fadd_rn(corr, __fmul_rn(__fmul_rn(kf, zxm), zwn));
            out[(size_t)m * N + n] = __fmul_rn(__fmul_rn(sxm, sw[n]), corr);
        }
    }
}

template <bool PACKED>
static int launch(const signed char* xq, const signed char* wq,
                  const float* sx, const float* zx, const float* sw,
                  const float* zw, float* out, int M, int N, int K,
                  int k_true, void* stream) {
    dim3 grid((N + QM_BN - 1) / QM_BN, (M + QM_BM - 1) / QM_BM);
    quant_matmul_kernel<PACKED><<<grid, QM_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        xq, wq, sx, zx, sw, zw, out, M, N, K, k_true);
    return (int)cudaGetLastError();
}

// K4: wq [K, N] int8.
extern "C" int quant_matmul_int8_launch(const signed char* xq,
                                        const signed char* wq,
                                        const float* sx, const float* zx,
                                        const float* sw, const float* zw,
                                        float* out, int M, int N, int K,
                                        int k_true, void* stream) {
    return launch<false>(xq, wq, sx, zx, sw, zw, out, M, N, K, k_true,
                         stream);
}

// K5: wp [K/2, N] packed int4; K (xq's width) is even.
extern "C" int quant_matmul_int4_launch(const signed char* xq,
                                        const signed char* wp,
                                        const float* sx, const float* zx,
                                        const float* sw, const float* zw,
                                        float* out, int M, int N, int K,
                                        int k_true, void* stream) {
    return launch<true>(xq, wp, sx, zx, sw, zw, out, M, N, K, k_true,
                        stream);
}
