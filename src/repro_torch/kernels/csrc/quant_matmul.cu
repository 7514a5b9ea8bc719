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
// to acc or the sums, but would overcount the k_true*zx*zw term. The
// int32 sums are exact in any order, so both routes below, and any split
// of K, give the same bits.
//
// Bound on the H100: bytes = M*K + K*N (K*N/2 packed) + 4*M*N + 8*(M+N)
// over 3.35 TB/s, against 2*M*N*K int8 operations over 1,979 TOP/s. At
// 256^3 that is bytes (0.39 MB, 0.12 us), where a launch costs more than
// the work; at granite-3-8b's MLP (d 4,096, up and gate folded into n
// 25,600) it is bytes at M 32 (105 MB of int8 weights, 32.4 us; 16.7 us
// packed) and operations at M 4,096 (859 TOP, 434 us).
//
// Design: two routes, chosen by the wrapper (kernels/quant_matmul.py,
// `route`) by shape and alignment:
//
// "tc" -- K and N multiples of 16 with 16-byte aligned bases (TMA's
// terms), quant_matmul_tc_kernel below: the products on the int8 tensor
// cores (wgmma .s32.s8.s8), xq fed by TMA, w loaded as it lies by TMA
// and turned K-major (and for K5 unpacked) in shared memory by converter
// warps, split K over a thread-block cluster for small products.
//
// "simt" -- every other shape (the JAX tests' ragged N, K not a multiple
// of 16, an odd K padded for int4), quant_matmul_kernel: one block of 256
// threads owns one 64 x 64 output tile; the ragged M and N edges are
// masked, not padded. The block loops over K in chunks of 64, staged in
// shared memory with K contiguous for both operands: each thread issues
// all of a chunk's global loads into registers at once (unconditional
// loads from clamped indices), stores them, and issues the next chunk's
// loads before multiplying this one. The w chunk is transposed on the way
// in, and for K5 unpacked from its nibbles at the same time, so the
// product loop is the same for both. Each thread keeps a 4 x 4 int32
// micro-tile and accumulates it with __dp4a on four codes at a time; in
// the same K loop 64 threads accumulate the code row sums of xq and 64
// the column sums of wq (__dp4a against 0x01010101). Its launch symbols
// stay quant_matmul_int8_launch / quant_matmul_int4_launch.
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

// ---------------------------------------------------------------------------
// The "tc" route: the int8 tensor cores.
//
// One block of 416 threads per (128 x 128 output tile, slice of K):
//   - warps 0-7, two consumer warpgroups, 64 output rows each: per K tile
//     of 128 codes, four wgmma m64n144k32 .s32.s8.s8 with both operands in
//     shared memory (K-major, 128-byte swizzle), int32 accumulators in
//     registers (72 a thread). B carries 16 rows of ones after its 128 w
//     columns, so columns 128.. of the product are the row sums of xq:
//     the tensor cores take them for 12.5% more B reads, and nothing else
//     reads the A tile. A warpgroup whose rows all lie past M (the second
//     one at M 32) waits and releases like the other, but issues no
//     product.
//   - warps 8-11, the converter warpgroup: s8 wgmma reads only K-major
//     operands from shared memory, and wq lies N-contiguous, so w cannot
//     go from TMA into wgmma. The converter reads the raw w tile as TMA
//     left it ([128 k][128 n] bytes, or [64 packed rows][128 n] for K5)
//     and writes the K-major, swizzled B tile: lane l takes the four
//     columns 4l .. 4l+3 and a slab of 16 k, reads 16 words (8 for K5),
//     transposes each 4 x 4 block of bytes with __byte_perm (for K5 the
//     two nibbles of a byte are neighbours along K, so the unpack is part
//     of the same byte shuffle; each nibble goes in times 16, masked in
//     place, and the int32 sums are shifted back), and stores four 16-byte
//     chunks at chunk (slab ^ (n % 8)) of row n -- the layout the
//     descriptor names. The lanes rotate the order of their four stores
//     so that every 8 lanes hit 8 different chunks (no bank conflict).
//     Touching every w code, it also sums the columns (__dp4a against
//     0x01010101). Before the loop it writes the ones rows of every B
//     stage and stages the tile's scales in shared memory.
//   - warp 12, the producer: one thread issues the TMA loads of the xq
//     tile (2-D map over [M, K], 128-byte swizzle; 64 rows where M <= 64,
//     so TMA zero-fills no rows that no product reads) and the raw w tile
//     (2-D map over [K or K/2, N], no swizzle) into a ring of ST load
//     stages (up to 5 for K4, 6 for K5: what sets the pace is how many
//     bytes are in flight); the converted B tiles have a ring of their
//     own, BS = 3 (K4) or 4 (K5) deep, so that the converter runs ahead
//     of the products instead of taking turns with them. Barriers:
//     a_full / raw_full (TMA bytes), raw_empty (the converter has read
//     raw), a_empty (the products that read A are done), b_full (the
//     converter has written B, after a proxy fence), b_empty.
// TMA fills rows past M, columns past N and codes past K with zeros,
// which add nothing to acc or the sums; k_true carries the true count,
// so the ragged edges need no mask in the product.
//
// What bounds it on this card (tools/k45_ablation.py): at M 4,096 shared
// memory. Each K tile moves ~116 KB through it (TMA writes 32, the
// converter reads 16 and writes 16, wgmma reads A 16 and B twice 36)
// against ~576 cycles of products at the tensor-core peak, and shared
// memory serves 128 B a cycle, so the products cannot reach peak in this
// tile shape. At M 32 the w bytes (K5: and the converter), with 200 tiles
// over 132 SMs in two uneven waves. At the testbed's shapes the launch
// and the per-block latency.
//
// Epilogue. With split 1 each consumer thread finishes its own fragment
// in registers (scales and column sums from shared memory) and writes it
// to global memory, two columns at a time. Split K: the blocks of a
// cluster of `split` (2, 4 or 8; `plan` in the wrapper takes one only
// where the grid is less than a wave, as at the testbed's shapes) share
// an output tile and take balanced slices of the K tiles. After the loop
// every block stages its int32 partial tile, row sums and column sums in
// its own (now idle) ring; after a cluster barrier block r sums rows
// [r*128/split, (r+1)*128/split) over all blocks of the cluster through
// distributed shared memory (exact: int32 adds), runs the epilogue on
// them into shared memory and writes them with one TMA store; a second
// cluster barrier keeps every block's shared memory alive until its peers
// have read it. One launch, no workspace.
#include <cuda.h>      // CUtensorMap and its enums (types only: no -lcuda)
#include <stdint.h>
#include <cooperative_groups.h>

namespace qm_tc {

namespace cg = cooperative_groups;

constexpr int ENCODE_ERROR = 2000;   // + CUresult of a failed encode
constexpr int NO_ENCODE_ENTRY = 1999;

constexpr int BM = 128, BN = 128, BK = 128;   // output tile, K tile (codes)
constexpr int BN_ONES = BN + 16;  // B's rows: w columns, then rows of ones
constexpr int NACC = BN_ONES / 2; // accumulators a consumer thread holds
constexpr int CONV_WARPS = 4;    // converter warps (8 slabs of 16 k each)
constexpr int CONVERTERS = 32 * CONV_WARPS;
constexpr int CONSUMERS = 256, CONVERTER0 = 256;
constexpr int PRODUCER = CONVERTER0 + CONVERTERS;
constexpr int THREADS = PRODUCER + 32;  // 2 consumer WGs, converters, 1 warp
constexpr int A_BYTES = BM * BK, B_BYTES = BN_ONES * BK;
// After the loop (split > 1) the ring holds the partial tile [BM][P_STRIDE]
// int32 (8 words of padding: the fragment stores are free of bank
// conflicts), the partial row and column sums, the converter warps'
// column sums, the slice's totals (read by no peer) and its f32 output.
constexpr int P_STRIDE = BN + 8;
constexpr int RS_OFF = BM * P_STRIDE * 4;
constexpr int CS_OFF = RS_OFF + BM * 4;
constexpr int CSW_OFF = CS_OFF + BN * 4;
constexpr int RT_OFF = CSW_OFF + CONV_WARPS * BN * 4;
constexpr int CT_OFF = RT_OFF + BM * 4;
constexpr int O_OFF = (CT_OFF + BN * 4 + 1023) / 1024 * 1024;
constexpr int RED_BYTES = O_OFF + BM * BN * 4;

// Shared memory: a ring of ST load stages (the xq tile and the raw w tile
// of one K tile each), a ring of BS converted B tiles, then the tile's
// scales (sx, zx per row; sw, zw per column: 2 KB) and the mbarriers.
template <bool PACKED, int ST> struct Cfg {
    static constexpr int BS = PACKED ? 4 : 3;   // the converted-B ring
    static constexpr int RAW_BYTES = PACKED ? BK / 2 * BN : BK * BN;
    static constexpr int RAW_ROWS = PACKED ? BK / 2 : BK;
    static constexpr int A_OFF = 0;
    static constexpr int RAW_OFF = ST * A_BYTES;
    static constexpr int B_OFF = RAW_OFF + ST * RAW_BYTES;
    static constexpr int RING = B_OFF + BS * B_BYTES;
    static constexpr int BODY = RING > RED_BYTES ? RING : RED_BYTES;
    static constexpr int SC_OFF = BODY;
    static constexpr int BAR_OFF = SC_OFF + 2 * (BM + BN) * 4;
    // + 256 for the mbarriers, + 1024 to round the base up to the
    // 1024-byte period of the swizzle
    static constexpr int SMEM = BAR_OFF + 256 + 1024;
    static_assert(4 * ST + 2 * BS <= 32, "mbarriers past their 256 bytes");
    static_assert(SMEM <= 232448, "past 227 KB of shared memory");
};

// Rows of the xq box: where M <= 64 only the first consumer warpgroup
// has rows, and TMA need not zero-fill the second one's.
__host__ __device__ __forceinline__ int a_rows(int M) {
    return M <= 64 ? 64 : BM;
}

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

// The poll loop inside one asm block (as in flash_attention.cu): a loop
// in C++ would be a branch ptxas cannot prove warp-uniform, and wgmma
// after it would be serialized.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile("{\n.reg .pred p;\n"
                 "LAB_WAIT:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
                 "@!p bra.uni LAB_WAIT;\n}\n"
                 :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1) : "memory");
}

// wgmma shared-memory descriptor, K-major with the 128-byte swizzle:
// start address and stride byte offset (1024: 8 rows of 128 bytes) in
// 16-byte units; the leading offset is unused for this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
           | (static_cast<uint64_t>(1) << 16)
           | (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving accumulator registers across the
// asynchronous wgmma (as CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_regs(int (&d)[NACC]) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// D (64 x 144, s32) += A (64 x 32 s8) . B^T (32 x 144 s8), both from
// shared memory, K-major. Fragment of thread t (warp w = t / 32 of the
// warpgroup, lane l): d[4j + 2i + c] is row 16w + l/4 + 8i, column
// 8j + 2(l%4) + c.
__device__ __forceinline__ void mma_s8(int (&d)[NACC], uint64_t a,
                                       uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71"
        "}, %72, %73, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
          "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
          "+r"(d[70]), "+r"(d[71])
        : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
    return __byte_perm(a, b, sel);
}

// Four rows a[0..3] of 4 bytes (4 columns each) -> four columns o[0..3]
// of 4 bytes (byte i of o[j] is byte j of a[i]).
__device__ __forceinline__ void transpose4(const uint32_t* a, uint32_t* o) {
    const uint32_t t0 = prmt(a[0], a[1], 0x5140);
    const uint32_t t1 = prmt(a[0], a[1], 0x7362);
    const uint32_t t2 = prmt(a[2], a[3], 0x5140);
    const uint32_t t3 = prmt(a[2], a[3], 0x7362);
    o[0] = prmt(t0, t2, 0x5410);
    o[1] = prmt(t0, t2, 0x7632);
    o[2] = prmt(t1, t3, 0x5410);
    o[3] = prmt(t1, t3, 0x7632);
}

// Two packed rows p0 (codes k, k+1 of four columns) and p1 (k+2, k+3)
// -> four columns o[0..3] of the 4 codes k .. k+3, each times 16 (the
// low nibble is the even row). As a signed byte, b & 0xF0 is 16 times
// the high nibble sign-extended (b >> 4) and (b << 4) & 0xF0 is 16 times
// the low one (((b & 0xF) ^ 8) - 8): no sign extension to compute. The
// products and column sums come out times 16 exactly and are shifted
// back (their int32 range is the int8 case's: |16 w| <= 128).
__device__ __forceinline__ void unpack4(uint32_t p0, uint32_t p1,
                                        uint32_t* o) {
    const uint32_t lo0 = (p0 << 4) & 0xF0F0F0F0u;
    const uint32_t hi0 = p0 & 0xF0F0F0F0u;
    const uint32_t lo1 = (p1 << 4) & 0xF0F0F0F0u;
    const uint32_t hi1 = p1 & 0xF0F0F0F0u;
    const uint32_t q0 = prmt(lo0, hi0, 0x5140);   // cols 0, 1: k, k+1
    const uint32_t q1 = prmt(lo0, hi0, 0x7362);   // cols 2, 3
    const uint32_t r0 = prmt(lo1, hi1, 0x5140);   // cols 0, 1: k+2, k+3
    const uint32_t r1 = prmt(lo1, hi1, 0x7362);
    o[0] = prmt(q0, r0, 0x5410);
    o[1] = prmt(q0, r0, 0x7632);
    o[2] = prmt(q1, r1, 0x5410);
    o[3] = prmt(q1, r1, 0x7632);
}

template <bool PACKED, int ST>
__global__ void __launch_bounds__(THREADS, 1)
quant_matmul_tc_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap omap,
                       const float* __restrict__ sx,
                       const float* __restrict__ zx,
                       const float* __restrict__ sw,
                       const float* __restrict__ zw,
                       float* __restrict__ out, int M, int N, int tiles_m,
                       int k_tiles, int split, int k_true) {
    using C = Cfg<PACKED, ST>;
    constexpr int BS = C::BS;
    constexpr int SHIFT = PACKED ? 4 : 0;    // K5's w codes come times 16
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* const sm = smem_raw + (base - raw);
    const uint32_t bar = base + C::BAR_OFF;
    auto a_full = [&](int s) { return bar + 8u * s; };
    auto raw_full = [&](int s) { return bar + 8u * (ST + s); };
    auto raw_empty = [&](int s) { return bar + 8u * (2 * ST + s); };
    auto a_empty = [&](int s) { return bar + 8u * (3 * ST + s); };
    auto b_full = [&](int s) { return bar + 8u * (4 * ST + s); };
    auto b_empty = [&](int s) { return bar + 8u * (4 * ST + BS + s); };
    float* const SXS = reinterpret_cast<float*>(sm + C::SC_OFF);
    float* const ZXS = SXS + BM;
    float* const SWS = ZXS + BM;
    float* const ZWS = SWS + BN;
    int* const P = reinterpret_cast<int*>(sm);
    int* const RS = reinterpret_cast<int*>(sm + RS_OFF);
    int* const CS = reinterpret_cast<int*>(sm + CS_OFF);
    int* const CSW = reinterpret_cast<int*>(sm + CSW_OFF);
    int* const RT = reinterpret_cast<int*>(sm + RT_OFF);
    int* const CT = reinterpret_cast<int*>(sm + CT_OFF);

    const int tid = threadIdx.x;
    const int rank = blockIdx.x % split;     // the cluster is along x
    const int tile = blockIdx.x / split;
    const int m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m) * BN;
    const int kt0 = rank * k_tiles / split;
    const int nk = (rank + 1) * k_tiles / split - kt0;
    const int a_bytes = a_rows(M) * BK;      // the xq box TMA fills

    if (tid == 0) {
        for (int s = 0; s < ST; ++s) {
            mbar_init(a_full(s), 1);
            mbar_init(raw_full(s), 1);
            mbar_init(raw_empty(s), CONVERTERS);
            mbar_init(a_empty(s), CONSUMERS);
        }
        for (int s = 0; s < BS; ++s) {
            mbar_init(b_full(s), CONVERTERS);
            mbar_init(b_empty(s), CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // The role through a shuffle, so ptxas sees the branch as
    // warp-uniform (wgmma needs that).
    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int lane = tid % 32;
    const bool active = wg < 2 && m0 + 64 * wg < M;
    int acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0;
    int cs[4] = {0, 0, 0, 0};             // converter: column sums

    if (wg < 2) {
        // ---- consumers: 64 output rows each ----
        for (int it = 0; it < nk; ++it) {
            const int s = it % ST, sb = it % BS;
            mbar_wait(a_full(s), (it / ST) & 1);
            mbar_wait(b_full(sb), (it / BS) & 1);
            if (active) {
                const uint64_t ad = sw128_desc(base + C::A_OFF
                                               + s * A_BYTES + wg * 64 * 128);
                const uint64_t bd = sw128_desc(base + C::B_OFF
                                               + sb * B_BYTES);
                wg_fence();
#pragma unroll
                for (int ks = 0; ks < BK / 32; ++ks)
                    mma_s8(acc, ad + 2 * ks, bd + 2 * ks);   // +32 bytes
                wg_commit();
                wg_wait<1>();     // the products of it - 1 are done
            }
            if (it > 0) {
                mbar_arrive(a_empty((it - 1) % ST));
                mbar_arrive(b_empty((it - 1) % BS));
            }
        }
        if (active) wg_wait<0>();
        fence_regs(acc);
    } else if (tid < PRODUCER) {
        // ---- converter: raw w -> K-major swizzled B; the column sums ----
        const int ct = tid - CONVERTER0, cw = ct / 32;
        const int rot = (lane >> 1) & 3;
        if (ct < BM) {                           // for the epilogue
            SXS[ct] = m0 + ct < M ? sx[m0 + ct] : 0.0f;
            ZXS[ct] = m0 + ct < M ? zx[m0 + ct] : 0.0f;
            SWS[ct] = n0 + ct < N ? sw[n0 + ct] : 0.0f;
            ZWS[ct] = n0 + ct < N ? zw[n0 + ct] : 0.0f;
        }
        for (int sb = 0; sb < BS; ++sb)          // B's rows of ones
            for (int i = ct; i < (BN_ONES - BN) * BK / 16; i += CONVERTERS)
                reinterpret_cast<uint4*>(sm + C::B_OFF + sb * B_BYTES
                                         + BN * BK)[i] =
                    make_uint4(0x01010101u, 0x01010101u, 0x01010101u,
                               0x01010101u);
        for (int it = 0; it < nk; ++it) {
            const int s = it % ST, sb = it % BS;
            const uint32_t* rw = reinterpret_cast<const uint32_t*>(
                sm + C::RAW_OFF + s * C::RAW_BYTES);
            uint8_t* bt = sm + C::B_OFF + sb * B_BYTES;
            mbar_wait(raw_full(s), (it / ST) & 1);
            mbar_wait(b_empty(sb), ((it / BS) & 1) ^ 1);   // B[sb] is free
#pragma unroll
            for (int h = 0; h < 8 / CONV_WARPS; ++h) {
                const int slab = cw + CONV_WARPS * h;   // k 16*slab .. +15
                uint32_t t[4][4];                    // [k group][column]
                if (PACKED) {
                    uint32_t p[8];
#pragma unroll
                    for (int i = 0; i < 8; ++i)
                        p[i] = rw[(8 * slab + i) * (BN / 4) + lane];
#pragma unroll
                    for (int g = 0; g < 4; ++g)
                        unpack4(p[2 * g], p[2 * g + 1], t[g]);
                } else {
                    uint32_t a[16];
#pragma unroll
                    for (int i = 0; i < 16; ++i)
                        a[i] = rw[(16 * slab + i) * (BN / 4) + lane];
#pragma unroll
                    for (int g = 0; g < 4; ++g)
                        transpose4(a + 4 * g, t[g]);
                }
                uint4 o[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
#pragma unroll
                    for (int g = 0; g < 4; ++g)
                        cs[j] = __dp4a((int)t[g][j], 0x01010101, cs[j]);
                    o[j] = make_uint4(t[0][j], t[1][j], t[2][j], t[3][j]);
                }
                // o[q] <- o[(q + rot) % 4]: store q of lane l writes
                // column 4l + (q + rot) % 4, so 8 lanes hit 8 chunks
                if (rot & 1) {
                    const uint4 x = o[0];
                    o[0] = o[1]; o[1] = o[2]; o[2] = o[3]; o[3] = x;
                }
                if (rot & 2) {
                    uint4 x = o[0]; o[0] = o[2]; o[2] = x;
                    x = o[1]; o[1] = o[3]; o[3] = x;
                }
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int n = 4 * lane + ((q + rot) & 3);
                    *reinterpret_cast<uint4*>(
                        bt + n * 128 + ((slab ^ (n & 7)) << 4)) = o[q];
                }
            }
            mbar_arrive(raw_empty(s));
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(b_full(sb));
        }
    } else if (tid == PRODUCER) {
        // ---- producer: one thread issues every TMA load ----
        for (int it = 0; it < nk; ++it) {
            const int s = it % ST;
            const uint32_t ph = (it / ST) & 1;
            const int k0 = (kt0 + it) * BK;
            mbar_wait(raw_empty(s), ph ^ 1);
            mbar_expect_tx(raw_full(s), C::RAW_BYTES);
            tma_load(base + C::RAW_OFF + s * C::RAW_BYTES, &wmap, raw_full(s),
                     n0, PACKED ? k0 / 2 : k0);
            mbar_wait(a_empty(s), ph ^ 1);
            mbar_expect_tx(a_full(s), a_bytes);
            tma_load(base + C::A_OFF + s * A_BYTES, &amap, a_full(s), k0, m0);
        }
    }

    // ---- the code sums, then the epilogue ----
    __syncthreads();       // every TMA load consumed, every product done
    // Thread (warpgroup wg, warp w, lane l) holds rows r_in and r_in + 8,
    // columns 8j + c_in (+1); acc[64 + 2i] is row r_in + 8i's sum of xq.
    const int r_in = 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
    const int c_in = 2 * (lane % 4);
    if (tid >= CONVERTER0 && tid < PRODUCER) {
        const int ct = tid - CONVERTER0;
#pragma unroll
        for (int j = 0; j < 4; ++j) CSW[(ct / 32) * BN + 4 * lane + j] = cs[j];
    } else if (split > 1 && active) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
                *reinterpret_cast<int2*>(
                    P + (r_in + 8 * i) * P_STRIDE + 8 * j + c_in) =
                    make_int2(acc[4 * j + 2 * i] >> SHIFT,
                              acc[4 * j + 2 * i + 1] >> SHIFT);
        if (c_in == 0) {
            RS[r_in] = acc[BN / 2];
            RS[r_in + 8] = acc[BN / 2 + 2];
        }
    }
    __syncthreads();
    if (tid >= CONVERTER0 && tid < CONVERTER0 + BN) {
        const int c = tid - CONVERTER0;
        int v = 0;
#pragma unroll
        for (int w = 0; w < CONV_WARPS; ++w) v += CSW[w * BN + c];
        CS[c] = v >> SHIFT;
    }
    const float kf = (float)k_true;
    if (split == 1) {
        __syncthreads();
        if (!active) return;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int m = m0 + r_in + 8 * i;
            if (m >= M) continue;
            const float sxm = SXS[r_in + 8 * i], zxm = ZXS[r_in + 8 * i];
            const float rsf = __int2float_rn(acc[BN / 2 + 2 * i]);
            const float kz = __fmul_rn(kf, zxm);
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                const int col = 8 * j + c_in;
                if (n0 + col >= N) continue;      // N % 16 == 0: both in
                float o[2];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const float zwn = ZWS[col + c];
                    const float csf = __int2float_rn(CS[col + c]);
                    float corr = __fadd_rn(
                        __int2float_rn(acc[4 * j + 2 * i + c] >> SHIFT),
                        __fmul_rn(zxm, csf));
                    corr = __fadd_rn(corr, __fmul_rn(zwn, rsf));
                    corr = __fadd_rn(corr, __fmul_rn(kz, zwn));
                    o[c] = __fmul_rn(__fmul_rn(sxm, SWS[col + c]), corr);
                }
                *reinterpret_cast<float2*>(out + (size_t)m * N + n0 + col) =
                    make_float2(o[0], o[1]);
            }
        }
        return;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();        // every block's partials are staged

    // This block's rows of the tile: their totals over the cluster, then
    // the epilogue into shared memory, then one TMA store (rows past M and
    // columns past N are dropped).
    const int rows = min(BM, M - m0), cols = min(BN, N - n0);
    const int per = BM / split;
    const int r0 = rank * per, r1 = min(r0 + per, rows);
    const int nr = max(r1 - r0, 0);
    if (nr > 0) {
        if (tid < BN) {
            int v = 0;
            for (int q = 0; q < split; ++q)
                v += *cluster.map_shared_rank(CS + tid, q);
            CT[tid] = v;
        } else if (tid < BN + nr) {
            const int r = r0 + tid - BN;
            int v = 0;
            for (int q = 0; q < split; ++q)
                v += *cluster.map_shared_rank(RS + r, q);
            RT[r] = v;
        }
    }
    __syncthreads();
    for (int g = tid; g < nr * (BN / 4); g += THREADS) {
        const int r = r0 + g / (BN / 4), c4 = 4 * (g % (BN / 4));
        if (c4 >= cols) continue;
        int a4[4] = {0, 0, 0, 0};
        for (int q = 0; q < split; ++q) {
            const int4 v = *cluster.map_shared_rank(
                reinterpret_cast<int4*>(P + r * P_STRIDE + c4), q);
            a4[0] += v.x; a4[1] += v.y; a4[2] += v.z; a4[3] += v.w;
        }
        const float sxm = SXS[r], zxm = ZXS[r];
        const float rsf = __int2float_rn(RT[r]);
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float zwn = ZWS[c4 + j];
            const float csf = __int2float_rn(CT[c4 + j]);
            float corr = __fadd_rn(__int2float_rn(a4[j]), __fmul_rn(zxm, csf));
            corr = __fadd_rn(corr, __fmul_rn(zwn, rsf));
            corr = __fadd_rn(corr, __fmul_rn(__fmul_rn(kf, zxm), zwn));
            o[j] = __fmul_rn(__fmul_rn(sxm, SWS[c4 + j]), corr);
        }
        *reinterpret_cast<float4*>(sm + O_OFF + ((r - r0) * BN + c4) * 4) =
            make_float4(o[0], o[1], o[2], o[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && nr > 0) {
        asm volatile(
            "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
            " [%0, {%2, %3}], [%1];\n"
            :: "l"(reinterpret_cast<uint64_t>(&omap)), "r"(base + O_OFF),
               "r"(n0), "r"(m0 + r0) : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    cluster.sync();        // peers have read this block's partials
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

// A 2-D map over a contiguous [rows, cols] matrix of `bytes`-wide elements
// moving [box_rows, box_cols] boxes; out-of-range elements load as zeros
// and are dropped by a store.
static int encode(CUtensorMap* map, CUtensorMapDataType type, int bytes,
                  const void* ptr, int rows, int cols, int box_rows,
                  int box_cols, CUtensorMapSwizzle swizzle) {
    EncodeTiled fn = encode_fn();
    if (fn == nullptr) return NO_ENCODE_ENTRY;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * bytes};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = fn(map, type, 2,
                          const_cast<void*>(ptr), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

template <bool PACKED, int ST>
static int launch(const void* xq, const void* wq, const float* sx,
                  const float* zx, const float* sw, const float* zw,
                  float* out, int M, int N, int K, int k_true, int split,
                  cudaStream_t stream) {
    using C = Cfg<PACKED, ST>;
    CUtensorMap amap, wmap, omap;
    int err = encode(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, M, K,
                     a_rows(M), BK, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
    err = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq,
                 PACKED ? K / 2 : K, N, C::RAW_ROWS, BN,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
    err = encode(&omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, M, N,
                 BM / split, BN, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
    static bool ready = false;
    if (!ready) {
        const cudaError_t e = cudaFuncSetAttribute(
            quant_matmul_tc_kernel<PACKED, ST>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
        if (e != cudaSuccess) return (int)e;
        ready = true;
    }
    const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
    const int k_tiles = (K + BK - 1) / BK;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles_m * tiles_n * split);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = C::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, quant_matmul_tc_kernel<PACKED, ST>, amap, wmap, omap, sx, zx,
        sw, zw, out, M, N, tiles_m, k_tiles, split, k_true);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace qm_tc

// The tensor-core route (K4 with packed 0, K5 with packed 1): K and N
// multiples of 16, xq and wq contiguous with 16-byte aligned bases (TMA's
// terms; the wrapper checks them), `split` blocks per cluster (1, 2, 4 or
// 8; at most the number of 128-code K tiles) and `stages` (the load
// ring: 2 to 5 for K4, 2 to 6 for K5) from kernels/quant_matmul.py::plan. Returns 0, a cudaError_t, or
// qm_tc::ENCODE_ERROR + the CUresult of a failed tensor map encode
// (qm_tc::NO_ENCODE_ENTRY: the driver has no encoder).
extern "C" int quant_matmul_tc_launch(const signed char* xq,
                                      const signed char* wq,
                                      const float* sx, const float* zx,
                                      const float* sw, const float* zw,
                                      float* out, int M, int N, int K,
                                      int k_true, int packed, int split,
                                      int stages, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (split != 1 && split != 2 && split != 4 && split != 8)
        return (int)cudaErrorInvalidValue;
#define QM_TC_CASE(P, S)                                                    \
    if ((packed != 0) == P && stages == S)                                  \
        return qm_tc::launch<P, S>(xq, wq, sx, zx, sw, zw, out, M, N, K,    \
                                   k_true, split, s);
    QM_TC_CASE(false, 2) QM_TC_CASE(false, 3) QM_TC_CASE(false, 4)
    QM_TC_CASE(false, 5)
    QM_TC_CASE(true, 2) QM_TC_CASE(true, 3) QM_TC_CASE(true, 4)
    QM_TC_CASE(true, 5) QM_TC_CASE(true, 6)
#undef QM_TC_CASE
    return (int)cudaErrorInvalidValue;
}
