// K2: fused 3-layer MLP forward, the DDPG actor/critic trunk.
//   h1 = relu(x W1 + b1),  h2 = relu(h1 W2 + b2),  y = h2 W3 + b3 [-> sigmoid]
// One launch emits y, h1 and h2 (the residuals the backward reuses).
//
// Replaces: src/repro/kernels/mlp_fused.py:_mlp3_kernel (Pallas, TPU).
//
// Shapes: x [B, D0], Wi [D(i-1), Di] (the JAX [in, out] layout), bi [Di],
// all f32 and contiguous.  On the search's path: actor 33 -> 400 -> 300 -> 3
// (sigmoid), critic 36 -> 400 -> 300 -> 1 (linear), B = the DDPG batch.
//
// Member form (mlp3_members_launch): P networks in one launch, every
// operand with a leading member axis (x [P, B, D0], Wi [P, D(i-1), Di],
// bi [P, Di], outputs [P, B, .]), what the JAX package's vmap over a
// population makes of the TPU kernel in the population's rollout.  The
// grid gains a y axis over the members; a block of member p offsets every
// pointer to member p's slices and then runs exactly the arithmetic of a
// one-network launch on them (the same column split, summation order and
// cluster), so each member's outputs are bit-equal to a launch of its own.
// The one-network launch is the case P = 1.
//
// Bound on the H100 at B = 64: operations.  The ~17 MFLOP take 0.26 us at
// the 67 TFLOP/s f32 (non-tensor-core) peak, the ~0.54 MB of weights
// 0.16 us at 3.35 TB/s; a launch with three cluster barriers cannot come
// near either.
//
// Design: the TPU kernel keeps every weight resident in VMEM; here f32 W2
// alone is 480 KB, over the 227 KB a block may hold, and the work is a
// chain of three dependent products too small to fill the card by rows.
// So the columns are split within a thread-block cluster and the rows
// across clusters (kernels/mlp_fused.py::mlp3_plan gives the columns):
//   * a cluster of MLP_CLUSTER = 8 CTAs owns a tile of MLP_BM = 8 rows
//     (8 and 16 clusters at the DDPG batches 64 and 128); CTA
//     `rank` owns columns [rank * n1, +n1) of h1 and [rank * n2, +n2) of
//     h2 (n1, n2 multiples of 4; the last ranks may own fewer or none);
//   * at entry each CTA stages, all in flight at once with cp.async, the
//     x tile and its slices of W1 and b1 (group 0), then its columns of
//     W2 and b2, its rows of W3 and b3 (group 1): one memory round trip,
//     and layer 1 runs while group 1 is still arriving;
//   * each layer is register tiles on the CUDA cores in f32 (the <= 1e-5
//     parity of the update rules out TF32): thread = (column, k-split),
//     MLP_BM accumulators, the k-splits' partials added in split order
//     through shared memory (deterministic); 16-byte activation loads
//     where the input width is a multiple of 4;
//   * each CTA writes its h1 columns into every peer's shared h1 tile
//     through distributed shared memory (after a first cluster barrier
//     that every CTA has started), and to global memory for the
//     backward; after cluster.sync() every CTA holds the whole h1 tile;
//   * layer 2 gives each CTA its h2 columns (also written to global);
//     layer 3 is a partial dot product over them per (row, output),
//     pushed into rank 0's shared memory; after the last cluster.sync()
//     rank 0 adds the partials in rank order, adds b3, applies the
//     sigmoid and writes y.  No CTA touches a peer's shared memory after
//     that barrier, so none exits while a peer may still need its own.
// Widths whose slices and tiles overflow the 227 KB a CTA may hold are
// refused at launch (cudaFuncSetAttribute's error is returned), as is a
// cluster shape the card cannot schedule (cudaOccupancyMaxActiveClusters
// of 0, checked once per shared-memory size).
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MLP_CLUSTER 8
#define MLP_BM 8
#define MLP_THREADS 256

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
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
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Copy src[r * ld + c] for r < rows, c < cols into dst[r * cols + c]
// (shared), asynchronously: 16 bytes at a time where every row start is
// on 16 bytes, else 4.
__device__ __forceinline__ void stage(float* dst, const float* src, int rows,
                                      int cols, int ld) {
    if (rows <= 0 || cols <= 0) return;
    if (((cols | ld) & 3) == 0 && ((uintptr_t)src & 15) == 0) {
        const int q = cols / 4;
        for (int i = threadIdx.x; i < rows * q; i += MLP_THREADS) {
            const int r = i / q, c = (i % q) * 4;
            cp_async16(dst + r * cols + c, src + (size_t)r * ld + c);
        }
    } else {
        for (int i = threadIdx.x; i < rows * cols; i += MLP_THREADS) {
            const int r = i / cols, c = i % cols;
            cp_async4(dst + r * cols + c, src + (size_t)r * ld + c);
        }
    }
}

// out[r * ldo + j] = relu(sum_k in[r * K + k] W[k * n + j] + b[j]) for
// r < MLP_BM, j < n, all operands in shared memory.  Thread t takes
// column t % NJ and k-split t / NJ of KS; red holds the partials
// [KS][MLP_BM][n], added in split order.  Shared-memory loads, not FMAs,
// bound the inner loop: where K % 4 == 0 (VEC) each row's activations
// come as one 16-byte load per 4 k, the k-splits cut on multiples of 4.
// Called by the whole block (n is uniform).
template <bool VEC>
__device__ __forceinline__ void dense_relu(const float* in, int K,
                                           const float* W, const float* b,
                                           int n, float* out, int ldo,
                                           float* red) {
    if (n <= 0) return;
    const int KS = n >= MLP_THREADS ? 1 : MLP_THREADS / n;
    const int NJ = MLP_THREADS / KS;
    const int ks = threadIdx.x / NJ;
    if (ks < KS) {
        const int g = VEC ? 4 : 1;
        const int k0 = g * (K / g * ks / KS), k1 = g * (K / g * (ks + 1) / KS);
        for (int j = threadIdx.x % NJ; j < n; j += NJ) {
            float acc[MLP_BM];
#pragma unroll
            for (int r = 0; r < MLP_BM; ++r) acc[r] = 0.0f;
            if (VEC) {
#pragma unroll 2
                for (int k = k0; k < k1; k += 4) {
                    const float w0 = W[k * n + j], w1 = W[(k + 1) * n + j];
                    const float w2 = W[(k + 2) * n + j];
                    const float w3 = W[(k + 3) * n + j];
#pragma unroll
                    for (int r = 0; r < MLP_BM; ++r) {
                        const float4 v =
                            *reinterpret_cast<const float4*>(in + r * K + k);
                        acc[r] = fmaf(v.x, w0, acc[r]);
                        acc[r] = fmaf(v.y, w1, acc[r]);
                        acc[r] = fmaf(v.z, w2, acc[r]);
                        acc[r] = fmaf(v.w, w3, acc[r]);
                    }
                }
            } else {
#pragma unroll 4
                for (int k = k0; k < k1; ++k) {
                    const float w = W[k * n + j];
#pragma unroll
                    for (int r = 0; r < MLP_BM; ++r)
                        acc[r] = fmaf(in[r * K + k], w, acc[r]);
                }
            }
#pragma unroll
            for (int r = 0; r < MLP_BM; ++r)
                red[(ks * MLP_BM + r) * n + j] = acc[r];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < MLP_BM * n; i += MLP_THREADS) {
        const int r = i / n, j = i % n;
        float v = red[r * n + j];
        for (int s = 1; s < KS; ++s) v += red[(s * MLP_BM + r) * n + j];
        out[r * ldo + j] = fmaxf(v + b[j], 0.0f);
    }
    __syncthreads();
}

// dense_relu with 16-byte activation loads where K allows them (in is on
// 16 bytes and its rows K floats apart).
__device__ __forceinline__ void dense(const float* in, int K, const float* W,
                                      const float* b, int n, float* out,
                                      int ldo, float* red) {
    if ((K & 3) == 0)
        dense_relu<true>(in, K, W, b, n, out, ldo, red);
    else
        dense_relu<false>(in, K, W, b, n, out, ldo, red);
}

__host__ __device__ __forceinline__ int up4(int v) { return (v + 3) & ~3; }

// Shared-memory layout of one CTA, in floats (every region on 16 bytes).
struct Layout {
    int xs, w1, b1, w2, b2, w3, b3, h1, h2, part, red, total;
    __host__ __device__ Layout(int D0, int D1, int D3, int n1, int n2) {
        xs = 0;
        w1 = xs + up4(MLP_BM * D0);
        b1 = w1 + up4(D0 * n1);
        w2 = b1 + up4(n1);
        b2 = w2 + up4(D1 * n2);
        w3 = b2 + up4(n2);
        b3 = w3 + up4(n2 * D3);
        h1 = b3 + up4(D3);
        h2 = h1 + up4(MLP_BM * D1);
        part = h2 + up4(MLP_BM * n2);
        red = part + up4(MLP_CLUSTER * MLP_BM * D3);
        const int widest = n1 > n2 ? n1 : n2;
        total = red + MLP_BM * (widest > MLP_THREADS ? widest
                                                     : MLP_THREADS);
    }
};

__global__ void __launch_bounds__(MLP_THREADS)
mlp3_kernel(const float* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, const float* __restrict__ w3,
            const float* __restrict__ b3, float* __restrict__ y,
            float* __restrict__ h1, float* __restrict__ h2, int B, int D0,
            int D1, int D2, int D3, int n1, int n2, int sigmoid) {
    extern __shared__ __align__(16) float smem[];
    // member blockIdx.y's slices (0 for a one-network launch)
    const long long pm = blockIdx.y;
    x += pm * B * D0;
    w1 += pm * D0 * D1;
    b1 += pm * D1;
    w2 += pm * D1 * D2;
    b2 += pm * D2;
    w3 += pm * D2 * D3;
    b3 += pm * D3;
    y += pm * B * D3;
    h1 += pm * B * D1;
    h2 += pm * B * D2;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const Layout L(D0, D1, D3, n1, n2);
    float* xs = smem + L.xs;
    float* w1s = smem + L.w1;
    float* b1s = smem + L.b1;
    float* w2s = smem + L.w2;
    float* b2s = smem + L.b2;
    float* w3s = smem + L.w3;
    float* b3s = smem + L.b3;
    float* h1s = smem + L.h1;        // the whole h1 tile [MLP_BM, D1]
    float* h2s = smem + L.h2;        // this CTA's h2 columns [MLP_BM, c2]
    float* part = smem + L.part;     // rank 0: [CLUSTER][MLP_BM][D3]
    float* red = smem + L.red;
    const int row0 = (blockIdx.x / MLP_CLUSTER) * MLP_BM;
    const int rows = min(MLP_BM, B - row0);
    const int j1 = rank * n1, c1 = max(0, min(n1, D1 - j1));
    const int j2 = rank * n2, c2 = max(0, min(n2, D2 - j2));

    // Every CTA of the cluster must be running before any writes into a
    // peer's shared memory: arrive now, wait just before the first write.
    cluster_arrive_relaxed();

    for (int i = threadIdx.x; i < MLP_BM * D0; i += MLP_THREADS) {
        if (i / D0 < rows)
            cp_async4(xs + i, x + (size_t)row0 * D0 + i);
        else
            xs[i] = 0.0f;
    }
    stage(w1s, w1 + j1, D0, c1, D1);
    stage(b1s, b1 + j1, 1, c1, c1);
    cp_commit();
    stage(w2s, w2 + j2, D1, c2, D2);
    stage(b2s, b2 + j2, 1, c2, c2);
    stage(w3s, w3 + (size_t)j2 * D3, c2, D3, D3);
    stage(b3s, b3, 1, D3, D3);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    dense(xs, D0, w1s, b1s, c1, h1s + j1, D1, red);

    cluster_wait();
    for (int i = threadIdx.x; i < MLP_BM * c1; i += MLP_THREADS) {
        const int r = i / c1, idx = r * D1 + j1 + i % c1;
        const float v = h1s[idx];
        for (int p = 1; p < MLP_CLUSTER; ++p)
            *cluster.map_shared_rank(h1s + idx, (rank + p) % MLP_CLUSTER) = v;
        if (r < rows) h1[(size_t)row0 * D1 + idx] = v;
    }
    cp_wait<0>();
    cluster.sync();                  // h1 whole in every CTA; W2 staged

    dense(h1s, D1, w2s, b2s, c2, h2s, c2, red);
    for (int i = threadIdx.x; i < rows * c2; i += MLP_THREADS)
        h2[(size_t)(row0 + i / c2) * D2 + j2 + i % c2] = h2s[i];

    // Layer 3, this CTA's share: a warp per (row, output), lanes over
    // the h2 columns, a fixed shuffle tree; into rank 0's slot `rank`.
    float* part0 = cluster.map_shared_rank(part, 0);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int i = warp; i < MLP_BM * D3; i += MLP_THREADS / 32) {
        const int r = i / D3, j = i % D3;
        float v = 0.0f;
        for (int k = lane; k < c2; k += 32)
            v = fmaf(h2s[r * c2 + k], w3s[k * D3 + j], v);
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
            v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) part0[(rank * MLP_BM + r) * D3 + j] = v;
    }
    cluster.sync();                  // the last touch of a peer's memory

    if (rank == 0)
        for (int i = threadIdx.x; i < rows * D3; i += MLP_THREADS) {
            const int r = i / D3, j = i % D3;
            float v = part[r * D3 + j];
            for (int p = 1; p < MLP_CLUSTER; ++p)
                v += part[(p * MLP_BM + r) * D3 + j];
            v += b3s[j];
            if (sigmoid) v = 1.0f / (1.0f + expf(-v));
            y[(size_t)(row0 + r) * D3 + j] = v;
        }
}

// n1, n2: each CTA's columns of h1 and h2 (kernels/mlp_fused.py::
// mlp3_plan); P: the members (1 for one network), the grid's y extent.
static int mlp3_launch_members(const float* x, const float* w1,
                               const float* b1, const float* w2,
                               const float* b2, const float* w3,
                               const float* b3, float* y, float* h1,
                               float* h2, int B, int D0, int D1, int D2,
                               int D3, int sigmoid, int n1, int n2, int P,
                               void* stream) {
    // Above 48 KB of dynamic shared memory a kernel must opt in; the
    // opt-in and the check that the cluster can be scheduled are kept for
    // the largest size asked so far.  Past the 227 KB a CTA may hold the
    // opt-in fails, and its error is returned.
    static size_t smem_ready = 0;
    if (P < 1 || P > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * Layout(D0, D1, D3, n1, n2).total;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(MLP_CLUSTER * ((B + MLP_BM - 1) / MLP_BM), P);
    cfg.blockDim = dim3(MLP_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = MLP_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (smem > smem_ready) {
        cudaError_t err = cudaFuncSetAttribute(
            mlp3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        int clusters = 0;
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveClusters(&clusters, mlp3_kernel,
                                                 &cfg);
        if (err == cudaSuccess && clusters == 0)
            err = cudaErrorInvalidConfiguration;
        if (err != cudaSuccess) {
            cudaGetLastError();   // clear it, or the next launch reports it
            return (int)err;
        }
        smem_ready = smem;
    }
    cudaError_t err = cudaLaunchKernelEx(&cfg, mlp3_kernel, x, w1, b1,
                                         w2, b2, w3, b3, y, h1, h2, B, D0,
                                         D1, D2, D3, n1, n2, sigmoid);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int mlp3_launch(const float* x, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* w3,
                           const float* b3, float* y, float* h1, float* h2,
                           int B, int D0, int D1, int D2, int D3,
                           int sigmoid, int n1, int n2, void* stream) {
    return mlp3_launch_members(x, w1, b1, w2, b2, w3, b3, y, h1, h2, B, D0,
                               D1, D2, D3, sigmoid, n1, n2, 1, stream);
}

extern "C" int mlp3_members_launch(const float* x, const float* w1,
                                   const float* b1, const float* w2,
                                   const float* b2, const float* w3,
                                   const float* b3, float* y, float* h1,
                                   float* h2, int B, int D0, int D1, int D2,
                                   int D3, int sigmoid, int n1, int n2,
                                   int P, void* stream) {
    return mlp3_launch_members(x, w1, b1, w2, b2, w3, b3, y, h1, h2, B, D0,
                               D1, D2, D3, sigmoid, n1, n2, P, stream);
}
