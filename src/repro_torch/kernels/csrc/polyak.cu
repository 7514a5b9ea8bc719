// K3: soft target update t <- (1 - tau) * t + tau * p over every leaf of
// the networks being updated (the DDPG step updates the target actor and
// the target critic together: 12 leaves), in one launch.
//
// Replaces: src/repro/kernels/mlp_fused.py:_polyak_kernel (Pallas, TPU).
//
// The coefficients arrive as f32 a = (1 - tau) and b = tau, rounded from
// the host's double as PyTorch rounds a Python scalar; the products and the
// sum use __fmul_rn / __fadd_rn in the order of the plain version
// (kernels/ref.py::polyak_ref), so nvcc cannot fuse them into an FMA and
// the kernel matches it bit for bit.
//
// Bound on the H100: bytes.  12 bytes move per element (read t and p, write
// the result), 2 multiplies and an add; both networks of the DDPG update
// hold ~270k elements, 3.2 MB, 0.97 us at 3.35 TB/s.  A launch costs ~2 us
// on its own, so the update sits at the launch floor: one launch for all
// leaves is the lever, not the loop.
//
// Design: a multi-tensor apply.  The wrapper passes a table of the leaves
// by value (pointers to t, p and the output, element counts, and the first
// block of each leaf); the leaves are read where they are, with no copy
// into a flat buffer.  Each block finds its leaf in the table and takes
// POLYAK_CHUNK elements of it.  Where t, p and the output of a leaf all
// start on 16 bytes the block moves float4s (a leaf's last < 4 elements go
// one by one); otherwise it goes element by element.  The output is one
// buffer the wrapper allocates; the new leaves are views of it (no in-place
// update of the old target).
#include <cuda_runtime.h>

#define POLYAK_MAX_LEAVES 32
#define POLYAK_THREADS 256
#define POLYAK_CHUNK 1024    // elements per block: one float4 per thread

struct PolyakTable {
    const float* t[POLYAK_MAX_LEAVES];
    const float* p[POLYAK_MAX_LEAVES];
    float* out[POLYAK_MAX_LEAVES];
    long long n[POLYAK_MAX_LEAVES];
    int first_block[POLYAK_MAX_LEAVES + 1];
    int leaves;
};

__device__ __forceinline__ float polyak1(float t, float p, float a, float b) {
    return __fadd_rn(__fmul_rn(a, t), __fmul_rn(b, p));
}

__global__ void __launch_bounds__(POLYAK_THREADS)
polyak_kernel(const __grid_constant__ PolyakTable tab, float a, float b) {
    int leaf = 0;
    while (leaf + 1 < tab.leaves && (int)blockIdx.x >= tab.first_block[leaf + 1])
        ++leaf;
    const float* __restrict__ t = tab.t[leaf];
    const float* __restrict__ p = tab.p[leaf];
    float* __restrict__ out = tab.out[leaf];
    const long long n = tab.n[leaf];
    const long long lo =
        (long long)(blockIdx.x - tab.first_block[leaf]) * POLYAK_CHUNK;
    const long long hi = min(n, lo + POLYAK_CHUNK);
    const bool vec = ((reinterpret_cast<unsigned long long>(t)
                       | reinterpret_cast<unsigned long long>(p)
                       | reinterpret_cast<unsigned long long>(out)) & 15) == 0;
    long long i = lo + threadIdx.x;
    if (vec) {
        const long long hi4 = lo + ((hi - lo) & ~3ll);
        for (long long j = lo + 4ll * threadIdx.x; j < hi4;
             j += 4ll * POLYAK_THREADS) {
            const float4 tv = *reinterpret_cast<const float4*>(t + j);
            const float4 pv = *reinterpret_cast<const float4*>(p + j);
            float4 o;
            o.x = polyak1(tv.x, pv.x, a, b);
            o.y = polyak1(tv.y, pv.y, a, b);
            o.z = polyak1(tv.z, pv.z, a, b);
            o.w = polyak1(tv.w, pv.w, a, b);
            *reinterpret_cast<float4*>(out + j) = o;
        }
        i = hi4 + threadIdx.x;
    }
    for (; i < hi; i += POLYAK_THREADS) out[i] = polyak1(t[i], p[i], a, b);
}

// t, p, out: `leaves` device pointers each (as integers); n: their element
// counts (every n >= 1).  Returns a cudaError_t.
extern "C" int polyak_launch(const long long* t, const long long* p,
                             const long long* out, const long long* n,
                             int leaves, float a, float b, void* stream) {
    if (leaves < 1 || leaves > POLYAK_MAX_LEAVES)
        return (int)cudaErrorInvalidValue;
    PolyakTable tab;
    long long blocks = 0;
    for (int i = 0; i < leaves; ++i) {
        if (n[i] < 1) return (int)cudaErrorInvalidValue;
        tab.t[i] = reinterpret_cast<const float*>(t[i]);
        tab.p[i] = reinterpret_cast<const float*>(p[i]);
        tab.out[i] = reinterpret_cast<float*>(out[i]);
        tab.n[i] = n[i];
        tab.first_block[i] = (int)blocks;
        blocks += (n[i] + POLYAK_CHUNK - 1) / POLYAK_CHUNK;
        if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    }
    tab.first_block[leaves] = (int)blocks;
    tab.leaves = leaves;
    polyak_kernel<<<(unsigned)blocks, POLYAK_THREADS, 0,
                    (cudaStream_t)stream>>>(tab, a, b);
    return (int)cudaGetLastError();
}
