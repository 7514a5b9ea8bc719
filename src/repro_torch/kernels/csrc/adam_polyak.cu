// Fused Adam + Polyak: one pass over every leaf of one network of a
// population (P members stacked on a leading axis) that takes the Adam
// step with its bias correction folded into per-member scalars and then
// the soft target update on the new parameters:
//   lr_t  = lr * sqrt(1 - b2^t) / (1 - b1^t),  eps_t = eps * sqrt(1 - b2^t)
//   m <- b1 m + (1 - b1) g,  v <- b2 v + (1 - b2) g g
//   p <- p - lr_t m / (sqrt(v) + eps_t),  target <- (1 - tau) target + tau p
// p, m, v and the target are updated in place; t is the (P,) int32 step
// count after this step (the wrapper increments it before the launch).
//
// Replaces: no Pallas kernel.  The JAX package computes this pass
// (src/repro/core/ddpg.py: _fused_adam_polyak) with jnp outside any kernel;
// as plain PyTorch it is ~10 elementwise kernels a leaf, which is what the
// megabatched population update (core/ddpg.py: _mega_update_step) would
// otherwise launch twice a step.
//
// Arithmetic: lr_t and eps_t come from t on the device (powf, as PyTorch's
// pow of a float scalar base and a float tensor exponent); every product,
// sum, quotient and root is __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn /
// __fsqrt_rn in the order of the plain version (kernels/ref.py::
// fused_adam_polyak_ref), so nvcc cannot contract them into FMAs and the
// kernel matches it bit for bit.
//
// Bound on the H100: bytes.  36 bytes move per element (read p, m, v, g and
// the target, write p, m, v and the target) for ~14 operations; the paper
// trunk's critic (36 -> 400 -> 300 -> 1, 135,401 elements) over P = 3
// members is 14.6 MB, 4.37 us at 3.35 TB/s.
//
// Design: a multi-tensor apply, as K3 (csrc/polyak.cu): the wrapper passes
// a table of the network's leaves by value (pointers to p, m, v, g and the
// target, the elements a member holds, the first block of each leaf); the
// grid's y axis is the member, so each block works inside one member's
// slice and computes that member's lr_t and eps_t once per thread.
#include <cuda_runtime.h>
#include <math.h>

#define AP_MAX_LEAVES 16
#define AP_THREADS 256
#define AP_CHUNK 1024        // elements of one member's leaf per block

struct AdamTable {
    float* p[AP_MAX_LEAVES];
    float* m[AP_MAX_LEAVES];
    float* v[AP_MAX_LEAVES];
    const float* g[AP_MAX_LEAVES];
    float* tg[AP_MAX_LEAVES];
    long long n[AP_MAX_LEAVES];          // elements per member
    int first_block[AP_MAX_LEAVES + 1];
    int leaves;
};

struct AdamScalars {
    float lr, b1, b2, omb1, omb2, eps, omtau, tau;
};

__global__ void __launch_bounds__(AP_THREADS)
adam_polyak_kernel(const __grid_constant__ AdamTable tab,
                   const __grid_constant__ AdamScalars k,
                   const int* __restrict__ t) {
    int leaf = 0;
    while (leaf + 1 < tab.leaves &&
           (int)blockIdx.x >= tab.first_block[leaf + 1])
        ++leaf;
    const long long n = tab.n[leaf];
    const long long base = (long long)blockIdx.y * n;
    float* __restrict__ p = tab.p[leaf] + base;
    float* __restrict__ m = tab.m[leaf] + base;
    float* __restrict__ v = tab.v[leaf] + base;
    const float* __restrict__ g = tab.g[leaf] + base;
    float* __restrict__ tg = tab.tg[leaf] + base;

    const float tf = (float)t[blockIdx.y];
    const float c1 = __fsub_rn(1.0f, powf(k.b1, tf));
    const float c2 = __fsub_rn(1.0f, powf(k.b2, tf));
    const float sc2 = __fsqrt_rn(c2);
    const float lr_t = __fdiv_rn(__fmul_rn(k.lr, sc2), c1);
    const float eps_t = __fmul_rn(k.eps, sc2);

    const long long lo =
        (long long)(blockIdx.x - tab.first_block[leaf]) * AP_CHUNK;
    const long long hi = min(n, lo + AP_CHUNK);
    for (long long i = lo + threadIdx.x; i < hi; i += AP_THREADS) {
        const float gi = g[i];
        const float m2 = __fadd_rn(__fmul_rn(k.b1, m[i]),
                                   __fmul_rn(k.omb1, gi));
        const float v2 = __fadd_rn(__fmul_rn(k.b2, v[i]),
                                   __fmul_rn(__fmul_rn(k.omb2, gi), gi));
        const float p2 = __fsub_rn(
            p[i], __fdiv_rn(__fmul_rn(lr_t, m2),
                            __fadd_rn(__fsqrt_rn(v2), eps_t)));
        p[i] = p2;
        m[i] = m2;
        v[i] = v2;
        tg[i] = __fadd_rn(__fmul_rn(k.omtau, tg[i]), __fmul_rn(k.tau, p2));
    }
}

// p, m, v, g, tg: `leaves` device pointers each (as integers), each leaf
// [P, n[i]] contiguous; n: elements per member (every n >= 1); t: the (P,)
// int32 step counts after this step; lr, b1, b2, omb1 = 1 - b1, omb2 =
// 1 - b2, eps, omtau = 1 - tau and tau each rounded to f32 from the host's
// double, as PyTorch rounds a Python scalar.
// Returns a cudaError_t.
extern "C" int adam_polyak_launch(const long long* p, const long long* m,
                                  const long long* v, const long long* g,
                                  const long long* tg, const long long* n,
                                  int leaves, int P, const int* t,
                                  float lr, float b1, float b2, float omb1,
                                  float omb2, float eps, float omtau,
                                  float tau, void* stream) {
    if (leaves < 1 || leaves > AP_MAX_LEAVES || P < 1 || P > 65535)
        return (int)cudaErrorInvalidValue;
    AdamTable tab;
    long long blocks = 0;
    for (int i = 0; i < leaves; ++i) {
        if (n[i] < 1) return (int)cudaErrorInvalidValue;
        tab.p[i] = reinterpret_cast<float*>(p[i]);
        tab.m[i] = reinterpret_cast<float*>(m[i]);
        tab.v[i] = reinterpret_cast<float*>(v[i]);
        tab.g[i] = reinterpret_cast<const float*>(g[i]);
        tab.tg[i] = reinterpret_cast<float*>(tg[i]);
        tab.n[i] = n[i];
        tab.first_block[i] = (int)blocks;
        blocks += (n[i] + AP_CHUNK - 1) / AP_CHUNK;
        if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    }
    tab.first_block[leaves] = (int)blocks;
    tab.leaves = leaves;
    const AdamScalars k = {lr, b1, b2, omb1, omb2, eps, omtau, tau};
    adam_polyak_kernel<<<dim3((unsigned)blocks, (unsigned)P), AP_THREADS, 0,
                         (cudaStream_t)stream>>>(tab, k, t);
    return (int)cudaGetLastError();
}
