// K3: soft target update t <- (1 - tau) * t + tau * p over one flat f32
// buffer per network (all of its layers concatenated).
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
// the result), 2 multiplies and an add; for the critic's 135,401 elements
// that is 1.6 MB, 0.49 us at 3.35 TB/s.
//
// Design: a grid-stride elementwise loop, one element per thread per step,
// neighbouring threads on neighbouring addresses; the tail is masked (no
// padding to the TPU's 128-lane rows).  The output is a separate buffer;
// the wrapper does not update in place.
#include <cuda_runtime.h>

__global__ void polyak_kernel(const float* __restrict__ t,
                              const float* __restrict__ p,
                              float* __restrict__ out, long long n, float a,
                              float b) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x)
        out[i] = __fadd_rn(__fmul_rn(a, t[i]), __fmul_rn(b, p[i]));
}

extern "C" int polyak_launch(const float* t, const float* p, float* out,
                             long long n, float a, float b, void* stream) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 4096) blocks = 4096;
    polyak_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        t, p, out, n, a, b);
    return (int)cudaGetLastError();
}
