// K1: per-channel fake quantization (paper Eq. 3), quantize-clip-dequantize.
//
// Replaces: src/repro/kernels/fake_quant.py:fake_quant_kernel (Pallas, TPU).
//
// x is [R, C] f32, row-major, with the channel axis last; the dynamic range
// of channel c is reduced over all R rows.  Per channel:
//   span = max(max - min, 1e-8);  s = n / ((min + span) - min)
//   z = floor(s * min) + 2^(b-1);  q = clip(floor(s * x - z), -n, n)
//   out = (q + z + 0.5) / s        with n = 2^b - 1, b = clip(bits, 1, 31)
// and bits >= 32 passes x through.  The arithmetic is that of the port's
// plain version (kernels/ref.py::fake_quant_ref, itself the JAX package's
// core/quantization.py::fake_quant), written with the _rn intrinsics so
// nvcc cannot contract s * x - z into an FMA: floor() turns a one-ulp
// difference into a whole quantization step.  Build without
// --use_fast_math and without -ftz (subnormals are kept, as in PyTorch).
//
// Bound on the H100: bytes.  Each element is read and written once by the
// function (8 bytes), against ~10 f32 operations; at [3072, 1024] that is
// 25 MB, 7.5 us at 3.35 TB/s.
//
// Design: one block owns FQ_COLS = 32 consecutive channels and all R rows,
// so the min/max reduction never crosses blocks (the TPU kernel's
// (R, bc) block, without its lane padding: the ragged column edge is
// masked here).  Each warp reads one row's 32 channels per step, coalesced
// (128 bytes).  Phase 1 reduces min/max per channel over the block's warps
// through shared memory; phase 2 reads x again (from L2 at the path's
// sizes: 12.6 MB at most) and writes the dequantized values.  At C = 256
// this is only 8 blocks on 132 SMs: a wider grid needs a cross-block
// reduction (a second pass), which is left for the PR that makes it fast.
#include <cuda_runtime.h>
#include <math.h>

#define FQ_COLS 32
#define FQ_WARPS 16

__global__ void fake_quant_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int R, int C,
                                  int bits) {
    __shared__ float s_min[FQ_WARPS][FQ_COLS];
    __shared__ float s_max[FQ_WARPS][FQ_COLS];
    const int lane = threadIdx.x % FQ_COLS;
    const int warp = threadIdx.x / FQ_COLS;
    const int c = blockIdx.x * FQ_COLS + lane;
    const bool live = c < C;

    if (bits >= 32) {
        if (live)
            for (int r = warp; r < R; r += FQ_WARPS)
                out[(size_t)r * C + c] = x[(size_t)r * C + c];
        return;
    }

    float mn = INFINITY, mx = -INFINITY;
    if (live)
        for (int r = warp; r < R; r += FQ_WARPS) {
            float v = x[(size_t)r * C + c];
            mn = fminf(mn, v);
            mx = fmaxf(mx, v);
        }
    s_min[warp][lane] = mn;
    s_max[warp][lane] = mx;
    __syncthreads();
    if (warp == 0) {
        for (int w = 1; w < FQ_WARPS; ++w) {
            mn = fminf(mn, s_min[w][lane]);
            mx = fmaxf(mx, s_max[w][lane]);
        }
        s_min[0][lane] = mn;
        s_max[0][lane] = mx;
    }
    __syncthreads();
    if (!live) return;
    mn = s_min[0][lane];
    mx = s_max[0][lane];

    const int b = bits < 1 ? 1 : (bits > 31 ? 31 : bits);
    const float n = __fsub_rn(exp2f((float)b), 1.0f);   // exact for integer b
    const float half = exp2f((float)(b - 1));
    const float span = fmaxf(__fsub_rn(mx, mn), 1e-8f);
    const float s = __fdiv_rn(n, __fsub_rn(__fadd_rn(mn, span), mn));
    const float z = __fadd_rn(floorf(__fmul_rn(s, mn)), half);
    for (int r = warp; r < R; r += FQ_WARPS) {
        const size_t i = (size_t)r * C + c;
        float q = floorf(__fsub_rn(__fmul_rn(s, x[i]), z));
        q = fminf(fmaxf(q, -n), n);
        out[i] = __fdiv_rn(__fadd_rn(__fadd_rn(q, z), 0.5f), s);
    }
}

extern "C" int fake_quant_launch(const float* x, float* out, int R, int C,
                                 int bits, void* stream) {
    dim3 grid((C + FQ_COLS - 1) / FQ_COLS);
    fake_quant_kernel<<<grid, FQ_COLS * FQ_WARPS, 0,
                        (cudaStream_t)stream>>>(x, out, R, C, bits);
    return (int)cudaGetLastError();
}
