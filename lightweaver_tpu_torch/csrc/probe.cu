// Toolchain probes: the two smallest kernels that show the nvcc build,
// the ctypes binding and a launch on PyTorch's stream work end to end.
//
// Replace the TPU probes of scripts/pallas_probe.py:
//   lw_probe_elementwise_f32  <- kernel (line 23):      o = 2 x + 1
//   lw_probe_recurrence_f32   <- sweep_kernel (line 47): o_k = a_k o_{k-1}
//                                + b_k down the rows, o_{-1} = 0
// Plain versions: lightweaver_tpu_torch/ops/probe.py.
//
// Design: one thread per element, and one thread per column walking the
// rows in order (the depth-sweep shape); neighbouring threads read
// neighbouring columns.  Both are a few KB: launch-bound.  2x + 1 is exact
// whether or not nvcc contracts it into an FMA (2x is exact); the
// recurrence's FMA rounds once where the plain version rounds twice.

#include <cuda_runtime.h>

namespace {

__global__ void elementwise_kernel(const float* __restrict__ x,
                                   float* __restrict__ o, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) o[i] = x[i] * 2.0f + 1.0f;
}

__global__ void recurrence_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  float* __restrict__ o, int rows, int cols) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= cols) return;
    float carry = 0.0f;
    for (int k = 0; k < rows; ++k) {
        const size_t off = static_cast<size_t>(k) * cols + c;
        carry = a[off] * carry + b[off];
        o[off] = carry;
    }
}

}  // namespace

extern "C" int lw_probe_elementwise_f32(const float* x, float* o, int n,
                                        void* stream) {
    const int threads = 256;
    elementwise_kernel<<<(n + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, o, n);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int lw_probe_recurrence_f32(const float* a, const float* b,
                                       float* o, int rows, int cols,
                                       void* stream) {
    const int threads = 128;
    recurrence_kernel<<<(cols + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a, b, o, rows,
                                                              cols);
    return static_cast<int>(cudaGetLastError());
}
