// y = alpha * (A @ x) + c for a slot-major ELL operand with absolute columns.
//
// Replaces the TPU kernel well_spmv_pallas (mlamg_tpu/ops/unstructured.py).
// That kernel windows x into VMEM per 128*RB-row block and rebuilds the
// gather x[col] from per-chunk lane gathers, because the TPU cannot gather
// across VMEM rows.  Hopper gathers natively, so none of that is kept: the
// layout stores absolute column ids and each thread reads x[col] through the
// read-only cache.
//
// Bound on this card: device-memory bytes.  Per stored slot the kernel reads
// one f32 value and one i32 column (8 B) and does one multiply-add, far
// below the H100's ops-per-byte balance.  The design keeps those streams
// coalesced: data and col are slot-major (w, n_pad), so for a fixed slot j
// neighbouring threads (rows) read neighbouring addresses.  x itself is read
// at RCM-banded columns, so a warp's gathers fall in a narrow window that
// stays in L1/L2.
//
// Arithmetic order matches the plain version (well_spmv_reference): sum over
// slots j = 0..w-1 in f32, then acc * alpha, then + c.
//
// Plain C interface (built by nvcc into a shared library, loaded with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void well_spmv_kernel(const float* __restrict__ data,
                                 const int32_t* __restrict__ col,
                                 const float* __restrict__ x,
                                 const float* __restrict__ c,
                                 float* __restrict__ y, int64_t n,
                                 int64_t n_pad, int w, float alpha) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // Padding rows (row >= n) carry col = row; they are never computed, so x
  // is never read past n.
  if (row >= n) return;
  float acc = 0.0f;
  for (int j = 0; j < w; ++j) {
    const int64_t k = (int64_t)j * n_pad + row;
    acc += data[k] * __ldg(x + col[k]);
  }
  acc = acc * alpha;
  if (c != nullptr) acc = acc + c[row];
  y[row] = acc;
}

}  // namespace

extern "C" {

// Launch on `stream`; `c` may be null.  Returns the cudaError_t of the launch
// (0 on success).
int well_spmv_f32(const float* data, const int32_t* col, const float* x,
                  const float* c, float* y, int64_t n, int64_t n_pad, int w,
                  float alpha, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  well_spmv_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      data, col, x, c, y, n, n_pad, w, alpha);
  return (int)cudaGetLastError();
}

}  // extern "C"
