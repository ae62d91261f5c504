// y = alpha * (A @ x) + c for a DIA (diagonal-storage) stencil operand.
//
// Replaces the TPU kernel dia_spmv_pallas (mlamg_tpu/ops/pallas_kernels.py).
// That kernel streams pre-blocked (D, n/128, 128) diagonal blocks and a
// clamped x window (block + halo) into VMEM by hand-double-buffered DMAs,
// and builds shifted x reads from two-slice lane concats because the TPU's
// vector registers are (8, 128) tiles.  None of that is needed on Hopper:
// the port keeps the flat (D, n) layout, one thread computes one row, and
// the hardware caches do the windowing.
//
// Bound on this card: device-memory bytes.  Per row the function reads D
// diagonal values and (once, ideally) one x value and writes one y value,
// (D + 2) * 4 B (+4 B for c) against 2 * D flops, far below the H100's
// ops-per-byte balance.  The design keeps every stream coalesced: for a
// fixed diagonal d, neighbouring threads read neighbouring data[d, i], and
// x[i + off_d] is a shifted contiguous read; the D shifted reads of a warp's
// x window overlap, so after the first they come from L1/L2.  Terms whose
// column i + off_d falls outside [0, n) are skipped: they are the stored
// zeros that the JAX package multiplies by padded x.
//
// Arithmetic order matches the plain version (dia_spmv_reference): sum over
// d = 0..D-1 in f32, then acc * alpha, then + c, each product and sum
// rounded on its own (__fmul_rn / __fadd_rn keep nvcc from contracting
// them into FMAs).
//
// Plain C interface (built by nvcc into a shared library, loaded with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

// Most diagonals one launch takes (must equal DIA_MAX_D in ops/dia.py).
#define DIA_MAX_D 64

namespace {

struct Offsets {
  int64_t v[DIA_MAX_D];
};

__global__ void dia_spmv_kernel(const float* __restrict__ data,
                                const float* __restrict__ x,
                                const float* __restrict__ c,
                                float* __restrict__ y, int64_t n, int D,
                                Offsets offs, float alpha) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) {
    const int64_t j = i + offs.v[d];
    if (j >= 0 && j < n) {
      acc = __fadd_rn(acc, __fmul_rn(data[(int64_t)d * n + i], __ldg(x + j)));
    }
  }
  if (alpha != 1.0f) acc = __fmul_rn(acc, alpha);
  if (c != nullptr) acc = __fadd_rn(acc, c[i]);
  y[i] = acc;
}

}  // namespace

extern "C" {

// Launch on `stream`; `offsets` is a host array of D offsets, `c` may be
// null.  Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue when D is out of range.
int dia_spmv_f32(const float* data, const int64_t* offsets, int D,
                 const float* x, const float* c, float* y, int64_t n,
                 float alpha, void* stream) {
  if (D < 0 || D > DIA_MAX_D) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Offsets offs;
  for (int d = 0; d < DIA_MAX_D; ++d) offs.v[d] = d < D ? offsets[d] : 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  dia_spmv_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      data, x, c, y, n, D, offs, alpha);
  return (int)cudaGetLastError();
}

}  // extern "C"
