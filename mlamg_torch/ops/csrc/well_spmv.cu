// y = alpha * (A @ x) + c for a sliced-ELL (SELL-32-sigma) operand with
// absolute columns.
//
// Replaces the TPU kernel well_spmv_pallas (mlamg_tpu/ops/unstructured.py).
// That kernel windows x into VMEM per 128*RB-row block and rebuilds the
// gather x[col] from per-chunk lane gathers, because the TPU cannot gather
// across VMEM rows.  Hopper gathers natively, so none of that is kept: each
// slot stores an absolute column id and x[col] is read through the
// read-only cache.
//
// Bound on this card: device-memory bytes.  The function must read each
// nonzero's value and column (8 B) once, x once and write y once; it does
// one multiply-add per nonzero, far below the H100's ops-per-byte balance.
// What the design does about it:
//
// - Padding.  JAX's ELL pads every row to the matrix's widest row, which
//   streams 1.9x (fine level) to 2.9x the nonzeros' slots.  The pack sorts
//   rows by degree inside windows of sigma rows and cuts them into slices
//   of 32 rows, each only as wide as its widest row (ops/unstructured.py).
//   Slot j of lane l in slice s sits at slice_ptr[s] + 32 * j + l, so a
//   warp's load of one slot is one coalesced 128 B access.
// - Small levels.  One warp per slice leaves the coarse levels (24k and 4.8k
//   rows) with too few warps to cover memory latency.  LANES warps share a
//   slice: warp p sums slots j = p, p + LANES, ... , and the parts meet in
//   shared memory.  The wrapper picks LANES per operator (choose_lanes).
// - Latency.  The slot loop is unrolled so that UNROLL column loads, then
//   their gathers, are in flight per thread, with the last step cut short
//   by predicates rather than run slot by slot; each lane loads its output
//   row and c before the loop.  Everything is read through the read-only
//   cache (__ldg).  The evict-first hint (__ldcs) on sdata and scol was
//   measured: it gains nothing at the fine level and costs at the coarse
//   levels, whose packs otherwise stay in L2 from one SpMV to the next.
//
// Arithmetic order matches the plain version (sliced_spmv_reference): each
// part sums its slots in order from 0, the parts are added in order 0..LANES-1,
// then acc * alpha, then + c, each product and sum rounded on its own
// (__fmul_rn / __fadd_rn keep nvcc from contracting them into FMAs).  With
// LANES = 1 that is plain slot order.
//
// Plain C interface (built by nvcc into a shared library, loaded with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLICE = 32;     // rows per slice (ops/unstructured.py SLICE)
constexpr int THREADS = 256;  // 8 warps per block
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;     // slots per step whose loads are in flight together

template <int LANES>
__global__ void __launch_bounds__(THREADS)
well_spmv_kernel(const float* __restrict__ sdata, const int32_t* __restrict__ scol,
                 const int32_t* __restrict__ slice_ptr,
                 const int32_t* __restrict__ slice_w,
                 const int32_t* __restrict__ row_perm, const float* __restrict__ x,
                 const float* __restrict__ c, float* __restrict__ y, int n,
                 int n_slices, float alpha) {
  constexpr int SLICES_PER_BLOCK = WARPS / LANES;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int part = warp % LANES;
  const int s = blockIdx.x * SLICES_PER_BLOCK + warp / LANES;

  // The output row and its c are loaded first, so that their latency hides
  // behind the slot loop's; n marks a lane that writes nothing (a dummy lane
  // of the last slice, a slice past the end, or a part other than 0).
  int row = n;
  float cv = 0.0f;
  if (part == 0 && s < n_slices) {
    row = __ldg(row_perm + s * SLICE + lane);
    if (c != nullptr && row < n) cv = __ldg(c + row);
  }

  float acc = 0.0f;
  if (s < n_slices) {
    const int w = slice_w[s];
    const int base = slice_ptr[s] + lane;
    const float* d = sdata + base;
    const int32_t* k = scol + base;
    // UNROLL of this part's slots per step, the last step cut short by
    // predicates, so that a row's column loads, then its gathers, go out
    // together even when its width is not a multiple of UNROLL.
    for (int j = part; j < w; j += UNROLL * LANES) {
      int cols[UNROLL];
      float vals[UNROLL];
      float xs[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const bool live = j + u * LANES < w;
        cols[u] = live ? __ldg(k + SLICE * (j + u * LANES)) : 0;
        vals[u] = live ? __ldg(d + SLICE * (j + u * LANES)) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) xs[u] = j + u * LANES < w ? __ldg(x + cols[u]) : 0.0f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (j + u * LANES < w) acc = __fadd_rn(acc, __fmul_rn(vals[u], xs[u]));
      }
    }
  }

  if constexpr (LANES > 1) {
    __shared__ float parts[WARPS][SLICE];
    parts[warp][lane] = acc;
    __syncthreads();
    if (part != 0) return;
#pragma unroll
    for (int p = 1; p < LANES; ++p) acc = __fadd_rn(acc, parts[warp + p][lane]);
  }
  if (row >= n) return;
  if (alpha != 1.0f) acc = __fmul_rn(acc, alpha);
  if (c != nullptr) acc = __fadd_rn(acc, cv);
  y[row] = acc;
}

template <int LANES>
cudaError_t launch(const float* sdata, const int32_t* scol,
                   const int32_t* slice_ptr, const int32_t* slice_w,
                   const int32_t* row_perm, const float* x, const float* c, float* y,
                   int n, int n_slices, float alpha, cudaStream_t stream) {
  constexpr int SLICES_PER_BLOCK = WARPS / LANES;
  const unsigned int blocks = (n_slices + SLICES_PER_BLOCK - 1) / SLICES_PER_BLOCK;
  well_spmv_kernel<LANES><<<blocks, THREADS, 0, stream>>>(
      sdata, scol, slice_ptr, slice_w, row_perm, x, c, y, n, n_slices, alpha);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` with `lanes` (1, 2, 4 or 8) warps per slice; `c` may
// be null.  Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue when `lanes` is not one of those.
int well_spmv_f32(const float* sdata, const int32_t* scol, const int32_t* slice_ptr,
                  const int32_t* slice_w, const int32_t* row_perm, const float* x,
                  const float* c, float* y, int n, int n_slices, int lanes,
                  float alpha, void* stream) {
  if (n <= 0 || n_slices <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (lanes) {
    case 1:
      return (int)launch<1>(sdata, scol, slice_ptr, slice_w, row_perm, x, c, y,
                            n, n_slices, alpha, st);
    case 2:
      return (int)launch<2>(sdata, scol, slice_ptr, slice_w, row_perm, x, c, y,
                            n, n_slices, alpha, st);
    case 4:
      return (int)launch<4>(sdata, scol, slice_ptr, slice_w, row_perm, x, c, y,
                            n, n_slices, alpha, st);
    case 8:
      return (int)launch<8>(sdata, scol, slice_ptr, slice_w, row_perm, x, c, y,
                            n, n_slices, alpha, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
