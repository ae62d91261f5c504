// Ordered sums: out = x_0 + x_1 + ... + x_{w-1} over one axis, added left to
// right, and the slot form out[i] = v[s_i0] + v[s_i1] + ... over a table of
// entry positions (ops/segment.py: ordered_sum, slot_sum).
//
// Replaces no TPU kernel.  The JAX package sums with XLA's reductions and
// segment_sum; the port sums in the order the JAX package's CPU backend adds
// (a chain of elementwise adds, one slice at a time), because the trained
// FullAggNet amplifies rounding about 316x at each InstanceNorm: a sum in
// any other order on the card moves its outputs away from the CPU's.  This
// kernel computes exactly that chain, one launch where the chain took w - 1
// adds (plus an unbind, and a cat and a gather for the slot form).
//
// Arithmetic: one thread per output element; it starts from slice 0 and adds
// slices 1 .. w-1 in order, each add rounded on its own (__fadd_rn /
// __dadd_rn keep nvcc from reassociating or contracting; no fast math).  No
// shared memory, no atomics: every run gives the chain's bits.  In the slot
// form a slot outside [0, E) (segment_slots fills empty slots with E) adds
// +0.0, as the chain's zero pad row does, so -0.0 and NaN propagate as there.
//
// Bound on this card: at the learned cell's shapes (at most 250 x 36 x 8
// values a call) the launch itself, a few microseconds; at a tree_sum level
// of a 600k or 16.8M vector, bytes: each input value read once and each
// output written once at 3.35 TB/s.  The design answers both: one pass, no
// temporaries, the input read through its own strides (no contiguous copy),
// and neighbouring threads on neighbouring outputs, so that where the
// outputs are contiguous in the input each slice's read is coalesced.
//
// Plain C interface (built by nvcc into a shared library, loaded with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

// Most output dimensions a launch takes after the wrapper merges them (must
// equal MAX_DIMS in ops/segment.py).
#define ORDERED_SUM_MAX_DIMS 8

namespace {

// The output's dimensions (row-major, the output is contiguous) and their
// strides in the input, in elements.
struct Geometry {
  int nd;
  int64_t size[ORDERED_SUM_MAX_DIMS];
  int64_t stride[ORDERED_SUM_MAX_DIMS];
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Input offset of contiguous output index i.
__device__ __forceinline__ int64_t offset_of(int64_t i, const Geometry& g) {
  int64_t off = 0;
  for (int d = g.nd - 1; d >= 0; --d) {
    const int64_t s = g.size[d];
    off += (i % s) * g.stride[d];
    i /= s;
  }
  return off;
}

template <typename T>
__global__ void ordered_sum_kernel(const T* __restrict__ x, T* __restrict__ out,
                                   int64_t n_out, Geometry g, int64_t w,
                                   int64_t stride_w) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const T* p = x + offset_of(i, g);
  T acc = p[0];
  for (int64_t k = 1; k < w; ++k) acc = add_rn(acc, p[k * stride_w]);
  out[i] = acc;
}

// out[i, j] = sum_k v[slots[i, k], j] in slot order; j runs over the values'
// trailing dimensions (`inner` elements, geometry g).
template <typename T>
__global__ void slot_sum_kernel(const T* __restrict__ v, const int64_t* __restrict__ slots,
                                T* __restrict__ out, int64_t n_out, int64_t inner,
                                Geometry g, int64_t E, int64_t stride_e, int64_t w,
                                int64_t slot_row, int64_t slot_col) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_out) return;
  const int64_t i = t / inner;
  const T* p = v + offset_of(t - i * inner, g);
  const int64_t* s = slots + i * slot_row;
  int64_t e = s[0];
  T acc = (e >= 0 && e < E) ? p[e * stride_e] : T(0);
  for (int64_t k = 1; k < w; ++k) {
    e = s[k * slot_col];
    acc = add_rn(acc, (e >= 0 && e < E) ? p[e * stride_e] : T(0));
  }
  out[t] = acc;
}

const int kThreads = 256;

// g from geom = [nd, size_0 .. size_{nd-1}, stride_0 .. stride_{nd-1}].
bool read_geometry(const int64_t* geom, Geometry* g) {
  const int64_t nd = geom[0];
  if (nd < 0 || nd > ORDERED_SUM_MAX_DIMS) return false;
  g->nd = (int)nd;
  for (int d = 0; d < ORDERED_SUM_MAX_DIMS; ++d) {
    g->size[d] = d < nd ? geom[1 + d] : 1;
    g->stride[d] = d < nd ? geom[1 + nd + d] : 0;
    if (g->size[d] <= 0) return false;
  }
  return true;
}

// plan = [n_out, w, stride_w, geometry...]
template <typename T>
int launch_ordered(const void* x, void* out, const int64_t* plan, void* stream) {
  Geometry g;
  const int64_t n_out = plan[0], w = plan[1], stride_w = plan[2];
  if (!read_geometry(plan + 3, &g) || w < 1) return (int)cudaErrorInvalidValue;
  if (n_out <= 0) return 0;
  const int64_t blocks = (n_out + kThreads - 1) / kThreads;
  ordered_sum_kernel<T><<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, n_out, g, w, stride_w);
  return (int)cudaGetLastError();
}

// plan = [m, inner, E, stride_e, w, slot_row, slot_col, geometry...]
template <typename T>
int launch_slots(const void* v, const int64_t* slots, void* out, const int64_t* plan,
                 void* stream) {
  Geometry g;
  const int64_t m = plan[0], inner = plan[1], E = plan[2], stride_e = plan[3], w = plan[4];
  if (!read_geometry(plan + 7, &g) || w < 1 || inner < 1) return (int)cudaErrorInvalidValue;
  const int64_t n_out = m * inner;
  if (n_out <= 0) return 0;
  const int64_t blocks = (n_out + kThreads - 1) / kThreads;
  slot_sum_kernel<T><<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)v, slots, (T*)out, n_out, inner, g, E, stride_e, w, plan[5], plan[6]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; `plan` is a host array laid out as above (the
// wrapper's, kept per shape and strides).  `double_precision` selects
// float64, else float32.  Returns the cudaError_t of the launch (0 on
// success), or cudaErrorInvalidValue for a plan it does not take.
int ordered_sum(int double_precision, const void* x, void* out, const int64_t* plan,
                void* stream) {
  return double_precision ? launch_ordered<double>(x, out, plan, stream)
                          : launch_ordered<float>(x, out, plan, stream);
}

int slot_sum(int double_precision, const void* v, const int64_t* slots, void* out,
             const int64_t* plan, void* stream) {
  return double_precision ? launch_slots<double>(v, slots, out, plan, stream)
                          : launch_slots<float>(v, slots, out, plan, stream);
}

}  // extern "C"
