// Kernel C1: the CTC lattice over frames for NVIDIA Hopper (sm_90a), as two
// kernels: ctc_lattice_alpha (the forward recursion and the NLL of each row)
// and ctc_lattice_beta (its adjoint, walking the frames downward).
//
// Replaces no Pallas kernel: the JAX package runs this recursion as the
// lax.scan of ppasr_tpu/ops/ctc.py:139-174, which XLA compiles into one loop
// on the TPU. In PyTorch the same scan was a Python loop over frames with
// autograd recording each step: about 40 launches a frame, forward and
// backward. Here each is one launch a loss call.
//
// Semantics (those of the loop lattice_alpha in ppasr_tpu_torch/ops/ctc.py,
// whose forward and autograd backward this arithmetic repeats):
//
// - emit [B, T, S] float32 holds log p of extended label s at frame t; the
//   masks valid / skip [B, S] (bool) come from _extended_labels.
// - alpha_0: emit[0, 0] at s = 0, emit[0, 1] at s = 1 when the row has a
//   label, LOG_EPSILON (-1e30, not -inf) elsewhere and at invalid s.
// - alpha_t(s) = logaddexp(logaddexp(alpha(s), alpha(s-1)), alpha(s-2)) +
//   emit[t, s] for t < the row's input length, alpha(s-2) taken only where
//   skip(s) (closed on a repeated label); the row is frozen after that. The
//   frames a row reaches are n = clamp(input length, 1, T).
// - nll = -logaddexp(alpha(2U), alpha(2U-1)), alpha(0) alone for U = 0.
// - logaddexp as PyTorch's kernel computes it: max + log1p(exp(-|a - b|)).
// - The backward is the adjoint of those operations, with the partials that
//   autograd gives logaddexp: g / (1 + exp(other - self)) to each operand.
//   The three partials that reach alpha(s) are added in the order in which
//   autograd's engine adds them through the loop (from logaddexp's first
//   operand, then from alpha(s+2), then from alpha(s+1)), so long chains of
//   frames round as the loop does.
//   In real arithmetic it equals the alpha-beta formula; in float32 it also
//   keeps the loop's gradient where a row's labels do not fit its frames
//   (every path LOG_EPSILON, where alpha + beta - emit + nll would read 0
//   and put -g on thousands of cells), and it never reads the emissions.
//   A_t(s), the adjoint of alpha_t(s), is an occupation probability times
//   -g: bounded, so it is kept in the linear domain.
//
// What bounds it: the T dependent steps, not bytes or operations. The cell
// moves about 13 MB a micro-step (emissions and alpha in, alpha and the
// gradient out), 4 us at 3.35 TB/s. So the design shortens each step:
//
// - One block per utterance; threads stride over the extended-label axis
//   (ITEMS values of s a thread, s = tid + i * blockDim), so any S up to
//   kMaxItems * 1024 works.
// - Forward: the lattice row lives in shared memory, double-buffered, so a
//   frame costs one barrier. Frame t + 1's emissions are loaded into
//   registers while frame t is computed. Each row of alpha goes to the
//   scratch the backward reads (skipped when no gradient is needed).
// - Backward: each thread keeps the adjoint of its own s in registers. The
//   two partials that move to s - 1 and s - 2 go through shared memory,
//   double-buffered, one barrier a frame. Alpha of frame t - 2 is loaded
//   while frame t - 1 is computed. Frames at or past n get zeros.
// - float32 throughout, IEEE division and the accurate expf / log1pf (no
//   fast math), as PyTorch's own kernels compute them.
//
// Resources: 32 to 1024 threads a block (S rounded up to a warp);
// dynamic shared memory 8 S bytes forward and 16 (S + 2) backward, above
// 48 KB only with the attribute set at launch.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float kLogEpsilon = -1e30f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxItems = 8;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float log_add_exp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

}  // namespace

template <int ITEMS>
__global__ void __launch_bounds__(kMaxThreads)
ctc_lattice_alpha(const float* __restrict__ emit,
                  const bool* __restrict__ valid,
                  const bool* __restrict__ skip,
                  const int* __restrict__ in_lens,
                  const int* __restrict__ label_lens, int T, int S,
                  float* __restrict__ alpha, float* __restrict__ nll) {
  extern __shared__ float rows[];  // [2][S]
  const int b = blockIdx.x;
  const int n = min(max(in_lens[b], 1), T);
  const int L = label_lens[b];
  const float* e_b = emit + (size_t)b * T * S;
  float* a_b = alpha == nullptr ? nullptr : alpha + (size_t)b * T * S;

  unsigned vbits = 0, kbits = 0;
  float e[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int s = threadIdx.x + i * blockDim.x;
    e[i] = 0.f;
    if (s >= S) continue;
    if (valid[(size_t)b * S + s]) vbits |= 1u << i;
    if (skip[(size_t)b * S + s]) kbits |= 1u << i;
    float a = kLogEpsilon;
    if (s == 0) a = e_b[0];
    else if (s == 1 && L > 0) a = e_b[1];
    if (!(vbits >> i & 1u)) a = kLogEpsilon;
    rows[s] = a;
    if (a_b != nullptr) a_b[s] = a;
    if (n > 1) e[i] = e_b[(size_t)S + s];
  }
  __syncthreads();

  for (int t = 1; t < n; ++t) {
    const float* cur = rows + ((t - 1) & 1) * S;
    float* nxt = rows + (t & 1) * S;
    float e_next[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int s = threadIdx.x + i * blockDim.x;
      e_next[i] = (s < S && t + 1 < n) ? e_b[(size_t)(t + 1) * S + s] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int s = threadIdx.x + i * blockDim.x;
      if (s >= S) continue;
      float v = kLogEpsilon;
      if (vbits >> i & 1u) {
        const float p1 = s >= 1 ? cur[s - 1] : kLogEpsilon;
        const float p2 = (kbits >> i & 1u) ? cur[s - 2] : kLogEpsilon;
        v = log_add_exp(log_add_exp(cur[s], p1), p2) + e[i];
      }
      nxt[s] = v;
      if (a_b != nullptr) a_b[(size_t)t * S + s] = v;
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) e[i] = e_next[i];
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    const float* fin = rows + ((n - 1) & 1) * S;
    const float last = fin[min(2 * L, S - 1)];
    const float second = L > 0 ? fin[min(2 * L - 1, S - 1)] : kLogEpsilon;
    nll[b] = -log_add_exp(last, second);
  }
}

template <int ITEMS>
__global__ void __launch_bounds__(kMaxThreads)
ctc_lattice_beta(const float* __restrict__ alpha,
                 const bool* __restrict__ valid,
                 const bool* __restrict__ skip,
                 const int* __restrict__ in_lens,
                 const int* __restrict__ label_lens,
                 const float* __restrict__ grad_nll, long long grad_stride,
                 int T, int S, float* __restrict__ grad_emit) {
  extern __shared__ float shared[];  // gp1 [2][S + 2], gp2 [2][S + 2]
  const int row = S + 2;
  float* gp1 = shared;
  float* gp2 = shared + 2 * row;
  const int b = blockIdx.x;
  const int n = min(max(in_lens[b], 1), T);
  const int L = label_lens[b];
  const float* a_b = alpha + (size_t)b * T * S;
  float* g_b = grad_emit + (size_t)b * T * S;

  if (threadIdx.x < 2) {  // the reads at s + 1 and s + 2 past the row
    gp1[S + threadIdx.x] = gp1[row + S + threadIdx.x] = 0.f;
    gp2[S + threadIdx.x] = gp2[row + S + threadIdx.x] = 0.f;
  }
  for (int t = n; t < T; ++t)
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      g_b[(size_t)t * S + s] = 0.f;

  // the adjoint of the final row: nll = -logaddexp(last, second)
  const float* fin = a_b + (size_t)(n - 1) * S;
  const int i_last = min(2 * L, S - 1);
  const float last = fin[i_last];
  const float second = L > 0 ? fin[min(2 * L - 1, S - 1)] : kLogEpsilon;
  const float g_neg = -grad_nll[(size_t)b * grad_stride];
  const float g_last = g_neg / (1.f + expf(second - last));
  const float g_second = L > 0 ? g_neg / (1.f + expf(last - second)) : 0.f;

  unsigned vbits = 0, kbits = 0;
  float A[ITEMS], pa[ITEMS], pp1[ITEMS], pp2[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int s = threadIdx.x + i * blockDim.x;
    A[i] = pa[i] = pp1[i] = pp2[i] = 0.f;
    if (s >= S) continue;
    if (valid[(size_t)b * S + s]) vbits |= 1u << i;
    if (skip[(size_t)b * S + s]) kbits |= 1u << i;
    if (s == i_last) A[i] = g_last;
    if (L > 0 && s == 2 * L - 1) A[i] += g_second;
    if (n > 1) {
      const float* prev = a_b + (size_t)(n - 2) * S;
      pa[i] = prev[s];
      pp1[i] = s >= 1 ? prev[s - 1] : kLogEpsilon;
      pp2[i] = s >= 2 ? prev[s - 2] : kLogEpsilon;
    }
  }
  __syncthreads();

  int buf = 0;
  for (int t = n - 1; t >= 1; --t) {
    float na[ITEMS], np1[ITEMS], np2[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int s = threadIdx.x + i * blockDim.x;
      na[i] = np1[i] = np2[i] = 0.f;
      if (s < S && t >= 2) {
        const float* prev = a_b + (size_t)(t - 2) * S;
        na[i] = prev[s];
        np1[i] = s >= 1 ? prev[s - 1] : kLogEpsilon;
        np2[i] = s >= 2 ? prev[s - 2] : kLogEpsilon;
      }
    }
    float* q1 = gp1 + buf * row;
    float* q2 = gp2 + buf * row;
    float ga[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int s = threadIdx.x + i * blockDim.x;
      ga[i] = 0.f;
      if (s >= S) continue;
      const float G = (vbits >> i & 1u) ? A[i] : 0.f;
      g_b[(size_t)t * S + s] = G;
      const float a = pa[i];
      const float p1 = s >= 1 ? pp1[i] : kLogEpsilon;
      const bool k = kbits >> i & 1u;
      const float p2 = k ? pp2[i] : kLogEpsilon;
      const float m1 = log_add_exp(a, p1);
      const float g_m1 = G / (1.f + expf(p2 - m1));
      const float g_p2 = G / (1.f + expf(m1 - p2));
      ga[i] = g_m1 / (1.f + expf(p1 - a));
      q1[s] = g_m1 / (1.f + expf(a - p1));
      q2[s] = k ? g_p2 : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int s = threadIdx.x + i * blockDim.x;
      // in the order autograd adds them up: the operand, then the skip
      if (s < S) A[i] = (ga[i] + q2[s + 2]) + q1[s + 1];
      pa[i] = na[i];
      pp1[i] = np1[i];
      pp2[i] = np2[i];
    }
    buf ^= 1;
  }

  // alpha_0 holds emit[0, 0] at s = 0 and emit[0, 1] at s = 1 (with a label)
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int s = threadIdx.x + i * blockDim.x;
    if (s >= S) continue;
    const bool own = s == 0 || (s == 1 && L > 0);
    g_b[s] = (own && (vbits >> i & 1u)) ? A[i] : 0.f;
  }
}

namespace {

// threads a block and values of s a thread for an extended-label axis of S
int threads_for(int S) {
  const int warps = (S + 31) / 32;
  return warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
}

template <int ITEMS>
cudaError_t launch_alpha(int B, int T, int S, int threads, const float* emit,
                         const bool* valid, const bool* skip,
                         const int* in_lens, const int* label_lens,
                         float* alpha, float* nll, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)S * sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        ctc_lattice_alpha<ITEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  ctc_lattice_alpha<ITEMS><<<B, threads, smem, stream>>>(
      emit, valid, skip, in_lens, label_lens, T, S, alpha, nll);
  return cudaGetLastError();
}

template <int ITEMS>
cudaError_t launch_beta(int B, int T, int S, int threads, const float* alpha,
                        const bool* valid, const bool* skip,
                        const int* in_lens, const int* label_lens,
                        const float* grad_nll, long long grad_stride,
                        float* grad_emit, cudaStream_t stream) {
  const size_t smem = 4 * ((size_t)S + 2) * sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        ctc_lattice_beta<ITEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  ctc_lattice_beta<ITEMS><<<B, threads, smem, stream>>>(
      alpha, valid, skip, in_lens, label_lens, grad_nll, grad_stride, T, S,
      grad_emit);
  return cudaGetLastError();
}

}  // namespace

// emit [B, T, S] float32, valid / skip [B, S] bool, in_lens / label_lens [B]
// int32, all contiguous on one device. alpha [B, T, S] (or null: the NLL
// only) and nll [B] are written.
extern "C" int ctc_lattice_alpha_launch(const float* emit, const bool* valid,
                                        const bool* skip, const int* in_lens,
                                        const int* label_lens, int B, int T,
                                        int S, float* alpha, float* nll,
                                        void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || S <= 0 || S > kMaxItems * kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const int threads = threads_for(S);
  const int items = (S + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (items <= 1)
    err = launch_alpha<1>(B, T, S, threads, emit, valid, skip, in_lens,
                          label_lens, alpha, nll, s);
  else if (items <= 2)
    err = launch_alpha<2>(B, T, S, threads, emit, valid, skip, in_lens,
                          label_lens, alpha, nll, s);
  else if (items <= 4)
    err = launch_alpha<4>(B, T, S, threads, emit, valid, skip, in_lens,
                          label_lens, alpha, nll, s);
  else
    err = launch_alpha<8>(B, T, S, threads, emit, valid, skip, in_lens,
                          label_lens, alpha, nll, s);
  return (int)err;
}

// alpha [B, T, S] from ctc_lattice_alpha_launch; grad_nll holds row b's
// incoming gradient at b * grad_stride (0 for an expanded scalar); writes
// every element of grad_emit [B, T, S].
extern "C" int ctc_lattice_beta_launch(const float* alpha, const bool* valid,
                                       const bool* skip, const int* in_lens,
                                       const int* label_lens,
                                       const float* grad_nll,
                                       long long grad_stride, int B, int T,
                                       int S, float* grad_emit,
                                       void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || S <= 0 || S > kMaxItems * kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const int threads = threads_for(S);
  const int items = (S + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (items <= 1)
    err = launch_beta<1>(B, T, S, threads, alpha, valid, skip, in_lens,
                         label_lens, grad_nll, grad_stride, grad_emit, s);
  else if (items <= 2)
    err = launch_beta<2>(B, T, S, threads, alpha, valid, skip, in_lens,
                         label_lens, grad_nll, grad_stride, grad_emit, s);
  else if (items <= 4)
    err = launch_beta<4>(B, T, S, threads, alpha, valid, skip, in_lens,
                         label_lens, grad_nll, grad_stride, grad_emit, s);
  else
    err = launch_beta<8>(B, T, S, threads, alpha, valid, skip, in_lens,
                         label_lens, grad_nll, grad_stride, grad_emit, s);
  return (int)err;
}
