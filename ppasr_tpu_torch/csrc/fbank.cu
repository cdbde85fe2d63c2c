// Fused kaldi log-mel fbank for NVIDIA Hopper (sm_90a).
//
// Replaces ppasr_tpu/ops/fbank_pallas.py::_fbank_kernel (the TPU kernel
// launched by fbank_frames_pallas). Per frame of 400 int16-scaled samples:
// DC removal over the 400 samples -> pre-emphasis 0.97 with the first
// sample replicated -> povey window -> 512-point real DFT (bins 0..255; bin
// 256, the nyquist bin, has zero mel weight) -> power -> mel projection ->
// log(max(mel, 1.19e-7)). Frame f starts at wav + f * frame_stride, so
// stride 400 reads a [N, 400] frame matrix and stride 160 reads the frames
// straight out of a waveform (fusing the framing step).
//
// Training dither (ppasr_tpu/ops/fbank.py:262-264): with a noise pointer,
// frame f adds its own row of 400 Gaussian draws right after the load,
// before the DC mean, so two frames that share samples get independent
// noise. Frames come in groups of noise_group (the k = S / 160 frames of one
// row of a flat batch); frame t of group g reads noise row g * noise_rows + t
// and frames with t >= noise_rows (those that straddle two rows and are
// dropped) add none. The noise costs 1,600 bytes a frame of extra reads.
//
// What bounds it: bytes. An FFT-based fbank does about 15k fp32 operations
// per frame against 1.6 KB read, under the card's 20 operations a byte.
// The design keeps everything after the load in registers and a small
// per-warp shared buffer:
//
// - One warp per frame, kWarps frames per block. The 512 real samples are
//   packed as 256 complex values z[n] = x[2n] + i x[2n+1] (z[n] = 0 for
//   n >= 200), and lane t loads z[t + 32 j], j < 7, as one 8-byte load
//   where the frame pointer is 8-byte aligned (two 4-byte loads where it is
//   not, as for a view at an odd offset): neighbouring lanes read
//   neighbouring samples. DC mean and pre-emphasis use warp shuffles.
// - A 256-point complex FFT, 256 = 8 * 8 * 4, decimated in frequency with
//   n = t + 32 j and k = q + 8 r + 64 s:
//     pass 1: lane t, radix 8 over j, times W256^(t q);
//     exchange through shared rows of 36 floats (lane 4 q + t0 reads
//     element q of lanes t0 + 4 t1);
//     pass 2: lane 4 q + t0, radix 8 over t1, times W32^(t0 r);
//     exchange through shared rows of 33 floats (lane q + 8 m reads element
//     r = m, m + 4 of lanes 4 q + t0);
//     pass 3: lane q + 8 m, two radix 4s over t0.
//   Lane M then holds Z[M + 32 j]. Both row strides make every exchange
//   free of bank conflicts.
// - The split step X[k] = (Z[k] + conj Z[256-k]) / 2
//   - i W512^k (Z[k] - conj Z[256-k]) / 2 takes Z[256-k] from lane 32 - M
//   by shuffle. The power |X[k]|^2 goes to the warp's shared buffer.
// - Twiddles have the exact angles cos/sin(pi j / 256) = sincospif(j/256),
//   computed once per block into a table laid out per lane (row = use,
//   column = lane), so every read is one conflict-free row.
// - The mel projection is banded: filter m sums its own contiguous run of
//   bins (first bin, length, offset into the packed weights; 501 weights in
//   all at 80 mels), one filter per lane at a time, from the power left in
//   shared memory. An empty filter writes log(1.19e-7).
// - fp32 on the CUDA cores only, no TF32 or bf16: a low-precision DFT
//   loses the pre-emphasis-suppressed low bins to cancellation
//   (ppasr_tpu/ops/fbank.py:239-245). The butterflies' rounding error grows
//   with log2 of the length, where the direct sum's grew with the length.
//
// Resources: 256 threads a block, 29,184 bytes of static shared memory
// (twiddles 5,632, mel tables 5,120, exchange buffers 8 x 2,304); 40
// registers and no spills in both instantiations (ptxas -v, sm_90a).
//
// Built with plain nvcc into a shared library with a C interface and loaded
// with ctypes (ppasr_tpu_torch/ops/fbank_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWin = 400;            // 25 ms at 16 kHz
constexpr int kHalf = kWin / 2;      // packed complex samples
constexpr int kWarps = 8;            // frames per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxMels = 256;
constexpr int kMaxWeights = 512;     // a bin lies in at most two triangles
constexpr int kTw1 = 0;              // twiddle rows: pass 1 (q = 1..7)
constexpr int kTw2 = 7;              // pass 2 (r = 1..7)
constexpr int kTw3 = 14;             // split step (j = 0..7)
constexpr int kTwRows = 22;
constexpr int kRow1 = 36;            // exchange 1 row stride, 4 mod 32
constexpr int kRow2 = 33;            // exchange 2 row stride, 1 mod 32
constexpr int kBuf = 8 * kRow1;      // also holds 8 * kRow2 and 256 powers
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLogFloor = 1.1920928955078125e-07f;
constexpr float kH = 0.70710678118654752f;   // cos(pi / 4)

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// a * conj(w): w = (cos, sin) of the table, conj(w) = W512^j
__device__ __forceinline__ float2 mul_conj(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, a.y * w.y), fmaf(a.y, w.x, -a.x * w.y));
}

// forward 4-point DFT in place, natural order
__device__ __forceinline__ void dft4(float2& b0, float2& b1, float2& b2,
                                     float2& b3) {
  const float2 c0 = add(b0, b2), c1 = sub(b0, b2), c2 = add(b1, b3);
  const float2 c3 = make_float2(b1.y - b3.y, b3.x - b1.x);  // (b1 - b3) * -i
  b0 = add(c0, c2);
  b1 = add(c1, c3);
  b2 = sub(c0, c2);
  b3 = sub(c1, c3);
}

// forward 8-point DFT in place, natural order: span-4 butterflies, the
// differences times W8^n, then a 4-point DFT of each half
__device__ __forceinline__ void dft8(float2 (&a)[8]) {
  float2 u[4], v[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    u[n] = add(a[n], a[n + 4]);
    v[n] = sub(a[n], a[n + 4]);
  }
  v[1] = make_float2(kH * (v[1].x + v[1].y), kH * (v[1].y - v[1].x));
  v[2] = make_float2(v[2].y, -v[2].x);
  v[3] = make_float2(kH * (v[3].y - v[3].x), -kH * (v[3].x + v[3].y));
  dft4(u[0], u[1], u[2], u[3]);
  dft4(v[0], v[1], v[2], v[3]);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    a[2 * n] = u[n];
    a[2 * n + 1] = v[n];
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
fbank_kernel(const float* __restrict__ wav, long long frame_stride,
             int n_frames, const float* __restrict__ window,
             const int* __restrict__ mel_band,
             const float* __restrict__ mel_w, int n_mels, float preemph,
             int remove_dc, const float* __restrict__ noise,
             long long noise_stride, int noise_group, int noise_rows,
             float* __restrict__ out) {
  __shared__ float2 tw[kTwRows][32];
  __shared__ int band_first[kMaxMels];
  __shared__ int band_len[kMaxMels];
  __shared__ int band_off[kMaxMels];
  __shared__ float weights[kMaxWeights];
  __shared__ float buf_re[kWarps][kBuf];
  __shared__ float buf_im[kWarps][kBuf];

  const int tid = threadIdx.x;
  for (int e = tid; e < kTwRows * 32; e += kThreads) {
    const int row = e >> 5, l = e & 31;
    int j;
    if (row < kTw2) {
      j = 2 * l * (row - kTw1 + 1);        // W256^(t q), t = l
    } else if (row < kTw3) {
      j = 16 * (l & 3) * (row - kTw2 + 1); // W32^(t0 r), t0 = l & 3
    } else {
      j = l + 32 * (row - kTw3);           // W512^k, k = l + 32 j
    }
    float s, c;
    sincospif((float)j / 256.0f, &s, &c);
    tw[row][l] = make_float2(c, s);
  }
  for (int m = tid; m < n_mels; m += kThreads) {
    band_first[m] = mel_band[3 * m];
    band_len[m] = mel_band[3 * m + 1];
    band_off[m] = mel_band[3 * m + 2];
  }
  const int n_weights = min(mel_band[3 * n_mels - 1] +
                            mel_band[3 * n_mels - 2], kMaxWeights);
  for (int i = tid; i < n_weights; i += kThreads) weights[i] = mel_w[i];
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const long long f = (long long)blockIdx.x * kWarps + warp;
  if (f >= n_frames) return;
  const float* x = wav + f * frame_stride;
  const float* nz = nullptr;
  if (noise != nullptr) {
    const long long g = f / noise_group, t = f - g * noise_group;
    if (t < noise_rows) nz = noise + (g * noise_rows + t) * noise_stride;
  }

  // lane t holds z[t + 32 j] = (x[2n], x[2n+1]), n = t + 32 j < 200
  float2 a[8];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    const int n = lane + 32 * j;
    float2 v = make_float2(0.0f, 0.0f);
    if (n < kHalf) {
      v = kAligned ? __ldg(reinterpret_cast<const float2*>(x) + n)
                   : make_float2(__ldg(x + 2 * n), __ldg(x + 2 * n + 1));
      if (nz != nullptr) {
        v.x += __ldg(nz + 2 * n);
        v.y += __ldg(nz + 2 * n + 1);
      }
    }
    a[j] = v;
    sum += v.x + v.y;
  }
  a[7] = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  const float mean = remove_dc ? sum / (float)kWin : 0.0f;

  // DC removal, pre-emphasis (first sample replicated), window. The sample
  // before x[2n] is x[2n-1], the odd sample of the lane to the left (of
  // lane 31 at the previous j for lane 0).
  float left[7];
#pragma unroll
  for (int j = 0; j < 7; ++j)
    left[j] = __shfl_sync(kFull, a[j].y, (lane + 31) & 31);
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    const int n = lane + 32 * j;
    const float prev = lane > 0 ? left[j] : (j > 0 ? left[j - 1] : a[0].x);
    const float2 w = n < kHalf
        ? __ldg(reinterpret_cast<const float2*>(window) + n)
        : make_float2(0.0f, 0.0f);
    const float e0 = a[j].x - mean, e1 = a[j].y - mean, p = prev - mean;
    a[j] = make_float2((e0 - preemph * p) * w.x, (e1 - preemph * e0) * w.y);
  }

  // pass 1: radix 8 over j, twiddle W256^(t q)
  dft8(a);
#pragma unroll
  for (int q = 1; q < 8; ++q) a[q] = mul_conj(a[q], tw[kTw1 + q - 1][lane]);
  float* re = buf_re[warp];
  float* im = buf_im[warp];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    re[q * kRow1 + lane] = a[q].x;
    im[q * kRow1 + lane] = a[q].y;
  }
  __syncwarp();

  // pass 2: lane 4 q + t0, radix 8 over t1, twiddle W32^(t0 r)
  {
    const int base = (lane >> 2) * kRow1 + (lane & 3);
#pragma unroll
    for (int t1 = 0; t1 < 8; ++t1)
      a[t1] = make_float2(re[base + 4 * t1], im[base + 4 * t1]);
  }
  __syncwarp();
  dft8(a);
#pragma unroll
  for (int r = 1; r < 8; ++r) a[r] = mul_conj(a[r], tw[kTw2 + r - 1][lane]);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    re[r * kRow2 + lane] = a[r].x;
    im[r * kRow2 + lane] = a[r].y;
  }
  __syncwarp();

  // pass 3: lane q + 8 m, radix 4 over t0 for r = m and m + 4; then
  // a[j] = Z[lane + 32 j]
  {
    const int q = lane & 7, m = lane >> 3;
#pragma unroll
    for (int rhi = 0; rhi < 2; ++rhi) {
      const int base = (m + 4 * rhi) * kRow2 + 4 * q;
      float2 c[4];
#pragma unroll
      for (int t0 = 0; t0 < 4; ++t0)
        c[t0] = make_float2(re[base + t0], im[base + t0]);
      dft4(c[0], c[1], c[2], c[3]);
#pragma unroll
      for (int s = 0; s < 4; ++s) a[rhi + 2 * s] = c[s];
    }
  }
  __syncwarp();

  // split step and power; Z[256 - k] is element 7 - j of lane 32 - lane
  // (element (8 - j) mod 8 of lane 0 itself for lane 0)
  float* power = re;
  const int partner = (32 - lane) & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float2 b = make_float2(__shfl_sync(kFull, a[7 - j].x, partner),
                           __shfl_sync(kFull, a[7 - j].y, partner));
    if (lane == 0) b = a[(8 - j) & 7];
    b.y = -b.y;                                    // conj Z[256 - k]
    const float2 s = add(a[j], b), d = sub(a[j], b);
    const float2 w = tw[kTw3 + j][lane];
    const float xr = 0.5f * (s.x + w.x * d.y - w.y * d.x);
    const float xi = 0.5f * (s.y - w.x * d.x - w.y * d.y);
    power[lane + 32 * j] = fmaf(xr, xr, xi * xi);
  }
  __syncwarp();

  // banded mel projection, one filter per lane at a time
  float* o = out + f * n_mels;
  for (int m = lane; m < n_mels; m += 32) {
    const float* pw = power + band_first[m];
    const float* wm = weights + band_off[m];
    const int len = band_len[m];
    float acc = 0.0f;
    for (int i = 0; i < len; ++i) acc = fmaf(wm[i], pw[i], acc);
    o[m] = logf(fmaxf(acc, kLogFloor));
  }
}

}  // namespace

// wav: first sample of frame 0; frame f reads wav[f*frame_stride, +400).
// window: [400] povey window, 8-byte aligned. mel_band: [n_mels, 3] int32
// (first bin, length, offset into mel_w) of each filter's nonzero run;
// mel_w: the packed weights, at most 512. noise: null for no dither, else
// rows of 400 floats noise_stride apart, noise_rows rows for each group of
// noise_group frames (see the header). out: [n_frames, n_mels].
// Returns cudaGetLastError() after the launch.
extern "C" int fbank_launch(const float* wav, long long frame_stride,
                            int n_frames, const float* window,
                            const int* mel_band, const float* mel_w,
                            int n_mels, float preemph, int remove_dc,
                            const float* noise, long long noise_stride,
                            int noise_group, int noise_rows, float* out,
                            void* stream) {
  if (n_frames <= 0) return 0;
  if (n_mels <= 0 || n_mels > kMaxMels ||
      reinterpret_cast<std::uintptr_t>(window) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (noise != nullptr &&
      (noise_group <= 0 || noise_rows < 0 || noise_rows > noise_group ||
       noise_stride < kWin))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)(((long long)n_frames + kWarps - 1) / kWarps);
  const bool aligned = reinterpret_cast<std::uintptr_t>(wav) % 8 == 0 &&
                       frame_stride % 2 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned) {
    fbank_kernel<true><<<blocks, kThreads, 0, s>>>(
        wav, frame_stride, n_frames, window, mel_band, mel_w, n_mels,
        preemph, remove_dc, noise, noise_stride, noise_group, noise_rows,
        out);
  } else {
    fbank_kernel<false><<<blocks, kThreads, 0, s>>>(
        wav, frame_stride, n_frames, window, mel_band, mel_w, n_mels,
        preemph, remove_dc, noise, noise_stride, noise_group, noise_rows,
        out);
  }
  return (int)cudaGetLastError();
}
