// GroupNorm of an NCHW tensor with its affine and the activation that
// follows it, and optionally a residual added before that activation:
//   y = act(gamma[c] * (x - mean[n, g]) * rsqrt(var[n, g] + eps) + beta[c]
//           (+ residual))
// with mean and the biased var over each (sample, group): the group's C / G
// channels of H * W values, one contiguous run of x. act is none, ReLU or
// LeakyReLU(0.01). The arithmetic is f32, the result rounded once to x's
// dtype (bf16 or f32).
//
// Replaces: no TPU kernel. The JAX package leaves GroupNorm to XLA
// (tcvom_tpu/models/layers.py::_GroupNorm), which fuses it with the ops
// around it. PyTorch's own GroupNorm (RowwiseMomentsCUDAKernel, then a
// broadcast apply pass, then separate passes for the activation and the
// residual add) runs one block per (sample, group): 32 blocks on 132 SMs at
// batch 1, one block walking up to 2.1 M values alone, so it reaches a few
// per cent of the card's bandwidth and is half of FBA's device time.
//
// Bound on the H100: device memory. The function reads x once for the
// statistics and once more with the residual for the output, and writes
// the output: at FBA's 61 GroupNorms of a 1088x1920 frame in bf16 2.26 GB
// (statistics) and 4.53 GB (apply), ~2 ms at 3.35 TB/s. Its operations are
// a few a value, far below that line.
//
// The design, two launches:
//
// group_norm_stats: each (sample, group) is split into `splits` CTAs
// (chosen by the host from the shape, enough to fill the card at batch 1),
// block b reading part b % splits of group b / splits, so consecutive blocks
// read consecutive addresses. Values are loaded 16 bytes at a time (8 bf16
// or 4 f32), a few loads in flight a thread; a head and a tail of scalars
// cover a run that does not start or end on 16 bytes (the PPM's 1x1 to
// 6x6 grids). Every value is shifted by the group's first value K before
// anything is summed, so a group whose mean is large against its spread
// does not cancel, and the partial statistics are (count, mean, M2) of the
// shifted values, merged by Chan's formula: within a thread per batch of
// loads, across the warp by shuffles, across the block through shared
// memory. Each block writes its triple to an f32 scratch [N * G, splits, 3].
//
// group_norm_apply: one block per (sample, channel) and tile of its H * W
// values, in reverse order of address, so the first blocks read what the
// statistics pass read last and the L2 cache still holds. Each block's
// first warp merges its group's partials (the same order in every block,
// so every block gets the same numbers, and no third launch is needed),
// takes the group's mean K + mean(x - K) as a pair hi + lo of floats (a
// two-sum: hi alone would be off by up to half its ulp, which the
// normalization multiplies by rstd), folds gamma and beta into a
// per-channel scale a = rstd * gamma and shift b = beta - lo * a, and
// streams y = act((x - hi) * a + b (+ residual)) with 16-byte loads and
// stores. x - hi is exact near the mean, so the output's rounding error
// scales with |x - mean|, not with |x| or |K|.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 1 << 16;

enum Act { kNone = 0, kRelu = 1, kLeakyRelu = 2 };

// 16 bytes of T as f32 values, and back (rounded to nearest even)
template <class T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ float to_float(float v) { return v; }
  static __device__ float from_float(float v) { return v; }
  static __device__ void unpack(const uint4& q, float (&v)[kN]) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  static __device__ uint4 pack(const float (&v)[kN]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ void unpack(const uint4& q, float (&v)[kN]) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ unsigned pair(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&p);
  }
  static __device__ uint4 pack(const float (&v)[kN]) {
    return make_uint4(pair(v[0], v[1]), pair(v[2], v[3]), pair(v[4], v[5]),
                      pair(v[6], v[7]));
  }
};

// (count, mean, M2) += (nb, mb, M2b), Chan et al.'s pairwise update
struct Moments {
  float n = 0.f, mean = 0.f, m2 = 0.f;

  __device__ void merge(float nb, float mb, float m2b) {
    if (nb == 0.f) return;
    const float total = n + nb;
    const float delta = mb - mean;
    const float r = nb / total;
    mean = fmaf(delta, r, mean);
    m2 += m2b + delta * delta * n * r;
    n = total;
  }

  // merged over the warp's lanes: lane 0 ends with the whole warp's
  __device__ void merge_warp() {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float nb = __shfl_xor_sync(0xffffffffu, n, off);
      const float mb = __shfl_xor_sync(0xffffffffu, mean, off);
      const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
      merge(nb, mb, m2b);
    }
  }
};

// Part `part` of `parts` of the elements [start, start + len) of a tensor
// whose base is 16-byte aligned: whole 16-byte vectors [v0, v1) (in units of
// kN elements), split evenly over the parts, and the scalars before the
// first and after the last whole vector, [h0, h1) and [t0, t1), which part
// 0 takes.
template <int kN>
struct Span {
  long long h0, h1, v0, v1, t0, t1;

  __device__ Span(long long start, long long len, int part, int parts) {
    const long long end = start + len;
    const long long a0 = (start + kN - 1) / kN, a1 = end / kN;
    if (a0 >= a1) {
      h0 = start;
      h1 = end;
      v0 = v1 = 0;
      t0 = t1 = end;
    } else {
      h0 = start;
      h1 = a0 * kN;
      t0 = a1 * kN;
      t1 = end;
      const long long per = (a1 - a0 + parts - 1) / parts;
      v0 = min(a1, a0 + part * per);
      v1 = min(a1, v0 + per);
    }
    if (part != 0) {
      h1 = h0;
      t0 = t1;
    }
  }
};

template <class T>
__global__ void __launch_bounds__(kThreads)
    group_norm_stats(const T* __restrict__ x, float* __restrict__ partials,
                     long long len, int splits) {
  using V = Vec<T>;
  constexpr int kN = V::kN;
  constexpr int kUnroll = 16 / kN;  // loads in flight a thread
  const long long group = blockIdx.x / splits;
  const int part = static_cast<int>(blockIdx.x % splits);
  const float shift = V::to_float(x[group * len]);
  const Span<kN> sp(group * len, len, part, splits);
  const uint4* xv = reinterpret_cast<const uint4*>(x);

  Moments acc;
  for (long long v = sp.v0 + threadIdx.x; v < sp.v1;
       v += kThreads * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * kThreads < sp.v1) raw[u] = __ldg(xv + v + u * kThreads);
    }
    float d[kUnroll][kN];
    float sum = 0.f, count = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * kThreads < sp.v1) {
        V::unpack(raw[u], d[u]);
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          d[u][e] -= shift;
          sum += d[u][e];
        }
        count += kN;
      }
    }
    const float mb = sum / count;
    float m2b = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * kThreads < sp.v1) {
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          const float t = d[u][e] - mb;
          m2b = fmaf(t, t, m2b);
        }
      }
    }
    acc.merge(count, mb, m2b);
  }
  for (long long i = sp.h0 + threadIdx.x; i < sp.h1; i += kThreads) {
    acc.merge(1.f, V::to_float(x[i]) - shift, 0.f);
  }
  for (long long i = sp.t0 + threadIdx.x; i < sp.t1; i += kThreads) {
    acc.merge(1.f, V::to_float(x[i]) - shift, 0.f);
  }

  __shared__ float s_part[3][kWarps];
  acc.merge_warp();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_part[0][warp] = acc.n;
    s_part[1][warp] = acc.mean;
    s_part[2][warp] = acc.m2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Moments all;
    for (int w = 0; w < kWarps; ++w) {
      all.merge(s_part[0][w], s_part[1][w], s_part[2][w]);
    }
    float* out = partials + 3 * static_cast<long long>(blockIdx.x);
    out[0] = all.n;
    out[1] = all.mean;
    out[2] = all.m2;
  }
}

template <int kAct>
__device__ __forceinline__ float activate(float y) {
  if (kAct == kRelu) return y < 0.f ? 0.f : y;
  if (kAct == kLeakyRelu) return y > 0.f ? y : y * 0.01f;
  return y;
}

template <class T, int kAct, bool kRes>
__device__ __forceinline__ T apply_one(T xv, const T* res, long long i,
                                       float mean, float a, float b) {
  using V = Vec<T>;
  float y = fmaf(V::to_float(xv) - mean, a, b);
  if (kRes) y += V::to_float(res[i]);
  return V::from_float(activate<kAct>(y));
}

template <class T, int kAct, bool kRes>
__global__ void __launch_bounds__(kThreads)
    group_norm_apply(const T* __restrict__ x, const T* __restrict__ gamma,
                     const T* __restrict__ beta, const T* __restrict__ res,
                     T* __restrict__ out, const float* __restrict__ partials,
                     long long hw, int channels, int per_group, int splits,
                     int tiles, float eps) {
  using V = Vec<T>;
  constexpr int kN = V::kN;
  constexpr int kUnroll = 16 / kN;
  // blocks run in reverse order of address (see the note at the top)
  const long long block = static_cast<long long>(gridDim.x) - 1 - blockIdx.x;
  const long long nc = block / tiles;  // n * C + c
  const int tile = static_cast<int>(block % tiles);
  const int c = static_cast<int>(nc % channels);
  const long long group = nc / per_group;

  __shared__ float s_stat[2];  // mean of the shifted values, rstd
  if (threadIdx.x < 32) {
    Moments acc;
    const float* p = partials + 3 * group * splits;
    for (int i = threadIdx.x; i < splits; i += 32) {
      acc.merge(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
    }
    acc.merge_warp();
    if (threadIdx.x == 0) {
      s_stat[0] = acc.mean;
      s_stat[1] = rsqrtf(acc.m2 / acc.n + eps);
    }
  }
  __syncthreads();
  const float shift = V::to_float(x[group * per_group * hw]);
  const float hi = shift + s_stat[0];
  const float hi_b = hi - shift;
  const float lo = (shift - (hi - hi_b)) + (s_stat[0] - hi_b);
  const float a = s_stat[1] * (gamma ? V::to_float(gamma[c]) : 1.f);
  const float b = (beta ? V::to_float(beta[c]) : 0.f) - lo * a;

  const Span<kN> sp(nc * hw, hw, tile, tiles);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* rv = reinterpret_cast<const uint4*>(res);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long v = sp.v0 + threadIdx.x; v < sp.v1;
       v += kThreads * kUnroll) {
    uint4 raw[kUnroll], rraw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * kThreads < sp.v1) {
        raw[u] = __ldg(xv + v + u * kThreads);
        if (kRes) rraw[u] = __ldg(rv + v + u * kThreads);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * kThreads < sp.v1) {
        float y[kN], r[kN];
        V::unpack(raw[u], y);
        if (kRes) V::unpack(rraw[u], r);
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          y[e] = fmaf(y[e] - hi, a, b);
          if (kRes) y[e] += r[e];
          y[e] = activate<kAct>(y[e]);
        }
        ov[v + u * kThreads] = V::pack(y);
      }
    }
  }
  for (long long i = sp.h0 + threadIdx.x; i < sp.h1; i += kThreads) {
    out[i] = apply_one<T, kAct, kRes>(x[i], res, i, hi, a, b);
  }
  for (long long i = sp.t0 + threadIdx.x; i < sp.t1; i += kThreads) {
    out[i] = apply_one<T, kAct, kRes>(x[i], res, i, hi, a, b);
  }
}

template <class T, int kAct, bool kRes>
void launch_apply(const void* x, const void* gamma, const void* beta,
                  const void* res, void* out, const float* partials,
                  long long nc, long long hw, int channels, int per_group,
                  int splits, int tiles, float eps, cudaStream_t stream) {
  group_norm_apply<T, kAct, kRes><<<static_cast<unsigned>(nc * tiles),
                                    kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<const T*>(res),
      static_cast<T*>(out), partials, hw, channels, per_group, splits, tiles,
      eps);
}

template <class T, int kAct>
void launch_apply(bool has_res, const void* x, const void* gamma,
                  const void* beta, const void* res, void* out,
                  const float* partials, long long nc, long long hw,
                  int channels, int per_group, int splits, int tiles,
                  float eps, cudaStream_t stream) {
  if (has_res) {
    launch_apply<T, kAct, true>(x, gamma, beta, res, out, partials, nc, hw,
                                channels, per_group, splits, tiles, eps,
                                stream);
  } else {
    launch_apply<T, kAct, false>(x, gamma, beta, res, out, partials, nc, hw,
                                 channels, per_group, splits, tiles, eps,
                                 stream);
  }
}

template <class T>
int run(const void* x, const void* gamma, const void* beta, const void* res,
        void* out, float* partials, long long n, long long channels,
        long long hw, int groups, float eps, int act, int splits, int tiles,
        cudaStream_t stream) {
  const int per_group = static_cast<int>(channels / groups);
  group_norm_stats<T><<<static_cast<unsigned>(n * groups * splits), kThreads,
                        0, stream>>>(static_cast<const T*>(x), partials,
                                     per_group * hw, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nc = n * channels;
  const bool has_res = res != nullptr;
  if (act == kRelu) {
    launch_apply<T, kRelu>(has_res, x, gamma, beta, res, out, partials, nc,
                           hw, static_cast<int>(channels), per_group, splits,
                           tiles, eps, stream);
  } else if (act == kLeakyRelu) {
    launch_apply<T, kLeakyRelu>(has_res, x, gamma, beta, res, out, partials,
                                nc, hw, static_cast<int>(channels), per_group,
                                splits, tiles, eps, stream);
  } else {
    launch_apply<T, kNone>(has_res, x, gamma, beta, res, out, partials, nc,
                           hw, static_cast<int>(channels), per_group, splits,
                           tiles, eps, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, residual (may be null) and out: [n, channels, hw] contiguous, 16-byte
// aligned; gamma and beta (may be null): [channels]; all of x's dtype (bf16
// when `bf16`, else f32). partials: f32 [n * groups, splits, 3] scratch.
// splits and tiles come from the host's plan
// (tcvom_tpu_torch/ops/group_norm_kernel.py::plan); arguments this source
// does not take are refused with cudaErrorInvalidValue.
extern "C" int group_norm_forward(const void* x, const void* gamma,
                                  const void* beta, const void* residual,
                                  void* out, void* partials, long long n,
                                  long long channels, long long hw,
                                  int groups, float eps, int act, int bf16,
                                  int splits, int tiles, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || channels <= 0 || hw <= 0 || groups <= 0 ||
      channels % groups || act < kNone || act > kLeakyRelu || splits < 1 ||
      splits > kMaxSplits || tiles < 1 || tiles > kMaxSplits ||
      n * groups * splits >= (1LL << 31) ||
      n * channels * tiles >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  return bf16 ? run<__nv_bfloat16>(x, gamma, beta, residual, out, p, n,
                                   channels, hw, groups, eps, act, splits,
                                   tiles, s)
              : run<float>(x, gamma, beta, residual, out, p, n, channels, hw,
                           groups, eps, act, splits, tiles, s);
}
