// Myers bit-vector Levenshtein distance (edlib NW and HW modes) as an XLA
// FFI custom call for Hopper (sm_90a).
//
// One thread block per query. The query's 32-bit words are split into
// contiguous runs of WPT words, one run per thread; each thread keeps its
// runs' Peq masks and vertical deltas (VP, VN) in registers for the whole
// target loop. Within a target column the words form a chain through the
// horizontal delta hin/hout in {-1, 0, +1}, so the block runs a diagonal
// wavefront: at step s thread j processes target character s - j, taking
// hin from thread j - 1's previous step (__shfl_up_sync inside a warp, a
// double-buffered shared-memory slot across warps). A query of W words
// costs N + ceil(W / WPT) - 1 steps.
//
// The per-word update is the one ops/edit_distance.py::myers_column runs
// (Hyyrö's D0 form), so both give the same distances, which equal the
// prefix-min DP (ops/edit_distance.py::batched_levenshtein) on ACGT codes.
//
// Inputs: queries u8 [..., B, M] (codes 0..3, pad arbitrary), query_lens
// s32 [..., B], targets u8 [..., N]; the leading dims of targets index one
// target per group of B queries. Output: s32 [..., B].

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

template <int WPT>
__global__ void __launch_bounds__(1024)
MyersKernel(const uint8_t* __restrict__ queries,
            const int32_t* __restrict__ qlens,
            const uint8_t* __restrict__ targets, int32_t* __restrict__ out,
            int M, int N, int per_target, int hw) {
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qlen = min(qlens[b], M);
  if (qlen <= 0) {  // empty query: NW distance = N, HW distance = 0
    if (tid == 0) out[b] = hw ? 0 : N;
    return;
  }
  const int teff = (((qlen + 31) >> 5) + WPT - 1) / WPT;  // threads with words
  const int nsync = (teff + 31) & ~31;  // whole warps in the wavefront
  if (tid >= nsync) return;

  const uint8_t* q = queries + b * M;
  const uint8_t* t = targets + (b / per_target) * N;

  uint32_t p0[WPT], p1[WPT], p2[WPT], p3[WPT], vp[WPT], vn[WPT];
#pragma unroll
  for (int w = 0; w < WPT; ++w) {
    p0[w] = p1[w] = p2[w] = p3[w] = 0u;
    const int base = (tid * WPT + w) * 32;
    for (int k = 0; k < 32; ++k) {
      const int pos = base + k;
      if (pos < qlen) {  // rows past qlen-1 never reach the score row
        const uint8_t c = q[pos];
        const uint32_t bit = 1u << k;
        p0[w] |= c == 0 ? bit : 0u;
        p1[w] |= c == 1 ? bit : 0u;
        p2[w] |= c == 2 ? bit : 0u;
        p3[w] |= c == 3 ? bit : 0u;
      }
    }
    vp[w] = ~0u;
    vn[w] = 0u;
  }

  // the score lives at DP row qlen-1: bit sbit of word sword
  const int sword = (qlen - 1) >> 5;
  const int sbit = (qlen - 1) & 31;
  const bool owner = tid == sword / WPT;
  const int sw_local = sword % WPT;
  int score = qlen;
  int best = qlen;

  __shared__ int carry[2][32];
  const bool multi_warp = nsync > 32;
  const int hin_top = hw ? 0 : 1;  // top-row horizontal delta
  int hin = 0;
  const int steps = N + teff - 1;
  for (int s = 0; s < steps; ++s) {
    const int i = s - tid;
    int h = tid == 0 ? hin_top : hin;
    if (tid < teff && i >= 0 && i < N) {
      const uint8_t c = t[i];
#pragma unroll
      for (int w = 0; w < WPT; ++w) {
        uint32_t eq = c == 0 ? p0[w]
                    : c == 1 ? p1[w]
                    : c == 2 ? p2[w]
                    : c == 3 ? p3[w]
                    : 0u;
        const uint32_t hneg = h < 0 ? 1u : 0u;
        const uint32_t hpos = h > 0 ? 1u : 0u;
        eq |= hneg;
        const uint32_t VP = vp[w];
        const uint32_t VN = vn[w];
        const uint32_t d0 = (((eq & VP) + VP) ^ VP) | eq | VN;
        const uint32_t hp = VN | ~(d0 | VP);
        const uint32_t hn = VP & d0;
        if (owner && w == sw_local) {
          score += static_cast<int>((hp >> sbit) & 1u) -
                   static_cast<int>((hn >> sbit) & 1u);
        }
        h = static_cast<int>(hp >> 31) - static_cast<int>(hn >> 31);
        const uint32_t hps = (hp << 1) | hpos;
        const uint32_t hns = (hn << 1) | hneg;
        vp[w] = hns | ~(d0 | hps);
        vn[w] = hps & d0;
      }
      best = min(best, score);
    } else {
      h = 0;
    }
    // hand hout to thread tid+1, which needs it at step s+1
    int up = __shfl_up_sync(0xffffffffu, h, 1);
    if (multi_warp) {
      if (lane == 31) carry[s & 1][warp] = h;
      asm volatile("bar.sync 1, %0;" ::"r"(nsync) : "memory");
      if (lane == 0 && warp > 0) up = carry[s & 1][warp - 1];
    }
    hin = up;
  }
  if (owner) out[b] = hw ? best : score;
}

ffi::Error MyersImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> queries,
                     ffi::Buffer<ffi::S32> qlens,
                     ffi::Buffer<ffi::U8> targets,
                     ffi::ResultBuffer<ffi::S32> out, int32_t hw, int32_t wpt,
                     int32_t threads) {
  const auto qd = queries.dimensions();
  const auto td = targets.dimensions();
  if (qd.size() < 2 || td.size() < 1) {
    return ffi::Error::InvalidArgument("queries must be [..., B, M], targets [..., N]");
  }
  const int64_t M = qd.back();
  const int64_t N = td.back();
  const int64_t n_queries = qlens.element_count();
  int64_t n_targets = 1;
  for (size_t k = 0; k + 1 < td.size(); ++k) n_targets *= td[k];
  if (n_queries == 0) return ffi::Error::Success();
  if (n_targets == 0 || n_queries % n_targets != 0) {
    return ffi::Error::InvalidArgument("query count is not a multiple of the target count");
  }
  if (threads <= 0 || threads > 1024 || threads % 32 != 0 ||
      static_cast<int64_t>(threads) * wpt * 32 < M) {
    return ffi::Error::InvalidArgument("bad launch shape for the query width");
  }
  const int per_target = static_cast<int>(n_queries / n_targets);
  const dim3 grid(static_cast<unsigned>(n_queries));
  const int m = static_cast<int>(M), n = static_cast<int>(N);
  switch (wpt) {
    case 1:
      MyersKernel<1><<<grid, threads, 0, stream>>>(
          queries.typed_data(), qlens.typed_data(), targets.typed_data(),
          out->typed_data(), m, n, per_target, hw);
      break;
    case 2:
      MyersKernel<2><<<grid, threads, 0, stream>>>(
          queries.typed_data(), qlens.typed_data(), targets.typed_data(),
          out->typed_data(), m, n, per_target, hw);
      break;
    case 4:
      MyersKernel<4><<<grid, threads, 0, stream>>>(
          queries.typed_data(), qlens.typed_data(), targets.typed_data(),
          out->typed_data(), m, n, per_target, hw);
      break;
    default:
      return ffi::Error::InvalidArgument("words per thread must be 1, 2 or 4");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("Myers kernel launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(GadevMyersLevenshtein, MyersImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("hw")
                                  .Attr<int32_t>("wpt")
                                  .Attr<int32_t>("threads"));
