// CUDA kernels for the two hot spots that XLA cannot express well, called
// from JAX through the FFI (see ops/_cuda.py for the build and registration).
//
// 1. The SSE diagonal update's op-count carry (ops/diag_carry.py): one
//    sequential dependence over M imaginary-time slots per replica. One
//    thread owns one replica and walks all M slots with the count in a
//    register; slot data for the next group of slots is loaded while the
//    current group is decided, so the loop is bound by the dependent chain,
//    not by load latency. Loads are coalesced across the replicas of a warp
//    ([M, R] row-major, replicas minor).
//
// 2. Checkerboard Metropolis on a periodic L x L lattice
//    (ops/checkerboard.py): one block per replica holds the whole spin field
//    in shared memory for all sweeps, so device memory is touched once on
//    load and once on store. Randomness is Philox-4x32-10 keyed on the seed
//    and counted by (site group, sweep, colour, replica); the plain-jnp twin
//    in ops/checkerboard.py computes the same bits.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// ---------------------------------------------------------------------------
// Diagonal-update carry
// ---------------------------------------------------------------------------

constexpr int kCarryGroup = 16;
constexpr int kCarryThreads = 32;

// kind: 0 = neither, 1 = insert candidate, 2 = removable diagonal op.
// thr (Metropolis): num_ins at insert candidates, num_rem at diagonal ops.
// bwt (heat-bath): beta * total bond weight per replica.
// The float expressions are those of sse/diagonal.py::_ins_rem, evaluated in
// the same order with explicit round-to-nearest intrinsics (no contraction),
// so decisions are bit-identical to the lax.scan carry.
template <bool kHeatbath>
__global__ void DiagCarryKernel(const int32_t* __restrict__ n0,
                                const float* __restrict__ u0,
                                const uint8_t* __restrict__ kind,
                                const float* __restrict__ thr,
                                const float* __restrict__ bwt,
                                uint8_t* __restrict__ code, int M, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  int n = n0[r];
  const float bw = kHeatbath ? bwt[r] : 0.0f;
  float cu[kCarryGroup], ct[kCarryGroup];
  uint8_t ck[kCarryGroup];
#pragma unroll
  for (int j = 0; j < kCarryGroup; ++j) {
    const size_t o = static_cast<size_t>(j) * R + r;
    const bool ok = j < M;
    cu[j] = ok ? u0[o] : 0.0f;
    ck[j] = ok ? kind[o] : 0;
    ct[j] = (!kHeatbath && ok) ? thr[o] : 0.0f;
  }
  for (int p0 = 0; p0 < M; p0 += kCarryGroup) {
    float nu[kCarryGroup], nt[kCarryGroup];
    uint8_t nk[kCarryGroup];
#pragma unroll
    for (int j = 0; j < kCarryGroup; ++j) {
      const int p = p0 + kCarryGroup + j;
      const size_t o = static_cast<size_t>(p) * R + r;
      const bool ok = p < M;
      nu[j] = ok ? u0[o] : 0.0f;
      nk[j] = ok ? kind[o] : 0;
      nt[j] = (!kHeatbath && ok) ? thr[o] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kCarryGroup; ++j) {
      const int p = p0 + j;
      if (p < M) {
        const float mmn = __int2float_rn(M - n);
        const float mmn1 = __fadd_rn(mmn, 1.0f);
        bool ins, rem;
        if (kHeatbath) {
          ins = (ck[j] == 1) & (__fmul_rn(cu[j], __fadd_rn(mmn, bw)) < bw);
          rem = (ck[j] == 2) & (__fmul_rn(cu[j], __fadd_rn(mmn1, bw)) < mmn1);
        } else {
          ins = (ck[j] == 1) & (__fmul_rn(cu[j], mmn) < ct[j]);
          rem = (ck[j] == 2) & (__fmul_rn(cu[j], ct[j]) < mmn1);
        }
        code[static_cast<size_t>(p) * R + r] =
            static_cast<uint8_t>(ins ? 1 : (rem ? 2 : 0));
        n += static_cast<int>(ins) - static_cast<int>(rem);
      }
    }
#pragma unroll
    for (int j = 0; j < kCarryGroup; ++j) {
      cu[j] = nu[j];
      ck[j] = nk[j];
      ct[j] = nt[j];
    }
  }
}

template <bool kHeatbath>
ffi::Error LaunchDiagCarry(cudaStream_t stream, ffi::Buffer<ffi::S32> n0,
                           ffi::Buffer<ffi::F32> u0, ffi::Buffer<ffi::U8> kind,
                           const float* thr, const float* bwt,
                           ffi::ResultBuffer<ffi::U8> code) {
  const auto dims = u0.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("u0 must be [M, R]");
  const int M = static_cast<int>(dims[0]);
  const int R = static_cast<int>(dims[1]);
  if (M == 0 || R == 0) return ffi::Error::Success();
  const int blocks = (R + kCarryThreads - 1) / kCarryThreads;
  DiagCarryKernel<kHeatbath><<<blocks, kCarryThreads, 0, stream>>>(
      n0.typed_data(), u0.typed_data(), kind.typed_data(), thr, bwt,
      code->typed_data(), M, R);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error DiagCarryMetropolis(cudaStream_t stream, ffi::Buffer<ffi::S32> n0,
                               ffi::Buffer<ffi::F32> u0,
                               ffi::Buffer<ffi::U8> kind,
                               ffi::Buffer<ffi::F32> thr,
                               ffi::ResultBuffer<ffi::U8> code) {
  return LaunchDiagCarry<false>(stream, n0, u0, kind, thr.typed_data(),
                                nullptr, code);
}

ffi::Error DiagCarryHeatbath(cudaStream_t stream, ffi::Buffer<ffi::S32> n0,
                             ffi::Buffer<ffi::F32> u0,
                             ffi::Buffer<ffi::U8> kind,
                             ffi::Buffer<ffi::F32> bwt,
                             ffi::ResultBuffer<ffi::U8> code) {
  return LaunchDiagCarry<true>(stream, n0, u0, kind, nullptr,
                               bwt.typed_data(), code);
}

// ---------------------------------------------------------------------------
// Checkerboard Metropolis
// ---------------------------------------------------------------------------

constexpr int kBoardThreads = 1024;

__device__ __forceinline__ void Philox4x32x10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    c[0] = hi1 ^ c[1] ^ k0;
    c[1] = lo1;
    c[2] = hi0 ^ c[3] ^ k1;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

// spins: uint8 0/1 [R, L, L]; thr: f32[10] acceptance thresholds indexed by
// spin * 5 + (number of up neighbours). Colour c holds the sites with
// (x + y) % 2 == c; site (y, x) of colour c has half-row index x / 2 and
// flat half-lattice index i = y * L / 2 + x / 2. Group g = i / 4 shares one
// Philox call (counter (g, sweep, c, replica)); site i uses word i % 4.
__global__ void CheckerboardKernel(const uint8_t* __restrict__ in,
                                   const float* __restrict__ thr_in,
                                   const uint32_t* __restrict__ seed_in,
                                   uint8_t* __restrict__ out, int L,
                                   int nsweeps) {
  extern __shared__ uint4 smem[];
  uint8_t* f = reinterpret_cast<uint8_t*>(smem);
  __shared__ float thr[10];
  const int r = blockIdx.x;
  const int LL = L * L;
  const uint4* src = reinterpret_cast<const uint4*>(in + static_cast<size_t>(r) * LL);
  for (int i = threadIdx.x; i < LL / 16; i += blockDim.x) smem[i] = src[i];
  if (threadIdx.x < 10) thr[threadIdx.x] = thr_in[threadIdx.x];
  const uint32_t seed = seed_in[0];
  __syncthreads();
  const int H = L / 2;
  const int ngroups = L * H / 4;
  for (int s = 0; s < nsweeps; ++s) {
    for (int c = 0; c < 2; ++c) {
      for (int g = threadIdx.x; g < ngroups; g += blockDim.x) {
        uint32_t w[4] = {static_cast<uint32_t>(g), static_cast<uint32_t>(s),
                         static_cast<uint32_t>(c), static_cast<uint32_t>(r)};
        Philox4x32x10(w, seed, 0u);
        const int i0 = 4 * g;
        const int y = i0 / H;
        const int xh0 = i0 - y * H;
        const int yu = (y == 0 ? L - 1 : y - 1) * L;
        const int yd = (y == L - 1 ? 0 : y + 1) * L;
        const int yy = y * L;
        const int off = (y + c) & 1;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int x = 2 * (xh0 + q) + off;
          const int xl = x == 0 ? L - 1 : x - 1;
          const int xr = x == L - 1 ? 0 : x + 1;
          const int nup = f[yu + x] + f[yd + x] + f[yy + xl] + f[yy + xr];
          const int sv = f[yy + x];
          const float u = static_cast<float>(w[q] >> 8) * (1.0f / 16777216.0f);
          if (u < thr[sv * 5 + nup]) f[yy + x] = static_cast<uint8_t>(1 - sv);
        }
      }
      __syncthreads();
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * LL);
  for (int i = threadIdx.x; i < LL / 16; i += blockDim.x) dst[i] = smem[i];
}

ffi::Error Checkerboard(cudaStream_t stream, ffi::Buffer<ffi::U8> spins,
                        ffi::Buffer<ffi::F32> thr, ffi::Buffer<ffi::U32> seed,
                        int32_t nsweeps, ffi::ResultBuffer<ffi::U8> out) {
  const auto dims = spins.dimensions();
  if (dims.size() != 3 || dims[1] != dims[2])
    return ffi::Error::InvalidArgument("spins must be [R, L, L]");
  const int R = static_cast<int>(dims[0]);
  const int L = static_cast<int>(dims[1]);
  if (L % 4 != 0)
    return ffi::Error::InvalidArgument("checkerboard kernel needs L % 4 == 0");
  if (R == 0) return ffi::Error::Success();
  const size_t bytes = static_cast<size_t>(L) * L;
  cudaError_t err = cudaFuncSetAttribute(
      CheckerboardKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  CheckerboardKernel<<<R, kBoardThreads, bytes, stream>>>(
      spins.typed_data(), thr.typed_data(), seed.typed_data(),
      out->typed_data(), L, nsweeps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(IsingDiagCarryMetropolis, DiagCarryMetropolis,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(IsingDiagCarryHeatbath, DiagCarryHeatbath,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(IsingCheckerboard, Checkerboard,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Attr<int32_t>("nsweeps")
                                  .Ret<ffi::Buffer<ffi::U8>>());
