// rt_div_check: common.cuh's correctly rounded operations from shared or
// approximate reciprocals (div_by, div_fast_pos, rcp_rn, sqrt_fast,
// rsqrt_fast), which the 3-D dynamic loop (dynamic3d.cuh), the fused step
// (fused.cuh), the analytic fields (media.cuh), fisheye_op1 (fisheye.cuh)
// and the generated custom fields use, against the card's own operations
// on many operands.  A check, not a port of a TPU kernel: chip_smoke.py and
// the card-only tests run it, and it fails them on any difference.
//
// mode 0: div_by: the numerators are the float32 bit patterns first ..
//   first + count - 1 (all 2^32 of them for count = 2^32), the denominator
//   b (60 and 360 are dynamic3d.cuh's constant denominators), against
//   __fdiv_rn;
// mode 1: div_by on count seeded pairs from a counter-based hash
//   (splitmix64 of seed + i): even i take random bit patterns over every
//   exponent (zeros, subnormals, infinities and NaN included), odd i random
//   mantissas with exponents drawn around the guard's fast-path ranges (|a|
//   in 2^-66 .. 2^66, |b| in 2^-34 .. 2^34) and random signs;
// modes 5 and 6: the same for div_fast_pos (its Recip from recip_pos; the
//   IEEE division where its guard fails, as the fused step does), b > 0
//   in mode 5; mode 6's odd pairs around its guard's ranges (|a| in
//   2^-102 .. 2^102, b in 2^-18 .. 2^18, positive);
// mode 2: rcp_rn(b) against __frcp_rn for the bit patterns of b
//   first .. first + count - 1;
// mode 3: sqrt_fast (sqrtf where its guard fails) against __fsqrt_rn, the
//   same operands;
// mode 4: rsqrt_fast (rsqrtf where its guard fails) against rsqrtf.
// Two results agree when their bits are equal or both are NaN.
// out[0] counts the differing operands, out[1] and out[2] hold the bits of
// one such (a, b) (a alone for modes 2-4).
//
// rt_fma: the card's fma_rn (common.cuh, one FFMA: the 2-D grid blend's
// sums of products) on n triples, elementwise, for chip_smoke.py's [fma32]
// phase and the card-only tests, which hold it to the plain versions'
// utils/fma.py::fma32 computed on the card.
#include "common.cuh"

namespace rt {

__device__ __forceinline__ unsigned long long splitmix64(unsigned long long z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// a float with mantissa bits m, sign bit s and unbiased exponent e
__device__ __forceinline__ float with_exponent(unsigned m, unsigned s, int e) {
  return __uint_as_float((s << 31) | (static_cast<unsigned>(e + 127) << 23) |
                         (m & 0x7FFFFFu));
}

// the fused step's quotient: div_fast_pos, the IEEE division where its
// guard fails
__device__ __forceinline__ float div_pos(float a, const Recip& d) {
  bool ok = true;
  const float q = div_fast_pos(a, d, ok);
  return ok ? q : a / d.b;
}

__global__ void div_check_kernel(int mode, float b, unsigned long long first,
                                 unsigned long long count,
                                 unsigned long long seed,
                                 unsigned long long* out) {
  const bool pos = mode == 5 || mode == 6;
  const Recip fixed = pos ? recip_pos(b) : recip(b);
  unsigned long long bad = 0;
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i =
           static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
           threadIdx.x;
       i < count; i += stride) {
    float a, d = 0.0f, q, want;
    if (mode >= 2 && mode <= 4) {
      a = __uint_as_float(static_cast<unsigned>(first + i));
      bool ok = true;
      if (mode == 2) {
        q = rcp_rn(a);
        want = __frcp_rn(a);
      } else if (mode == 3) {
        q = sqrt_fast(a, ok);
        q = ok ? q : sqrtf(a);
        want = __fsqrt_rn(a);
      } else {
        q = rsqrt_fast(a, ok);
        q = ok ? q : rsqrtf(a);
        want = rsqrtf(a);
      }
    } else {
      Recip r;
      if (mode == 0 || mode == 5) {
        a = __uint_as_float(static_cast<unsigned>(first + i));
        d = b;
        r = fixed;
      } else {
        const unsigned long long h = splitmix64(seed + i);
        const unsigned lo = static_cast<unsigned>(h);
        const unsigned hi = static_cast<unsigned>(h >> 32);
        if (i & 1ull && pos) {
          const unsigned long long g = splitmix64(~(seed + i));
          a = with_exponent(lo, lo >> 31, static_cast<int>(g % 205ull) - 102);
          d = with_exponent(hi, 0u, static_cast<int>((g >> 32) % 37ull) - 18);
        } else if (i & 1ull) {
          const unsigned long long g = splitmix64(~(seed + i));
          a = with_exponent(lo, lo >> 31, static_cast<int>(g % 133ull) - 66);
          d = with_exponent(hi, hi >> 31,
                            static_cast<int>((g >> 32) % 69ull) - 34);
        } else {
          a = __uint_as_float(lo);
          d = __uint_as_float(hi);
        }
        r = pos ? recip_pos(d) : recip(d);
      }
      q = pos ? div_pos(a, r) : div_by(a, r);
      want = __fdiv_rn(a, d);
    }
    const bool both_nan = q != q && want != want;
    if (__float_as_uint(q) != __float_as_uint(want) && !both_nan) {
      ++bad;
      out[1] = __float_as_uint(a);
      out[2] = __float_as_uint(d);
    }
  }
  if (bad) atomicAdd(out, bad);
}

__global__ void fma_kernel(const float* a, const float* b, const float* c,
                           float* out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = fma_rn(a[i], b[i], c[i]);
}

}  // namespace rt

// out[i] = fma_rn(a[i], b[i], c[i]) for i < n, float32 arrays on the card
extern "C" int rt_fma(const void* a, const void* b, const void* c, void* out,
                      long long n, void* stream) {
  if (n <= 0) return 0;
  rt::fma_kernel<<<132 * 16, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// out: three unsigned 64-bit integers on the card, zeroed by the caller
extern "C" int rt_div_check(int mode, float b, unsigned long long first,
                            unsigned long long count, unsigned long long seed,
                            void* out, void* stream) {
  if (count == 0) return 0;
  if (mode < 0 || mode > 6) return static_cast<int>(cudaErrorInvalidValue);
  rt::div_check_kernel<<<132 * 16, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, b, first, count, seed, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
