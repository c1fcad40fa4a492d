// rt_div_check: common.cuh's div_by, the division by a shared reciprocal
// that the 3-D dynamic loop (dynamic3d.cuh) forms its quotients with,
// against the card's IEEE division (__fdiv_rn) on many operand pairs.  A
// check, not a port of a TPU kernel: chip_smoke.py and the card-only tests
// run it, and it fails them on any difference.
//
// mode 0: the numerators are the float32 bit patterns first .. first +
//   count - 1 (all 2^32 of them for count = 2^32), the denominator b (60
//   and 360 are dynamic3d.cuh's constant denominators);
// mode 1: count seeded pairs from a counter-based hash (splitmix64 of seed
//   + i): even i take random bit patterns over every exponent (zeros,
//   subnormals, infinities and NaN included), odd i random mantissas with
//   exponents drawn around the guard's fast-path ranges (|a| in 2^-66 ..
//   2^66, |b| in 2^-34 .. 2^34) and random signs.
// Two quotients agree when their bits are equal or both are NaN.
// out[0] counts the differing pairs, out[1] and out[2] hold the bits of
// one such (a, b).
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

__global__ void div_check_kernel(int mode, float b, unsigned long long first,
                                 unsigned long long count,
                                 unsigned long long seed,
                                 unsigned long long* out) {
  const Recip fixed = recip(b);
  unsigned long long bad = 0;
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i =
           static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
           threadIdx.x;
       i < count; i += stride) {
    float a, d;
    Recip r;
    if (mode == 0) {
      a = __uint_as_float(static_cast<unsigned>(first + i));
      d = b;
      r = fixed;
    } else {
      const unsigned long long h = splitmix64(seed + i);
      const unsigned lo = static_cast<unsigned>(h);
      const unsigned hi = static_cast<unsigned>(h >> 32);
      if (i & 1ull) {
        const unsigned long long g = splitmix64(~(seed + i));
        a = with_exponent(lo, lo >> 31, static_cast<int>(g % 133ull) - 66);
        d = with_exponent(hi, hi >> 31,
                          static_cast<int>((g >> 32) % 69ull) - 34);
      } else {
        a = __uint_as_float(lo);
        d = __uint_as_float(hi);
      }
      r = recip(d);
    }
    const float q = div_by(a, r);
    const float want = __fdiv_rn(a, d);
    const bool both_nan = q != q && want != want;
    if (__float_as_uint(q) != __float_as_uint(want) && !both_nan) {
      ++bad;
      out[1] = __float_as_uint(a);
      out[2] = __float_as_uint(d);
    }
  }
  if (bad) atomicAdd(out, bad);
}

}  // namespace rt

// out: three unsigned 64-bit integers on the card, zeroed by the caller
extern "C" int rt_div_check(int mode, float b, unsigned long long first,
                            unsigned long long count, unsigned long long seed,
                            void* out, void* stream) {
  if (count == 0) return 0;
  if (mode != 0 && mode != 1) return static_cast<int>(cudaErrorInvalidValue);
  rt::div_check_kernel<<<132 * 16, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, b, first, count, seed, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
