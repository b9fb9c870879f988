// Limb-Montgomery RSA-2048 e=65537 verify chain for Hopper (sm_90a): the port's K3.
//
// K3 mont_verify_kernel replaces bftkv_tpu/ops/pallas_mont.py::_verify_kernel
//    (pallas_call at pallas_mont.py:174, entry verify_e65537).
//
// What it computes is the Pallas kernel's chain, per row with its own modulus:
// to-Montgomery with r2, 16 squarings, x s, from-Montgomery, then v XOR em into a
// (T, 128) int32 diff of 16-bit digits (a row verifies iff its diff is all zero).
// The plain version is bftkv_tpu_torch/ops/rsa.py::_verify_chain.
//
// Limbs: the operands are 128 16-bit digits; inside the kernel they are packed in
// pairs into 64 32-bit words and every Montgomery product is CIOS (coarsely
// integrated operand scanning) with 64-bit multiply-adds and one final
// conditional subtraction.  R = 2^2048 in both widths, so the reference's r2
// serves unchanged, and n0' = -n^-1 mod 2^32 is the low 32 bits of its n' (the
// kernel reads n'[0] | n'[1] << 16).  Both forms give the canonical v < n, so
// the diff is bit-identical to the plain version.
//
// Design (a simple kernel that is right; making it fast is later work):
// - one thread runs one row through the whole chain; its 64-word accumulator,
//   multiplicand and modulus live in registers (the word loops are unrolled);
// - the multiplier of each product is read one word per outer step from this
//   thread's own column of shared memory (conflict-free: lane l reads bank l),
//   so the outer loop need not be unrolled; no thread reads another's column,
//   so the kernel has no barrier;
// - 32 rows per block (one warp): T = 4096 gives 128 blocks for 132 SMs.
// Bound: operations.  Each row does 19 products of ~2 * 64^2 32-bit multiply-
// adds and reads 2.5 KB; at about one warp per SM the dependent carry chains
// leave it latency-bound, far from the card's peak.
//
// Rows past T are not run and not written; the wrapper refuses T % 256 != 0,
// as the reference's grid covers only whole 256-row tiles.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 64;    // 32-bit words of a 2048-bit number
constexpr int kDigits = 128;  // 16-bit digits per operand row
constexpr int kRows = 32;     // rows (one per thread) per block

// One row's 128 16-bit digits (int32) -> 64 words in registers.
__device__ __forceinline__ void load_words(const int32_t* __restrict__ src,
                                           uint32_t (&w)[kWords]) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    w[j] = ((uint32_t)src[2 * j] & 0xFFFFu) | (((uint32_t)src[2 * j + 1] & 0xFFFFu) << 16);
  }
}

// 64 words -> this thread's shared-memory column (word i at col[i * kRows]).
__device__ __forceinline__ void store_col(const uint32_t (&w)[kWords], uint32_t* col) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) col[j * kRows] = w[j];
}

// out = a * b * 2^-2048 mod n (CIOS), for a < 2^2048 and b < n; out may alias a.
// After outer step i the accumulator t is < a + n < 2^2049, so it fits 64 words
// plus one bit (t_hi); the final value is < 2n and one subtraction makes it < n.
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[kWords], const uint32_t* b,
                                         const uint32_t (&n)[kWords], uint32_t n0p,
                                         uint32_t (&out)[kWords]) {
  uint32_t t[kWords];
  uint32_t t_hi = 0u;
#pragma unroll
  for (int j = 0; j < kWords; ++j) t[j] = 0u;
#pragma unroll 1
  for (int i = 0; i < kWords; ++i) {
    const uint32_t bi = b[i * kRows];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {  // t += a * b_i
      const uint64_t p = (uint64_t)a[j] * bi + t[j] + c;
      t[j] = (uint32_t)p;
      c = p >> 32;
    }
    const uint64_t top = (uint64_t)t_hi + c;
    const uint32_t m = t[0] * n0p;  // t + m * n is divisible by 2^32
    uint64_t p = (uint64_t)m * n[0] + t[0];
    c = p >> 32;
#pragma unroll
    for (int j = 1; j < kWords; ++j) {  // t = (t + m * n) / 2^32
      p = (uint64_t)m * n[j] + t[j] + c;
      t[j - 1] = (uint32_t)p;
      c = p >> 32;
    }
    const uint64_t s = top + c;
    t[kWords - 1] = (uint32_t)s;
    t_hi = (uint32_t)(s >> 32);
  }
  // t >= n?  Compare by the borrow of t - n, then subtract under a mask.
  uint32_t borrow = 0u;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t x = (uint64_t)t[j] - n[j] - borrow;
    borrow = (uint32_t)(x >> 63);
  }
  const uint32_t mask = (t_hi != 0u || borrow == 0u) ? 0xFFFFFFFFu : 0u;
  borrow = 0u;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t x = (uint64_t)t[j] - (n[j] & mask) - borrow;
    out[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
}

__global__ void __launch_bounds__(kRows)
mont_verify_kernel(const int32_t* __restrict__ sig, const int32_t* __restrict__ em,
                   const int32_t* __restrict__ n, const int32_t* __restrict__ nprime,
                   const int32_t* __restrict__ r2, int T, int32_t* __restrict__ out) {
  __shared__ uint32_t b_all[kWords * kRows];   // multiplier of the current product
  __shared__ uint32_t sm_all[kWords * kRows];  // s in Montgomery form
  const int lane = threadIdx.x;
  const int row = blockIdx.x * kRows + lane;
  if (row >= T) return;  // no barrier below: an early exit is safe
  uint32_t* b = b_all + lane;
  uint32_t* sm = sm_all + lane;
  const size_t base = (size_t)row * kDigits;
  const uint32_t n0 = ((uint32_t)nprime[base] & 0xFFFFu) |
                      (((uint32_t)nprime[base + 1] & 0xFFFFu) << 16);

  uint32_t nn[kWords], acc[kWords];
  load_words(n + base, nn);
  load_words(r2 + base, acc);
  store_col(acc, b);
  load_words(sig + base, acc);
  mont_mul(acc, b, nn, n0, acc);  // s * R mod n
  store_col(acc, sm);
#pragma unroll 1
  for (int i = 0; i < 16; ++i) {  // s^(2^16)
    store_col(acc, b);
    mont_mul(acc, b, nn, n0, acc);
  }
  mont_mul(acc, sm, nn, n0, acc);  // s^65537 in Montgomery form
  b[0] = 1u;
#pragma unroll
  for (int j = 1; j < kWords; ++j) b[j * kRows] = 0u;
  mont_mul(acc, b, nn, n0, acc);  // v = s^65537 mod n, canonical

  const int32_t* e = em + base;
  int32_t* o = out + base;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    o[2 * j] = (int32_t)(acc[j] & 0xFFFFu) ^ e[2 * j];
    o[2 * j + 1] = (int32_t)(acc[j] >> 16) ^ e[2 * j + 1];
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t value (0 = launched).  All operands are (T, 128) int32
// 16-bit digits, row-major.
int mont_verify_launch(const int32_t* sig, const int32_t* em, const int32_t* n,
                       const int32_t* nprime, const int32_t* r2, int T, int32_t* out,
                       void* stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (T + kRows - 1) / kRows;
  mont_verify_kernel<<<grid, kRows, 0, (cudaStream_t)stream>>>(sig, em, n, nprime, r2, T, out);
  return (int)cudaGetLastError();
}

// Registers and local-memory bytes (spills and stack) per thread, as compiled.
int mont_kernel_attrs(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, mont_verify_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
