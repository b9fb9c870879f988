// Limb-Montgomery RSA-2048 e=65537 verify chain for Hopper (sm_90a): the port's K3.
//
// K3 mont_verify_kernel replaces bftkv_tpu/ops/pallas_mont.py::_verify_kernel
//    (pallas_call at pallas_mont.py:174, entry verify_e65537).
//
// What it computes is the Pallas kernel's chain, per row with its own modulus:
// to-Montgomery with r2, 16 squarings, x s, from-Montgomery, then v XOR em into a
// (T, 128) int32 diff of 16-bit digits (a row verifies iff its diff is all zero).
// The plain version is bftkv_tpu_torch/ops/rsa.py::_verify_chain; the per-lane
// algorithm below is modelled step for step in tests/test_torch_mont_arith.py.
//
// Limbs: the operands are 128 16-bit digits; inside the kernel they are packed in
// pairs into 64 32-bit words and every Montgomery product is CIOS (coarsely
// integrated operand scanning) with 64-bit multiply-adds and one final
// conditional subtraction.  R = 2^2048 in both widths, so the reference's r2
// serves unchanged, and n0' = -n^-1 mod 2^32 is the low 32 bits of its n' (the
// kernel reads n'[0] | n'[1] << 16).  Every product ends canonical (v < n), so
// the diff is bit-identical to the plain version.
//
// What bounds it on this card.  Counted on int8 tensor cores (chip_smoke.py's
// bound of record) the chain's digit MACs take 0.0079 ms at T=4096; but the two
// operands of a product belong to one row, so no matrix operand is shared and
// the tensor cores do not apply.  On the CUDA cores a row does 19 products of
// 2 * 64^2 word multiply-adds: T=4096 issues about 6.4e8 IMAD.WIDE plus as many
// carry adds, an issue floor of about 0.05-0.1 ms over 132 SMs.  A kernel with one
// thread per row gets one warp per SM at T=4096, whose dependent carry chains
// leave it bound by latency, at a fraction of that rate.  Split 16 ways, T=4096
// runs 16 warps per SM; the integer multiply pipe then sets the pace (per CIOS
// step 8 IMAD.WIDE and about 7 more IMADs for carries and moves, as compiled),
// at about twice the IMAD.WIDE floor (PERF.md section 6).
//
// Design: each row is split across a group of kTpi lanes of one warp.
// - Lane r of a group owns words [r*kW, r*kW + kW) of the multiplicand a, the
//   modulus n, the accumulator t and s in Montgomery form, all in registers; it
//   loads its own 2*kW contiguous digits, so a row's group reads one 512 B run.
// - Multiplier word i is broadcast from its owner lane (i / kW) by a shuffle.  The
//   64 steps of a product are unrolled, so no register array is indexed at run
//   time (unrolling the loop over owner lanes too took 22% off, PERF.md).
// - CIOS step i: every lane adds a * b_i into its kW words with a local carry
//   chain; lane 0's lowest word is exact (no carry ever lands there), so
//   m = t_0 * n0' is computed there and broadcast; every lane adds m * n; the
//   one-word right shift takes the next lane's lowest word (one shuffle).  The
//   carry out of a lane's top word belongs, after the shift, to that same top
//   word: it is kept as a pending carry h and folded in on the next step, so no
//   step carries across lanes.
//   Bound: each 64-bit multiply-add a*b + t + c <= (2^32-1)^2 + 2(2^32-1) =
//   2^64 - 1, so a chain's carry is < 2^32; folding h (<= 2^33) into a 32-bit
//   top word adds at most 2 to that carry, so the next h <= (2^32 + 1) +
//   (2^32 - 1) = 2^33, by induction from h = 0.
// - Once per product the pending carries resolve: each lane folds h into its top
//   word (excess <= 2, handed to the next lane by one shuffle and rippled in
//   locally, leaving a carry-out of one bit), then one generate/propagate pair of
//   ballots and one integer add give every lane its carry-in (the Kogge-Stone scan
//   of pallas_mont.py:63-86 in one step).  t < 2n < 2^2049, so the bits above
//   word 63 are 0 or 1.  t >= n? and the subtraction go the same way: borrows by
//   ballot, the mask from the top bit and the last borrow, selected with no
//   branch on the data.
// - Blocks of kThreads (kRows rows).  kRows divides 256 and the launcher refuses
//   T % kRows != 0, so every lane of every warp runs every shuffle and ballot.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 64;    // 32-bit words of a 2048-bit number
constexpr int kDigits = 128;  // 16-bit digits per operand row
constexpr int kTpi = 16;      // threads (lanes) per row
constexpr int kW = kWords / kTpi;        // words per lane
constexpr int kThreads = 128;            // threads per block
constexpr int kRows = kThreads / kTpi;   // rows per block
constexpr int kProducts = 19;            // to-Montgomery, 16 squarings, x s, from-Montgomery
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kWords % kTpi == 0 && kTpi <= 16 && kW >= 2, "a lane owns >= 2 words");
static_assert(256 % kRows == 0 && kThreads % 32 == 0, "blocks are whole warps of whole rows");

// A lane's place in its row's group: r = lane within the group, base = the
// group's first lane in the warp.
struct Lane {
  int r;
  unsigned base;
};

// Lane r's 2*kW 16-bit digits (int32) -> its kW words.
__device__ __forceinline__ void load_words(const int32_t* __restrict__ src, uint32_t (&w)[kW]) {
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    w[j] = ((uint32_t)src[2 * j] & 0xFFFFu) | (((uint32_t)src[2 * j + 1] & 0xFFFFu) << 16);
  }
}

// Carry (or borrow) into each lane and out of the group's top lane, from per-lane
// generate g and propagate p flags, never both set.  With X = G | P and Y = G,
// the add X + Y generates where G and propagates where P, so bit l of
// (X + Y) ^ P is the carry into lane l, and bit kTpi the carry out of the top.
__device__ __forceinline__ void scan(bool g, bool p, Lane ln, uint32_t& cin, uint32_t& cout) {
  constexpr unsigned kSeg = (1u << kTpi) - 1u;
  const unsigned G = (__ballot_sync(kFull, g) >> ln.base) & kSeg;
  const unsigned P = (__ballot_sync(kFull, p) >> ln.base) & kSeg;
  const unsigned s = (G | P) + G;
  cin = ((s ^ P) >> ln.r) & 1u;
  cout = s >> kTpi;
}

// out = a * b * 2^-2048 mod n, canonical, for a < 2^2048 and b < n (CIOS across
// the group; see the head comment).  out may alias a or b.
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[kW], const uint32_t (&b)[kW],
                                         const uint32_t (&n)[kW], uint32_t n0p, Lane ln,
                                         uint32_t (&out)[kW]) {
  uint32_t t[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) t[k] = 0u;
  uint64_t h = 0;  // pending carry at the weight of t[kW - 1]; <= 2^33
#pragma unroll
  for (int src = 0; src < kTpi; ++src) {  // words i = src * kW + kk of b
    uint32_t bw[kW];
#pragma unroll
    for (int kk = 0; kk < kW; ++kk) bw[kk] = __shfl_sync(kFull, b[kk], src, kTpi);
#pragma unroll
    for (int kk = 0; kk < kW; ++kk) {
      uint64_t c = 0;
#pragma unroll
      for (int k = 0; k < kW; ++k) {  // t += a * b_i
        const uint64_t p = (uint64_t)a[k] * bw[kk] + t[k] + c;
        t[k] = (uint32_t)p;
        c = p >> 32;
      }
      const uint64_t q = (uint64_t)t[kW - 1] + h;
      t[kW - 1] = (uint32_t)q;
      c += q >> 32;
      // t + m * n is divisible by 2^32; lane 0's t[0] is the exact low word.
      const uint32_t m = __shfl_sync(kFull, t[0] * n0p, 0, kTpi);
      uint64_t c2 = 0;
#pragma unroll
      for (int k = 0; k < kW; ++k) {  // t += m * n
        const uint64_t p = (uint64_t)m * n[k] + t[k] + c2;
        t[k] = (uint32_t)p;
        c2 = p >> 32;
      }
      // t /= 2^32: lane 0's t[0] is now 0; every lane takes the next one's.
      uint32_t next = __shfl_down_sync(kFull, t[0], 1, kTpi);
      if (ln.r == kTpi - 1) next = 0u;
#pragma unroll
      for (int k = 0; k < kW - 1; ++k) t[k] = t[k + 1];
      t[kW - 1] = next;
      h = c + c2;
    }
  }

  // Resolve: fold h into the top word; the excess (<= 2) goes up one lane.
  uint64_t q = (uint64_t)t[kW - 1] + h;
  t[kW - 1] = (uint32_t)q;
  const uint32_t g = (uint32_t)(q >> 32);
  uint32_t c = __shfl_up_sync(kFull, g, 1, kTpi);
  if (ln.r == 0) c = 0u;
  const uint32_t g_top = __shfl_sync(kFull, g, kTpi - 1, kTpi);  // weight 2^2048
  bool ones = true;
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    q = (uint64_t)t[k] + c;
    t[k] = (uint32_t)q;
    c = (uint32_t)(q >> 32);
    ones = ones && t[k] == 0xFFFFFFFFu;
  }
  uint32_t cin, cout;
  scan(c != 0u, ones, ln, cin, cout);  // a lane that carried out holds words <= 1
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    q = (uint64_t)t[k] + cin;
    t[k] = (uint32_t)q;
    cin = (uint32_t)(q >> 32);
  }
  const uint32_t hi = g_top + cout;  // t < 2n < 2^2049: 0 or 1

  // t >= n?  d = t - n with borrows by the same scan; keep d where t >= n.
  uint32_t d[kW];
  uint32_t bo = 0u;
  bool zero = true;
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    const uint64_t x = (uint64_t)t[k] - n[k] - bo;
    d[k] = (uint32_t)x;
    bo = (uint32_t)(x >> 63);
    zero = zero && d[k] == 0u;
  }
  uint32_t bin, bout;
  scan(bo != 0u, zero, ln, bin, bout);  // a lane that borrowed out has d != 0
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    const uint64_t x = (uint64_t)d[k] - bin;
    d[k] = (uint32_t)x;
    bin = (uint32_t)(x >> 63);
  }
  const uint32_t mask = 0u - (uint32_t)(hi != 0u || bout == 0u);
#pragma unroll
  for (int k = 0; k < kW; ++k) out[k] = (d[k] & mask) | (t[k] & ~mask);
}

__global__ void __launch_bounds__(kThreads)
mont_verify_kernel(const int32_t* __restrict__ sig, const int32_t* __restrict__ em,
                   const int32_t* __restrict__ n, const int32_t* __restrict__ nprime,
                   const int32_t* __restrict__ r2, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const Lane ln{lane % kTpi, (unsigned)(lane - lane % kTpi)};
  const int row = blockIdx.x * kRows + threadIdx.x / kTpi;
  const size_t base = (size_t)row * kDigits;
  const size_t own = base + (size_t)ln.r * 2 * kW;  // this lane's digits
  const uint32_t n0 = ((uint32_t)nprime[base] & 0xFFFFu) |
                      (((uint32_t)nprime[base + 1] & 0xFFFFu) << 16);

  uint32_t nn[kW], acc[kW], sm[kW], b[kW];
  load_words(n + own, nn);
  load_words(r2 + own, sm);  // r2 rides in sm until the first product
  load_words(sig + own, acc);
#pragma unroll 1
  for (int p = 0; p < kProducts; ++p) {
    // multiplier: r2 (p = 0), acc (16 squarings), s in Montgomery form
    // (p = 17), 1 (p = 18)
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const uint32_t one = (ln.r == 0 && k == 0) ? 1u : 0u;
      b[k] = (p == 0 || p == kProducts - 2) ? sm[k] : (p == kProducts - 1 ? one : acc[k]);
    }
    mont_mul(acc, b, nn, n0, ln, acc);
    if (p == 0) {
#pragma unroll
      for (int k = 0; k < kW; ++k) sm[k] = acc[k];  // s * R mod n
    }
  }

  const int32_t* e = em + own;
  int32_t* o = out + own;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    o[2 * j] = (int32_t)(acc[j] & 0xFFFFu) ^ e[2 * j];
    o[2 * j + 1] = (int32_t)(acc[j] >> 16) ^ e[2 * j + 1];
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t value (0 = launched).  All operands are (T, 128) int32
// 16-bit digits, row-major; T must be a positive multiple of kRows (the wrapper
// asks for a multiple of 256).
int mont_verify_launch(const int32_t* sig, const int32_t* em, const int32_t* n,
                       const int32_t* nprime, const int32_t* r2, int T, int32_t* out,
                       void* stream) {
  if (T <= 0 || T % kRows != 0) return (int)cudaErrorInvalidValue;
  mont_verify_kernel<<<T / kRows, kThreads, 0, (cudaStream_t)stream>>>(sig, em, n, nprime, r2,
                                                                      out);
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
