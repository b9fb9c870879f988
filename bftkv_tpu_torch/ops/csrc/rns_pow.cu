// K2 for Hopper (sm_90a): fused RNS fixed-4-bit-window modexp.
//
// rns_pow_kernel replaces bftkv_tpu/ops/pallas_rns.py::_pow_body (pallas_call
// at pallas_rns.py:403) and computes the reference's ops/rns.py::_pow_kernel
// bit for bit: digit halves to residues, to-Montgomery, the Montgomery one, a
// 16-entry window table, 4*digits window steps (4 squarings, a constant-time
// one-hot select, one multiply), out of Montgomery form, and the CRT
// coefficients sigma = v * invMi_b mod p_b over base B, as (T, k) int32.
//
// What bounds it: the Montgomery products, 17 + 20*digits per row, each on
// the tensor cores as rns_mma.cuh sets out (shared with K1).  K2's own parts:
//
// - R rows per block (RNS_POW_ROWS): slot s runs row s mod R, so with R < 8
//   the slots past R repeat a row and are never stored.  The window table is
//   uint16 pairs (B | B' << 16, the redundant channel in the low half at
//   j = k), 16 x R x (M_pad + 4) words in shared memory.
//
// Constant time in the secret exponent: the window entry is an arithmetic
// one-hot blend over all 16 table entries; no branch, index or shared-memory
// address depends on a nibble.  Rows past the batch end compute on a clamped
// copy of the last row and are never stored.

#include <cstdint>
#include <cuda_runtime.h>

#include "rns_mma.cuh"

namespace {

using rns_mma::Chain;
using rns_mma::Geo;
using rns_mma::KeyRows;
using rns_mma::Num;
using rns_mma::RnsConsts;
using rns_mma::kSlots;

constexpr int kMaxWarps = 16;        // M_pad <= 256 channels for k <= 255

// K2's geometry: the work area holds the window table, uint16 pairs, 16 x R
// x tstride words.
template <int R>
__host__ __device__ Geo pow_geo(int k, int digits) {
  return Geo(k, digits, (size_t)16 * R * (Geo::tiles(k) * 16 + 4) * 4);
}

template <int R>
struct PowChain : Chain {
  uint32_t* tab;      // (16, R, tstride)
  int tstride;        // conflict-free table reads across slots 2t

  __device__ PowChain(const RnsConsts& cc, unsigned char* raw)
      : Chain(cc, raw, pow_geo<R>(cc.k, cc.digits)) {
    tab = work;
    tstride = geo.mt * 16 + 4;
  }

  // Table entry w of this thread's pair p (an address of position only).
  __device__ __forceinline__ uint32_t* entry(int w, int p) const {
    return tab + ((size_t)w * R + (slot[p & 1] % R)) * tstride + j[p >> 1];
  }

  __device__ void put_entry(int w, const Num& x) const {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int h = p >> 1, cs = p & 1;
      if (slot[cs] < R) *entry(w, p) = red[h] ? x.r[cs] : (x.b[p] | (x.q[p] << 16));
    }
  }

  // Constant-time select: every entry is read, the mask is arithmetic.
  __device__ void select(const uint32_t (&nib)[2], Num& x) const {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    for (int w = 0; w < 16; ++w) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t m = 0u - (uint32_t)(nib[p & 1] == (uint32_t)w);
        v[p] |= m & *entry(w, p);
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      x.b[p] = red[p >> 1] ? 0u : (v[p] & 0xFFFFu);
      x.q[p] = v[p] >> 16;
    }
#pragma unroll
    for (int cs = 0; cs < 2; ++cs) x.r[cs] = (red[1] ? v[2 + cs] : v[cs]) & 0xFFFFu;
  }
};

template <int R>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
rns_pow_kernel(const uint8_t* __restrict__ base_h, const uint8_t* __restrict__ nib_t,
               const int32_t* __restrict__ idx, int T, int n_keys, KeyRows key,
               RnsConsts cc, int32_t* __restrict__ sigma_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PowChain<R> ch(cc, smem_raw);
  const int k = cc.k;
  const int row0 = blockIdx.x * R;

  // Rows of this thread's slots (slot s runs row s mod R, clamped to the
  // batch) and their key rows; a key index outside [0, n_keys) reads key row
  // 0 (the entry points refuse such indices).
  int row[2], kid[2];
#pragma unroll
  for (int cs = 0; cs < 2; ++cs) {
    row[cs] = min(row0 + (2 * ch.t + cs) % R, T - 1);
    const int x = idx[row[cs]];
    kid[cs] = (x >= 0 && x < n_keys) ? x : 0;
  }
  ch.init(key, kid);
  ch.stage(smem_raw);

  Num x, m2, one, acc;
  // One conversion per 17 + 20*digits products: 4 loads of D in flight.
  ch.template to_residues<R, 4>(base_h, row0, T, x);  // its barriers order the staging too
  ch.key_num(key.m2_all, key.m2_r, kid, m2);
  Chain::set_one(one);
  ch.mont(x, m2, x);      // base in Montgomery form
  ch.mont(m2, one, acc);  // M mod N: the Montgomery one

  // 16-entry window table t[w] = base^w (Montgomery form), in shared memory.
  ch.put_entry(0, acc);
  ch.put_entry(1, x);
  Num tw = x;
  for (int w = 2; w < 16; ++w) {
    ch.mont(tw, x, tw);
    ch.put_entry(w, tw);
  }
  __syncthreads();

  // acc = one; per nibble (most significant first): acc^16 * t[nibble].
  const int steps = 4 * cc.digits;
  for (int st = 0; st < steps; ++st) {
    uint32_t nib[2];
#pragma unroll
    for (int cs = 0; cs < 2; ++cs) nib[cs] = nib_t[(size_t)st * T + row[cs]];
    for (int i = 0; i < 4; ++i) ch.mont(acc, acc, acc);
    ch.select(nib, x);
    ch.mont(acc, x, acc);
  }
  ch.mont(acc, one, acc);  // out of Montgomery form

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int h = p >> 1, s = ch.slot[p & 1];
    if (ch.chan[h] && s < R && row0 + s < T) {
      sigma_out[(size_t)(row0 + s) * k + ch.j[h]] =
          (int32_t)rns_mma::shoup(acc.b[p], ch.invMi_b[h], ch.invMi_b_sh[h], ch.pb[h]);
    }
  }
}

// Rows per block.  At k = 188 (2048-bit moduli) 8 rows would need 254,496 B
// of shared memory, over the H100's opt-in 232,448 B; 4 rows need 204,320 B.
// time_rns.py times other counts (-DRNS_POW_ROWS=R); PERF.md has why 4.
#ifndef RNS_POW_ROWS
#define RNS_POW_ROWS 4
#endif
constexpr int kPowRows = RNS_POW_ROWS;
static_assert(kPowRows >= 1 && kPowRows <= kSlots && (kSlots % kPowRows) == 0,
              "rows per block must divide the 8 mma row slots");

}  // namespace

extern "C" {

// Returns a cudaError_t value (0 = launched), or rns_mma::kErrSharedMemory
// when the block's shared memory does not fit the card; writes the need and
// the device's opt-in limit per block to smem_need and smem_limit.  ev_before
// and ev_after, where not null, are cudaEvent_t recorded around the kernel.
int rns_pow_launch(const uint8_t* base_h, const uint8_t* nib_t, const int32_t* idx, int T,
                   int n_keys, const int32_t* n_all, const int32_t* n_r, const int32_t* neg_ninv_b,
                   const int32_t* ninv_all, const int32_t* m2_all, const int32_t* m2_r,
                   const int32_t* p_all, const int32_t* invMi_b, const int32_t* invMi_q,
                   const int32_t* Mq_mod_b, const int32_t* invM_q,
                   const uint32_t* mu_all, const uint32_t* invMi_b_sh,
                   const uint32_t* Mq_mod_b_sh, const uint32_t* invM_q_sh,
                   const int8_t* E_mma, const uint16_t* D,
                   int invMq_pr, int invM_pr, int k, int digits,
                   int32_t* sigma_out, void* stream, int* smem_need, int* smem_limit,
                   void* ev_before, void* ev_after) {
  // k <= 255 keeps every extension sum below 2^32 and the M tiles within
  // kMaxWarps warps.
  if (T <= 0 || n_keys <= 0 || k <= 0 || k > 255 || digits <= 0 || digits > 256)
    return (int)cudaErrorInvalidValue;
  const KeyRows key{n_all, n_r, neg_ninv_b, ninv_all, m2_all, m2_r};
  const RnsConsts cc{p_all, mu_all, invMi_b, invMi_b_sh, invMi_q,
                     Mq_mod_b, Mq_mod_b_sh, invM_q, invM_q_sh,
                     reinterpret_cast<const uint4*>(E_mma), D,
                     (uint32_t)invMq_pr, (uint32_t)invM_pr, k, digits};
  return rns_mma::launch(rns_pow_kernel<kPowRows>, pow_geo<kPowRows>(k, digits),
                         (T + kPowRows - 1) / kPowRows, (cudaStream_t)stream, smem_need,
                         smem_limit, (cudaEvent_t)ev_before, (cudaEvent_t)ev_after,
                         base_h, nib_t, idx, T, n_keys, key, cc, sigma_out);
}

// Registers and local-memory bytes (spills and stack) per thread of K2 as
// compiled, and its rows per block.  Returns a cudaError_t value.
int rns_pow_attrs(int* regs, int* local_bytes, int* rows_per_block) {
  *rows_per_block = kPowRows;
  return rns_mma::attrs(rns_pow_kernel<kPowRows>, regs, local_bytes);
}

}  // extern "C"
