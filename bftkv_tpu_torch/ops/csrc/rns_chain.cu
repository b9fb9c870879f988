// K1 for Hopper (sm_90a): fused RNS RSA-2048 e=65537 verify.
//
// rns_verify_kernel replaces bftkv_tpu/ops/pallas_rns.py::_verify_body
// (pallas_call at pallas_rns.py:517) and computes the reference's
// ops/rns.py::_verify_kernel bit for bit: the digit halves of s and em to
// residues, to-Montgomery (x M^2), 16 squarings, x s and from-Montgomery
// (19 RNS Montgomery products), then the alpha check: Delta_j = (v_j - em_j)
// * N^-1 mod p_j must be one alpha <= k+1 in every channel of B and B'.
// (K2, the windowed modexp, is in rns_pow.cu.)
//
// What bounds it: the 19 Montgomery products, run on the tensor cores as
// rns_mma.cuh sets out (shared with K2), and the two conversions.  K1's own
// parts:
// - 8 rows per block, one per mma row slot; one warp per 16-channel M tile
//   (12 warps at k = 188).  K1 has no window table, so the block takes the E
//   planes, the sigma planes and the conversion area: 174,400 B at k = 188,
//   one block per SM.
// - s, em and the running product stay in registers (Num) across the chain;
//   residues never leave the block between products.
// - The alpha check runs where the C fragment lands: each thread forms
//   Delta of its 4 (channel, slot) pairs by Barrett (the products are
//   < 2^24), the thread holding channel 0 posts each slot's alpha to shared
//   memory, every thread marks its slots' mismatches (channels j < k only;
//   the pairs at j >= k are inert), and one thread per slot writes the
//   verdict.
//
// Fail closed: a key index outside [0, n_keys) reads key row 0 (so no read
// leaves the key table) and gets verdict 0; every row below the batch end
// is written, and no row at or past it.  Rows past the end compute on a
// clamped copy of the last row.

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

// At most 12 warps, so at most 12 M tiles: k + 1 <= 192 extension outputs.
// The launch bound then leaves a thread up to 168 registers.
constexpr int kVerifyWarps = 12;
constexpr int kMaxK = 16 * kVerifyWarps - 1;
// The check's words in the work area: alpha of channel 0 and a mismatch
// word, per slot.
constexpr size_t kCheckBytes = 2 * kSlots * sizeof(uint32_t);

__global__ void __launch_bounds__(32 * kVerifyWarps, 1)
rns_verify_kernel(const uint8_t* __restrict__ sig_h, const uint8_t* __restrict__ em_h,
                  const int32_t* __restrict__ idx, int T, int n_keys, KeyRows key,
                  RnsConsts cc, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Chain ch(cc, smem_raw, Geo(cc.k, cc.digits, kCheckBytes));
  const int k = cc.k;
  const int row0 = blockIdx.x * kSlots;

  int kid[2];
#pragma unroll
  for (int cs = 0; cs < 2; ++cs) {
    const int x = idx[min(row0 + 2 * ch.t + cs, T - 1)];
    kid[cs] = (x >= 0 && x < n_keys) ? x : 0;
  }
  ch.init(key, kid);
  ch.stage(smem_raw);

  // Two conversions per 19 products, each waiting on D's loads: 16 in flight.
  Num s, em, acc;
  ch.to_residues<kSlots, 16>(sig_h, row0, T, s);  // its barriers order the staging too
  ch.to_residues<kSlots, 16>(em_h, row0, T, em);
  ch.key_num(key.m2_all, key.m2_r, kid, acc);
  ch.mont(s, acc, s);  // s * M mod N: Montgomery form
  ch.mont(s, s, acc);
  for (int i = 1; i < 16; ++i) ch.mont(acc, acc, acc);
  ch.mont(acc, s, acc);  // s^65537 in Montgomery form
  Chain::set_one(s);
  ch.mont(acc, s, acc);  // v = s^e mod N, v < (k+1)N

  // Delta of this thread's pairs; channel 0's is each slot's alpha.
  uint32_t* alpha0 = ch.work;          // (8)
  uint32_t* bad = alpha0 + kSlots;     // (8)
  uint32_t db[4], dq[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int h = p >> 1, cs = p & 1;
    const size_t base = (size_t)kid[cs] * 2 * k;
    const int x = ch.chan[h] ? ch.j[h] : 0;
    const uint32_t nb = ch.chan[h] ? (uint32_t)key.ninv_all[base + x] : 0u;
    const uint32_t nq = ch.chan[h] ? (uint32_t)key.ninv_all[base + k + x] : 0u;
    const uint32_t xb = acc.b[p] >= em.b[p] ? acc.b[p] - em.b[p] : acc.b[p] + ch.pb[h] - em.b[p];
    const uint32_t xq = acc.q[p] >= em.q[p] ? acc.q[p] - em.q[p] : acc.q[p] + ch.pq[h] - em.q[p];
    db[p] = rns_mma::barrett(xb * nb, ch.pb[h], ch.mub[h]);
    dq[p] = rns_mma::barrett(xq * nq, ch.pq[h], ch.muq[h]);
    if (ch.j[h] == 0) alpha0[ch.slot[cs]] = db[p];
  }
  if (threadIdx.x < kSlots) bad[threadIdx.x] = 0u;
  __syncthreads();
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t a = alpha0[ch.slot[p & 1]];
    if (ch.chan[p >> 1] && (db[p] != a || dq[p] != a)) bad[ch.slot[p & 1]] = 1u;
  }
  __syncthreads();
  if (threadIdx.x < kSlots) {
    const int r = row0 + threadIdx.x;
    if (r < T) {
      const int x = idx[r];
      const bool ok = bad[threadIdx.x] == 0u && alpha0[threadIdx.x] <= (uint32_t)(k + 1) &&
                      x >= 0 && x < n_keys;
      out[r] = ok ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t value (0 = launched), or rns_mma::kErrSharedMemory
// when the block's shared memory does not fit the card; writes the need and
// the device's opt-in limit per block to smem_need and smem_limit.  The
// arguments are K2's (rns_pow_launch), with sig_h, em_h and out; ev_before
// and ev_after, where not null, are cudaEvent_t recorded around the kernel.
int rns_verify_launch(const uint8_t* sig_h, const uint8_t* em_h, const int32_t* idx, int T,
                      int n_keys, const int32_t* n_all, const int32_t* n_r, const int32_t* neg_ninv_b,
                      const int32_t* ninv_all, const int32_t* m2_all, const int32_t* m2_r,
                      const int32_t* p_all, const int32_t* invMi_b, const int32_t* invMi_q,
                      const int32_t* Mq_mod_b, const int32_t* invM_q,
                      const uint32_t* mu_all, const uint32_t* invMi_b_sh,
                      const uint32_t* Mq_mod_b_sh, const uint32_t* invM_q_sh,
                      const int8_t* E_mma, const uint16_t* D,
                      int invMq_pr, int invM_pr, int k, int digits,
                      int32_t* out, void* stream, int* smem_need, int* smem_limit,
                      void* ev_before, void* ev_after) {
  // k <= kMaxK keeps the M tiles within the kernel's 12 warps (and every
  // extension sum below 2^32).
  if (T <= 0 || n_keys <= 0 || k <= 0 || k > kMaxK || digits <= 0 || digits > 256)
    return (int)cudaErrorInvalidValue;
  const KeyRows key{n_all, n_r, neg_ninv_b, ninv_all, m2_all, m2_r};
  const RnsConsts cc{p_all, mu_all, invMi_b, invMi_b_sh, invMi_q,
                     Mq_mod_b, Mq_mod_b_sh, invM_q, invM_q_sh,
                     reinterpret_cast<const uint4*>(E_mma), D,
                     (uint32_t)invMq_pr, (uint32_t)invM_pr, k, digits};
  return rns_mma::launch(rns_verify_kernel, Geo(k, digits, kCheckBytes),
                         (T + kSlots - 1) / kSlots, (cudaStream_t)stream, smem_need, smem_limit,
                         (cudaEvent_t)ev_before, (cudaEvent_t)ev_after,
                         sig_h, em_h, idx, T, n_keys, key, cc, out);
}

// Registers and local-memory bytes (spills and stack) per thread of K1 as
// compiled, and its rows per block.  Returns a cudaError_t value.
int rns_verify_attrs(int* regs, int* local_bytes, int* rows_per_block) {
  *rows_per_block = kSlots;
  return rns_mma::attrs(rns_verify_kernel, regs, local_bytes);
}

const char* rns_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
