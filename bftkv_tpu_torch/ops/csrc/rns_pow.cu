// K2 for Hopper (sm_90a): fused RNS fixed-4-bit-window modexp.
//
// rns_pow_kernel replaces bftkv_tpu/ops/pallas_rns.py::_pow_body (pallas_call
// at pallas_rns.py:403) and computes the reference's ops/rns.py::_pow_kernel
// bit for bit: digit halves to residues, to-Montgomery, the Montgomery one, a
// 16-entry window table, 4*digits window steps (4 squarings, a constant-time
// one-hot select, one multiply), out of Montgomery form, and the CRT
// coefficients sigma = v * invMi_b mod p_b over base B, as (T, k) int32.
//
// What bounds it: integer multiply-adds, almost all of them in the two base
// extensions of each Montgomery product (Sigma_i sigma_i * E[i][j] over k
// channels), then the elementwise modular steps of each channel.  The design:
//
// - Base extensions on int8 tensor cores.  An extension is out^T = E^T *
//   sigma^T: the k+1 output channels are mma.sync.m16n8k32 M (tiles of 16),
//   the k input channels K (steps of 32), and the block's 8 row slots N.
//   Residues are < 2^12, so sigma = sigma_hi*64 + sigma_lo and E likewise, all
//   planes < 64 (s8; the reference's own 6-bit split, pallas_rns.py:191-216).
//   Three plane products, lo*lo, hi*hi and (lo+hi)*(lo+hi) (sums < 127, still
//   s8), sum in s32 to < 2^22 each; mid = ss - ll - hh (Karatsuba) and S = ll +
//   64*mid + 4096*hh, taken in uint32, is the exact integer
//   Sigma sigma_i*E[i][j] < k*4095^2 < 2^32.  The
//   host packs E1, E2 once per context as int8 planes in A-fragment order
//   (ops/rns.py::mma_planes), staged whole in shared memory; sigma goes
//   through shared memory as int8 planes [slot][i], read as B fragments.
// - One warp per M tile; a thread holds the C fragment's 4 (channel, slot)
//   pairs (channels g, g+8 of its tile, slots 2t, 2t+1) and runs every
//   elementwise step of those pairs where the fragment lands, with the
//   pairs' constants in registers.  The 2^12 redundant channel is output
//   j = k of both extensions; its thread computes rr and alpha, and alpha
//   reaches the other channels through shared memory.  Channels j > k (and
//   the B / B' values at j = k) are inert: p = 1, multipliers 0, E rows and
//   columns zero (the reference's p = 1 dummies, pallas_rns.py:17-23).
// - Every reduction by a run-time prime is reciprocal arithmetic on 32-bit
//   words, no '%': Barrett for x < 2^32, q = umulhi(x, mu_p) with mu_p =
//   floor(2^32/p), so q >= floor(x/p) - 1 and r = x - q*p < 2p; Shoup for a*w
//   with a fixed w < p, q = umulhi(a, w'), w' = floor(w*2^32/p), r = a*w - q*p
//   (mod 2^32) < 2p; one conditional subtraction each.  The context's mu_p
//   and w' come from the host (ops/rns.py::_Consts.kern); the w' of the
//   key's -N^-1 and N are derived once per row at the start.
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

namespace {

constexpr uint32_t kPrMask = 4095u;  // the 2^12 redundant channel
constexpr int kSlots = 8;            // mma N: row slots per block
constexpr int kMaxWarps = 16;        // M_pad <= 256 channels for k <= 255

struct PowConsts {
  const int32_t* p_all;        // (2k): base B then base B'
  const uint32_t* mu_all;      // (2k): floor(2^32 / p)
  const int32_t* invMi_b;      // (k) and the Shoup w' of each fixed multiplier
  const uint32_t* invMi_b_sh;
  const int32_t* invMi_q;
  const uint32_t* invMi_q_sh;
  const int32_t* Mq_mod_b;
  const uint32_t* Mq_mod_b_sh;
  const int32_t* invM_q;
  const uint32_t* invM_q_sh;
  const uint4* E_mma;          // (2 ext, 2 planes, M tiles, K steps, 32 lanes) x 16 B
  const uint16_t* D;           // (2*digits, 2k+1) 8-bit halves -> residues
  uint32_t invMq_pr, invM_pr;
  int k, digits;
};

struct KeyRows {             // unique key rows (K, .), gathered through idx
  const int32_t* n_all;      // (K, 2k)
  const int32_t* n_r;        // (K, 1)
  const int32_t* neg_ninv_b; // (K, k)
  const int32_t* ninv_all;   // (K, 2k)
  const int32_t* m2_all;     // (K, 2k)
  const int32_t* m2_r;       // (K, 1)
};

// Tile geometry and the shared-memory layout of one block, in bytes:
// [E planes | sigma planes (2 ext x 2 planes x 8 slots x sstride) | alpha (8
// words) | window table (16 x R x tstride words), which first holds the digit
// halves (2*digits x 8 words) and the converted residues ((2k+1) x 8 words)].
struct Geo {
  int mt, ks, sstride, tstride;
  size_t e_bytes, sig_bytes, tab_bytes;

  __host__ __device__ Geo(int k, int digits, int rows) {
    mt = (k + 1 + 15) / 16;
    ks = (k + 31) / 32;
    sstride = ks * 32 + 16;   // conflict-free B-fragment reads across the 8 slots
    tstride = mt * 16 + 4;    // conflict-free table reads across slots 2t
    e_bytes = (size_t)4 * mt * ks * 512;
    sig_bytes = (size_t)4 * kSlots * sstride;
    const size_t tab = (size_t)16 * rows * tstride * 4;
    const size_t conv = ((size_t)2 * digits + 2 * k + 1) * kSlots * 4;
    tab_bytes = tab > conv ? tab : conv;
  }
  __host__ __device__ size_t bytes() const { return e_bytes + sig_bytes + 32 + tab_bytes; }
};

__device__ __forceinline__ uint32_t barrett(uint32_t x, uint32_t p, uint32_t mu) {
  const uint32_t r = x - __umulhi(x, mu) * p;
  return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t shoup(uint32_t a, uint32_t w, uint32_t w_sh, uint32_t p) {
  const uint32_t r = a * w - __umulhi(a, w_sh) * p;
  return r >= p ? r - p : r;
}

// w' = floor(w * 2^32 / p) for w < p (an inert channel has w = 0, p = 1).
__device__ __forceinline__ uint32_t shoup_const(uint32_t w, uint32_t p) {
  return (uint32_t)(((uint64_t)w << 32) / p);
}

__device__ __forceinline__ void mma_s8(uint32_t (&c)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// One number at this thread's 4 (channel h, slot c) pairs, p = 2h + c: its B
// and B' residues, and per slot its redundant residue (meaningful at the
// thread that holds channel j = k).
struct Num {
  uint32_t b[4], q[4], r[2];
};

template <int R>
struct Chain {
  PowConsts c;
  Geo geo;
  const uint4* sE;    // E planes in fragment order
  uint8_t* sig;       // (2 ext, 2 planes, 8 slots, sstride) int8 planes
  uint32_t* alpha;    // (8)
  uint32_t* tab;      // (16, R, tstride)
  int lane, warp, g, t;
  int j[2], slot[2];
  bool chan[2], red[2];
  uint32_t pb[2], pq[2], mub[2], muq[2];
  uint32_t invMi_b[2], invMi_b_sh[2], invMi_q[2], invMi_q_sh[2];
  uint32_t Mq_b[2], Mq_b_sh[2], invM_q[2], invM_q_sh[2];
  uint32_t nninv[4], nninv_sh[4], nq[4], nq_sh[4], nr[2];

  __device__ Chain(const PowConsts& cc, unsigned char* raw) : c(cc), geo(cc.k, cc.digits, R) {
    sE = reinterpret_cast<const uint4*>(raw);
    sig = raw + geo.e_bytes;
    alpha = reinterpret_cast<uint32_t*>(sig + geo.sig_bytes);
    tab = alpha + 8;
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    g = lane >> 2;
    t = lane & 3;
  }

  __device__ void init(const KeyRows& key, const int (&kid)[2]) {
    const int k = c.k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      j[h] = warp * 16 + g + 8 * h;
      chan[h] = j[h] < k;
      red[h] = j[h] == k;
      const int x = chan[h] ? j[h] : 0;
      pb[h] = chan[h] ? (uint32_t)c.p_all[x] : 1u;
      pq[h] = chan[h] ? (uint32_t)c.p_all[k + x] : 1u;
      mub[h] = chan[h] ? c.mu_all[x] : 0xFFFFFFFFu;
      muq[h] = chan[h] ? c.mu_all[k + x] : 0xFFFFFFFFu;
      invMi_b[h] = chan[h] ? (uint32_t)c.invMi_b[x] : 0u;
      invMi_b_sh[h] = chan[h] ? c.invMi_b_sh[x] : 0u;
      invMi_q[h] = chan[h] ? (uint32_t)c.invMi_q[x] : 0u;
      invMi_q_sh[h] = chan[h] ? c.invMi_q_sh[x] : 0u;
      Mq_b[h] = chan[h] ? (uint32_t)c.Mq_mod_b[x] : 0u;
      Mq_b_sh[h] = chan[h] ? c.Mq_mod_b_sh[x] : 0u;
      invM_q[h] = chan[h] ? (uint32_t)c.invM_q[x] : 0u;
      invM_q_sh[h] = chan[h] ? c.invM_q_sh[x] : 0u;
    }
#pragma unroll
    for (int cs = 0; cs < 2; ++cs) {
      slot[cs] = 2 * t + cs;
      nr[cs] = (uint32_t)key.n_r[kid[cs]];
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int h = p >> 1, cs = p & 1;
      const int x = chan[h] ? j[h] : 0;
      nninv[p] = chan[h] ? (uint32_t)key.neg_ninv_b[(size_t)kid[cs] * k + x] : 0u;
      nq[p] = chan[h] ? (uint32_t)key.n_all[(size_t)kid[cs] * 2 * k + k + x] : 0u;
      nninv_sh[p] = shoup_const(nninv[p], pb[h]);
      nq_sh[p] = shoup_const(nq[p], pq[h]);
    }
  }

  // Writes sigma of pair p as two int8 planes of extension e's input.
  __device__ __forceinline__ void put_sigma(int e, int p, uint32_t s) const {
    const int h = p >> 1, cs = p & 1;
    uint8_t* lo = sig + (size_t)(e * 2) * kSlots * geo.sstride;
    const size_t at = (size_t)slot[cs] * geo.sstride + j[h];
    lo[at] = (uint8_t)(s & 63u);
    lo[(size_t)kSlots * geo.sstride + at] = (uint8_t)(s >> 6);
  }

  // S[p] = Sigma_i sigma[slot][i] * E_e[i][j] for this thread's 4 pairs, exact.
  __device__ __forceinline__ void extend(int e, uint32_t (&S)[4]) const {
    uint32_t ll[4] = {0u, 0u, 0u, 0u}, ss[4] = {0u, 0u, 0u, 0u}, hh[4] = {0u, 0u, 0u, 0u};
    const uint8_t* slo = sig + (size_t)(e * 2) * kSlots * geo.sstride + g * geo.sstride + 4 * t;
    const uint8_t* shi = slo + (size_t)kSlots * geo.sstride;
    const uint4* alo = sE + ((size_t)(e * 2 + 0) * geo.mt + warp) * geo.ks * 32 + lane;
    const uint4* ahi = sE + ((size_t)(e * 2 + 1) * geo.mt + warp) * geo.ks * 32 + lane;
#pragma unroll 3
    for (int s = 0; s < geo.ks; ++s) {
      const uint32_t blo0 = *reinterpret_cast<const uint32_t*>(slo + s * 32);
      const uint32_t blo1 = *reinterpret_cast<const uint32_t*>(slo + s * 32 + 16);
      const uint32_t bhi0 = *reinterpret_cast<const uint32_t*>(shi + s * 32);
      const uint32_t bhi1 = *reinterpret_cast<const uint32_t*>(shi + s * 32 + 16);
      const uint4 al = alo[s * 32], ah = ahi[s * 32];
      // Every byte is < 64, so a 32-bit add is the bytewise sum (< 127: s8).
      const uint4 as = make_uint4(al.x + ah.x, al.y + ah.y, al.z + ah.z, al.w + ah.w);
      mma_s8(ll, al, blo0, blo1);
      mma_s8(hh, ah, bhi0, bhi1);
      mma_s8(ss, as, blo0 + bhi0, blo1 + bhi1);
    }
    // Karatsuba: lo*hi + hi*lo = (lo+hi)*(lo+hi) - lo*lo - hi*hi.
#pragma unroll
    for (int p = 0; p < 4; ++p) S[p] = ll[p] + ((ss[p] - ll[p] - hh[p]) << 6) + (hh[p] << 12);
  }

  // The redundant channel's sum for slot cs (from the pair at j = k, if any).
  __device__ __forceinline__ uint32_t red_of(const uint32_t (&S)[4], int cs) const {
    return red[1] ? S[2 + cs] : S[cs];
  }

  // o = a * b * M^-1 mod N in RNS (Bajard AMM + Shenoy).  Every input is read
  // before the first barrier, so o may alias a or b.
  __device__ __forceinline__ void mont(const Num& a, const Num& b, Num& o) const {
    uint32_t dq[4], dr[2], rq[4], rr[2], S[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int h = p >> 1;
      dq[p] = barrett(a.q[p] * b.q[p], pq[h], muq[h]);
      const uint32_t db = barrett(a.b[p] * b.b[p], pb[h], mub[h]);
      const uint32_t qb = shoup(db, nninv[p], nninv_sh[p], pb[h]);  // q = d * (-N^-1)
      put_sigma(0, p, shoup(qb, invMi_b[h], invMi_b_sh[h], pb[h]));
    }
#pragma unroll
    for (int cs = 0; cs < 2; ++cs) dr[cs] = (a.r[cs] * b.r[cs]) & kPrMask;
    __syncthreads();
    extend(0, S);  // q^ = Sigma sigma_i M_i over B' and 2^12
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int h = p >> 1;
      const uint32_t tq = shoup(barrett(S[p], pq[h], muq[h]), nq[p], nq_sh[p], pq[h]);
      uint32_t x = dq[p] + tq;
      x = x >= pq[h] ? x - pq[h] : x;
      rq[p] = shoup(x, invM_q[h], invM_q_sh[h], pq[h]);  // r = (d + q^ N) / M
      put_sigma(1, p, shoup(rq[p], invMi_q[h], invMi_q_sh[h], pq[h]));
    }
#pragma unroll
    for (int cs = 0; cs < 2; ++cs) {
      const uint32_t qr = red_of(S, cs) & kPrMask;
      rr[cs] = (((dr[cs] + qr * nr[cs]) & kPrMask) * c.invM_pr) & kPrMask;
    }
    __syncthreads();
    extend(1, S);  // exact return extension B' -> B and 2^12
    if (red[0] || red[1]) {
#pragma unroll
      for (int cs = 0; cs < 2; ++cs) {
        // ((ext_r - rr) mod 2^12) * (Mq^-1 mod 2^12): the uint32 difference
        // wraps modulo 2^32, a multiple of 2^12.
        alpha[slot[cs]] = (((red_of(S, cs) - rr[cs]) & kPrMask) * c.invMq_pr) & kPrMask;
      }
    }
    uint32_t eb[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) eb[p] = barrett(S[p], pb[p >> 1], mub[p >> 1]);
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int h = p >> 1;
      const uint32_t corr = shoup(alpha[slot[p & 1]], Mq_b[h], Mq_b_sh[h], pb[h]);
      o.b[p] = eb[p] >= corr ? eb[p] - corr : eb[p] + pb[h] - corr;
      o.q[p] = rq[p];
    }
#pragma unroll
    for (int cs = 0; cs < 2; ++cs) o.r[cs] = rr[cs];
  }

  // Table entry w of this thread's pair p (an address of position only).
  __device__ __forceinline__ uint32_t* entry(int w, int p) const {
    return tab + ((size_t)w * R + (slot[p & 1] % R)) * geo.tstride + j[p >> 1];
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

  // Digit halves of the 8 slots' rows -> residues of this thread's pairs.
  __device__ void to_residues(const uint8_t* h, int row0, int T, Num& x) const {
    const int k = c.k, nd = 2 * c.digits, nch = 2 * k + 1;
    uint32_t* halves = tab;                      // (nd, 8)
    uint32_t* res = tab + (size_t)nd * kSlots;   // (nch, 8)
    for (int i = threadIdx.x; i < nd * kSlots; i += blockDim.x) {
      const int s = i & (kSlots - 1), d = i >> 3;
      halves[i] = h[(size_t)min(row0 + s % R, T - 1) * nd + d];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nch * kSlots; i += blockDim.x) {
      const int s = i & (kSlots - 1), ch = i >> 3;
      uint32_t acc = 0u;
      for (int d = 0; d < nd; ++d) acc += halves[d * kSlots + s] * (uint32_t)c.D[(size_t)d * nch + ch];
      const int cp = min(ch, 2 * k - 1);  // ch = 2k is the redundant channel
      res[i] = ch == 2 * k ? (acc & kPrMask) : barrett(acc, (uint32_t)c.p_all[cp], c.mu_all[cp]);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int hh = p >> 1, s = slot[p & 1];
      x.b[p] = chan[hh] ? res[j[hh] * kSlots + s] : 0u;
      x.q[p] = chan[hh] ? res[(k + j[hh]) * kSlots + s] : 0u;
    }
#pragma unroll
    for (int cs = 0; cs < 2; ++cs) x.r[cs] = res[2 * k * kSlots + slot[cs]];
    __syncthreads();  // the table may overwrite halves and res now
  }
};

template <int R>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
rns_pow_kernel(const uint8_t* __restrict__ base_h, const uint8_t* __restrict__ nib_t,
               const int32_t* __restrict__ idx, int T, int n_keys, KeyRows key,
               PowConsts cc, int32_t* __restrict__ sigma_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Chain<R> ch(cc, smem_raw);
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

  // Stage E's planes; zero the sigma planes (their K padding is never written).
  {
    uint4* dst = reinterpret_cast<uint4*>(smem_raw);
    const size_t n = ch.geo.e_bytes / 16;
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = cc.E_mma[i];
    uint32_t* sg = reinterpret_cast<uint32_t*>(ch.sig);
    for (size_t i = threadIdx.x; i < ch.geo.sig_bytes / 4; i += blockDim.x) sg[i] = 0u;
  }

  Num x, m2, one, acc;
  ch.to_residues(base_h, row0, T, x);  // its barriers order the staging too
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int h = p >> 1, cs = p & 1;
    const size_t base = (size_t)kid[cs] * 2 * k;
    const int xj = ch.chan[h] ? ch.j[h] : 0;
    m2.b[p] = ch.chan[h] ? (uint32_t)key.m2_all[base + xj] : 0u;
    m2.q[p] = ch.chan[h] ? (uint32_t)key.m2_all[base + k + xj] : 0u;
    one.b[p] = 1u;
    one.q[p] = 1u;
  }
#pragma unroll
  for (int cs = 0; cs < 2; ++cs) {
    m2.r[cs] = (uint32_t)key.m2_r[kid[cs]];
    one.r[cs] = 1u;
  }
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
          (int32_t)shoup(acc.b[p], ch.invMi_b[h], ch.invMi_b_sh[h], ch.pb[h]);
    }
  }
}

// Rows per block.  At k = 188 (2048-bit moduli) 8 rows would need 254,496 B
// of shared memory, over the H100's opt-in 232,448 B; 4 rows need 204,320 B.
// time_k2_rows.py times other counts (-DRNS_POW_ROWS=R); PERF.md has why 4.
#ifndef RNS_POW_ROWS
#define RNS_POW_ROWS 4
#endif
constexpr int kPowRows = RNS_POW_ROWS;
static_assert(kPowRows >= 1 && kPowRows <= kSlots && (kSlots % kPowRows) == 0,
              "rows per block must divide the 8 mma row slots");
// Returned (instead of a cudaError_t) when the block's shared memory does not
// fit the device; the launcher has then written the need and the limit.
constexpr int kErrSharedMemory = -2;

}  // namespace

extern "C" {

// Returns a cudaError_t value (0 = launched), or kErrSharedMemory when the
// block's shared memory does not fit the card; writes the need and the
// device's opt-in limit per block to smem_need and smem_limit.
int rns_pow_launch(const uint8_t* base_h, const uint8_t* nib_t, const int32_t* idx, int T,
                   int n_keys, const int32_t* n_all, const int32_t* n_r, const int32_t* neg_ninv_b,
                   const int32_t* ninv_all, const int32_t* m2_all, const int32_t* m2_r,
                   const int32_t* p_all, const int32_t* invMi_b, const int32_t* invMi_q,
                   const int32_t* Mq_mod_b, const int32_t* invM_q,
                   const uint32_t* mu_all, const uint32_t* invMi_b_sh, const uint32_t* invMi_q_sh,
                   const uint32_t* Mq_mod_b_sh, const uint32_t* invM_q_sh,
                   const int8_t* E_mma, const uint16_t* D,
                   int invMq_pr, int invM_pr, int k, int digits,
                   int32_t* sigma_out, void* stream, int* smem_need, int* smem_limit) {
  // k <= 255 keeps every extension sum below 2^32 and the M tiles within
  // kMaxWarps warps.
  if (T <= 0 || n_keys <= 0 || k <= 0 || k > 255 || digits <= 0 || digits > 256)
    return (int)cudaErrorInvalidValue;
  const KeyRows key{n_all, n_r, neg_ninv_b, ninv_all, m2_all, m2_r};
  const PowConsts cc{p_all, mu_all, invMi_b, invMi_b_sh, invMi_q, invMi_q_sh,
                     Mq_mod_b, Mq_mod_b_sh, invM_q, invM_q_sh,
                     reinterpret_cast<const uint4*>(E_mma), D,
                     (uint32_t)invMq_pr, (uint32_t)invM_pr, k, digits};
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const Geo geo(k, digits, kPowRows);
  const size_t smem = geo.bytes();
  *smem_need = (int)smem;
  *smem_limit = optin;
  if (smem > (size_t)optin) return kErrSharedMemory;
  const auto kernel = rns_pow_kernel<kPowRows>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (T + kPowRows - 1) / kPowRows;
  kernel<<<grid, 32 * geo.mt, smem, (cudaStream_t)stream>>>(base_h, nib_t, idx, T, n_keys, key,
                                                            cc, sigma_out);
  return (int)cudaGetLastError();
}

// Registers and local-memory bytes (spills and stack) per thread of K2 as
// compiled, and its rows per block.  Returns a cudaError_t value.
int rns_pow_attrs(int* regs, int* local_bytes, int* rows_per_block) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, rns_pow_kernel<kPowRows>);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *rows_per_block = kPowRows;
  return 0;
}

}  // extern "C"
