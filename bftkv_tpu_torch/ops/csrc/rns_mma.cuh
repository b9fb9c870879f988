// The RNS Montgomery product on Hopper's int8 tensor cores, shared by K1
// (rns_chain.cu, the e=65537 verify chain), K2 (rns_pow.cu, the windowed
// modexp) and K5 (ec_p256.cu, the P-256 scalar mult, which runs its products
// in rounds of independent ones through mont_n).  Device code only; each
// kernel includes it.
//
// The kernels compute the reference's ops/rns.py::_mont_mul bit for bit:
// Bajard's approximate extension B -> B' and the 2^12 channel, then the
// exact return extension B' -> B with the Shenoy correction.  What bounds a
// product: integer multiply-adds, almost all of them in the two base
// extensions (Sigma_i sigma_i * E[i][j] over k channels), then the
// elementwise modular steps of each channel.  The design:
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
//   (mod 2^32) < 2p; one conditional subtraction each, as an unsigned
//   minimum.  The context's mu_p and w' come from the host
//   (ops/rns.py::_Consts.kern); the key's multipliers and their w' are
//   derived once per row at the start.  Fixed multipliers that follow each
//   other are folded into one: sigma over B is d * (-N^-1 (M/m_j)^-1) and
//   sigma over B' is (d + q^ N) * (M^-1 (M'/m_j)^-1), each one Shoup step.
// - The digit -> residue conversion runs one thread per output channel with
//   the 8 slots' sums in registers: each entry of D is read once per block,
//   and the slots' digit halves are broadcast from shared memory.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rns_mma {

constexpr uint32_t kPrMask = 4095u;  // the 2^12 redundant channel
constexpr int kSlots = 8;            // mma N: row slots per block
// Returned (instead of a cudaError_t) by a launcher when the block's shared
// memory does not fit the device; it has then written the need and the limit.
constexpr int kErrSharedMemory = -2;

struct RnsConsts {
  const int32_t* p_all;        // (2k): base B then base B'
  const uint32_t* mu_all;      // (2k): floor(2^32 / p)
  const int32_t* invMi_b;      // (k) and the Shoup w' of each fixed multiplier
  const uint32_t* invMi_b_sh;
  const int32_t* invMi_q;      // (k): folded with invM_q at init, no w' of its own
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
// words) | work area].  The work area first holds the digit halves (2*digits
// x 8 words) and the converted residues ((2k+1) x 8 words); after the
// conversions it is the kernel's own (`tail` bytes: K2's window table, K1's
// check words).
struct Geo {
  int mt, ks, sstride;
  size_t e_bytes, sig_bytes, work_bytes;

  __host__ __device__ static int tiles(int k) { return (k + 1 + 15) / 16; }

  __host__ __device__ Geo(int k, int digits, size_t tail) {
    mt = tiles(k);
    ks = (k + 31) / 32;
    sstride = ks * 32 + 16;   // conflict-free B-fragment reads across the 8 slots
    e_bytes = (size_t)4 * mt * ks * 512;
    sig_bytes = (size_t)4 * kSlots * sstride;
    const size_t conv = ((size_t)2 * digits + 2 * k + 1) * kSlots * 4;
    work_bytes = tail > conv ? tail : conv;
  }
  __host__ __device__ size_t bytes() const { return e_bytes + sig_bytes + 32 + work_bytes; }
};

// r mod p for r < 2p: r - p wraps above r exactly when r < p, so the
// unsigned minimum is the one conditional subtraction.
__device__ __forceinline__ uint32_t reduce(uint32_t r, uint32_t p) { return min(r, r - p); }

__device__ __forceinline__ uint32_t barrett(uint32_t x, uint32_t p, uint32_t mu) {
  return reduce(x - __umulhi(x, mu) * p, p);
}

__device__ __forceinline__ uint32_t shoup(uint32_t a, uint32_t w, uint32_t w_sh, uint32_t p) {
  return reduce(a * w - __umulhi(a, w_sh) * p, p);
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

struct Chain {
  RnsConsts c;
  Geo geo;
  const uint4* sE;    // E planes in fragment order
  uint8_t* sig;       // (2 ext, 2 planes, 8 slots, sstride) int8 planes
  uint32_t* alpha;    // (8)
  uint32_t* work;     // the work area
  int lane, warp, g, t;
  int j[2], slot[2];
  bool chan[2], red[2];
  uint32_t pb[2], pq[2], mub[2], muq[2];
  uint32_t invMi_b[2], invMi_b_sh[2], rsig[2], rsig_sh[2];
  uint32_t Mq_b[2], Mq_b_sh[2], invM_q[2], invM_q_sh[2];
  uint32_t qsig[4], qsig_sh[4], nq[4], nq_sh[4], nr[2];

  __device__ Chain(const RnsConsts& cc, unsigned char* raw, const Geo& gg) : c(cc), geo(gg) {
    sE = reinterpret_cast<const uint4*>(raw);
    sig = raw + geo.e_bytes;
    alpha = reinterpret_cast<uint32_t*>(sig + geo.sig_bytes);
    work = alpha + 8;
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    g = lane >> 2;
    t = lane & 3;
  }

  // The pairs' channel constants, and the key constants of the rows kid[cs]
  // of this thread's two slots.
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
      Mq_b[h] = chan[h] ? (uint32_t)c.Mq_mod_b[x] : 0u;
      Mq_b_sh[h] = chan[h] ? c.Mq_mod_b_sh[x] : 0u;
      invM_q[h] = chan[h] ? (uint32_t)c.invM_q[x] : 0u;
      invM_q_sh[h] = chan[h] ? c.invM_q_sh[x] : 0u;
      // sigma over B' straight from (d + q^ N): M^-1 (M'/m_j)^-1 mod p_j.
      const uint32_t invMi_q = chan[h] ? (uint32_t)c.invMi_q[x] : 0u;
      rsig[h] = barrett(invM_q[h] * invMi_q, pq[h], muq[h]);
      rsig_sh[h] = shoup_const(rsig[h], pq[h]);
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
      // sigma over B straight from d: -N^-1 (M/m_j)^-1 mod p_j.
      const uint32_t nninv = chan[h] ? (uint32_t)key.neg_ninv_b[(size_t)kid[cs] * k + x] : 0u;
      qsig[p] = barrett(nninv * invMi_b[h], pb[h], mub[h]);
      nq[p] = chan[h] ? (uint32_t)key.n_all[(size_t)kid[cs] * 2 * k + k + x] : 0u;
      qsig_sh[p] = shoup_const(qsig[p], pb[h]);
      nq_sh[p] = shoup_const(nq[p], pq[h]);
    }
  }

  // Stages E's planes, 8 loads in flight per thread, and zeroes the sigma
  // planes (their K padding is never written); the conversion's first
  // barrier orders these stores.
  __device__ void stage(unsigned char* raw) const {
    uint4* dst = reinterpret_cast<uint4*>(raw);
    const int n = (int)(geo.e_bytes / 16), step = blockDim.x;
    int i = threadIdx.x;
    for (; i + 7 * step < n; i += 8 * step) {
      uint4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = c.E_mma[i + u * step];
#pragma unroll
      for (int u = 0; u < 8; ++u) dst[i + u * step] = v[u];
    }
    for (; i < n; i += step) dst[i] = c.E_mma[i];
    uint32_t* sg = reinterpret_cast<uint32_t*>(sig);
    for (size_t i = threadIdx.x; i < geo.sig_bytes / 4; i += blockDim.x) sg[i] = 0u;
  }

  // A per-key number (all: (K, 2k) B then B' residues, r: (K, 1) its 2^12
  // residue) at this thread's pairs.
  __device__ void key_num(const int32_t* all, const int32_t* r, const int (&kid)[2], Num& x) const {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int h = p >> 1, cs = p & 1;
      const size_t base = (size_t)kid[cs] * 2 * c.k;
      const int xj = chan[h] ? j[h] : 0;
      x.b[p] = chan[h] ? (uint32_t)all[base + xj] : 0u;
      x.q[p] = chan[h] ? (uint32_t)all[base + c.k + xj] : 0u;
    }
#pragma unroll
    for (int cs = 0; cs < 2; ++cs) x.r[cs] = (uint32_t)r[kid[cs]];
  }

  __device__ static void set_one(Num& x) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      x.b[p] = 1u;
      x.q[p] = 1u;
    }
    x.r[0] = x.r[1] = 1u;
  }

  // Writes sigma of pair p as two int8 planes of extension e's input into
  // the sigma buffer sg (2 ext x 2 planes x 8 slots x sstride bytes).
  __device__ __forceinline__ void put_sigma(uint8_t* sg, int e, int p, uint32_t s) const {
    const int h = p >> 1, cs = p & 1;
    uint8_t* lo = sg + (size_t)(e * 2) * kSlots * geo.sstride;
    const size_t at = (size_t)slot[cs] * geo.sstride + j[h];
    lo[at] = (uint8_t)(s & 63u);
    lo[(size_t)kSlots * geo.sstride + at] = (uint8_t)(s >> 6);
  }

  // S[p] = Sigma_i sigma[slot][i] * E_e[i][j] for this thread's 4 pairs, exact,
  // with sigma from buffer sg.
  __device__ __forceinline__ void extend(const uint8_t* sg, int e, uint32_t (&S)[4]) const {
    uint32_t ll[4] = {0u, 0u, 0u, 0u}, ss[4] = {0u, 0u, 0u, 0u}, hh[4] = {0u, 0u, 0u, 0u};
    const uint8_t* slo = sg + (size_t)(e * 2) * kSlots * geo.sstride + g * geo.sstride + 4 * t;
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

  // o[i] = a[i] * b[i] * M^-1 mod N in RNS (Bajard AMM + Shenoy) for NP
  // independent products at once: their steps interleave, so a thread has
  // NP times the independent work between the three barriers they share.
  // Product i exchanges sigma through buffer i of sigs (NP x geo.sig_bytes)
  // and alpha through alphas[8 i .. 8 i + 7].  Every input is read before
  // the first barrier, so o[i] may alias an input.
  template <int NP>
  __device__ __forceinline__ void mont_n(const Num (&a)[NP], const Num (&b)[NP], Num (&o)[NP],
                                         uint8_t* sigs, uint32_t* alphas) const {
    uint32_t dq[NP][4], dr[NP][2], rq[NP][4], rr[NP][2], eb[NP][4];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      uint8_t* sg = sigs + (size_t)i * geo.sig_bytes;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int h = p >> 1;
        dq[i][p] = barrett(a[i].q[p] * b[i].q[p], pq[h], muq[h]);
        // sigma_j = q_j (M/m_j)^-1 with q = d (-N^-1): one step from d.
        const uint32_t db = barrett(a[i].b[p] * b[i].b[p], pb[h], mub[h]);
        put_sigma(sg, 0, p, shoup(db, qsig[p], qsig_sh[p], pb[h]));
      }
#pragma unroll
      for (int cs = 0; cs < 2; ++cs) dr[i][cs] = (a[i].r[cs] * b[i].r[cs]) & kPrMask;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      uint8_t* sg = sigs + (size_t)i * geo.sig_bytes;
      uint32_t S[4];
      extend(sg, 0, S);  // q^ = Sigma sigma_i M_i over B' and 2^12
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int h = p >> 1;
        const uint32_t tq = shoup(barrett(S[p], pq[h], muq[h]), nq[p], nq_sh[p], pq[h]);
        const uint32_t x = reduce(dq[i][p] + tq, pq[h]);  // r = (d + q^ N) / M
        rq[i][p] = shoup(x, invM_q[h], invM_q_sh[h], pq[h]);
        put_sigma(sg, 1, p, shoup(x, rsig[h], rsig_sh[h], pq[h]));  // r (M'/m_j)^-1
      }
#pragma unroll
      for (int cs = 0; cs < 2; ++cs) {
        const uint32_t qr = red_of(S, cs) & kPrMask;
        rr[i][cs] = (((dr[i][cs] + qr * nr[cs]) & kPrMask) * c.invM_pr) & kPrMask;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      uint32_t S[4];
      extend(sigs + (size_t)i * geo.sig_bytes, 1, S);  // exact return extension B' -> B and 2^12
      if (red[0] || red[1]) {
#pragma unroll
        for (int cs = 0; cs < 2; ++cs) {
          // ((ext_r - rr) mod 2^12) * (Mq^-1 mod 2^12): the uint32 difference
          // wraps modulo 2^32, a multiple of 2^12.
          alphas[8 * i + slot[cs]] = (((red_of(S, cs) - rr[i][cs]) & kPrMask) * c.invMq_pr) & kPrMask;
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) eb[i][p] = barrett(S[p], pb[p >> 1], mub[p >> 1]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NP; ++i) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int h = p >> 1;
        const uint32_t corr = shoup(alphas[8 * i + slot[p & 1]], Mq_b[h], Mq_b_sh[h], pb[h]);
        o[i].b[p] = reduce(eb[i][p] + pb[h] - corr, pb[h]);
        o[i].q[p] = rq[i][p];
      }
#pragma unroll
      for (int cs = 0; cs < 2; ++cs) o[i].r[cs] = rr[i][cs];
    }
  }

  // o = a * b * M^-1 mod N (one product, through the block's own buffers).
  // Every input is read before the first barrier, so o may alias a or b.
  __device__ __forceinline__ void mont(const Num& a, const Num& b, Num& o) const {
    using One = Num[1];
    mont_n<1>(reinterpret_cast<const One&>(a), reinterpret_cast<const One&>(b),
              reinterpret_cast<One&>(o), sig, alpha);
  }

  // Digit halves of the 8 slots' rows (slot s runs row row0 + s % R, clamped
  // to the batch) -> residues of this thread's pairs, through the work area.
  // U loads of D are in flight per thread (D is read from L2).
  template <int R, int U>
  __device__ void to_residues(const uint8_t* h, int row0, int T, Num& x) const {
    const int k = c.k, nd = 2 * c.digits, nch = 2 * k + 1;
    uint32_t* halves = work;                      // (nd, 8)
    uint32_t* res = work + (size_t)nd * kSlots;   // (nch, 8)
    for (int i = threadIdx.x; i < nd * kSlots; i += blockDim.x) {
      const int s = i & (kSlots - 1), d = i >> 3;
      halves[i] = h[(size_t)min(row0 + s % R, T - 1) * nd + d];
    }
    __syncthreads();
    const uint4* hv = reinterpret_cast<const uint4*>(halves);
    for (int ch = threadIdx.x; ch < nch; ch += blockDim.x) {
      // Sums < 2*digits * 255 * 4095 < 2^32 for digits <= 256.
      uint32_t acc[kSlots] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      const uint16_t* dcol = c.D + ch;
#pragma unroll (U)
      for (int d = 0; d < nd; ++d) {
        const uint32_t w = dcol[(size_t)d * nch];
        const uint4 lo = hv[2 * d], hi = hv[2 * d + 1];  // broadcast reads
        acc[0] += lo.x * w;
        acc[1] += lo.y * w;
        acc[2] += lo.z * w;
        acc[3] += lo.w * w;
        acc[4] += hi.x * w;
        acc[5] += hi.y * w;
        acc[6] += hi.z * w;
        acc[7] += hi.w * w;
      }
      const bool rc = ch == 2 * k;  // the redundant channel
      const uint32_t p = rc ? 1u : (uint32_t)c.p_all[rc ? 0 : ch];
      const uint32_t mu = rc ? 0u : c.mu_all[rc ? 0 : ch];
      uint32_t v[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) v[s] = rc ? (acc[s] & kPrMask) : barrett(acc[s], p, mu);
      uint4* out = reinterpret_cast<uint4*>(res + (size_t)ch * kSlots);
      out[0] = make_uint4(v[0], v[1], v[2], v[3]);
      out[1] = make_uint4(v[4], v[5], v[6], v[7]);
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
    __syncthreads();  // the work area is free again
  }
};

// Launches kernel<<<grid, 32 * geo.mt, geo.bytes(), stream>>>(args...) after
// checking its dynamic shared memory against the device's opt-in limit per
// block, which it writes with the need to smem_need and smem_limit.  The
// events before and after, where not null, are recorded on the stream just
// before and just after the kernel, so that their interval is the kernel's
// own.  Returns a cudaError_t value (0 = launched) or kErrSharedMemory.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), const Geo& geo, int grid, cudaStream_t stream,
           int* smem_need, int* smem_limit, cudaEvent_t before, cudaEvent_t after,
           Args... args) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = geo.bytes();
  *smem_need = (int)smem;
  *smem_limit = optin;
  if (smem > (size_t)optin) return kErrSharedMemory;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (before != nullptr && (err = cudaEventRecord(before, stream)) != cudaSuccess) return (int)err;
  kernel<<<grid, 32 * geo.mt, smem, stream>>>(args...);
  err = cudaGetLastError();
  if (err == cudaSuccess && after != nullptr) err = cudaEventRecord(after, stream);
  return (int)err;
}

// Registers and local-memory bytes (spills and stack) per thread of a kernel
// as compiled.  Returns a cudaError_t value.
template <typename... Params>
int attrs(void (*kernel)(Params...), int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // namespace rns_mma
