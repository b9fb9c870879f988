// K5 for Hopper (sm_90a): P-256 scalar multiplication on the RNS field core,
// eight points a group, the base extensions on the int8 tensor cores.
//
// ec_scalar_mult_kernel replaces the reference's jitted XLA program
// bftkv_tpu/ops/ec_rns.py::_scalar_mult_fn (ec_rns.py:437, no Pallas form) and
// computes the port's plain version bftkv_tpu_torch/ops/ec_rns.py::_scalar_mult
// bit for bit: per point, the window table t[j] = j*P (14 unified adds), then 64
// windows, most significant first, of 4 doublings, a one-hot blend select of the
// window's entry and one unified add; out come the Jacobian Montgomery residues
// (X, Y, Z) of k*P.  Field elements are residues over P-256's RNS context (k = 27
// primes per base B and B', and the 2^12 redundant channel); a field multiply is
// rns_mma.cuh's RNS Montgomery product (Bajard AMM, Shenoy return extension, the
// one K1 and K2 run) with P-256's prime as every slot's key; adds and subtracts
// are channelwise with the reference's slacks (a subtraction adds 32p, 2^14 p or
// 2^16 p), and is_zero is the alpha-consistency test.  The arithmetic below is
// modelled step for step, in this layout, in tests/test_torch_ec_arith.py.
//
// What bounds it on this card.  One scalar mult is 3,920 RNS Montgomery products
// (14 table adds of 24 products, with the doubling each add evaluates, and 64
// windows of 4 x 8 + 24), each two base extensions of k(k+1) residue
// multiply-adds: about 0.15 ms at T = 8192 on the int8 tensor cores.  Every
// point's sigma meets the same 27 x 28 matrix, so a group's extension is one
// matrix product, E^T (28 x 27) x sigma (27 x 8 points), and runs as
// rns_mma.cuh's Karatsuba plane products (6 mma.sync.m16n8k32 per extension and
// group).  What is left on the CUDA cores is elementwise: 10 Barrett and Shoup
// steps per product and (channel, point), and the field's adds.  A group's
// products form one dependent chain, and at the main path's sizes a scheduler
// holds one or two warps, so the chain's latency sets the pace: the group law
// runs as rounds of up to 3 independent products (rns_mma's mont_n), whose
// steps interleave and which share their three barriers.
//
// Design: one group of 8 points per block of 2 warps (rns_mma's Chain at k = 27:
// one warp per 16-channel M tile, the 8 points as the mma's N).
// - A thread holds 4 (channel, slot) pairs, channels j = 16 warp + g + 8h of both
//   bases and slots 2t, 2t+1, and per slot its 2^12 residue.  The 2^12 channel is
//   output j = k of both extensions (tile 1, g = 3, h = 1); channels past it are
//   inert (p = 1, constants 0), as in K1 and K2.
// - The doubling is 4 rounds (3, 3, 1, 1 products), the add 6 (3, 3, 3, 3, 2,
//   2).  The products are the plain version's, operand for operand; only their
//   order differs.  Each product of a round has its own sigma buffer and alpha
//   words.
// - is_zero is per slot: w_j = v_j * p^-1 mod p_j over B, reduced to the slot's
//   (min, max) by 3 xor shuffles within the warp (two slots as uint16 halves)
//   and across both warps through shared memory; zero iff min == max <= 64.
//   The four tests of one unified add share one reduction and one barrier.
// - Every select of the group law is arithmetic on per-slot masks: no branch
//   depends on a point's value or on its scalar.  Every branch below is on the
//   schedule (the step counter) or on the thread's position.
// - The window table is uint16 in shared memory (16 entries x 3 coordinates x
//   55 rows: B at row j <= k, the 2^12 residue at row k, B' at row k + 1 + j;
//   4 words a row for the slot pairs 2t, 2t+1), 41 KB a group.  Each thread
//   reads back only the words it wrote, at addresses fixed by entry,
//   coordinate, channel and slot; the select reads all 16 entries and blends
//   with a mask made from the nibble.
// - One code copy of the doubling and of the add: the table's 14 adds and the
//   64 windows run as one loop of 334 steps, each a doubling of the accumulator
//   and, on add steps, the add's other cases (the sum of A and B, or B, A, O),
//   then a per-slot select of the doubling where A = B.
//
// Layout: res and out are (3, 2 kK + 1, T) int32, X/Y/Z on the first axis, the
// B, B' and 2^12 rows on the second, points on the last (the reference's
// channel-major block); nib is (64, T) uint8; field is (kFieldRows, 2 kK + 1)
// int32 over [B | B' | 2^12] (ops/ec_rns.py::FIELD_ROWS, in the order of enum
// FieldRow).  Every point below T is written, and nothing at or past it; slots
// past T compute on a copy of point T - 1.

#include <cstdint>
#include <cuda_runtime.h>

#include "rns_mma.cuh"

namespace {

using rns_mma::Chain;
using rns_mma::Geo;
using rns_mma::KeyRows;
using rns_mma::Num;
using rns_mma::RnsConsts;
using rns_mma::barrett;
using rns_mma::kPrMask;
using rns_mma::kSlots;
using rns_mma::reduce;

constexpr int kK = 27;             // channels per base: rns.context(16, 256)
constexpr int kChan = 2 * kK + 1;  // rows of one coordinate in res and out
constexpr int kNwin = 64;          // 4-bit windows of a 256-bit scalar
constexpr int kEntries = 16;       // window table entries
constexpr int kTableAdds = kEntries - 2;
constexpr int kSteps = kTableAdds + kNwin * 5;  // 4 doublings and an add a window
constexpr int kCoords = 3;
constexpr int kQRow = kK + 1;      // table row of channel j of B' (of B: row j)
constexpr int kRows = kQRow + kK;  // table rows of one coordinate
constexpr int kFieldCols = 68;     // B at j, B' at 32 + j, the 2^12 channel at 64
constexpr int kFieldQ = 32;
constexpr int kRCol = 64;
constexpr int kMaxProducts = 3;    // independent products in one round of mont_n
constexpr uint32_t kZeroAlphaMax = 64;  // is_zero is exact below 2 * S_SMALL

// Rows of the field table.
enum FieldRow : int { kPinvB, kOne, kSpSmall, kSpL1, kSpL2, kFieldRows };

// Slack index of Field::sub.
enum Slack : int { kSmall, kL1, kL2 };

// Work area of the block: the window table (uint32 words holding the slot pairs
// 2t, 2t+1 as uint16 halves), is_zero's (min, max) words per warp, value and
// t, the field table, and the sigma buffers and alpha words of kMaxProducts
// products.
constexpr size_t kTabWords = (size_t)kEntries * kCoords * kRows * 4;
constexpr size_t kZeroWords = 2 * 4 * 4 * 2;
constexpr size_t kFieldWords = (size_t)kFieldRows * kFieldCols;
constexpr size_t kAlphaWords = (size_t)kMaxProducts * kSlots;

__host__ __device__ inline size_t ec_sig_bytes() { return Geo(kK, 0, 0).sig_bytes; }

__host__ __device__ inline Geo ec_geo() {
  return Geo(kK, 0,
             (kTabWords + kZeroWords + kFieldWords + kAlphaWords) * 4 +
                 kMaxProducts * ec_sig_bytes());
}

struct Pt {
  Num x, y, z;
};

// (a & m) | (b & ~m): one LOP3, no branch.
__device__ __forceinline__ uint32_t pick(uint32_t m, uint32_t a, uint32_t b) {
  return (a & m) | (b & ~m);
}

__device__ __forceinline__ Num pick(const uint32_t (&m)[2], const Num& a, const Num& b) {
  Num o;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    o.b[p] = pick(m[p & 1], a.b[p], b.b[p]);
    o.q[p] = pick(m[p & 1], a.q[p], b.q[p]);
  }
#pragma unroll
  for (int cs = 0; cs < 2; ++cs) o.r[cs] = pick(m[cs], a.r[cs], b.r[cs]);
  return o;
}

__device__ __forceinline__ Pt pick(const uint32_t (&m)[2], const Pt& a, const Pt& b) {
  return {pick(m, a.x, b.x), pick(m, a.y, b.y), pick(m, a.z, b.z)};
}

// The field on one thread's pairs: rns_mma's product, and the channelwise ops.
struct Field : Chain {
  uint32_t* tab;       // the window table
  uint32_t* zs;        // is_zero's words
  const uint32_t* sf;  // (kFieldRows, kFieldCols)
  uint32_t* alphas;    // (kMaxProducts, 8)
  uint8_t* sigs;       // kMaxProducts sigma buffers

  __device__ Field(const RnsConsts& cc, unsigned char* raw) : Chain(cc, raw, ec_geo()) {
    tab = work;
    zs = work + kTabWords;
    sf = zs + kZeroWords;
    alphas = zs + kZeroWords + kFieldWords;
    sigs = reinterpret_cast<uint8_t*>(alphas + kAlphaWords);
  }

  // Stages E's planes and the field table, and zeroes the sigma planes.
  __device__ void stage_field(unsigned char* raw, const int32_t* __restrict__ field) const {
    stage(raw);
    uint32_t* sg = reinterpret_cast<uint32_t*>(sigs);
    for (int i = threadIdx.x; i < (int)(kMaxProducts * ec_sig_bytes() / 4); i += blockDim.x)
      sg[i] = 0u;
    uint32_t* dst = zs + kZeroWords;
    for (int i = threadIdx.x; i < (int)kFieldWords; i += blockDim.x) {
      const int row = i / kFieldCols, col = i % kFieldCols;
      const int32_t* f = field + row * kChan;
      uint32_t v = 0u;
      if (col < kFieldQ) v = col < kK ? (uint32_t)f[col] : 0u;
      else if (col < kRCol) v = col - kFieldQ < kK ? (uint32_t)f[kK + col - kFieldQ] : 0u;
      else if (col == kRCol) v = (uint32_t)f[2 * kK];
      dst[i] = v;
    }
    __syncthreads();
  }

  __device__ __forceinline__ uint32_t fb(int row, int h) const { return sf[row * kFieldCols + j[h]]; }
  __device__ __forceinline__ uint32_t fq(int row, int h) const {
    return sf[row * kFieldCols + kFieldQ + j[h]];
  }
  __device__ __forceinline__ uint32_t fr(int row) const { return sf[row * kFieldCols + kRCol]; }

  // Products of one round: o[i] = a[i] * b[i], independent, interleaved.
  template <int NP>
  __device__ __forceinline__ void mul_n(const Num (&a)[NP], const Num (&b)[NP], Num (&o)[NP]) const {
    static_assert(NP <= kMaxProducts, "one round holds at most kMaxProducts products");
    mont_n<NP>(a, b, o, sigs, alphas);
  }

  __device__ __forceinline__ Num mul(const Num& a, const Num& b) const {
    using One = Num[1];
    Num o;
    mul_n<1>(reinterpret_cast<const One&>(a), reinterpret_cast<const One&>(b),
             reinterpret_cast<One&>(o));
    return o;
  }

  __device__ __forceinline__ Num add(const Num& a, const Num& b) const {
    Num o;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int h = p >> 1;
      o.b[p] = reduce(a.b[p] + b.b[p], pb[h]);
      o.q[p] = reduce(a.q[p] + b.q[p], pq[h]);
    }
#pragma unroll
    for (int cs = 0; cs < 2; ++cs) o.r[cs] = (a.r[cs] + b.r[cs]) & kPrMask;
    return o;
  }

  __device__ __forceinline__ Num dbl(const Num& a) const { return add(a, a); }

  // a - b + S*p (the slack keeps the value positive; S*p = 0 mod p).
  __device__ __forceinline__ Num sub(const Num& a, const Num& b, int s) const {
    Num o;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int h = p >> 1;
      const uint32_t x = reduce(a.b[p] + pb[h] - b.b[p], pb[h]) + fb(kSpSmall + s, h);
      const uint32_t y = reduce(a.q[p] + pq[h] - b.q[p], pq[h]) + fq(kSpSmall + s, h);
      o.b[p] = reduce(x, pb[h]);
      o.q[p] = reduce(y, pq[h]);
    }
    const uint32_t sr = fr(kSpSmall + s);
#pragma unroll
    for (int cs = 0; cs < 2; ++cs) o.r[cs] = (a.r[cs] - b.r[cs] + sr) & kPrMask;
    return o;
  }

  // This warp's (min, max) of w_j = v_j p^-1 mod p_j over its channels of B,
  // per slot as uint16 halves (slot 2t low, 2t+1 high), written by lanes g = 0.
  __device__ __forceinline__ void zero_words(const Num& v, int i) const {
    uint32_t lo = 0xFFFFFFFFu, hi = 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t pinv = fb(kPinvB, h);
      const uint32_t w = barrett(v.b[2 * h] * pinv, pb[h], mub[h]) |
                         (barrett(v.b[2 * h + 1] * pinv, pb[h], mub[h]) << 16);
      lo = chan[h] ? __vminu2(lo, w) : lo;
      hi = chan[h] ? __vmaxu2(hi, w) : hi;
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      lo = __vminu2(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, off));
      hi = __vmaxu2(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, off));
    }
    if (g == 0) {
      zs[((warp * 4 + i) * 4 + t) * 2] = lo;
      zs[((warp * 4 + i) * 4 + t) * 2 + 1] = hi;
    }
  }

  // Per-slot masks of v_i = 0 mod p, exact for v_i < (min prime) * p: the
  // w_j agree over B (min == max) and alpha = w_0 <= 64.
  __device__ __forceinline__ void is_zero4(const Num& v0, const Num& v1, const Num& v2,
                                           const Num& v3, uint32_t (&z)[4][2]) const {
    zero_words(v0, 0);
    zero_words(v1, 1);
    zero_words(v2, 2);
    zero_words(v3, 3);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t* w0 = zs + ((0 * 4 + i) * 4 + t) * 2;
      const uint32_t* w1 = zs + ((1 * 4 + i) * 4 + t) * 2;
      const uint32_t lo = __vminu2(w0[0], w1[0]), hi = __vmaxu2(w0[1], w1[1]);
#pragma unroll
      for (int cs = 0; cs < 2; ++cs) {
        const uint32_t l = (lo >> (16 * cs)) & 0xFFFFu, m = (hi >> (16 * cs)) & 0xFFFFu;
        z[i][cs] = 0u - (uint32_t)(l == m && m <= kZeroAlphaMax);
      }
    }
  }

  // dbl-2001-b for a = -3, with Z3 = 2 Y1 Z1 (keeps the identity's Z exactly 0),
  // in 4 rounds of independent products (3, 3, 1, 1).
  __device__ __forceinline__ Pt jac_double(const Pt& P) const {
    Num o[3];
    {
      const Num a[3] = {P.z, P.y, P.y}, b[3] = {P.z, P.y, P.z};
      mul_n<3>(a, b, o);
    }
    const Num delta = o[0], gamma = o[1], Z3 = dbl(o[2]);
    const Num t0 = sub(P.x, delta, kL1);
    const Num t1 = add(P.x, delta);
    {
      const Num a[3] = {P.x, t0, gamma}, b[3] = {gamma, add(dbl(t1), t1), gamma};
      mul_n<3>(a, b, o);
    }
    const Num beta4 = dbl(dbl(o[0]));  // 4 beta, beta = X gamma
    const Num alpha = o[1], g2 = o[2];
    const Num X3 = sub(mul(alpha, alpha), dbl(beta4), kL1);
    const Num Y3 = sub(mul(alpha, sub(beta4, X3, kL2)), dbl(dbl(dbl(g2))), kL1);
    return {X3, Y3, Z3};
  }

  // The unified add (add-2007-bl shape) but for its doubling case: W = B where
  // A is the identity, A where B is, O (Z = 0) where A = -B, else A + B; and
  // the mask of the slots where A = B, whose sum is jac_double(A).  16
  // products in 6 rounds (3, 3, 3, 3, 2, 2).
  __device__ __forceinline__ void add_part(const Pt& A, const Pt& B, Pt& W,
                                           uint32_t (&is_dbl)[2]) const {
    Num o[3];
    {
      const Num a[3] = {A.z, B.z, A.y}, b[3] = {A.z, B.z, B.z};
      mul_n<3>(a, b, o);
    }
    const Num Z1Z1 = o[0], Z2Z2 = o[1], Y1Z2 = o[2];
    {
      const Num a[3] = {B.y, A.x, B.x}, b[3] = {A.z, Z2Z2, Z1Z1};
      mul_n<3>(a, b, o);
    }
    const Num Y2Z1 = o[0], U1 = o[1], U2 = o[2];
    {
      const Num a[3] = {Y1Z2, Y2Z1, A.z}, b[3] = {Z2Z2, Z1Z1, B.z};
      mul_n<3>(a, b, o);
    }
    const Num S1 = o[0], Z1Z2 = o[2];
    const Num H = sub(U2, U1, kSmall);
    const Num R = sub(o[1], S1, kSmall);  // S2 - S1
    uint32_t z[4][2];
    is_zero4(A.z, B.z, H, R, z);
    {
      const Num a[3] = {H, R, Z1Z2}, b[3] = {H, R, H};
      mul_n<3>(a, b, o);
    }
    const Num H2 = o[0], RR = o[1], Z3 = o[2];
    Num p[2];
    {
      const Num a[2] = {H2, U1}, b[2] = {H, H2};
      mul_n<2>(a, b, p);
    }
    const Num H3 = p[0], U1H2 = p[1];
    const Num X3 = sub(sub(RR, H3, kL1), dbl(U1H2), kL1);
    {
      const Num a[2] = {S1, R}, b[2] = {H3, sub(U1H2, X3, kL2)};
      mul_n<2>(a, b, p);
    }
    const Num Y3 = sub(p[1], p[0], kL1);  // R (U1H2 - X3) - S1 H3
    uint32_t to_inf[2], inf1[2], inf2[2];
#pragma unroll
    for (int cs = 0; cs < 2; ++cs) {
      inf1[cs] = z[0][cs];
      inf2[cs] = z[1][cs];
      const uint32_t same_x = z[2][cs] & ~z[0][cs] & ~z[1][cs];
      is_dbl[cs] = same_x & z[3][cs];
      to_inf[cs] = same_x & ~z[3][cs];  // P + (-P) = O
    }
    const Num zero{};
    W = pick(inf1, B, pick(inf2, A, Pt{X3, Y3, pick(to_inf, zero, Z3)}));
  }

  // Table word of entry e, coordinate c, row (an address of position only).
  __device__ __forceinline__ uint32_t* word(int e, int c, int row) const {
    return tab + ((size_t)(e * kCoords + c) * kRows + row) * 4 + t;
  }

  // Rows j <= k of B (the 2^12 residue at row k) and j < k of B' are stored;
  // a thread stores and reads only its own words, and the inert positions
  // (chosen by position, never by value) none.
  __device__ __forceinline__ void put_num(int e, int c, const Num& v) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (red[h]) *word(e, c, j[h]) = v.r[0] | (v.r[1] << 16);
      if (chan[h]) {
        *word(e, c, j[h]) = v.b[2 * h] | (v.b[2 * h + 1] << 16);
        *word(e, c, kQRow + j[h]) = v.q[2 * h] | (v.q[2 * h + 1] << 16);
      }
    }
  }

  __device__ __forceinline__ void put(int e, const Pt& P) const {
    put_num(e, 0, P.x);
    put_num(e, 1, P.y);
    put_num(e, 2, P.z);
  }

  // Constant-time select of coordinate c of entry nib[cs] per slot: every
  // entry is read, at addresses fixed by entry and position; the nibble only
  // forms the mask.
  __device__ __forceinline__ Num select_num(const uint32_t (&nib)[2], int c) const {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll 4
    for (int e = 0; e < kEntries; ++e) {
      const uint32_t m = ((0u - (uint32_t)(nib[0] == (uint32_t)e)) & 0xFFFFu) |
                         ((0u - (uint32_t)(nib[1] == (uint32_t)e)) & 0xFFFF0000u);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (chan[h] || red[h]) v[h] |= m & *word(e, c, j[h]);
        if (chan[h]) v[2 + h] |= m & *word(e, c, kQRow + j[h]);
      }
    }
    Num o;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int h = p >> 1, sh = 16 * (p & 1);
      o.b[p] = red[h] ? 0u : (v[h] >> sh) & 0xFFFFu;
      o.q[p] = (v[2 + h] >> sh) & 0xFFFFu;
    }
    const uint32_t rw = red[1] ? v[1] : v[0];
    o.r[0] = rw & 0xFFFFu;
    o.r[1] = rw >> 16;
    return o;
  }

  __device__ __forceinline__ Pt select(const uint32_t (&nib)[2]) const {
    return {select_num(nib, 0), select_num(nib, 1), select_num(nib, 2)};
  }

  // The identity: X = Y = the Montgomery one, Z = 0.
  __device__ __forceinline__ Pt identity() const {
    Num one;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      one.b[p] = fb(kOne, p >> 1);
      one.q[p] = fq(kOne, p >> 1);
    }
    one.r[0] = one.r[1] = fr(kOne);
    return {one, one, Num{}};
  }
};

__global__ void __launch_bounds__(64)
ec_scalar_mult_kernel(const int32_t* __restrict__ res, const uint8_t* __restrict__ nib, int T,
                      KeyRows key, RnsConsts cc, const int32_t* __restrict__ field,
                      int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Field F(cc, smem_raw);
  const int kid[2] = {0, 0};  // every slot's key is P-256's prime
  F.init(key, kid);
  F.stage_field(smem_raw, field);

  const int pt0 = blockIdx.x * kSlots;
  int col[2];
#pragma unroll
  for (int cs = 0; cs < 2; ++cs) col[cs] = min(pt0 + F.slot[cs], T - 1);
  const size_t plane = (size_t)T;

  auto load = [&](int c) -> Num {
    Num v;
    const int32_t* base = res + (size_t)c * kChan * plane;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int h = p >> 1, x = F.chan[h] ? F.j[h] : 0;
      v.b[p] = F.chan[h] ? (uint32_t)base[x * plane + col[p & 1]] : 0u;
      v.q[p] = F.chan[h] ? (uint32_t)base[(kK + x) * plane + col[p & 1]] : 0u;
    }
#pragma unroll
    for (int cs = 0; cs < 2; ++cs) v.r[cs] = (uint32_t)base[2 * kK * plane + col[cs]];
    return v;
  };

  // Table t[0] = identity, t[1] = P; the 14 add steps fill t[2..15].
  F.put(0, F.identity());
  Pt A{load(0), load(1), load(2)};
  F.put(1, A);

#pragma unroll 1
  for (int s = 0; s < kSteps; ++s) {
    // Steps s < kTableAdds: A + P into t[s + 2].  Then per window w: doubling
    // steps d = 0..3 and the add step d = 4.  Branches on s only.
    const int u = s - kTableAdds, d = u % 5;
    if (s == kTableAdds) A = F.identity();
    const bool add_step = s < kTableAdds || d == 4;
    Pt W;
    uint32_t is_dbl[2];
    if (add_step) {
      uint32_t v[2] = {1u, 1u};
      if (s >= kTableAdds) {
#pragma unroll
        for (int cs = 0; cs < 2; ++cs) v[cs] = nib[(size_t)(u / 5) * plane + col[cs]];
      }
      F.add_part(A, F.select(v), W, is_dbl);
    }
    const Pt D = F.jac_double(A);
    if (add_step) A = pick(is_dbl, D, W);
    else A = D;
    if (s < kTableAdds) F.put(s + 2, A);
  }

  auto store = [&](int c, const Num& v) {
    int32_t* base = out + (size_t)c * kChan * plane;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int h = p >> 1, cs = p & 1, pt = pt0 + F.slot[cs];
      if (pt >= T) continue;
      if (F.chan[h]) {
        base[F.j[h] * plane + pt] = (int32_t)v.b[p];
        base[(kK + F.j[h]) * plane + pt] = (int32_t)v.q[p];
      } else if (F.red[h]) {
        base[2 * kK * plane + pt] = (int32_t)v.r[cs];
      }
    }
  };
  store(0, A.x);
  store(1, A.y);
  store(2, A.z);
}

}  // namespace

extern "C" {

// Returns a cudaError_t value (0 = launched), or rns_mma::kErrSharedMemory
// when the block's shared memory does not fit the card; writes the need and
// the device's opt-in limit per block to smem_need and smem_limit.  res and
// out are (3, chan, T) int32 with chan = 2 kK + 1, nib (64, T) uint8; the key
// rows are P-256's prime's ((1, 2k), (1, 1), (1, k)), the channel vectors and
// E_mma those of rns.consts(16, 256) at k = kK, field (kFieldRows, chan).
// ev_before and ev_after, where not null, are cudaEvent_t recorded around the
// kernel.
int ec_scalar_mult_launch(const int32_t* res, const uint8_t* nib, int chan, int T,
                          const int32_t* n_all, const int32_t* n_r, const int32_t* neg_ninv_b,
                          const int32_t* p_all, const int32_t* invMi_b, const int32_t* invMi_q,
                          const int32_t* Mq_mod_b, const int32_t* invM_q,
                          const uint32_t* mu_all, const uint32_t* invMi_b_sh,
                          const uint32_t* Mq_mod_b_sh,
                          const uint32_t* invM_q_sh, const int8_t* E_mma, const int32_t* field,
                          int invMq_pr, int invM_pr, int k, int32_t* out, void* stream,
                          int* smem_need, int* smem_limit, void* ev_before, void* ev_after) {
  if (T <= 0 || chan != kChan || k != kK) return (int)cudaErrorInvalidValue;
  const KeyRows key{n_all, n_r, neg_ninv_b, nullptr, nullptr, nullptr};
  const RnsConsts cc{p_all, mu_all, invMi_b, invMi_b_sh, invMi_q,
                     Mq_mod_b, Mq_mod_b_sh, invM_q, invM_q_sh,
                     reinterpret_cast<const uint4*>(E_mma), nullptr,
                     (uint32_t)invMq_pr, (uint32_t)invM_pr, k, 0};
  return rns_mma::launch(ec_scalar_mult_kernel, ec_geo(), (T + kSlots - 1) / kSlots,
                         (cudaStream_t)stream, smem_need, smem_limit, (cudaEvent_t)ev_before,
                         (cudaEvent_t)ev_after, res, nib, T, key, cc, field, out);
}

// Registers and local-memory bytes (spills and stack) per thread of K5 as
// compiled, its points per block and the blocks an SM holds at once (by its
// registers and shared memory).  Returns a cudaError_t value.
int ec_kernel_attrs(int* regs, int* local_bytes, int* points_per_block, int* blocks_per_sm) {
  *points_per_block = kSlots;
  const int err = rns_mma::attrs(ec_scalar_mult_kernel, regs, local_bytes);
  if (err != 0) return err;
  const int smem = (int)ec_geo().bytes();
  cudaError_t e = cudaFuncSetAttribute(ec_scalar_mult_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ec_scalar_mult_kernel,
                                                            32 * ec_geo().mt, smem);
}

}  // extern "C"
