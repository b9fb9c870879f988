// K5 for Hopper (sm_90a): P-256 scalar multiplication on the RNS field core.
//
// ec_scalar_mult_kernel replaces the reference's jitted XLA program
// bftkv_tpu/ops/ec_rns.py::_scalar_mult_fn (ec_rns.py:437, no Pallas form) and
// computes the port's plain version bftkv_tpu_torch/ops/ec_rns.py::_scalar_mult
// bit for bit: per point, the window table t[j] = j*P (15 unified adds), then 64
// windows, most significant first, of 4 doublings, a one-hot blend select of the
// window's entry and one unified add; out come the Jacobian Montgomery residues
// (X, Y, Z) of k*P.  Field elements are residues over P-256's RNS context (k = 27
// primes per base B and B', and the 2^12 redundant channel); a field multiply is
// the Bajard/Shenoy RNS Montgomery product with P-256's prime as the fixed modulus,
// adds and subtracts are channelwise with the reference's slacks (a subtraction
// adds 32p, 2^14 p or 2^16 p), and is_zero is the alpha-consistency test.  The
// per-lane arithmetic below is modelled step for step in
// tests/test_torch_ec_arith.py.
//
// What bounds it on this card.  One scalar mult is 3,920 RNS Montgomery products
// (14 table adds of 24 products, with the doubling each add evaluates, and 64
// windows of 4 x 8 + 24), each two base extensions of k(k+1) residue
// multiply-adds.  Counted on the int8 tensor cores (chip_smoke.py's convention)
// that is about 0.15 ms at T = 8192; but every point's extension has its own
// sigma and a 27 x 28 matrix, so this simple form runs them on the CUDA cores:
// per product and lane 2 x 27 shuffles and multiply-adds plus about 20 Barrett
// reductions, and the shuffles (one warp instruction per clock per SM) set the
// floor.  A tensor-core form of the extensions (rns_mma.cuh at k = 27) is the
// redesign this kernel leaves for later.
//
// Design: one warp per point, kWarps points per block.
// - Lane j < kK owns channel j of B (its b slot) and of B' (its q slot).  Lane kK
//   holds the 2^12 channel in its q slot (modulus 4096, so the same Barrett and
//   conditional subtractions are exact mod 2^12) and computes the second
//   extension's 2^12 output in its b slot; lanes past it are idle (moduli 4096,
//   constants 0).  Only lanes < kK are ever a shuffle source of an extension, and
//   lane kK of alpha, so the b slot of lane kK and the idle lanes never reach a
//   live value.
// - Residues are uint32 < 2^12; every product of two is < 2^24 and every
//   extension sum of kK products < 2^29, reduced by one Barrett step
//   (q = umulhi(x, floor(2^32/p)), one conditional subtraction: r < 2p for x <
//   2^32).
// - Each base extension is kK __shfl_sync steps of sigma_i * E[i][lane], E from
//   shared memory (the lane-constant table's E rows, loaded once per block).
// - is_zero: w_j = v_j * p^-1 mod p_j over B, alpha = w_0 by shuffle, lane
//   agreement by __all_sync, then alpha <= 64.  Every branch of the group law is
//   a select on warp-uniform flags.
// - The 16-entry table lives in shared memory as uint16 (6 KB a warp).  The
//   select reads all 16 entries at addresses fixed by the entry and the lane,
//   and blends with a mask made from the nibble: no branch, index or address
//   depends on the (secret) scalar.
//
// Layout: res and out are (3, 2 kK + 1, T) int32, X/Y/Z on the first axis, the
// B, B' and 2^12 rows on the second, points on the last (the reference's
// channel-major block); nib is (64, T) uint8; lane_tab is (kRows, 32) int32
// (ops/ec_rns.py::lane_table, rows in the order of enum Row = ec_rns.LANE_ROWS,
// then E1 and E2).  Every point below T is written, and nothing past it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 27;            // channels per base: rns.context(16, 256)
constexpr int kRLane = kK;        // the lane holding the 2^12 channel
constexpr int kChan = 2 * kK + 1; // rows of one coordinate
constexpr int kWarps = 4;         // points (warps) per block
constexpr int kNwin = 64;         // 4-bit windows of a 256-bit scalar
constexpr int kEntries = 16;      // window table entries
constexpr int kSlotsPerEntry = 6; // X, Y, Z x (b, q)
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kPrMask = 4095u;
constexpr uint32_t kZeroAlphaMax = 64; // is_zero is exact below 2 * S_SMALL

// Rows of the lane-constant table.
enum Row : int {
  kPb, kMub, kPq, kMuq, kNegNinvB, kInvMiB, kNq, kInvMQ, kInvMiQ, kMqModB, kPinvB,
  kOneB, kOneQ, kSpSmallB, kSpSmallQ, kSpL1B, kSpL1Q, kSpL2B, kSpL2Q, kInvMqPr,
  kE1, kE2 = kE1 + kK, kRows = kE2 + kK
};

// Slack index of Field::sub.
enum Slack : int { kSmall, kL1, kL2 };

struct Fe {
  uint32_t b, q;
};

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ uint32_t barrett(uint32_t x, uint32_t p, uint32_t mu) {
  const uint32_t r = x - __umulhi(x, mu) * p;
  return r >= p ? r - p : r;
}

__device__ __forceinline__ Fe sel(bool f, Fe a, Fe b) { return {f ? a.b : b.b, f ? a.q : b.q}; }

__device__ __forceinline__ Pt sel(bool f, const Pt& a, const Pt& b) {
  return {sel(f, a.x, b.x), sel(f, a.y, b.y), sel(f, a.z, b.z)};
}

// The field on one lane: its constants, and the extension matrices in shared memory.
struct Field {
  uint32_t lane, pb, mub, pq, muq, nnb, imb, nq, imq, imiq, mqb, pinv, imq_pr;
  Fe one, sp[3];
  const uint32_t* e1;  // [kK][32]: E1[i][lane]
  const uint32_t* e2;  // [kK][32]: E2[j][lane]

  __device__ Field(const int32_t* __restrict__ tab, const uint32_t* se, uint32_t l) : lane(l) {
    auto ld = [&](int row) { return (uint32_t)tab[row * 32 + l]; };
    pb = ld(kPb); mub = ld(kMub); pq = ld(kPq); muq = ld(kMuq);
    nnb = ld(kNegNinvB); imb = ld(kInvMiB); nq = ld(kNq); imq = ld(kInvMQ);
    imiq = ld(kInvMiQ); mqb = ld(kMqModB); pinv = ld(kPinvB); imq_pr = ld(kInvMqPr);
    one = {ld(kOneB), ld(kOneQ)};
    sp[kSmall] = {ld(kSpSmallB), ld(kSpSmallQ)};
    sp[kL1] = {ld(kSpL1B), ld(kSpL1Q)};
    sp[kL2] = {ld(kSpL2B), ld(kSpL2Q)};
    e1 = se;
    e2 = se + kK * 32;
  }

  // RNS Montgomery product a*b*M^-1 mod p (Bajard AMM, Shenoy return extension).
  __device__ __forceinline__ Fe mul(Fe a, Fe b) const {
    const uint32_t db = barrett(a.b * b.b, pb, mub);
    const uint32_t dq = barrett(a.q * b.q, pq, muq);
    const uint32_t qb = barrett(db * nnb, pb, mub);
    const uint32_t sg = barrett(qb * imb, pb, mub);
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < kK; ++i) acc += __shfl_sync(kFull, sg, i) * e1[i * 32 + lane];
    const uint32_t qh = barrett(acc, pq, muq);  // q-hat over B' (lane kK: mod 2^12)
    uint32_t s = dq + barrett(qh * nq, pq, muq);
    s = s >= pq ? s - pq : s;
    const uint32_t rq = barrett(s * imq, pq, muq);  // r over B' (lane kK: r mod 2^12)
    const uint32_t sg2 = barrett(rq * imiq, pq, muq);
    acc = 0;
#pragma unroll
    for (int j = 0; j < kK; ++j) acc += __shfl_sync(kFull, sg2, j) * e2[j * 32 + lane];
    const uint32_t eb = barrett(acc, pb, mub);  // extension to B (lane kK: to 2^12)
    const uint32_t al =
        __shfl_sync(kFull, (((eb - rq) & kPrMask) * imq_pr) & kPrMask, kRLane);
    const uint32_t corr = barrett(al * mqb, pb, mub);
    return {eb >= corr ? eb - corr : eb + pb - corr, rq};
  }

  __device__ __forceinline__ Fe add(Fe a, Fe b) const {
    const uint32_t x = a.b + b.b, y = a.q + b.q;
    return {x >= pb ? x - pb : x, y >= pq ? y - pq : y};
  }

  __device__ __forceinline__ Fe dbl(Fe a) const { return add(a, a); }

  // a - b + S*p (the slack keeps the value positive; S*p = 0 mod p).
  __device__ __forceinline__ Fe sub(Fe a, Fe b, int s) const {
    uint32_t x = a.b >= b.b ? a.b - b.b : a.b + pb - b.b;
    uint32_t y = a.q >= b.q ? a.q - b.q : a.q + pq - b.q;
    x += sp[s].b;
    y += sp[s].q;
    return {x >= pb ? x - pb : x, y >= pq ? y - pq : y};
  }

  // v = 0 mod p, for v < (min prime) * p: w_j = v_j p^-1 mod p_j agree over B.
  __device__ __forceinline__ bool is_zero(Fe v) const {
    const uint32_t w = barrett(v.b * pinv, pb, mub);
    const uint32_t a = __shfl_sync(kFull, w, 0);
    return __all_sync(kFull, lane >= (uint32_t)kK || w == a) && a <= kZeroAlphaMax;
  }

  // dbl-2001-b for a = -3, with Z3 = 2 Y1 Z1 (keeps the identity's Z exactly 0).
  __device__ Pt jac_double(const Pt& P) const {
    const Fe delta = mul(P.z, P.z);
    const Fe gamma = mul(P.y, P.y);
    const Fe beta = mul(P.x, gamma);
    const Fe t0 = sub(P.x, delta, kL1);
    const Fe t1 = add(P.x, delta);
    const Fe alpha = mul(t0, add(dbl(t1), t1));
    const Fe beta4 = dbl(dbl(beta));
    const Fe X3 = sub(mul(alpha, alpha), dbl(beta4), kL1);
    const Fe Z3 = dbl(mul(P.y, P.z));
    const Fe g2 = mul(gamma, gamma);
    const Fe Y3 = sub(mul(alpha, sub(beta4, X3, kL2)), dbl(dbl(dbl(g2))), kL1);
    return {X3, Y3, Z3};
  }

  // Unified add (add-2007-bl shape) with the doubling, P + (-P) and identity
  // cases selected on warp-uniform flags.
  __device__ Pt jac_add(const Pt& A, const Pt& B) const {
    const Fe Z1Z1 = mul(A.z, A.z);
    const Fe Z2Z2 = mul(B.z, B.z);
    const Fe U1 = mul(A.x, Z2Z2);
    const Fe U2 = mul(B.x, Z1Z1);
    const Fe S1 = mul(mul(A.y, B.z), Z2Z2);
    const Fe S2 = mul(mul(B.y, A.z), Z1Z1);
    const Fe H = sub(U2, U1, kSmall);
    const Fe R = sub(S2, S1, kSmall);
    const Fe H2 = mul(H, H);
    const Fe H3 = mul(H2, H);
    const Fe U1H2 = mul(U1, H2);
    const Fe X3 = sub(sub(mul(R, R), H3, kL1), dbl(U1H2), kL1);
    const Fe Y3 = sub(mul(R, sub(U1H2, X3, kL2)), mul(S1, H3), kL1);
    const Fe Z3 = mul(mul(A.z, B.z), H);
    const Pt D = jac_double(A);

    const bool inf1 = is_zero(A.z);
    const bool inf2 = is_zero(B.z);
    const bool same_x = is_zero(H) && !inf1 && !inf2;
    const bool same_y = is_zero(R);
    const bool is_dbl = same_x && same_y;
    const bool to_inf = same_x && !same_y;  // P + (-P) = O

    Pt out = sel(is_dbl, D, Pt{X3, Y3, Z3});
    out.z = sel(to_inf, Fe{0u, 0u}, out.z);
    return sel(inf1, B, sel(inf2, A, out));
  }
};

__global__ void __launch_bounds__(32 * kWarps)
ec_scalar_mult_kernel(const int32_t* __restrict__ res, const uint8_t* __restrict__ nib,
                      const int32_t* __restrict__ lane_tab, int T, int32_t* __restrict__ out) {
  __shared__ uint32_t s_e[2 * kK * 32];
  __shared__ uint16_t s_tab[kWarps][kEntries * kSlotsPerEntry * 32];
  for (int i = threadIdx.x; i < 2 * kK * 32; i += blockDim.x) s_e[i] = (uint32_t)lane_tab[kE1 * 32 + i];
  __syncthreads();

  const uint32_t lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int pt = blockIdx.x * kWarps + w;
  if (pt >= T) return;  // the whole warp: one point per warp
  const Field F(lane_tab, s_e, lane);
  const size_t plane = (size_t)T;

  auto load = [&](int c) -> Fe {
    const int32_t* base = res + (size_t)c * kChan * plane + pt;
    const uint32_t b = lane < (uint32_t)kK ? (uint32_t)base[lane * plane] : 0u;
    const uint32_t q = lane < (uint32_t)kK ? (uint32_t)base[(kK + lane) * plane]
                       : lane == (uint32_t)kRLane ? (uint32_t)base[2 * kK * plane]
                                                   : 0u;
    return {b, q};
  };
  const Pt P{load(0), load(1), load(2)};

  uint16_t* tab = s_tab[w];
  auto put = [&](int e, const Pt& v) {
    uint16_t* t = tab + e * kSlotsPerEntry * 32 + lane;
    t[0 * 32] = (uint16_t)v.x.b;
    t[1 * 32] = (uint16_t)v.x.q;
    t[2 * 32] = (uint16_t)v.y.b;
    t[3 * 32] = (uint16_t)v.y.q;
    t[4 * 32] = (uint16_t)v.z.b;
    t[5 * 32] = (uint16_t)v.z.q;
  };

  // Window table t[j] = j*P: t[0] = identity (Z = 0), t[1] = P, then 14 adds.
  const Pt ident{F.one, F.one, {0u, 0u}};
  put(0, ident);
  put(1, P);
  Pt cur = P;
#pragma unroll 1
  for (int e = 2; e < kEntries; ++e) {
    cur = F.jac_add(cur, P);
    put(e, cur);
  }
  __syncwarp();

  Pt acc = ident;
#pragma unroll 1
  for (int win = 0; win < kNwin; ++win) {
    const uint32_t v = nib[(size_t)win * plane + pt];
#pragma unroll 1
    for (int d = 0; d < 4; ++d) acc = F.jac_double(acc);
    // One-hot blend over all 16 entries: every entry is read, at an address
    // fixed by the entry and the lane; the nibble only makes the mask.
    uint32_t s[kSlotsPerEntry] = {0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < kEntries; ++e) {
      const uint32_t m = 0u - (uint32_t)(v == (uint32_t)e);
#pragma unroll
      for (int cs = 0; cs < kSlotsPerEntry; ++cs)
        s[cs] |= (uint32_t)tab[(e * kSlotsPerEntry + cs) * 32 + lane] & m;
    }
    acc = F.jac_add(acc, Pt{{s[0], s[1]}, {s[2], s[3]}, {s[4], s[5]}});
  }

  auto store = [&](int c, Fe v) {
    int32_t* base = out + (size_t)c * kChan * plane + pt;
    if (lane < (uint32_t)kK) {
      base[lane * plane] = (int32_t)v.b;
      base[(kK + lane) * plane] = (int32_t)v.q;
    } else if (lane == (uint32_t)kRLane) {
      base[2 * kK * plane] = (int32_t)v.q;
    }
  };
  store(0, acc.x);
  store(1, acc.y);
  store(2, acc.z);
}

}  // namespace

extern "C" {

// Returns a cudaError_t value (0 = launched).  res and out are (3, chan, T)
// int32 with chan = 2 kK + 1, nib (64, T) uint8, lane_tab (kRows, 32) int32.
int ec_scalar_mult_launch(const int32_t* res, const uint8_t* nib, const int32_t* lane_tab,
                          int chan, int T, int32_t* out, void* stream) {
  if (T <= 0 || chan != kChan) return (int)cudaErrorInvalidValue;
  ec_scalar_mult_kernel<<<(T + kWarps - 1) / kWarps, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      res, nib, lane_tab, T, out);
  return (int)cudaGetLastError();
}

// Registers and local-memory bytes (spills and stack) per thread of K5 as
// compiled, and its points per block.  Returns a cudaError_t value.
int ec_kernel_attrs(int* regs, int* local_bytes, int* points_per_block) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, ec_scalar_mult_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *points_per_block = kWarps;
  return 0;
}

}  // extern "C"
