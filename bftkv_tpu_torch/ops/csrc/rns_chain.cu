// Fused RNS Montgomery chain for Hopper (sm_90a): the port's K1.
//
// K1 rns_verify_kernel replaces bftkv_tpu/ops/pallas_rns.py::_verify_body
//    (pallas_call at pallas_rns.py:517): RSA-2048 e=65537 verify in RNS.
// (K2, the windowed modexp, is in rns_pow.cu.)
//
// What it computes is the reference's ops/rns.py::_verify_kernel, bit for
// bit.  Residues are canonical integers in [0, p) with
// p < 2^12, so exact uint32 arithmetic gives the same values as the
// reference's f32 Barrett: a product of two residues is < 2^24, and a base
// extension sum over k <= 255 channels of such products is < 2^32 (k = 188
// gives at most 3.15e9), so the kernels accumulate Sigma sigma_i * E[i][j]
// directly in uint32 and reduce once, with no 6-bit split.
//
// Design (a simple kernel that is right; no tensor cores yet):
// - one thread block runs R batch rows through the WHOLE chain in one launch,
//   so residues never round-trip device memory between Montgomery products
//   (the point of the Pallas design, pallas_rns.py:1-16);
// - thread c owns channel c of base B and of base B' for all R rows; the
//   thread with c == k owns the 2^12 redundant channel's extension sums; the
//   redundant-channel values themselves are kept replicated in every thread;
// - the two extension matrices E1, E2 (k x (k+1) uint16) are staged in shared
//   memory once per block; sigma vectors are broadcast from shared memory;
// - the digit -> residue matrix D is read from global memory (L2 resident).
// Bound: integer multiply-adds (about 1.5 M per verify row), i.e. operations,
// not bytes; each row reads a few hundred bytes.
//
// Rows past the batch end compute on a clamped copy of the last row and are
// never stored; every row below the batch end is written (fail closed).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPrMask = 4095u;  // the 2^12 redundant channel

struct RnsConsts {
  const int32_t* p_all;     // (2k): base B then base B'
  const int32_t* invMi_b;   // (k)
  const int32_t* invMi_q;   // (k)
  const int32_t* Mq_mod_b;  // (k)
  const int32_t* invM_q;    // (k)
  const uint16_t* E1;       // (k, k+1)  B -> B' | 2^12
  const uint16_t* E2;       // (k, k+1)  B' -> B | 2^12
  const uint16_t* D;        // (2*digits, 2k+1) 8-bit halves -> residues
  uint32_t invMq_pr, invM_pr;
  int k, digits;
};

struct KeyRows {            // unique key rows (K, .), gathered through idx
  const int32_t* n_all;     // (K, 2k)
  const int32_t* n_r;       // (K, 1)
  const int32_t* neg_ninv_b;// (K, k)
  const int32_t* ninv_all;  // (K, 2k)
  const int32_t* m2_all;    // (K, 2k)
  const int32_t* m2_r;      // (K, 1)
};

// Shared-memory layout of one block, in 32-bit words, then the uint16
// extension matrices.
template <int R>
struct Smem {
  uint32_t* sig1;    // (k, R) sigma of the B -> B' extension
  uint32_t* sig2;    // (k, R) sigma of the B' -> B extension
  uint32_t* halves;  // (2*digits, R) digit halves of the row being converted
  uint32_t* res;     // (2k+1, R) converted residues
  uint32_t* rr;      // (R) redundant channel of the product
  uint32_t* alpha;   // (R) Shenoy correction
  uint32_t* misc;    // (2R) verify: alpha of channel 0, mismatch flag
  uint16_t* E1;      // (k, k+1)
  uint16_t* E2;      // (k, k+1)

  __host__ __device__ static size_t words(int k, int digits) {
    return 2 * (size_t)k * R + 2 * (size_t)digits * R +
           (2 * (size_t)k + 1) * R + 4 * (size_t)R;
  }
  __host__ __device__ static size_t bytes(int k, int digits) {
    size_t e = 2 * (size_t)k * (k + 1) * sizeof(uint16_t);
    return words(k, digits) * sizeof(uint32_t) + e;
  }
  __device__ void carve(unsigned char* raw, int k, int digits) {
    uint32_t* w = reinterpret_cast<uint32_t*>(raw);
    sig1 = w;   w += (size_t)k * R;
    sig2 = w;   w += (size_t)k * R;
    halves = w; w += 2 * (size_t)digits * R;
    res = w;    w += (2 * (size_t)k + 1) * R;
    rr = w;     w += R;
    alpha = w;  w += R;
    misc = w;   w += 2 * R;
    E1 = reinterpret_cast<uint16_t*>(w);
    E2 = E1 + (size_t)k * (k + 1);
  }
};

template <int R>
struct Chain {
  using V = uint32_t[R];

  RnsConsts c;
  Smem<R> s;
  int ch;        // this thread's channel
  bool chan;     // ch < k: owns channel ch of B and of B'
  bool redund;   // ch == k: owns the redundant channel's extension sums
  uint32_t pb, pq, invMi_b, invMi_q, Mq_mod_b, invM_q;
  uint32_t nninv[R], nq[R], nr[R];  // per-row key constants of this channel

  __device__ void init(const RnsConsts& cc, const KeyRows& key, const int (&kid)[R]) {
    c = cc;
    ch = threadIdx.x;
    chan = ch < c.k;
    redund = ch == c.k;
    const int cc_ = chan ? ch : 0;
    // Threads without a channel hold p = 1: every residue they form is 0.
    pb = chan ? (uint32_t)c.p_all[cc_] : 1u;
    pq = chan ? (uint32_t)c.p_all[c.k + cc_] : 1u;
    invMi_b = (uint32_t)c.invMi_b[cc_];
    invMi_q = (uint32_t)c.invMi_q[cc_];
    Mq_mod_b = (uint32_t)c.Mq_mod_b[cc_];
    invM_q = (uint32_t)c.invM_q[cc_];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      nninv[r] = (uint32_t)key.neg_ninv_b[(size_t)kid[r] * c.k + cc_];
      nq[r] = (uint32_t)key.n_all[(size_t)kid[r] * 2 * c.k + c.k + cc_];
      nr[r] = (uint32_t)key.n_r[kid[r]];
    }
  }

  // s[r] = Sigma_i sg[i][r] * E[i][ch] over the k channels (exact in uint32).
  __device__ __forceinline__ void extend(const uint16_t* E, const uint32_t* sg, V& acc) const {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0u;
    if (ch <= c.k) {
      const int k1 = c.k + 1;
      for (int i = 0; i < c.k; ++i) {
        const uint32_t e = E[i * k1 + ch];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] += sg[i * R + r] * e;
      }
    }
  }

  // (ob, oq, orr) = a * b * M^-1 mod N in RNS (Bajard AMM + Shenoy).
  // Every input is read before the first barrier, so outputs may alias inputs.
  __device__ __forceinline__ void mont(const V& ab, const V& aq, const V& ar,
                                       const V& bb, const V& bq, const V& br,
                                       V& ob, V& oq, V& orr) const {
    uint32_t dq[R], dr[R], acc[R], rq[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dr[r] = (ar[r] * br[r]) & kPrMask;
      dq[r] = (aq[r] * bq[r]) % pq;
      if (chan) {
        const uint32_t db = (ab[r] * bb[r]) % pb;
        const uint32_t qb = (db * nninv[r]) % pb;   // q = d * (-N^-1) mod p
        s.sig1[ch * R + r] = (qb * invMi_b) % pb;
      }
    }
    __syncthreads();
    extend(s.E1, s.sig1, acc);  // q^ = Sigma sigma_i M_i over B' and 2^12
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (chan) {
        const uint32_t t = ((acc[r] % pq) * nq[r]) % pq;
        uint32_t x = dq[r] + t;
        x = x >= pq ? x - pq : x;
        rq[r] = (x * invM_q) % pq;                  // r = (d + q^ N) / M
        s.sig2[ch * R + r] = (rq[r] * invMi_q) % pq;
      } else {
        rq[r] = 0u;
      }
      if (redund) {
        const uint32_t qr = acc[r] & kPrMask;
        s.rr[r] = (((dr[r] + qr * nr[r]) & kPrMask) * c.invM_pr) & kPrMask;
      }
    }
    __syncthreads();
    extend(s.E2, s.sig2, acc);  // exact return extension B' -> B and 2^12
    uint32_t rrv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rrv[r] = s.rr[r];
      if (redund) {
        // ((ext_r - rr) mod 2^12) * (Mq^-1 mod 2^12), non-negative: the
        // uint32 difference wraps modulo 2^32, a multiple of 2^12.
        s.alpha[r] = (((acc[r] - rrv[r]) & kPrMask) * c.invMq_pr) & kPrMask;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t al = s.alpha[r];
      if (chan) {
        const uint32_t eb = acc[r] % pb;
        const uint32_t corr = (al * Mq_mod_b) % pb;
        ob[r] = eb >= corr ? eb - corr : eb + pb - corr;
      } else {
        ob[r] = 0u;
      }
      oq[r] = rq[r];
      orr[r] = rrv[r];
    }
  }

  // Digit halves (already in s.halves) -> residues (xb, xq, xr).
  __device__ void to_residues(V& xb, V& xq, V& xr) const {
    const int nch = 2 * c.k + 1, nd = 2 * c.digits;
    for (int j = threadIdx.x; j < nch; j += blockDim.x) {
      uint32_t acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0u;
      for (int d = 0; d < nd; ++d) {
        const uint32_t w = c.D[(size_t)d * nch + j];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] += s.halves[d * R + r] * w;
      }
      const bool red = j == 2 * c.k;
      const uint32_t p = red ? 1u : (uint32_t)c.p_all[red ? 0 : j];
#pragma unroll
      for (int r = 0; r < R; ++r) s.res[j * R + r] = red ? (acc[r] & kPrMask) : acc[r] % p;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      xb[r] = chan ? s.res[ch * R + r] : 0u;
      xq[r] = chan ? s.res[(c.k + ch) * R + r] : 0u;
      xr[r] = s.res[2 * c.k * R + r];
    }
    __syncthreads();  // s.res and s.halves are free again
  }

  // Stage one (T, 2*digits) uint8 operand's rows into s.halves.
  __device__ void load_halves(const uint8_t* h, const int (&row)[R]) const {
    const int nd = 2 * c.digits;
    for (int x = threadIdx.x; x < nd * R; x += blockDim.x) {
      const int r = x / nd, d = x - r * nd;
      s.halves[d * R + r] = h[(size_t)row[r] * nd + d];
    }
    __syncthreads();
  }

  __device__ void stage_matrices() const {
    const int n = c.k * (c.k + 1);
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      s.E1[x] = c.E1[x];
      s.E2[x] = c.E2[x];
    }
    // The first barrier inside the chain orders these stores before any read.
  }
};

// Rows of this block (clamped: rows past T compute but are never stored) and
// their key rows.  A key index outside [0, n_keys) is clamped so no read
// leaves the key table, and reported in the returned bit mask: the kernel
// fails such rows closed.  (The entry points refuse such indices.)
template <int R>
__device__ __forceinline__ unsigned block_rows(int T, const int32_t* idx, int n_keys,
                                               int (&row)[R], int (&kid)[R]) {
  const int row0 = blockIdx.x * R;
  unsigned bad = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = min(row0 + r, T - 1);
    const int x = idx[row[r]];
    const bool ok = x >= 0 && x < n_keys;
    bad |= ok ? 0u : (1u << r);
    kid[r] = ok ? x : 0;
  }
  return bad;
}

template <int R>
__global__ void __launch_bounds__(256, 1)
rns_verify_kernel(const uint8_t* __restrict__ sig_h, const uint8_t* __restrict__ em_h,
                  const int32_t* __restrict__ idx, int T, int n_keys, KeyRows key,
                  RnsConsts cc, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Chain<R> ch;
  ch.s.carve(smem_raw, cc.k, cc.digits);
  int row[R], kid[R];
  const unsigned bad_idx = block_rows<R>(T, idx, n_keys, row, kid);
  ch.init(cc, key, kid);
  ch.stage_matrices();
  const int k = cc.k;
  const int cc_ = ch.chan ? ch.ch : 0;

  uint32_t sb[R], sq[R], sr[R], eb[R], eq[R], er[R];
  ch.load_halves(sig_h, row);
  ch.to_residues(sb, sq, sr);
  ch.load_halves(em_h, row);
  ch.to_residues(eb, eq, er);

  uint32_t mb[R], mq[R], mr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t base = (size_t)kid[r] * 2 * k;
    mb[r] = (uint32_t)key.m2_all[base + cc_];
    mq[r] = (uint32_t)key.m2_all[base + k + cc_];
    mr[r] = (uint32_t)key.m2_r[kid[r]];
  }
  ch.mont(sb, sq, sr, mb, mq, mr, sb, sq, sr);  // s * M mod N: Montgomery form
  uint32_t ab[R], aq[R], ar[R];
#pragma unroll
  for (int r = 0; r < R; ++r) { ab[r] = sb[r]; aq[r] = sq[r]; ar[r] = sr[r]; }
  for (int i = 0; i < 16; ++i) ch.mont(ab, aq, ar, ab, aq, ar, ab, aq, ar);
  ch.mont(ab, aq, ar, sb, sq, sr, ab, aq, ar);  // s^65537 in Montgomery form
#pragma unroll
  for (int r = 0; r < R; ++r) { mb[r] = 1u; mq[r] = 1u; mr[r] = 1u; }
  ch.mont(ab, aq, ar, mb, mq, mr, ab, aq, ar);  // v = s^e mod N, v < (k+1)N

  // Delta_j = (v_j - em_j) * N^-1 mod p_j must be one alpha <= k+1 everywhere.
  uint32_t db[R], dq[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t base = (size_t)kid[r] * 2 * k;
    const uint32_t ninv_b = (uint32_t)key.ninv_all[base + cc_];
    const uint32_t ninv_q = (uint32_t)key.ninv_all[base + k + cc_];
    const uint32_t xb = ab[r] >= eb[r] ? ab[r] - eb[r] : ab[r] + ch.pb - eb[r];
    const uint32_t xq = aq[r] >= eq[r] ? aq[r] - eq[r] : aq[r] + ch.pq - eq[r];
    db[r] = (xb * ninv_b) % ch.pb;
    dq[r] = (xq * ninv_q) % ch.pq;
    if (threadIdx.x == 0) {
      ch.s.misc[r] = db[r];
      ch.s.misc[R + r] = 0u;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t a0 = ch.s.misc[r];
    if (ch.chan && (db[r] != a0 || dq[r] != a0)) ch.s.misc[R + r] = 1u;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int row0 = blockIdx.x * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r < T) {
        const bool ok = ch.s.misc[R + r] == 0u && ch.s.misc[r] <= (uint32_t)(k + 1) &&
                        !((bad_idx >> r) & 1u);
        out[row0 + r] = ok ? 1 : 0;
      }
    }
  }
}

constexpr int kVerifyRows = 8;
// Returned (instead of a cudaError_t) when the block's shared memory does not
// fit the device; the launcher has then written the need and the limit.
constexpr int kErrSharedMemory = -2;

int threads_for(int k) { return ((k + 1 + 31) / 32) * 32; }

// Launches `kernel` at R rows per block after checking its dynamic shared
// memory against the device's opt-in limit per block.
template <int R, typename Kernel>
int launch(Kernel kernel, int T, int n_keys, int k, int digits,
           cudaStream_t stream, const uint8_t* a, const uint8_t* b, const int32_t* idx,
           KeyRows key, RnsConsts cc, int32_t* out, int* smem_need, int* smem_limit) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = Smem<R>::bytes(k, digits);
  *smem_need = (int)smem;
  *smem_limit = optin;
  if (smem > (size_t)optin) return kErrSharedMemory;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (T + R - 1) / R;
  kernel<<<grid, threads_for(k), smem, stream>>>(a, b, idx, T, n_keys, key, cc, out);
  return (int)cudaGetLastError();
}

bool bad_shape(int T, int n_keys, int k, int digits) {
  // k <= 255 keeps every extension sum below 2^32 and the k + 1 channel
  // threads within the kernel's 256-thread launch bound.
  return T <= 0 || n_keys <= 0 || k <= 0 || k > 255 || digits <= 0 || digits > 256;
}

}  // namespace

extern "C" {

// The launcher returns a cudaError_t value (0 = launched), or
// kErrSharedMemory when the block's shared memory does not fit the card.
// It writes the dynamic shared memory the launch needs and the device's
// opt-in limit per block to smem_need and smem_limit.
int rns_verify_launch(const uint8_t* sig_h, const uint8_t* em_h, const int32_t* idx, int T,
                      int n_keys, const int32_t* n_all, const int32_t* n_r, const int32_t* neg_ninv_b,
                      const int32_t* ninv_all, const int32_t* m2_all, const int32_t* m2_r,
                      const int32_t* p_all, const int32_t* invMi_b, const int32_t* invMi_q,
                      const int32_t* Mq_mod_b, const int32_t* invM_q,
                      const uint16_t* E1, const uint16_t* E2, const uint16_t* D,
                      int invMq_pr, int invM_pr, int k, int digits,
                      int32_t* out, void* stream, int* smem_need, int* smem_limit) {
  if (bad_shape(T, n_keys, k, digits)) return (int)cudaErrorInvalidValue;
  const KeyRows key{n_all, n_r, neg_ninv_b, ninv_all, m2_all, m2_r};
  const RnsConsts cc{p_all, invMi_b, invMi_q, Mq_mod_b, invM_q, E1, E2, D,
                     (uint32_t)invMq_pr, (uint32_t)invM_pr, k, digits};
  return launch<kVerifyRows>(rns_verify_kernel<kVerifyRows>, T, n_keys, k, digits,
                             (cudaStream_t)stream, sig_h, em_h, idx, key, cc, out,
                             smem_need, smem_limit);
}

// Registers and local-memory bytes (spills and stack) per thread of K1 as
// compiled.  Returns a cudaError_t value.
int rns_kernel_attrs(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, rns_verify_kernel<kVerifyRows>);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

const char* rns_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
