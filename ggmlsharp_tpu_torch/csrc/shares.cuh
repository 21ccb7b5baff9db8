// Weight shares in shared memory, shared by gpt2_layer.cu and the one-row
// instance of mlp_fused_q8.cu: one persistent CTA an SM owns a contiguous
// range of rows of each Q8_0 weight (qs int8 [N, K] element order, d f16
// [N, K/32]), which its producer warp copies into shared memory by TMA bulk
// copies and its CW consumer warps multiply against an activation vector
// that is also in shared memory.
//
// The wrapper's plan (kernels/gpt2_layer.py::smem_plan, place) cuts each
// CTA's shares into pieces and places them in shared memory; each piece has
// its own `full` mbarrier. Where the shares fit at once a piece is a whole
// share; else pieces of at most 32 KB of qs form a ring, and a piece that
// lands on earlier pieces' bytes is issued once the consumers have released
// them (their `empty` mbarrier). Every mbarrier is used once a launch, so
// every wait is on parity 0. The consumer warps take a piece when its
// barrier completes, in units of RW (1 or 2) rows and every P-th
// 256-element step of their K, RW and P chosen by the plan (q8_dot.cuh's
// smem_rows_dot; one warp reduction a row and unit, the partials added in
// a fixed order).
#pragma once
#include "persist.cuh"
#include "q8_dot.cuh"

namespace shares {

// The shared-memory plan the wrapper computes, as it hands it over: a
// header, then PIECE_INTS a piece.
constexpr int MAX_PIECES = 64;
constexpr int COPY_BYTES = 8192;  // the most bytes of one bulk copy (a multiple of 16)
// a piece: weight, first row of the share, rows, byte offset in the ring,
// the piece whose release it waits for (or -1), rows a unit (1 or 2), splits
// of the row's steps (P)
constexpr int PIECE_INTS = 7;
// the header: pieces, byte offsets of the partial sums, of the kernel's own
// scratch, of the mbarriers and of the ring, shared-memory bytes, CTAs, and
// the first piece of each of up to four weights (then the piece count)
enum PlanHdr : int { H_N = 0, H_RED, H_ATT, H_BAR, H_RING, H_SMEM, H_G, H_FIRST, H_LEN = H_FIRST + 5 };

struct Plan {
  int hdr[H_LEN];
  int piece[MAX_PIECES][PIECE_INTS];
};

// One weight as this CTA sees it: rows [lo, hi) of N, K columns.
struct Mat {
  const int8_t* qs;
  const __half* d;
  int N, K, lo, hi;
};

// CTA blockIdx.x's share of a weight of N rows: rows [N c / G, N (c + 1) /
// G). 32-bit: N G < 2^31 (the entries check); a 64-bit division is a long
// software sequence.
__device__ __forceinline__ Mat share(const int8_t* qs, const __half* d, int N, int K) {
  Mat m;
  m.qs = qs;
  m.d = d;
  m.N = N;
  m.K = K;
  m.lo = (int)((unsigned)N * blockIdx.x / gridDim.x);
  m.hi = (int)((unsigned)N * (blockIdx.x + 1) / gridDim.x);
  return m;
}

// rows of piece p that this CTA owns (its share may be a row short of the
// most the plan was made for)
__device__ __forceinline__ int piece_rows(const Plan& plan, const Mat& m, int p) {
  const int* pc = plan.piece[p];
  return max(0, min(pc[2], m.hi - m.lo - pc[1]));
}

// Pieces [p0, p1) by the producer warp's lane 0 (mat_of(w): weight w's
// Mat): each piece's qs rows (bulk copies (TMA) of at most COPY_BYTES, so
// that several are in flight) and scales (one bulk copy), completing on the
// piece's `full` mbarrier, in plan order; a piece that reuses earlier
// pieces' bytes first waits for their release. The scale range is widened
// to 16-byte bounds (the plane's size is a multiple of 16 bytes, so the
// widened range stays inside it).
template <class MatOf>
__device__ void issue(const Plan& plan, MatOf mat_of, int p0, int p1, unsigned char* ring,
                      uint64_t* full, uint64_t* empty) {
  for (int p = p0; p < p1; ++p) {
    const int* pc = plan.piece[p];
    const Mat m = mat_of(pc[0]);
    if (pc[4] >= 0) persist::mbar_wait(&empty[pc[4]], 0);
    const int r = piece_rows(plan, m, p);
    if (r == 0) {
      persist::mbar_arrive(&full[p]);
      continue;
    }
    const size_t row0 = (size_t)m.lo + pc[1];
    const size_t qbytes = (size_t)r * m.K;
    const size_t start = row0 * (m.K / 16), end = start + (size_t)r * (m.K / 16);
    const size_t d0 = start & ~(size_t)15, d1 = (end + 15) & ~(size_t)15;
    persist::mbar_arrive_tx(&full[p], (unsigned)(qbytes + (d1 - d0)));
    unsigned char* dst = ring + pc[3];
    const int8_t* src = m.qs + row0 * m.K;
    for (size_t off = 0; off < qbytes; off += COPY_BYTES)  // several copies in flight
      persist::bulk_copy(dst + off, src + off, (unsigned)min((size_t)COPY_BYTES, qbytes - off),
                         &full[p]);
    persist::bulk_copy(dst + (size_t)pc[2] * m.K,
                       reinterpret_cast<const unsigned char*>(m.d) + d0, (unsigned)(d1 - d0),
                       &full[p]);
  }
}

// The consumers' pass over one piece: unit (row group g of RW rows, split s
// of P) goes to warp g + s groups mod CW, which leaves its partial sums in
// red[i * CW + s] (i: the row's index in the CTA's share).
template <int CW, int RW>
__device__ __forceinline__ void consume_piece(const Mat& m, const int* pc, int r, const float* vec,
                                              const unsigned char* ring, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (r + RW - 1) / RW, P = pc[6];
  const int8_t* q0 = reinterpret_cast<const int8_t*>(ring + pc[3]);
  const size_t start = ((size_t)m.lo + pc[1]) * (m.K / 16);
  const __half* d0 =
      reinterpret_cast<const __half*>(ring + pc[3] + (size_t)pc[2] * m.K + (start & 15));
  int g = groups > 0 ? warp % groups : 0, s = groups > 0 ? warp / groups : 0;
  for (int u = warp; u < groups * P; u += CW) {  // unit u: group g = u % groups, split s
    float acc[RW];
    q8::smem_rows_dot<RW>(vec, q0 + (size_t)g * RW * m.K, d0 + (size_t)g * RW * (m.K / 32),
                          m.K, min(RW, r - g * RW), s, P, lane, acc);
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      const float v = q8::warp_sum(acc[j]);
      if (lane == j && g * RW + j < r) red[(size_t)(pc[1] + g * RW + j) * CW + s] = v;
    }
    for (g += CW; g >= groups && groups > 0; g -= groups) ++s;
  }
}

// The consumers' pass over weight w's pieces, each once its bytes land,
// released after it. FORCE_RW: rows a unit (0: the plan's). tr: where warp
// 0 stamps the first piece's wait and its end (a trace build), or nullptr.
template <int CW, int FORCE_RW = 0>
__device__ __forceinline__ void consume(const Plan& plan, int w, const Mat& m, const float* vec,
                                        const unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, float* red, long long* tr = nullptr) {
  for (int p = plan.hdr[H_FIRST + w]; p < plan.hdr[H_FIRST + w + 1]; ++p) {
    const int* pc = plan.piece[p];
    const int r = piece_rows(plan, m, p);
    persist::mbar_wait(&full[p], 0);
    if (tr != nullptr && threadIdx.x == 0) tr[0] = clock64();
    if constexpr (FORCE_RW > 0)
      consume_piece<CW, FORCE_RW>(m, pc, r, vec, ring, red);
    else if (pc[5] == 1)
      consume_piece<CW, 1>(m, pc, r, vec, ring, red);
    else
      consume_piece<CW, 2>(m, pc, r, vec, ring, red);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) persist::mbar_arrive(&empty[p]);
    if (tr != nullptr && threadIdx.x == 0) tr[1] = clock64();
  }
}

// Row i of the CTA's share of weight w: its partials added in split order.
template <int CW>
__device__ __forceinline__ float row_total(const Plan& plan, int w, int i, const float* red) {
  int p = plan.hdr[H_FIRST + w];
  while (i >= plan.piece[p][1] + plan.piece[p][2]) ++p;
  const int P = plan.piece[p][6];
  float v = 0.f;
  for (int s = 0; s < P; ++s) v += red[(size_t)i * CW + s];
  return v;
}

// The mbarriers of the plan's pieces, by thread 0 before the CTA's first
// barrier: `full` completes on the producer's arrival and the bytes, `empty`
// on one arrival a consumer warp.
template <int CW>
__device__ __forceinline__ void init_barriers(const Plan& plan, uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int p = 0; p < plan.hdr[H_N]; ++p) {
      persist::mbar_init(&full[p], 1);
      persist::mbar_init(&empty[p], CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

}  // namespace shares
