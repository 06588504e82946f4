// Suffix-array construction by induced sorting (SA-IS), int32 text,
// arbitrary integer alphabet.
//
// This is the native build core of the index pipeline — the
// replacement for the reference's ropebwt2 / SGA `sga index` suffix-sorting
// stack (SURVEY.md §2.1-§2.2): build-time only, so it runs on the host while
// the serve path lives on the device. Implemented from the SA-IS algorithm of
// Nong, Zhang & Chan (DCC'09) — linear time, integer alphabet, recursion on
// the reduced LMS-substring problem.
//
// The multi-string read text uses one distinct sentinel per read
// (values 0..m-1 at read ends), so the final character is NOT the unique
// global minimum that SA-IS requires; the entry point shifts the alphabet
// up by one and appends a unique 0 terminator (see index/builder.py for why
// this preserves the generalized suffix order).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

typedef int32_t i32;
typedef int64_t i64;

inline bool is_lms(const std::vector<bool>& stype, i64 i) {
  return i > 0 && stype[i] && !stype[i - 1];
}

void get_buckets(const i32* T, i64 n, i64 K, std::vector<i64>& bkt, bool end) {
  std::fill(bkt.begin(), bkt.end(), 0);
  for (i64 i = 0; i < n; i++) bkt[T[i]]++;
  i64 sum = 0;
  for (i64 c = 0; c < K; c++) {
    sum += bkt[c];
    bkt[c] = end ? sum : sum - bkt[c];
  }
}

void induce(const i32* T, i32* SA, i64 n, i64 K, const std::vector<bool>& stype,
            std::vector<i64>& bkt) {
  // L-type pass, left to right, from bucket heads
  get_buckets(T, n, K, bkt, /*end=*/false);
  for (i64 i = 0; i < n; i++) {
    i64 j = SA[i];
    if (j > 0 && !stype[j - 1]) SA[bkt[T[j - 1]]++] = (i32)(j - 1);
  }
  // S-type pass, right to left, from bucket tails
  get_buckets(T, n, K, bkt, /*end=*/true);
  for (i64 i = n - 1; i >= 0; i--) {
    i64 j = SA[i];
    if (j > 0 && stype[j - 1]) SA[--bkt[T[j - 1]]] = (i32)(j - 1);
  }
}

// Core SA-IS. Precondition: n >= 1, T[i] in [0, K), T[n-1] == 0 is the
// unique minimum.
void sais_rec(const i32* T, i32* SA, i64 n, i64 K) {
  if (n == 1) {
    SA[0] = 0;
    return;
  }
  std::vector<bool> stype(n);
  stype[n - 1] = true;
  for (i64 i = n - 2; i >= 0; i--)
    stype[i] = (T[i] < T[i + 1]) || (T[i] == T[i + 1] && stype[i + 1]);

  std::vector<i64> bkt(K);

  // Step 1: sort LMS substrings — place LMS suffixes at bucket tails, induce.
  std::fill(SA, SA + n, -1);
  get_buckets(T, n, K, bkt, /*end=*/true);
  for (i64 i = n - 1; i >= 1; i--)
    if (is_lms(stype, i)) SA[--bkt[T[i]]] = (i32)i;
  induce(T, SA, n, K, stype, bkt);

  // Compact the sorted LMS suffixes to the front.
  i64 n1 = 0;
  for (i64 i = 0; i < n; i++)
    if (SA[i] > 0 && is_lms(stype, SA[i])) SA[n1++] = SA[i];
  // (the suffix at n-1 is LMS and lands here too since is_lms(n-1) holds)

  // Step 2: name LMS substrings; store names at SA[n1 + pos/2].
  std::fill(SA + n1, SA + n, -1);
  i64 name = 0, prev = -1;
  for (i64 i = 0; i < n1; i++) {
    i64 pos = SA[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (i64 d = 0;; d++) {
        if (T[pos + d] != T[prev + d] || stype[pos + d] != stype[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(stype, pos + d) || is_lms(stype, prev + d))) {
          if (is_lms(stype, pos + d) != is_lms(stype, prev + d)) diff = true;
          break;
        }
      }
    }
    if (diff) {
      name++;
      prev = pos;
    }
    SA[n1 + (pos >> 1)] = (i32)(name - 1);
  }
  // Compact names to the tail of SA (reduced text T1, in text order).
  for (i64 i = n - 1, j = n - 1; i >= n1; i--)
    if (SA[i] >= 0) SA[j--] = SA[i];

  // Step 3: solve the reduced problem.
  i32* SA1 = SA;
  i32* T1 = SA + n - n1;
  if (name < n1) {
    sais_rec(T1, SA1, n1, name);
  } else {
    for (i64 i = 0; i < n1; i++) SA1[T1[i]] = (i32)i;
  }

  // Step 4: map reduced SA back to LMS positions and induce the full SA.
  {
    i64 j = 0;
    for (i64 i = 1; i < n; i++)
      if (is_lms(stype, i)) T1[j++] = (i32)i;  // LMS positions in text order
  }
  for (i64 i = 0; i < n1; i++) SA1[i] = T1[SA1[i]];
  std::fill(SA + n1, SA + n, -1);
  get_buckets(T, n, K, bkt, /*end=*/true);
  for (i64 i = n1 - 1; i >= 0; i--) {
    i64 j = SA[i];
    SA[i] = -1;
    SA[--bkt[T[j]]] = (i32)j;
  }
  induce(T, SA, n, K, stype, bkt);
}

}  // namespace

extern "C" {

// Suffix array of T[0..n) over alphabet [0, K). No terminator requirement:
// internally shifts the alphabet by +1 and appends a unique 0 sentinel
// (valid for any text where no suffix is a proper prefix of another, which
// distinct per-read sentinels guarantee). Returns 0 on success.
int sais_int32(const int32_t* T, int32_t* SA_out, int64_t n, int64_t K) {
  if (n <= 0 || K <= 0) return -1;
  if (n >= (1LL << 31) - 1) return -2;
  std::vector<i32> T2((size_t)n + 1);
  for (i64 i = 0; i < n; i++) {
    if (T[i] < 0 || T[i] >= K) return -3;
    T2[(size_t)i] = T[i] + 1;
  }
  T2[(size_t)n] = 0;
  std::vector<i32> SA2((size_t)n + 1);
  sais_rec(T2.data(), SA2.data(), n + 1, K + 1);
  std::memcpy(SA_out, SA2.data() + 1, (size_t)n * sizeof(i32));
  return 0;
}

// BWT of the concatenated multi-string text given its suffix array:
// bwt[r] = text[SA[r]-1] (text[n-1] for SA[r]==0), sentinel values
// (< num_reads) collapsed to 0 and bases shifted to 1..4.
// Fused into C++ to avoid two n-sized temporaries in NumPy at chr20 scale.
int bwt_from_sa(const int32_t* T, const int32_t* SA, uint8_t* bwt_out,
                int64_t n, int64_t num_reads) {
  for (i64 i = 0; i < n; i++) {
    i64 j = SA[i];
    i32 c = (j > 0) ? T[j - 1] : T[n - 1];
    bwt_out[i] = (c < num_reads) ? 0 : (uint8_t)(c - num_reads + 1);
  }
  return 0;
}

// LF-mapping array in one linear pass: lf[i] = C[bwt[i]] + occ(bwt[i], i).
// (The fast-resolve tier's precomputed walk table; the NumPy fallback does
// 5 masked passes per chunk — this is ~10x faster at chr20 scale.)
// Returns -1 if any LF value overflows int32.
int compute_lf(const uint8_t* bwt, const int64_t* C5, int32_t* lf_out,
               int64_t n) {
  int64_t run[5];
  for (int c = 0; c < 5; c++) run[c] = C5[c];
  for (i64 i = 0; i < n; i++) {
    int64_t v = run[bwt[i]]++;
    if (v >= (1LL << 31)) return -1;
    lf_out[i] = (int32_t)v;
  }
  return 0;
}

}  // extern "C"
