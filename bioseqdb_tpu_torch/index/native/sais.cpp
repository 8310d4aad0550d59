// Suffix-array construction (SA-IS) — the native heart of index building.
//
// TPU-native replacement for the role of libbwa's internal `is_bwt`
// (reference: bioseqdb/bwa.cpp:10,47 — SA-IS over the doubled
// fwd+revcomp pac, 32-bit limited). This is a clean-room textbook SA-IS
// (Nong, Zhang & Chan 2009: induced sorting with LMS substrings),
// templated on the index type so the int64 path is available for
// GRCh38-scale references (SURVEY.md §7 "32-bit limits").
//
// Exposed C ABI (consumed via ctypes from index/native/build.py):
//   sais_u8_i32(T, n, SA): SA of the uint8 string T with an implicit
//     appended sentinel; SA has n+1 entries, SA[0] = n (sentinel row).
//   sais_u8_i64: same with 64-bit indices.
//
// Compile: g++ -O3 -fPIC -shared -o libsais_tpu.so sais.cpp

#include <cstdint>
#include <vector>

namespace {

template <typename I>
inline bool is_lms(const std::vector<bool>& t, I i) {
    return i > 0 && t[i] && !t[i - 1];
}

template <typename I, typename TT>
void get_counts(const TT* T, std::vector<I>& C, I n, I K) {
    for (I i = 0; i < K; ++i) C[i] = 0;
    for (I i = 0; i < n; ++i) ++C[T[i]];
}

template <typename I>
void get_buckets(const std::vector<I>& C, std::vector<I>& B, I K, bool end) {
    I sum = 0;
    for (I i = 0; i < K; ++i) {
        sum += C[i];
        B[i] = end ? sum : sum - C[i];
    }
}

template <typename I, typename TT>
void induce(const TT* T, I* SA, I n, I K, const std::vector<bool>& t,
            const std::vector<I>& C, std::vector<I>& B) {
    // induce L-type suffixes, left to right
    get_buckets(C, B, K, false);
    for (I i = 0; i < n; ++i) {
        I j = SA[i];
        if (j > 0 && !t[j - 1]) SA[B[T[j - 1]]++] = j - 1;
    }
    // induce S-type suffixes, right to left
    get_buckets(C, B, K, true);
    for (I i = n - 1; i >= 0; --i) {
        I j = SA[i];
        if (j > 0 && t[j - 1]) SA[--B[T[j - 1]]] = j - 1;
    }
}

// Compare the LMS substrings starting at a and b for equality.
template <typename I, typename TT>
bool lms_eq(const TT* T, const std::vector<bool>& t, I n, I a, I b) {
    if (a == b) return true;
    if (a == n - 1 || b == n - 1) return false;  // sentinel substring is unique
    for (I i = 0;; ++i) {
        if (T[a + i] != T[b + i] || t[a + i] != t[b + i]) return false;
        if (i > 0 && (is_lms(t, a + i) || is_lms(t, b + i)))
            return is_lms(t, a + i) && is_lms(t, b + i);
    }
}

// T[n-1] must be a unique smallest sentinel (value 0). Values in [0, K).
// TT is the text element type: uint16 at the top level (the 257-symbol
// shifted alphabet) so a GRCh38-scale call does not materialize the
// text as 64-bit ints (that alone was 50 GB); recursion levels carry
// names and use TT = I.
template <typename I, typename TT>
void sais_main(const TT* T, I* SA, I n, I K) {
    if (n == 1) {
        SA[0] = 0;
        return;
    }
    std::vector<bool> t(n);
    std::vector<I> C(K), B(K);

    // classify suffix types
    t[n - 1] = true;
    t[n - 2] = false;  // T[n-2] > sentinel
    for (I i = n - 3; i >= 0; --i)
        t[i] = (T[i] < T[i + 1]) || (T[i] == T[i + 1] && t[i + 1]);

    // stage 1: sort LMS substrings by induced sorting
    get_counts(T, C, n, K);
    get_buckets(C, B, K, true);
    for (I i = 0; i < n; ++i) SA[i] = -1;
    for (I i = 1; i < n; ++i)
        if (is_lms(t, i)) SA[--B[T[i]]] = i;
    induce(T, SA, n, K, t, C, B);

    // compact the sorted LMS positions into SA[0..n1)
    I n1 = 0;
    for (I i = 0; i < n; ++i)
        if (is_lms(t, SA[i])) SA[n1++] = SA[i];

    // name LMS substrings in SA[n1..n)
    for (I i = n1; i < n; ++i) SA[i] = -1;
    I name = 0, prev = -1;
    for (I i = 0; i < n1; ++i) {
        I pos = SA[i];
        if (prev < 0 || !lms_eq(T, t, n, prev, pos)) {
            ++name;
            prev = pos;
        }
        SA[n1 + pos / 2] = name - 1;
    }
    for (I i = n - 1, j = n - 1; i >= n1; --i)
        if (SA[i] >= 0) SA[j--] = SA[i];

    // recurse on the reduced problem if names are not yet unique
    I* SA1 = SA;
    I* s1 = SA + n - n1;
    if (name < n1) {
        sais_main<I, I>(s1, SA1, n1, name);
    } else {
        for (I i = 0; i < n1; ++i) SA1[s1[i]] = i;
    }

    // stage 2: induce the full SA from the sorted LMS order
    for (I i = 1, j = 0; i < n; ++i)
        if (is_lms(t, i)) s1[j++] = i;          // LMS positions in text order
    for (I i = 0; i < n1; ++i) SA1[i] = s1[SA1[i]];  // rank -> position
    for (I i = n1; i < n; ++i) SA[i] = -1;
    get_buckets(C, B, K, true);
    for (I i = n1 - 1; i >= 0; --i) {
        I j = SA[i];
        SA[i] = -1;
        SA[--B[T[j]]] = j;
    }
    induce(T, SA, n, K, t, C, B);
}

template <typename I>
int sais_u8(const uint8_t* T, I n, I* SA) {
    if (n < 0) return -1;
    if (n == 0) {
        SA[0] = 0;
        return 0;
    }
    // append the sentinel explicitly; shift the alphabet up by one
    // (uint16 buffer: 257 symbols, and 8x smaller than I at int64 scale)
    std::vector<uint16_t> buf(n + 1);
    for (I i = 0; i < n; ++i) buf[i] = static_cast<uint16_t>(T[i]) + 1;
    buf[n] = 0;
    sais_main<I, uint16_t>(buf.data(), SA, n + 1, (I)257);
    return 0;
}

}  // namespace

extern "C" {

int sais_u8_i32(const uint8_t* T, int32_t n, int32_t* SA) {
    return sais_u8<int32_t>(T, n, SA);
}

int sais_u8_i64(const uint8_t* T, int64_t n, int64_t* SA) {
    return sais_u8<int64_t>(T, n, SA);
}

}  // extern "C"
