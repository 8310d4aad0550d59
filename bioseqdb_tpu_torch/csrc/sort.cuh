// A group's sort of 64-bit entries, shared by extend.cu (the set-up's two
// argsorts) and resolve.cu (the expansion's argsort of a read's
// intervals).
//
// An entry packs a 32-bit key above a 32-bit slot, so entries order by
// (key, slot); the slots of a sort are distinct, so are its entries, and
// any sort of them is the stable argsort of the keys (a caller may pack
// narrower keys and slots into 32 bits the same way). Up to G entries
// sort in registers, a lane an entry, by a bitonic network over n's power
// of two with shuffles between (lane_sort; the lanes past n hold a pad and
// sort among themselves). More sort in the buffer, a lane a comparator a
// step, by the bitonic network whose comparators all put the smaller
// entry first: each merge's first step compares mirrored places, the later
// steps places j apart. No comparator ever moves a larger entry to a
// lower place, so the places from n to the power of two act as entries
// larger than all and every comparator that reaches one is skipped: the
// buffer holds the n entries alone.

#pragma once

#include "lanes.cuh"

// the entry of a 32-bit key (its sign bit flipped, so that the unsigned
// order of entries is the signed order of keys) and a slot
LANE_HD inline uint64_t sort_entry(int32_t key, long long slot) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(key) ^ 0x80000000u)
          << 32) |
         static_cast<uint32_t>(slot);
}
LANE_HD inline int32_t entry_slot(uint64_t e) {
  return static_cast<int32_t>(static_cast<uint32_t>(e));
}
constexpr uint64_t kSortPad = ~0ULL;  // after every entry

// Sorts the first n (<= G) lanes' entries v ascending across the group's
// lanes, by a bitonic network of n's power of two with shuffles between
// (the lanes past n take pad and sort among themselves): lane t returns
// the t-th smallest. T is uint32_t or uint64_t; pad is larger than every
// entry.
template <int G, typename T>
GROUP_FN Lanes<T, G> lane_sort(Lanes<T, G> v, int n, T pad) {
  int P = 2;   // the network's size: n's power of two
  while (P < n) P <<= 1;
  FOR_LANES(G, t) {
    if (t >= n) v[t] = pad;
  }
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const Lanes<T, G> o = shfl_xor<G>(v, j);
      FOR_LANES(G, t) {
        const bool low = ((t & j) == 0) == ((t & k) == 0);
        v[t] = low ? min_(v[t], o[t]) : max_(v[t], o[t]);
      }
    }
  }
  return v;
}

// Sorts buf[0, n) ascending, by a group of G threads (a group body: every
// thread of the group calls it; buf is visible to them all on entry and
// sorted for them all on return).
template <int G>
GROUP_FN void group_sort(uint64_t* buf, long long n) {
  if (n <= 1) return;
  if (n <= G) {
    Lanes<uint64_t, G> v;
    FOR_LANES(G, t) { v[t] = t < n ? buf[t] : kSortPad; }
    v = lane_sort<G>(v, static_cast<int>(n), kSortPad);
    FOR_LANES(G, t) {
      if (t < n) buf[t] = v[t];
    }
    group_sync<G>();
    return;
  }
  long long N = 2;   // n's power of two
  while (N < n) N <<= 1;
  for (long long k = 2; k <= N; k <<= 1) {
    for (long long j = k >> 1; j > 0; j >>= 1) {
      FOR_LANES(G, t) {
        for (long long i = t; i < N / 2; i += G) {
          const long long lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
          const long long hi = j == k >> 1 ? lo ^ (k - 1) : lo + j;
          if (hi >= n) continue;
          const uint64_t a = buf[lo], c = buf[hi];
          if (a > c) {
            buf[lo] = c;
            buf[hi] = a;
          }
        }
      }
      group_sync<G>();
    }
  }
}
