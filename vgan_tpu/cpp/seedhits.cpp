// Batched read seeding (native).
//
// One call replaces mapper/giraffe.py::_batch_hits for a whole read
// batch: rolling 2-bit k-mer packing, canonical splitmix64 hashing,
// binary-search join against the sorted minimizer index, and postings
// expansion into flat (read, path, strand, diag) hit arrays — the
// exact math of mapper/minimizer.py (kmer_codes / revcomp_code /
// splitmix64) and the diagonal convention of _batch_hits. Threaded
// over the read range (the host has 2 cores).
//
// Replacement context: the reference seeds inside vg
// giraffe's C++ (`src/map_giraffe.cpp:82-86`); here seeding feeds the
// device SW scorer (mapper/sw_pallas.py) with candidate windows.
//
// Built into libgamcodec.so (see Makefile).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

struct Hit {
  int32_t read;
  int32_t path;
  uint8_t strand;
  int64_t diag;
};

}  // namespace

extern "C" int64_t batch_seed_hits(
    const uint8_t* read_buf, const int64_t* read_off, int64_t n_reads,
    int32_t k, int32_t ry,
    const uint64_t* idx_hashes, int64_t n_hashes, const int64_t* post_off,
    const int32_t* post_path, const int64_t* post_ppos,
    const uint8_t* post_rc,
    int32_t* hit_read, int32_t* hit_path, uint8_t* hit_strand,
    int64_t* hit_diag, int64_t cap) {
  if (n_reads == 0 || n_hashes == 0) return 0;
  int n_threads = n_reads >= 512 ? 2 : 1;
  std::vector<std::vector<Hit>> partial(n_threads);
  auto work = [&](int t) {
    auto& out = partial[t];
    int64_t lo = n_reads * t / n_threads;
    int64_t hi = n_reads * (t + 1) / n_threads;
    const uint64_t mask =
        (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1ULL);
    const int shift_rc = 2 * (k - 1);
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* s = read_buf + read_off[r];
      const int64_t L = read_off[r + 1] - read_off[r];
      if (L < k) continue;
      uint64_t fwd = 0, rc = 0;
      int64_t run = 0;  // consecutive valid codes ending at i
      for (int64_t i = 0; i < L; ++i) {
        uint8_t c = s[i];
        if (ry) {  // minimizer.to_ry: G->A(R), C->T(Y)
          if (c == 2) c = 0;
          else if (c == 1) c = 3;
        }
        if (c >= 4) {
          run = 0;
          continue;
        }
        ++run;
        fwd = ((fwd << 2) | c) & mask;
        rc = (rc >> 2) | ((uint64_t)(3 - c) << shift_rc);
        if (run < k) continue;
        const bool is_rc = rc < fwd;
        const uint64_t h = splitmix64(is_rc ? rc : fwd);
        const uint64_t* p =
            std::lower_bound(idx_hashes, idx_hashes + n_hashes, h);
        if (p == idx_hashes + n_hashes || *p != h) continue;
        const int64_t u = p - idx_hashes;
        const int64_t pos = i - k + 1;  // k-mer start in read
        const int64_t rc_pos = L - k - pos;
        for (int64_t j = post_off[u]; j < post_off[u + 1]; ++j) {
          const uint8_t strand = (uint8_t)((post_rc[j] != 0) ^ is_rc);
          const int64_t diag =
              strand ? post_ppos[j] - rc_pos : post_ppos[j] - pos;
          out.push_back(Hit{(int32_t)r, post_path[j], strand, diag});
        }
      }
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::thread t1(work, 0);
    work(1);
    t1.join();
  }
  int64_t total = 0;
  for (auto& v : partial) total += (int64_t)v.size();
  if (total > cap) return -total;  // caller re-allocates and retries
  int64_t w = 0;
  for (auto& v : partial) {
    for (const Hit& h : v) {
      hit_read[w] = h.read;
      hit_path[w] = h.path;
      hit_strand[w] = h.strand;
      hit_diag[w] = h.diag;
      ++w;
    }
  }
  return total;
}
