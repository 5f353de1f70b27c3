// Native host-side symbolic factorization.
//
// Role of the reference's EliminationTree.cpp:65-123 (bottom-up merge of
// child update sets).  An irregular graph algorithm that belongs on the
// host CPU; the Python planner calls it through ctypes.  This is the
// symbolic part of strumpack_tpu/native/hostsym.cpp; the orderings there
// (BFS/multilevel nested dissection, minimum degree, minimum fill) are not
// part of this package yet.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 hostsym.cpp -o libhostsym.so
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

using i64 = int64_t;

extern "C" {

// ---------------------------------------------------------------------------
// Symbolic factorization: per-front update index sets.
// Returns 0 on success; *out_upd is a malloc'd flat array with offsets
// *out_off (nseps+1 entries).  Caller frees both with hostsym_free.
// ---------------------------------------------------------------------------
int symbolic_factorization(i64 n, const i64* rowptr, const i64* colind,
                           i64 nseps, const i64* sep_begin,
                           const i64* sep_end, const i64* lch,
                           const i64* rch, i64** out_upd, i64** out_off) {
  std::vector<std::vector<i64>> upd(nseps);
  std::vector<i64> tmp;
  for (i64 i = 0; i < nseps; ++i) {
    i64 sb = sep_begin[i], se = sep_end[i];
    tmp.clear();
    for (i64 r = sb; r < se; ++r)
      for (i64 p = rowptr[r]; p < rowptr[r + 1]; ++p) {
        i64 c = colind[p];
        if (c >= se) tmp.push_back(c);
      }
    for (int side = 0; side < 2; ++side) {
      i64 ch = side == 0 ? lch[i] : rch[i];
      if (ch < 0) continue;
      for (i64 v : upd[ch])
        if (v >= se) tmp.push_back(v);
      // children's sets are no longer needed once merged into the parent,
      // but they are returned to the caller, so keep them.
    }
    std::sort(tmp.begin(), tmp.end());
    tmp.erase(std::unique(tmp.begin(), tmp.end()), tmp.end());
    upd[i] = tmp;
  }
  i64 total = 0;
  for (auto& u : upd) total += (i64)u.size();
  i64* flat = (i64*)malloc(sizeof(i64) * std::max<i64>(total, 1));
  i64* off = (i64*)malloc(sizeof(i64) * (nseps + 1));
  i64 pos = 0;
  off[0] = 0;
  for (i64 i = 0; i < nseps; ++i) {
    std::memcpy(flat + pos, upd[i].data(), sizeof(i64) * upd[i].size());
    pos += (i64)upd[i].size();
    off[i + 1] = pos;
  }
  *out_upd = flat;
  *out_off = off;
  return 0;
}

void hostsym_free(i64* p) { free(p); }

}  // extern "C"
