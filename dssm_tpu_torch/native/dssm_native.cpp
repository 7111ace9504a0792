// dssm_native: the C++ host data plane of dssm_tpu_torch.
//
// Two hot loops of the input pipeline: the letter-trigram hashing (tokenize
// -> bracket -> trigram -> FNV-1a -> top-K) and the two-level batch dedupe.
// Both are bit-equal to their plain versions, dssm_tpu_torch/data/trigram.py
// and data/dedupe.py (tests/test_torch_native.py).
//
// A plain C interface (pointers and sizes), loaded with ctypes by
// dssm_tpu_torch/data/native.py. ctypes releases the GIL for the length of
// every call, so the loader's pool threads run these calls side by side.
// The caller allocates every output; nothing here touches a Python object.
//
// Texts arrive lowercased by Python's str.lower() and UTF-8 encoded, as one
// buffer with int64 offsets. On lowered text a byte scan for [a-z0-9'] is
// exactly re.findall(r"[a-z0-9']+", text.lower()): no byte of a multibyte
// UTF-8 sequence is below 0x80, so none is a word byte. Lowering in Python
// keeps the letters whose lowercase is ASCII (the Kelvin sign is 'k').
//
// Entry points (each returns 0, or an error code the wrapper raises on):
//   dssm_hash_batch(text, offsets, n, vocab, k, normalize, idx, wgt)
//       idx int32 [n, k], wgt f32 [n, k]
//   dssm_hash_batch_sequence(text, offsets, n, vocab, t, kw, normalize,
//                            idx, wgt, mask)
//       idx int32 [n, t, kw], wgt f32 [n, t, kw], mask f32 [n, t]
//   dssm_dedupe_two_level(a, na, b, nb, g_cap_rows, u2_cap, group,
//                         uniq_groups, row_sel, inv2, keep)
//       the union of spans a and b (a first; nb = 0 for one span):
//       uniq_groups int32 [g_cap_rows / group], row_sel int32 [u2_cap],
//       inv2 int32 [na + nb], keep f32 [na + nb]

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001B3ULL;
// data/dedupe.py's SKIP_SENTINEL_GID: the group id of a padding slot.
constexpr int32_t kSkipSentinelGid = 1 << 25;

constexpr int kOk = 0;
constexpr int kBadShape = 1;
constexpr int kNegativeIndex = 2;

inline bool word_byte(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '\'';
}

// Appends the trigram ids of the word w[0, n) bracketed as "#w#" (n >= 1, so
// at least one trigram): 1 + FNV-1a(trigram) % (vocab - 1), as trigram_id.
void word_trigram_ids(const char* w, size_t n, uint64_t vocab,
                      std::vector<int32_t>* ids) {
  auto at = [w, n](size_t p) -> unsigned char {
    return (p == 0 || p == n + 1) ? '#' : static_cast<unsigned char>(w[p - 1]);
  };
  for (size_t j = 0; j < n; ++j) {
    uint64_t h = kFnvOffset;
    for (size_t p = j; p < j + 3; ++p) {
      h ^= at(p);
      h *= kFnvPrime;
    }
    ids->push_back(static_cast<int32_t>(1 + h % (vocab - 1)));
  }
}

// Calls fn(word, length) for each run of word bytes in text[0, len).
template <typename F>
void for_each_word(const char* text, size_t len, F&& fn) {
  size_t start = 0;
  bool in_word = false;
  for (size_t i = 0; i < len; ++i) {
    const bool w = word_byte(static_cast<unsigned char>(text[i]));
    if (w && !in_word) start = i;
    if (!w && in_word) fn(text + start, i - start);
    in_word = w;
  }
  if (in_word) fn(text + start, len - start);
}

// The counts of `ids` (sorted here) as k (index, weight) slots: the top k
// by (count desc, index asc), padded with index 0 at weight 0, then scaled
// to unit norm if normalize. That is _counts_to_fixed's order, and
// np.linalg.norm's float32 sum of squares and square root: the counts are
// whole numbers, so the sum is exact in any order.
void fixed_from_ids(std::vector<int32_t>* ids, int k, bool normalize,
                    std::vector<std::pair<int32_t, float>>* items,
                    int32_t* idx, float* wgt) {
  std::sort(ids->begin(), ids->end());
  items->clear();
  for (size_t i = 0; i < ids->size();) {
    size_t j = i + 1;
    while (j < ids->size() && (*ids)[j] == (*ids)[i]) ++j;
    items->push_back({(*ids)[i], static_cast<float>(j - i)});
    i = j;
  }
  // The items are in index order, so a stable sort by count keeps ties so.
  std::stable_sort(items->begin(), items->end(),
                   [](const std::pair<int32_t, float>& a,
                      const std::pair<int32_t, float>& b) {
                     return a.second > b.second;
                   });
  const int m = std::min<int>(k, static_cast<int>(items->size()));
  for (int j = 0; j < m; ++j) {
    idx[j] = (*items)[j].first;
    wgt[j] = (*items)[j].second;
  }
  for (int j = m; j < k; ++j) {
    idx[j] = 0;
    wgt[j] = 0.0f;
  }
  if (normalize) {
    float ss = 0.0f;
    for (int j = 0; j < k; ++j) ss += wgt[j] * wgt[j];
    const float norm = std::sqrt(ss);
    if (norm > 0.0f) {
      for (int j = 0; j < k; ++j) wgt[j] /= norm;
    }
  }
}

// The ids to keep under a cap, sorted ascending: the top `cap` by (count
// desc, id asc), as numpy's stable argsort(-counts)[:cap] over ids in
// ascending order. The ids are distinct, so the order is total and
// nth_element picks the same set as a full sort.
void top_by_count(std::vector<std::pair<int32_t, int64_t>>* id_counts,
                  size_t cap, std::vector<int32_t>* kept) {
  auto cmp = [](const std::pair<int32_t, int64_t>& a,
                const std::pair<int32_t, int64_t>& b) {
    if (a.second != b.second) return a.second > b.second;
    return a.first < b.first;
  };
  const size_t n = std::min(cap, id_counts->size());
  if (id_counts->size() > cap) {
    std::nth_element(id_counts->begin(), id_counts->begin() + cap,
                     id_counts->end(), cmp);
  }
  kept->resize(n);
  for (size_t j = 0; j < n; ++j) (*kept)[j] = (*id_counts)[j].first;
  std::sort(kept->begin(), kept->end());
}

// The nonzero entries of counts, as their ids in ascending order, or the
// top `cap` of them (top_by_count) when there are more.
void select_ids(const std::vector<int64_t>& counts, size_t cap,
                std::vector<int32_t>* kept) {
  size_t live = 0;
  for (int64_t c : counts) live += (c != 0);
  if (live > cap) {
    std::vector<std::pair<int32_t, int64_t>> items;
    items.reserve(live);
    for (size_t i = 0; i < counts.size(); ++i) {
      if (counts[i]) items.push_back({static_cast<int32_t>(i), counts[i]});
    }
    top_by_count(&items, cap, kept);
    return;
  }
  kept->clear();
  kept->reserve(live);
  for (size_t i = 0; i < counts.size(); ++i) {
    if (counts[i]) kept->push_back(static_cast<int32_t>(i));
  }
}

}  // namespace

extern "C" {

int dssm_hash_batch(const char* text, const int64_t* offsets, int64_t n,
                    int64_t vocab, int k, int normalize, int32_t* idx,
                    float* wgt) {
  if (n < 0 || vocab < 2 || k < 0) return kBadShape;
  std::vector<int32_t> ids;
  std::vector<std::pair<int32_t, float>> items;
  for (int64_t i = 0; i < n; ++i) {
    ids.clear();
    for_each_word(text + offsets[i],
                  static_cast<size_t>(offsets[i + 1] - offsets[i]),
                  [&](const char* w, size_t len) {
                    word_trigram_ids(w, len, static_cast<uint64_t>(vocab),
                                     &ids);
                  });
    fixed_from_ids(&ids, k, normalize != 0, &items, idx + i * k, wgt + i * k);
  }
  return kOk;
}

int dssm_hash_batch_sequence(const char* text, const int64_t* offsets,
                             int64_t n, int64_t vocab, int t, int kw,
                             int normalize, int32_t* idx, float* wgt,
                             float* mask) {
  if (n < 0 || vocab < 2 || t < 0 || kw < 0) return kBadShape;
  std::vector<int32_t> ids;
  std::vector<std::pair<int32_t, float>> items;
  for (int64_t i = 0; i < n; ++i) {
    int words = 0;
    for_each_word(text + offsets[i],
                  static_cast<size_t>(offsets[i + 1] - offsets[i]),
                  [&](const char* w, size_t len) {
                    if (words == t) return;  // words past max_words
                    const int64_t slot = i * t + words;
                    ids.clear();
                    word_trigram_ids(w, len, static_cast<uint64_t>(vocab),
                                     &ids);
                    fixed_from_ids(&ids, kw, normalize != 0, &items,
                                   idx + slot * kw, wgt + slot * kw);
                    mask[slot] = 1.0f;
                    ++words;
                  });
    for (int wi = words; wi < t; ++wi) {
      const int64_t slot = i * t + wi;
      std::fill(idx + slot * kw, idx + (slot + 1) * kw, 0);
      std::fill(wgt + slot * kw, wgt + (slot + 1) * kw, 0.0f);
      mask[slot] = 0.0f;
    }
  }
  return kOk;
}

// Two-level dedupe of the lookups a[0, na) then b[0, nb): row groups
// (index >> log2(group)) for the gather, then exact unique compact rows,
// each level keeping its top-count entries when over its cap. Bit-equal
// to data/dedupe.py's numpy version. One thread: the loader's pool builds
// batches side by side. inv2 holds each lookup's compact row (or -1,
// dropped) between the passes, so no scratch is allocated.
int dssm_dedupe_two_level(const int32_t* a, int64_t na, const int32_t* b,
                          int64_t nb, int64_t g_cap_rows, int64_t u2_cap,
                          int32_t group, int32_t* uniq_groups,
                          int32_t* row_sel, int32_t* inv2, float* keep) {
  if (na < 0 || nb < 0 || group <= 0 || (group & (group - 1)) != 0 ||
      g_cap_rows <= 0 || g_cap_rows % group != 0 || u2_cap <= 0) {
    return kBadShape;
  }
  const size_t n = static_cast<size_t>(na + nb);
  const size_t g_cap = static_cast<size_t>(g_cap_rows / group);
  int shift = 0;
  while ((1 << shift) < group) ++shift;
  const int32_t off_mask = group - 1;
  auto at = [=](size_t i) { return i < static_cast<size_t>(na) ? a[i]
                                                              : b[i - na]; };

  // Pass A: the largest and the smallest index, then the group histogram.
  int32_t max_idx = 0, min_idx = 0;
  for (size_t i = 0; i < n; ++i) {
    max_idx = std::max(max_idx, at(i));
    min_idx = std::min(min_idx, at(i));
  }
  if (min_idx < 0) return kNegativeIndex;
  const size_t gspan = static_cast<size_t>(max_idx >> shift) + 1;
  std::vector<int64_t> gcounts(gspan, 0);
  for (size_t i = 0; i < n; ++i) ++gcounts[at(i) >> shift];

  // Level 1: the kept groups, in id order, each at its compact slot.
  std::vector<int32_t> kept_g;
  select_ids(gcounts, g_cap, &kept_g);
  std::vector<int32_t> gslot(gspan, -1);
  for (size_t j = 0; j < kept_g.size(); ++j) {
    gslot[kept_g[j]] = static_cast<int32_t>(j);
    uniq_groups[j] = kept_g[j];
  }
  std::fill(uniq_groups + kept_g.size(), uniq_groups + g_cap,
            kSkipSentinelGid);

  // Pass B: each lookup's compact row (slot * group + offset, or -1 where
  // its group was dropped) into inv2, and the compact rows' histogram.
  std::vector<int64_t> rcounts(static_cast<size_t>(g_cap_rows), 0);
  for (size_t i = 0; i < n; ++i) {
    const int32_t v = at(i);
    const int32_t s = gslot[v >> shift];
    if (s < 0) {
      inv2[i] = -1;
    } else {
      inv2[i] = s * group + (v & off_mask);
      ++rcounts[inv2[i]];
    }
  }

  // Level 2: the kept compact rows, in row order, each at its slot.
  std::vector<int32_t> kept_r;
  select_ids(rcounts, static_cast<size_t>(u2_cap), &kept_r);
  std::vector<int32_t> rslot(static_cast<size_t>(g_cap_rows), -1);
  for (size_t j = 0; j < kept_r.size(); ++j) {
    rslot[kept_r[j]] = static_cast<int32_t>(j);
    row_sel[j] = kept_r[j];
  }
  std::fill(row_sel + kept_r.size(), row_sel + u2_cap, 0);

  // Pass C: each lookup's slot, 0 with keep 0 where either level dropped it.
  for (size_t i = 0; i < n; ++i) {
    const int32_t r = inv2[i];
    const int32_t s = r < 0 ? -1 : rslot[r];
    inv2[i] = s < 0 ? 0 : s;
    keep[i] = s < 0 ? 0.0f : 1.0f;
  }
  return kOk;
}

}  // extern "C"
