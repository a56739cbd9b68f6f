// Host-side batch assembly engine (the port's copy of
// recformer_tpu/native/batcher.cpp; the same entry points and results).
//
// The reference assembles every batch in per-example Python loops inside
// torch DataLoader workers (reference/collator.py:71-90 and the
// padding loop at recformer/tokenization.py:109-152). In this framework the
// per-token work already moved on-device; what remains on the host is the
// ragged->dense packing of item-id sequences into (B, S) int32 batches plus
// label/length bookkeeping. This file implements that remaining loop in C++
// with a plain C ABI (loaded via ctypes, no pybind11 dependency), operating
// directly on numpy buffers.
//
// Layout contract: sequences are stored once as a contiguous ragged buffer
// (flat int32 data + int64 row offsets, offsets[0]=0, offsets[n] = total).
// Batches select rows by an order array (shuffled by the caller per epoch).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Pack rows order[start, start+batch) into out_ids (batch, max_len) and
// out_lens (batch). Rows longer than max_len keep their NEWEST (last)
// max_len items — matching newest-first truncation semantics
// (reference/recformer/tokenization.py:70-71: older items are the ones
// dropped). Rows beyond n_rows are zero-filled with length written as 1 and
// valid=0.
void pack_batch(const int32_t* flat, const int64_t* offsets, int64_t n_rows,
                const int64_t* order, int64_t start, int64_t batch,
                int64_t max_len, int32_t* out_ids, int32_t* out_lens,
                uint8_t* out_valid) {
  for (int64_t b = 0; b < batch; ++b) {
    int32_t* row_out = out_ids + b * max_len;
    std::memset(row_out, 0, sizeof(int32_t) * max_len);
    int64_t pos = start + b;
    if (pos >= n_rows) {
      out_lens[b] = 1;
      out_valid[b] = 0;
      continue;
    }
    int64_t row = order[pos];
    int64_t lo = offsets[row], hi = offsets[row + 1];
    int64_t len = hi - lo;
    if (len > max_len) {           // keep newest max_len items
      lo = hi - max_len;
      len = max_len;
    }
    std::memcpy(row_out, flat + lo, sizeof(int32_t) * len);
    out_lens[b] = static_cast<int32_t>(len > 0 ? len : 1);
    out_valid[b] = len > 0 ? 1 : 0;
  }
}

// Fisher-Yates shuffle with a splitmix64-seeded xorshift generator so epochs
// are reproducible across platforms.
static inline uint64_t splitmix64(uint64_t& x) {
  uint64_t z = (x += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

void shuffle_order(int64_t* order, int64_t n, uint64_t seed) {
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  uint64_t s = seed;
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(splitmix64(s) % static_cast<uint64_t>(i + 1));
    std::swap(order[i], order[j]);
  }
}

// Pack a tokenized-item corpus (ragged ids/types/word-begin rows) into the
// dense ItemTable arrays in one pass (replaces the per-item Python loop in
// ItemTable.build for large catalogs).
void pack_item_table(const int32_t* flat_ids, const int32_t* flat_types,
                     const int32_t* flat_begin, const int64_t* offsets,
                     int64_t n_items, int64_t max_item_len, int32_t pad_id,
                     int32_t* out_ids, int32_t* out_types, int32_t* out_begin,
                     int32_t* out_lens) {
  // rows 0..n_items-1 are items; row n_items is the null item
  for (int64_t i = 0; i <= n_items; ++i) {
    int32_t* ids_row = out_ids + i * max_item_len;
    int32_t* types_row = out_types + i * max_item_len;
    int32_t* begin_row = out_begin + i * max_item_len;
    for (int64_t m = 0; m < max_item_len; ++m) {
      ids_row[m] = pad_id;
      types_row[m] = 3;
      begin_row[m] = 0;
    }
    if (i == n_items) {
      out_lens[i] = 0;
      continue;
    }
    int64_t lo = offsets[i], hi = offsets[i + 1];
    int64_t len = std::min(hi - lo, max_item_len);
    std::memcpy(ids_row, flat_ids + lo, sizeof(int32_t) * len);
    std::memcpy(types_row, flat_types + lo, sizeof(int32_t) * len);
    std::memcpy(begin_row, flat_begin + lo, sizeof(int32_t) * len);
    out_lens[i] = static_cast<int32_t>(len);
  }
}

}  // extern "C"
