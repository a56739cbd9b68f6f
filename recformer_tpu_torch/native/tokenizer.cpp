// Native corpus tokenizer for the hash (SimpleVocab) text backend (the port's
// copy of recformer_tpu/native/tokenizer.cpp).
//
// Reproduces data/vocab.py::SimpleVocab.tokenize_text +
// data/tokenization.py::RecformerTokenizer.encode_item bit-for-bit for
// ASCII corpora (the Python wrapper falls back for non-ASCII, where
// byte-chunking and char-chunking diverge): whitespace-split words, fixed
// `chunk`-char pieces, id = reserved + le32(md5(piece)[:4]) % (vocab-1 -
// reserved); per attribute, name tokens (type 1) then value tokens (type 2),
// truncated to max_attr_length; at most max_attr_num attributes per item.
//
// The Python loop this replaces is the corpus-preprocessing hot path (the
// reference gets the equivalent from HF's native 'tokenizers'); output feeds
// pack_item_table_native (batcher.cpp) unchanged.

#include <cstdint>
#include <cstring>

namespace {

// ---------------------------------------------------------------------------
// MD5 (RFC 1321) — single-buffer implementation, enough for <=chunk-byte keys
// ---------------------------------------------------------------------------

struct Md5 {
  uint32_t a0 = 0x67452301, b0 = 0xefcdab89, c0 = 0x98badcfe, d0 = 0x10325476;

  static uint32_t rotl(uint32_t x, int c) { return (x << c) | (x >> (32 - c)); }

  void block(const uint8_t* p) {
    static const uint32_t K[64] = {
        0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
        0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
        0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
        0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
        0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
        0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
        0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
        0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
        0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
        0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
        0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};
    static const int S[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                              7, 12, 17, 22, 5, 9,  14, 20, 5, 9,  14, 20,
                              5, 9,  14, 20, 5, 9,  14, 20, 4, 11, 16, 23,
                              4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                              6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21,
                              6, 10, 15, 21};
    uint32_t M[16];
    for (int i = 0; i < 16; ++i)
      M[i] = (uint32_t)p[4 * i] | ((uint32_t)p[4 * i + 1] << 8) |
             ((uint32_t)p[4 * i + 2] << 16) | ((uint32_t)p[4 * i + 3] << 24);
    uint32_t A = a0, B = b0, C = c0, D = d0;
    for (int i = 0; i < 64; ++i) {
      uint32_t F;
      int g;
      if (i < 16) {
        F = (B & C) | (~B & D);
        g = i;
      } else if (i < 32) {
        F = (D & B) | (~D & C);
        g = (5 * i + 1) & 15;
      } else if (i < 48) {
        F = B ^ C ^ D;
        g = (3 * i + 5) & 15;
      } else {
        F = C ^ (B | ~D);
        g = (7 * i) & 15;
      }
      F += A + K[i] + M[g];
      A = D;
      D = C;
      C = B;
      B += rotl(F, S[i]);
    }
    a0 += A;
    b0 += B;
    c0 += C;
    d0 += D;
  }

  // digest of a short message (< 56 bytes fits one padded block)
  uint32_t first4_le(const uint8_t* msg, uint64_t len) {
    uint8_t buf[128];
    uint64_t full = len / 64;
    for (uint64_t b = 0; b < full; ++b) block(msg + 64 * b);
    uint64_t rem = len - 64 * full;
    std::memset(buf, 0, sizeof(buf));
    std::memcpy(buf, msg + 64 * full, rem);
    buf[rem] = 0x80;
    uint64_t bits = len * 8;
    uint64_t nblk = (rem + 1 + 8 <= 64) ? 1 : 2;
    std::memcpy(buf + nblk * 64 - 8, &bits, 8);  // little-endian host assumed
    for (uint64_t b = 0; b < nblk; ++b) block(buf + 64 * b);
    return a0;  // md5 digest's first 4 bytes, little-endian == a0
  }
};

// Python's str.split() whitespace in ASCII: also the separators 0x1c-0x1f,
// which the JAX package's copy treats as word characters.
inline bool is_space(uint8_t c) {
  return c == ' ' || (c >= '\t' && c <= '\r') || (c >= 0x1c && c <= 0x1f);
}

struct Emit {
  int32_t* ids;
  int32_t* types;
  int32_t* begin;
  int64_t pos;
  int64_t cap;
};

// tokenize one string; emit up to `budget` tokens of `type`; returns tokens
// emitted (post-truncation). `budget` implements the per-attribute
// max_attr_length truncation ACROSS name+value.
int64_t tokenize_text(const uint8_t* s, int64_t len, int32_t type,
                      int32_t chunk, int32_t lo, int32_t hi, int64_t budget,
                      Emit* out) {
  int64_t emitted = 0;
  int64_t i = 0;
  while (i < len && emitted < budget) {
    while (i < len && is_space(s[i])) ++i;
    int64_t w0 = i;
    while (i < len && !is_space(s[i])) ++i;
    for (int64_t j = w0; j < i && emitted < budget; j += chunk) {
      int64_t plen = (i - j < chunk) ? (i - j) : chunk;
      Md5 md5;
      uint32_t h = md5.first4_le(s + j, (uint64_t)plen);
      if (out->pos >= out->cap) return -1;  // capacity error (caller sizes)
      out->ids[out->pos] = lo + (int32_t)(h % (uint32_t)(hi - lo));
      out->types[out->pos] = type;
      out->begin[out->pos] = (j == w0) ? 1 : 0;
      ++out->pos;
      ++emitted;
    }
  }
  return emitted;
}

}  // namespace

extern "C" {

// Strings are flattened: for item i with attr_counts[i] attributes, the
// strings [name0, value0, name1, value1, ...] occupy consecutive slots of
// (buf, str_offs). Outputs are the ragged corpus arrays ItemTable.build
// consumes (out_offsets has n_items+1 entries). Returns total tokens, or -1
// if out capacity `cap` is insufficient.
int64_t tokenize_corpus_hash(const uint8_t* buf, const int64_t* str_offs,
                             const int32_t* attr_counts, int64_t n_items,
                             int32_t max_attr_num, int32_t max_attr_length,
                             int32_t vocab_size, int32_t reserved,
                             int32_t chunk, int32_t* out_ids,
                             int32_t* out_types, int32_t* out_begin,
                             int64_t cap, int64_t* out_offsets) {
  Emit out{out_ids, out_types, out_begin, 0, cap};
  int32_t lo = reserved, hi = vocab_size - 1;
  int64_t str_idx = 0;
  out_offsets[0] = 0;
  for (int64_t it = 0; it < n_items; ++it) {
    int32_t na = attr_counts[it];
    int32_t use = na < max_attr_num ? na : max_attr_num;
    for (int32_t a = 0; a < na; ++a) {
      const uint8_t* name = buf + str_offs[str_idx];
      int64_t name_len = str_offs[str_idx + 1] - str_offs[str_idx];
      const uint8_t* val = buf + str_offs[str_idx + 1];
      int64_t val_len = str_offs[str_idx + 2] - str_offs[str_idx + 1];
      str_idx += 2;
      if (a >= use) continue;  // truncated attribute: consume strings only
      int64_t got = tokenize_text(name, name_len, 1, chunk, lo, hi,
                                  max_attr_length, &out);
      if (got < 0) return -1;
      got = tokenize_text(val, val_len, 2, chunk, lo, hi,
                          max_attr_length - got, &out);
      if (got < 0) return -1;
    }
    out_offsets[it + 1] = out.pos;
  }
  return out.pos;
}

}  // extern "C"
