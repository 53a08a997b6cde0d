// Host-side entropy coder (copy of pcc_geo_cnn_v2_tpu/native/range_coder.cpp).
//
// Sequential arithmetic coding is not a TPU workload; the reference keeps it
// in tensorflow-compression's C++ range-coder ops
// (reference src/utils/patch_gaussian_conditional.py:27-31 documents the
// contract: per-element CDF-row indexes, quantized int32 CDFs with
// 16-bit precision, unbounded symbols via an overflow escape with
// overflow_width-bit chunks). This is a from-scratch implementation of that
// capability as a 64-bit rANS coder:
//
// - state: uint64, renormalized in 32-bit words, lower bound 2^31
// - regular symbols: bucket b = symbol - offset[row] coded against the row's
//   quantized CDF (cdf[row][b] .. cdf[row][b+1], total 2^precision)
// - out-of-range symbols: escape bucket (last bucket of the row), then the
//   zigzagged overflow magnitude in (overflow_width+1)-bit units
//   (low bits = chunk, top bit = continuation), uniform-coded
// - stream layout: 8-byte little-endian final state, then 32-bit words in
//   decode order
//
// Self-consistency (encode->decode identity) is the contract; the bitstream
// is not byte-compatible with tfc (models are retrained anyway).
//
// Build: g++ -O3 -shared -fPIC -o librange_coder.so range_coder.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint64_t kRansL = 1ull << 31;  // normalized interval lower bound

struct Event {  // one rANS coding event (start/freq over 2^bits)
  uint32_t start;
  uint32_t freq;
  uint32_t bits;
};

inline void rans_enc(uint64_t& x, std::vector<uint32_t>& words,
                     uint32_t start, uint32_t freq, uint32_t bits) {
  // renormalize so the new state stays in [kRansL, kRansL * 2^32)
  const uint64_t x_max = ((kRansL >> bits) << 32) * freq;
  while (x >= x_max) {
    words.push_back(static_cast<uint32_t>(x));
    x >>= 32;
  }
  x = ((x / freq) << bits) + (x % freq) + start;
}

struct RansDec {
  uint64_t x;
  const uint8_t* words;  // the stream's 32-bit words, little endian
  int64_t n_words;
  int64_t pos;  // next word to read

  inline uint32_t peek(uint32_t bits) const {
    return static_cast<uint32_t>(x & ((1ull << bits) - 1));
  }
  inline bool advance(uint32_t start, uint32_t freq, uint32_t bits) {
    x = freq * (x >> bits) + peek(bits) - start;
    while (x < kRansL) {
      if (pos >= n_words) return false;
      uint32_t w;
      std::memcpy(&w, words + 4 * pos++, 4);
      x = (x << 32) | w;
    }
    return true;
  }
};

// Map an out-of-range bucket to its escape payload (zigzag + side).
inline uint64_t overflow_value(int64_t bucket, int64_t num_regular) {
  if (bucket < 0) return (static_cast<uint64_t>(-bucket - 1) << 1);
  return (static_cast<uint64_t>(bucket - num_regular) << 1) | 1u;
}

inline int64_t overflow_bucket(uint64_t v, int64_t num_regular) {
  if (v & 1u) return num_regular + static_cast<int64_t>(v >> 1);
  return -static_cast<int64_t>(v >> 1) - 1;
}

// Single-stream encode core. Scratch vectors are thread_local so batch
// callers pay one allocation per thread, not one per stream.
static int64_t rc_encode_impl(const int32_t* symbols, const int32_t* indexes,
                              int64_t n, const int32_t* cdf,
                              int64_t cdf_stride, const int32_t* cdf_length,
                              const int32_t* offset, int32_t precision,
                              int32_t overflow_width, uint8_t* out,
                              int64_t out_capacity) {
  const uint32_t w = static_cast<uint32_t>(overflow_width);
  const uint32_t unit_bits = w + 1;
  const uint32_t cont_flag = 1u << w;

  static thread_local std::vector<Event> events;
  events.clear();
  events.reserve(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    const int32_t row = indexes[i];
    const int32_t* c = cdf + row * cdf_stride;
    const int64_t len = cdf_length[row];     // entries in this row
    const int64_t num_regular = len - 2;     // regular buckets
    const int64_t escape = num_regular;      // escape bucket index
    int64_t b = static_cast<int64_t>(symbols[i]) - offset[row];
    if (b < 0 || b >= num_regular) {
      const uint64_t v = overflow_value(b, num_regular);
      events.push_back({static_cast<uint32_t>(c[escape]),
                        static_cast<uint32_t>(c[escape + 1] - c[escape]),
                        static_cast<uint32_t>(precision)});
      // variable-length units, least-significant chunk first
      uint64_t rest = v;
      do {
        uint32_t unit = static_cast<uint32_t>(rest & (cont_flag - 1));
        rest >>= w;
        if (rest) unit |= cont_flag;
        events.push_back({unit, 1u, unit_bits});
      } while (rest);
    } else {
      events.push_back({static_cast<uint32_t>(c[b]),
                        static_cast<uint32_t>(c[b + 1] - c[b]),
                        static_cast<uint32_t>(precision)});
    }
  }

  uint64_t x = kRansL;
  static thread_local std::vector<uint32_t> words;
  words.clear();
  words.reserve(events.size() / 2 + 4);
  for (auto it = events.rbegin(); it != events.rend(); ++it) {
    rans_enc(x, words, it->start, it->freq, it->bits);
  }

  const int64_t total =
      8 + static_cast<int64_t>(words.size()) * 4;
  if (total > out_capacity) return -1;
  std::memcpy(out, &x, 8);
  uint8_t* p = out + 8;
  for (auto it = words.rbegin(); it != words.rend(); ++it) {
    std::memcpy(p, &(*it), 4);
    p += 4;
  }
  return total;
}

}  // namespace

extern "C" {

// Returns bytes written, or -1 on overflow of out_capacity / bad args.
int64_t pcc_rc_encode(const int32_t* symbols, const int32_t* indexes,
                      int64_t n, const int32_t* cdf, int64_t cdf_stride,
                      const int32_t* cdf_length, const int32_t* offset,
                      int32_t precision, int32_t overflow_width,
                      uint8_t* out, int64_t out_capacity) {
  return rc_encode_impl(symbols, indexes, n, cdf, cdf_stride, cdf_length,
                        offset, precision, overflow_width, out, out_capacity);
}

// Batch encode of ``n_streams`` independent equal-length streams in ONE
// foreign call (the bench host has a single core: the win is dropping
// per-stream Python/ctypes overhead and holding the GIL released for the
// whole batch, not parallelism). ``symbols`` is [n_streams * stream_len];
// ``indexes`` is one shared row of ``stream_len`` entries when
// ``shared_indexes`` is nonzero, else [n_streams * stream_len]. Streams
// are written back-to-back into ``out``; ``out_offsets`` (n_streams + 1
// entries) receives the byte offsets. Each stream is byte-identical to a
// pcc_rc_encode call on the same row. Returns total bytes, or -1 on
// capacity overflow.
int64_t pcc_rc_encode_batch(const int32_t* symbols, const int32_t* indexes,
                            int32_t shared_indexes, int64_t n_streams,
                            int64_t stream_len, const int32_t* cdf,
                            int64_t cdf_stride, const int32_t* cdf_length,
                            const int32_t* offset, int32_t precision,
                            int32_t overflow_width, uint8_t* out,
                            int64_t out_capacity, int64_t* out_offsets) {
  int64_t pos = 0;
  out_offsets[0] = 0;
  for (int64_t s = 0; s < n_streams; ++s) {
    const int32_t* idx =
        shared_indexes ? indexes : indexes + s * stream_len;
    const int64_t nb = rc_encode_impl(
        symbols + s * stream_len, idx, stream_len, cdf, cdf_stride,
        cdf_length, offset, precision, overflow_width, out + pos,
        out_capacity - pos);
    if (nb < 0) return -1;
    pos += nb;
    out_offsets[s + 1] = pos;
  }
  return pos;
}

}  // extern "C"

namespace {

// Decode the next n symbols of one stream from ``dec``'s state.
// Returns 0 on success, -1 on a malformed stream. When ``lut`` is
// non-null it maps (row, slot) -> bucket directly (slot->bucket lookup
// table of stride 2^precision, built host-side from the same CDF), so
// the per-symbol CDF binary search (~9 cache-missing probes) becomes
// one load — ~3x decode throughput on the y-symbol streams.
static int64_t rc_decode_symbols(RansDec& dec, const int32_t* indexes,
                                 int64_t n, const int32_t* cdf,
                                 int64_t cdf_stride,
                                 const int32_t* cdf_length,
                                 const int32_t* offset, int32_t precision,
                                 int32_t overflow_width,
                                 const uint16_t* lut, int32_t* symbols_out) {
  const uint32_t w = static_cast<uint32_t>(overflow_width);
  const uint32_t unit_bits = w + 1;
  const uint32_t cont_flag = 1u << w;

  for (int64_t i = 0; i < n; ++i) {
    const int32_t row = indexes[i];
    const int32_t* c = cdf + row * cdf_stride;
    const int64_t len = cdf_length[row];
    const int64_t num_regular = len - 2;
    const uint32_t slot = dec.peek(static_cast<uint32_t>(precision));
    int64_t b;
    if (lut) {
      b = lut[(static_cast<int64_t>(row) << precision) + slot];
    } else {
      // binary search: largest b with c[b] <= slot
      int64_t lo = 0, hi = len - 1;
      while (hi - lo > 1) {
        const int64_t mid = (lo + hi) >> 1;
        if (static_cast<uint32_t>(c[mid]) <= slot) lo = mid;
        else hi = mid;
      }
      b = lo;
    }
    if (!dec.advance(static_cast<uint32_t>(c[b]),
                     static_cast<uint32_t>(c[b + 1] - c[b]),
                     static_cast<uint32_t>(precision)))
      return -1;
    int64_t bucket = b;
    if (b == num_regular) {  // escape: read overflow units
      uint64_t v = 0;
      uint32_t shift = 0;
      while (true) {
        const uint32_t unit = dec.peek(unit_bits);
        if (!dec.advance(unit, 1u, unit_bits)) return -1;
        v |= static_cast<uint64_t>(unit & (cont_flag - 1)) << shift;
        shift += w;
        if (!(unit & cont_flag)) break;
        if (shift > 62) return -1;
      }
      bucket = overflow_bucket(v, num_regular);
    }
    symbols_out[i] = static_cast<int32_t>(bucket + offset[row]);
  }
  return 0;
}

// A stream's initial decoder state: its 8-byte final encoder state, then
// its words. False when the length cannot be a stream's.
static bool rc_decode_begin(const uint8_t* in, int64_t in_len,
                            RansDec& dec) {
  if (in_len < 8 || (in_len - 8) % 4 != 0) return false;
  std::memcpy(&dec.x, in, 8);
  dec.words = in + 8;
  dec.n_words = (in_len - 8) / 4;
  dec.pos = 0;
  return true;
}

static int64_t rc_decode_impl(const uint8_t* in, int64_t in_len,
                              const int32_t* indexes, int64_t n,
                              const int32_t* cdf, int64_t cdf_stride,
                              const int32_t* cdf_length,
                              const int32_t* offset, int32_t precision,
                              int32_t overflow_width,
                              const uint16_t* lut, int32_t* symbols_out) {
  RansDec dec;
  if (!rc_decode_begin(in, in_len, dec)) return -1;
  return rc_decode_symbols(dec, indexes, n, cdf, cdf_stride, cdf_length,
                           offset, precision, overflow_width, lut,
                           symbols_out);
}

}  // namespace

extern "C" {

int64_t pcc_rc_decode(const uint8_t* in, int64_t in_len,
                      const int32_t* indexes, int64_t n, const int32_t* cdf,
                      int64_t cdf_stride, const int32_t* cdf_length,
                      const int32_t* offset, int32_t precision,
                      int32_t overflow_width, int32_t* symbols_out) {
  return rc_decode_impl(in, in_len, indexes, n, cdf, cdf_stride, cdf_length,
                        offset, precision, overflow_width, nullptr,
                        symbols_out);
}

int64_t pcc_rc_decode_lut(const uint8_t* in, int64_t in_len,
                          const int32_t* indexes, int64_t n,
                          const int32_t* cdf, int64_t cdf_stride,
                          const int32_t* cdf_length, const int32_t* offset,
                          int32_t precision, int32_t overflow_width,
                          const uint16_t* lut, int32_t* symbols_out) {
  return rc_decode_impl(in, in_len, indexes, n, cdf, cdf_stride, cdf_length,
                        offset, precision, overflow_width, lut, symbols_out);
}

// Batch decode of ``n_streams`` equal-length streams stored back-to-back
// in ``data`` at ``data_offsets`` (n_streams + 1 byte offsets) — the
// inverse of pcc_rc_encode_batch, in ONE foreign call. ``indexes`` is one
// shared row when ``shared_indexes`` is nonzero, else per-stream rows.
// ``symbols_out`` receives [n_streams * stream_len] int32. Returns 0, or
// -1 on any malformed stream.
int64_t pcc_rc_decode_lut_batch(
    const uint8_t* data, const int64_t* data_offsets, const int32_t* indexes,
    int32_t shared_indexes, int64_t n_streams, int64_t stream_len,
    const int32_t* cdf, int64_t cdf_stride, const int32_t* cdf_length,
    const int32_t* offset, int32_t precision, int32_t overflow_width,
    const uint16_t* lut, int32_t* symbols_out) {
  for (int64_t s = 0; s < n_streams; ++s) {
    const int32_t* idx =
        shared_indexes ? indexes : indexes + s * stream_len;
    const int64_t rc = rc_decode_impl(
        data + data_offsets[s], data_offsets[s + 1] - data_offsets[s], idx,
        stream_len, cdf, cdf_stride, cdf_length, offset, precision,
        overflow_width, lut, symbols_out + s * stream_len);
    if (rc != 0) return -1;
  }
  return 0;
}

// Resumable batch decode: the streams of pcc_rc_decode_lut_batch decoded
// in consecutive parts, each stream's decoder state (``state_x``, and
// ``state_pos``: the next 32-bit word) kept by the caller between calls.
// pcc_rc_decode_resume_begin sets the states of ``n_streams`` streams
// (returns -1 when a length cannot be a stream's); each
// pcc_rc_decode_lut_resume call then decodes the next ``stream_len``
// symbols of every stream against its rows of ``indexes`` (one shared row
// when ``shared_indexes`` is nonzero) and advances the states. The parts
// of one stream, decoded in turn, are the symbols a one-shot decode gives.
int64_t pcc_rc_decode_resume_begin(const uint8_t* data,
                                   const int64_t* data_offsets,
                                   int64_t n_streams, uint64_t* state_x,
                                   int64_t* state_pos) {
  for (int64_t s = 0; s < n_streams; ++s) {
    RansDec dec;
    if (!rc_decode_begin(data + data_offsets[s],
                         data_offsets[s + 1] - data_offsets[s], dec))
      return -1;
    state_x[s] = dec.x;
    state_pos[s] = 0;
  }
  return 0;
}

int64_t pcc_rc_decode_lut_resume(
    const uint8_t* data, const int64_t* data_offsets, uint64_t* state_x,
    int64_t* state_pos, const int32_t* indexes, int32_t shared_indexes,
    int64_t n_streams, int64_t stream_len, const int32_t* cdf,
    int64_t cdf_stride, const int32_t* cdf_length, const int32_t* offset,
    int32_t precision, int32_t overflow_width, const uint16_t* lut,
    int32_t* symbols_out) {
  for (int64_t s = 0; s < n_streams; ++s) {
    RansDec dec;
    if (!rc_decode_begin(data + data_offsets[s],
                         data_offsets[s + 1] - data_offsets[s], dec))
      return -1;
    dec.x = state_x[s];
    dec.pos = state_pos[s];
    const int32_t* idx =
        shared_indexes ? indexes : indexes + s * stream_len;
    const int64_t rc = rc_decode_symbols(
        dec, idx, stream_len, cdf, cdf_stride, cdf_length, offset,
        precision, overflow_width, lut, symbols_out + s * stream_len);
    if (rc != 0) return -1;
    state_x[s] = dec.x;
    state_pos[s] = dec.pos;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Context-adaptive binary range coder (for the builtin octree anchor).
//
// G-PCC's octree geometry mode codes child-occupancy bits with a
// context-adaptive binary arithmetic coder (the reference invokes the real
// tmc3 binary for this, its src/mp_run.py:33-41). This is the same coder
// family: an LZMA-style binary range coder (12-bit adaptive
// probabilities, shift-5 update, byte renormalization with carry cache).
// Encoder and decoder adapt identically, so no tables are transmitted.
// Probabilities live in the handle; the decoder is stateful because octree
// contexts depend on previously decoded planes/levels (the caller
// interleaves vectorized context computation with per-plane decode calls).
// ---------------------------------------------------------------------------

namespace {

constexpr uint32_t kProbBits = 12;
constexpr uint16_t kProbInit = 1u << (kProbBits - 1);
constexpr uint32_t kMoveBits = 5;
constexpr uint32_t kTopValue = 1u << 24;

struct BinEnc {
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  int64_t cache_size = 1;
  std::vector<uint8_t> out;

  inline void shift_low() {
    if (static_cast<uint32_t>(low) < 0xFF000000u || (low >> 32) != 0) {
      uint8_t carry = static_cast<uint8_t>(low >> 32);
      uint8_t temp = cache;
      do {
        out.push_back(static_cast<uint8_t>(temp + carry));
        temp = 0xFF;
      } while (--cache_size);
      cache = static_cast<uint8_t>(low >> 24);
    }
    ++cache_size;
    low = (low << 8) & 0xFFFFFFFFu;
  }

  inline void encode(uint16_t* p, uint32_t bit) {
    const uint32_t bound = (range >> kProbBits) * (*p);
    if (!bit) {
      range = bound;
      *p += (static_cast<uint16_t>(1u << kProbBits) - *p) >> kMoveBits;
    } else {
      low += bound;
      range -= bound;
      *p -= *p >> kMoveBits;
    }
    while (range < kTopValue) {
      shift_low();
      range <<= 8;
    }
  }

  inline void flush() {
    for (int i = 0; i < 5; ++i) shift_low();
  }
};

struct BinDec {
  const uint8_t* in;
  int64_t in_len;
  int64_t pos = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;
  std::vector<uint16_t> probs;

  inline uint8_t next_byte() { return pos < in_len ? in[pos++] : 0; }

  void init() {
    next_byte();  // first emitted byte is always 0 (cache priming)
    for (int i = 0; i < 4; ++i) code = (code << 8) | next_byte();
  }

  inline uint32_t decode(uint16_t* p) {
    const uint32_t bound = (range >> kProbBits) * (*p);
    uint32_t bit;
    if (code < bound) {
      range = bound;
      *p += (static_cast<uint16_t>(1u << kProbBits) - *p) >> kMoveBits;
      bit = 0;
    } else {
      code -= bound;
      range -= bound;
      *p -= *p >> kMoveBits;
      bit = 1;
    }
    while (range < kTopValue) {
      range <<= 8;
      code = (code << 8) | next_byte();
    }
    return bit;
  }
};

}  // namespace

extern "C" {

// One-shot contextual encode of n bits; returns bytes written or -1 if
// out_capacity is too small / a context id is out of range.
int64_t pcc_abc_encode(const uint8_t* bits, const int32_t* ctxs, int64_t n,
                       int64_t n_ctx, uint8_t* out, int64_t out_capacity) {
  std::vector<uint16_t> probs(static_cast<size_t>(n_ctx), kProbInit);
  BinEnc enc;
  enc.out.reserve(static_cast<size_t>(n / 4 + 16));
  for (int64_t i = 0; i < n; ++i) {
    const int32_t c = ctxs[i];
    if (c < 0 || c >= n_ctx) return -1;
    enc.encode(&probs[c], bits[i] & 1u);
  }
  enc.flush();
  if (static_cast<int64_t>(enc.out.size()) > out_capacity) return -1;
  std::memcpy(out, enc.out.data(), enc.out.size());
  return static_cast<int64_t>(enc.out.size());
}

// Stateful decoder: contexts for later planes depend on decoded bits.
void* pcc_abc_dec_new(const uint8_t* in, int64_t in_len, int64_t n_ctx) {
  BinDec* d = new BinDec();
  d->in = in;
  d->in_len = in_len;
  d->probs.assign(static_cast<size_t>(n_ctx), kProbInit);
  d->init();
  return d;
}

int64_t pcc_abc_dec_bits(void* handle, const int32_t* ctxs, int64_t n,
                         uint8_t* bits_out) {
  BinDec* d = static_cast<BinDec*>(handle);
  const int64_t n_ctx = static_cast<int64_t>(d->probs.size());
  for (int64_t i = 0; i < n; ++i) {
    const int32_t c = ctxs[i];
    if (c < 0 || c >= n_ctx) return -1;
    bits_out[i] = static_cast<uint8_t>(d->decode(&d->probs[c]));
  }
  return 0;
}

void pcc_abc_dec_free(void* handle) { delete static_cast<BinDec*>(handle); }

}  // extern "C"
