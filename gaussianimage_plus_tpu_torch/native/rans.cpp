// rANS entropy coder (the port's own copy of gaussianimage_plus_tpu/native/rans.cpp)
// — native replacement for the constriction wheel the
// reference uses for its ANS bitstreams (utils.py:61-110). Implements the
// same two entropy models the reference exercises:
//   * categorical over an explicit probability table
//     (compress_matrix_flatten_categorical, utils.py:61-77)
//   * quantized Gaussian over an integer support
//     (compress_matrix_flatten_gaussian_global, utils.py:94-110)
// 32-bit-state streaming rANS with 16-bit renormalization, 16-bit
// probability quantization. Encoding runs in reverse (stack order) so decode
// is forward — matching constriction's AnsCoder.encode_reverse/decode.
//
// C ABI for ctypes:
//   rans_encode(symbols, n, freqs, num_symbols, out_words, out_capacity)
//     -> number of u16 words written (or -1 if capacity too small)
//   rans_decode(words, num_words, freqs, num_symbols, out_symbols, n)
//     -> 0 on success; the stream is 16-bit words
// Frequencies are uint32 counts; the coder normalizes them to 1<<16 itself
// (deterministically), so encoder and decoder only need the same counts.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 16;  // lower bound of the state interval

// Deterministic frequency normalization to kProbScale, guaranteeing every
// nonzero count keeps a nonzero slot.
void normalize_freqs(const uint32_t* counts, int num_symbols,
                     std::vector<uint32_t>& freq,
                     std::vector<uint32_t>& cum) {
  uint64_t total = 0;
  for (int i = 0; i < num_symbols; ++i) total += counts[i];
  freq.assign(num_symbols, 0);
  if (total == 0) return;
  uint64_t assigned = 0;
  int last_nz = -1;
  for (int i = 0; i < num_symbols; ++i) {
    if (counts[i] == 0) continue;
    uint64_t f = (static_cast<uint64_t>(counts[i]) * kProbScale) / total;
    if (f == 0) f = 1;
    freq[i] = static_cast<uint32_t>(f);
    assigned += f;
    last_nz = i;
  }
  // fix rounding drift on the largest symbol (or steal from any with slack)
  if (last_nz >= 0) {
    int64_t drift = static_cast<int64_t>(kProbScale) - static_cast<int64_t>(assigned);
    if (drift != 0) {
      // give/take drift on the most frequent symbol with enough mass
      int big = last_nz;
      for (int i = 0; i < num_symbols; ++i)
        if (freq[i] > freq[big]) big = i;
      int64_t nf = static_cast<int64_t>(freq[big]) + drift;
      if (nf < 1) return;  // degenerate; caller's data has too many symbols
      freq[big] = static_cast<uint32_t>(nf);
    }
  }
  cum.assign(num_symbols + 1, 0);
  for (int i = 0; i < num_symbols; ++i) cum[i + 1] = cum[i] + freq[i];
}

}  // namespace

extern "C" {

// Returns number of u32 words written, or -1 on error.
long rans_encode(const int32_t* symbols, long n, const uint32_t* counts,
                 int num_symbols, uint16_t* out_words, long out_capacity) {
  std::vector<uint32_t> freq, cum;
  normalize_freqs(counts, num_symbols, freq, cum);
  if (cum.empty()) return -1;

  std::vector<uint16_t> words;
  words.reserve(n + 4);
  uint32_t state = kRansL;
  // encode in reverse so the decoder reads forward
  for (long j = n - 1; j >= 0; --j) {
    int32_t s = symbols[j];
    if (s < 0 || s >= num_symbols || freq[s] == 0) return -1;
    uint32_t f = freq[s];
    // renormalize: keep state < ((kRansL >> kProbBits) << 16) * f
    // (u64 guard: f can reach kProbScale for a 1-symbol alphabet)
    uint64_t x_max = (static_cast<uint64_t>(kRansL >> kProbBits) << 16) * f;
    while (state >= x_max) {
      words.push_back(state & 0xffffu);
      state >>= 16;
    }
    state = ((state / f) << kProbBits) + (state % f) + cum[s];
  }
  // flush state (2 words)
  words.push_back(state & 0xffffu);
  words.push_back(state >> 16);

  long total = static_cast<long>(words.size());
  if (total > out_capacity) return -1;
  // reverse so decode streams forward
  for (long i = 0; i < total; ++i) out_words[i] = words[total - 1 - i];
  return total;
}

int rans_decode(const uint16_t* words, long num_words, const uint32_t* counts,
                int num_symbols, int32_t* out_symbols, long n) {
  std::vector<uint32_t> freq, cum;
  normalize_freqs(counts, num_symbols, freq, cum);
  if (cum.empty()) return 1;
  // symbol lookup table (kProbScale entries) for O(1) decode
  std::vector<int32_t> lut(kProbScale);
  for (int s = 0; s < num_symbols; ++s)
    for (uint32_t k = cum[s]; k < cum[s + 1]; ++k) lut[k] = s;

  long pos = 0;
  if (num_words < 2) return 1;
  uint32_t state = (static_cast<uint32_t>(words[pos]) << 16) | words[pos + 1];
  pos += 2;
  for (long j = 0; j < n; ++j) {
    uint32_t slot = state & (kProbScale - 1);
    int32_t s = lut[slot];
    out_symbols[j] = s;
    state = freq[s] * (state >> kProbBits) + slot - cum[s];
    while (state < kRansL && pos < num_words) {
      state = (state << 16) | words[pos++];
    }
  }
  return 0;
}

}  // extern "C"
