// Fast note-event extraction (host decode hot path).
//
// The port's copy of native/note_extract.cpp, built with the host compiler
// at first use by reconvat_tpu_torch/kernels/_build.py.
// C counterpart of reconvat_tpu_torch/decode.py:
// extract_notes_wo_velocity_plain
// (reference semantics at model/decoding.py:4-55): strict > thresholds,
// rising-edge onsets, rule1/rule2, walk-to-first-inactive offsets.
// Operates on row-major float rolls (T, P); returns packed
// (pitch, onset, offset) int32 triples in row-major onset order.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Load a K-byte packed row into two 64-bit lanes (pitches 0-63, 64-127).
// Little-endian byte order matches the packing contract (bit j of byte k
// = pitch k*8+j).
inline void load_row(const uint8_t* row, int K, uint64_t* lo,
                     uint64_t* hi) {
  uint64_t a = 0, b = 0;
  std::memcpy(&a, row, K < 8 ? K : 8);
  if (K > 8) std::memcpy(&b, row + 8, K - 8);
  *lo = a;
  *hi = b;
}

}  // namespace

extern "C" {

// Returns number of notes. *out is malloc'd [n*3] (pitch, onset, offset).
long long extract_notes(const float* onsets, const float* frames,
                        int T, int P, float onset_threshold,
                        float frame_threshold, int rule1,
                        int32_t** out) {
  std::vector<uint8_t> on((size_t)T * P), fr((size_t)T * P);
  for (size_t i = 0; i < (size_t)T * P; ++i) {
    on[i] = onsets[i] > onset_threshold;
    fr[i] = frames[i] > frame_threshold;
  }

  // next inactive index at or after t, per pitch (backward scan)
  std::vector<int32_t> nz((size_t)(T + 1) * P);
  for (int p = 0; p < P; ++p) nz[(size_t)T * P + p] = T;
  for (int t = T - 1; t >= 0; --t) {
    for (int p = 0; p < P; ++p) {
      bool active = on[(size_t)t * P + p] || fr[(size_t)t * P + p];
      nz[(size_t)t * P + p] =
          active ? nz[(size_t)(t + 1) * P + p] : t;
    }
  }

  std::vector<int32_t> notes;
  for (int t = 0; t < T; ++t) {
    for (int p = 0; p < P; ++p) {
      bool edge = on[(size_t)t * P + p] &&
                  (t == 0 || !on[(size_t)(t - 1) * P + p]);
      if (!edge) continue;
      if (rule1 && !fr[(size_t)t * P + p]) continue;
      int32_t offset = nz[(size_t)t * P + p];
      if (offset > t) {
        notes.push_back(p);
        notes.push_back(t);
        notes.push_back(offset);
      }
    }
  }

  long long n = (long long)(notes.size() / 3);
  *out = (int32_t*)malloc(notes.size() * sizeof(int32_t));
  if (!*out) return -1;
  for (size_t i = 0; i < notes.size(); ++i) (*out)[i] = notes[i];
  return n;
}

void notes_free(int32_t* p) { free(p); }

// Batched decode over bit-packed rolls — the serving hot path.
//
// The device thresholds the posteriogram and packs it to bits
// (models/common.py:pack_roll_device: bit j of byte k at (b, t) = pitch
// k*8+j, little bit order, K = ceil(P/8) bytes per row, matching
// np.unpackbits(..., bitorder="little")). One call decodes the whole
// batch with no per-item Python/ctypes overhead, working on two 64-bit
// lanes per row: rising edges fall out of `on & ~prev_on` word ops and
// the offset walk only touches the ~1-2% active cells of a trained
// transcriber's roll. Same note semantics as extract_notes above
// (reference model/decoding.py:4-55), verified bit-for-bit against the
// numpy plain versions in tests/test_torch_native_decode.py.
//
// onsets/frames may alias (the ReconVAT transcribe path decodes the
// frame roll as both, reference model/self_attention_VAT.py:1309-1312).
//
// Returns total note count across the batch; *out is malloc'd
// [total*3] int32 (pitch, onset, offset) triples grouped by batch item
// in row-major (t, p) onset order; counts[b] = notes in item b.
// Returns -1 on allocation failure, -2 on bad arguments.
long long extract_notes_packed_batch(const uint8_t* onsets,
                                     const uint8_t* frames,
                                     int B, int T, int K, int P,
                                     int rule1, int32_t** out,
                                     int64_t* counts) {
  if (B < 0 || T < 0 || P <= 0 || P > 128 || K != (P + 7) / 8 || !out ||
      !counts)
    return -2;

  std::vector<int32_t> notes;
  notes.reserve((size_t)B * 64 * 3);

  // per-row bit lanes: pitches 0-63 in lane 0, 64-127 in lane 1
  std::vector<uint64_t> on0(T), on1(T), ac0(T), ac1(T);

  // padding bits above P must never read as active
  uint64_t mask0 = (P >= 64) ? ~0ull : ((1ull << P) - 1);
  uint64_t mask1 = (P >= 128) ? ~0ull
                 : (P > 64) ? ((1ull << (P - 64)) - 1) : 0ull;
  bool alias = onsets == frames;

  for (int b = 0; b < B; ++b) {
    const uint8_t* ob = onsets + (size_t)b * T * K;
    const uint8_t* fb = frames + (size_t)b * T * K;
    for (int t = 0; t < T; ++t) {
      uint64_t o0, o1;
      load_row(ob + (size_t)t * K, K, &o0, &o1);
      o0 &= mask0;
      o1 &= mask1;
      on0[t] = o0;
      on1[t] = o1;
      if (alias) {
        ac0[t] = o0;
        ac1[t] = o1;
      } else {
        uint64_t f0, f1;
        load_row(fb + (size_t)t * K, K, &f0, &f1);
        ac0[t] = o0 | (f0 & mask0);
        ac1[t] = o1 | (f1 & mask1);
      }
    }

    size_t start = notes.size();
    uint64_t prev0 = 0, prev1 = 0;
    for (int t = 0; t < T; ++t) {
      uint64_t e0 = on0[t] & ~prev0, e1 = on1[t] & ~prev1;
      if (rule1 && (e0 | e1)) {
        // rule1: the frame channel must be active at the onset
        uint64_t f0, f1;
        load_row(fb + (size_t)t * K, K, &f0, &f1);
        e0 &= f0;
        e1 &= f1;
      }
      prev0 = on0[t]; prev1 = on1[t];
      while (e0 | e1) {
        int p;
        if (e0) {
          p = __builtin_ctzll(e0);
          e0 &= e0 - 1;
        } else {
          p = 64 + __builtin_ctzll(e1);
          e1 &= e1 - 1;
        }
        int tt = t + 1;  // (on|fr) is active at t (onset bit is set)
        if (p < 64) {
          uint64_t bit = 1ull << p;
          while (tt < T && (ac0[tt] & bit)) ++tt;
        } else {
          uint64_t bit = 1ull << (p - 64);
          while (tt < T && (ac1[tt] & bit)) ++tt;
        }
        notes.push_back(p);
        notes.push_back(t);
        notes.push_back(tt);
      }
    }
    counts[b] = (int64_t)((notes.size() - start) / 3);
  }

  long long total = (long long)(notes.size() / 3);
  size_t nbytes = notes.size() ? notes.size() * sizeof(int32_t) : 1;
  *out = (int32_t*)malloc(nbytes);
  if (!*out) return -1;
  for (size_t i = 0; i < notes.size(); ++i) (*out)[i] = notes[i];
  return total;
}

}  // extern "C"
