// Native entropy-coding primitives for pcgcv2_tpu.
//
// Replaces the reference's torchac C++ arithmetic coder
// (reference entropy_model.py:174,192 usage) with a static-CDF rANS
// coder for bottleneck features, and provides an adaptive binary range coder
// (LZMA-style) used by the octree coordinate codec (the built-in fallback for
// the external MPEG tmc3 binary, ref gpcc.py).
//
// Both coders are host-side: TPU computes the PMF tables; these functions
// only touch CPU byte streams.  Exposed via a plain C ABI for ctypes.
//
// Build: g++ -O2 -shared -fPIC -o libpcgc_coding.so coding.cpp

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// rANS, 16-bit precision, byte renormalization (rans_byte construction).
//
// CDF layout: uint32[C, S+1] per channel, cdf[c][0] == 0,
// cdf[c][S] == 1<<16, strictly increasing (every symbol has freq >= 1).
// Symbol i of the flattened row-major [points, channels] array uses
// channel i % C — matching the reference's per-channel CDF replication
// (entropy_model.py:173).
// ---------------------------------------------------------------------------

static const uint32_t RANS_L = 1u << 23;
static const int PROB_BITS = 16;

long rans_encode(const uint32_t* cdf, int C, int S, const int32_t* syms,
                 long N, uint8_t* out, long cap) {
  uint8_t* ptr = out + cap;
  uint32_t x = RANS_L;
  for (long i = N - 1; i >= 0; --i) {
    const uint32_t* row = cdf + (long)(i % C) * (S + 1);
    int s = syms[i];
    if (s < 0 || s >= S) return -2;
    uint32_t start = row[s];
    uint32_t freq = row[s + 1] - start;
    uint32_t x_max = ((RANS_L >> PROB_BITS) << 8) * freq;
    while (x >= x_max) {
      if (ptr <= out) return -1;
      *--ptr = (uint8_t)(x & 0xff);
      x >>= 8;
    }
    x = ((x / freq) << PROB_BITS) + (x % freq) + start;
  }
  for (int k = 0; k < 4; ++k) {
    if (ptr <= out) return -1;
    *--ptr = (uint8_t)(x & 0xff);
    x >>= 8;
  }
  long n_bytes = (long)((out + cap) - ptr);
  std::memmove(out, ptr, (size_t)n_bytes);
  return n_bytes;
}

long rans_decode(const uint32_t* cdf, int C, int S, const uint8_t* in,
                 long n_in, int32_t* syms, long N) {
  if (n_in < 4) return -1;
  const uint8_t* ptr = in;
  const uint8_t* end = in + n_in;
  uint32_t x = 0;
  for (int k = 0; k < 4; ++k) x = (x << 8) | *ptr++;
  const uint32_t mask = (1u << PROB_BITS) - 1;
  for (long i = 0; i < N; ++i) {
    const uint32_t* row = cdf + (long)(i % C) * (S + 1);
    uint32_t cum = x & mask;
    int lo = 0, hi = S;
    while (hi - lo > 1) {
      int mid = (lo + hi) >> 1;
      if (row[mid] <= cum) lo = mid; else hi = mid;
    }
    uint32_t start = row[lo];
    uint32_t freq = row[lo + 1] - start;
    x = freq * (x >> PROB_BITS) + cum - start;
    while (x < RANS_L) x = (x << 8) | (ptr < end ? *ptr++ : 0);
    syms[i] = lo;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Adaptive binary range coder (carry-handling LZMA construction) coding
// bytes through a per-context bit tree.  Contexts are caller-supplied ids,
// which lets the octree codec condition each occupancy byte on its parent's
// byte while decoding level by level (streaming handles below keep coder
// state across calls).
// ---------------------------------------------------------------------------

static const int KPROB_BITS = 12;
static const uint16_t PROB_INIT = 1 << (KPROB_BITS - 1);
static const int ADAPT_SHIFT = 5;

// Probability models (per context-tree node):
//   mode 0: exponential update, shift 5 (LZMA-style) — legacy streams.
//   mode 1: Krichevsky–Trofimov counts p0 = (2*c0+1)/(2*(c0+c1)+2) —
//           near-optimal for the short streams the octree codec emits
//           (~6k bytes per frame; measured 2.29 -> 1.81 bits/coord on the
//           vox10 bottleneck vs mode 0).
static inline uint16_t kt_p0(uint32_t cc) {
  uint32_t c0 = cc >> 16, c1 = cc & 0xffffu;
  uint32_t p = (uint32_t)((((uint64_t)(2 * c0 + 1)) << KPROB_BITS) /
                          (2 * (c0 + c1) + 2));
  if (p < 1) p = 1;
  if (p > (1u << KPROB_BITS) - 1) p = (1u << KPROB_BITS) - 1;
  return (uint16_t)p;
}

static inline void kt_update(uint32_t* cc, int bit) {
  uint32_t c0 = *cc >> 16, c1 = *cc & 0xffffu;
  if (bit) c1++; else c0++;
  if (c0 + c1 >= 60000u) { c0 >>= 1; c1 >>= 1; }
  *cc = (c0 << 16) | c1;
}

struct AbcEncoder {
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  long cache_size = 1;
  int mode = 0;
  std::vector<uint8_t> bytes;
  std::vector<uint16_t> probs;   // [n_ctx * 256] (mode 0)
  std::vector<uint32_t> counts;  // [n_ctx * 256] packed c0:c1 (mode 1)

  void shift_low() {
    if ((uint32_t)low < 0xFF000000u || (int)(low >> 32) != 0) {
      uint8_t temp = cache;
      do {
        bytes.push_back((uint8_t)(temp + (uint8_t)(low >> 32)));
        temp = 0xFF;
      } while (--cache_size != 0);
      cache = (uint8_t)(low >> 24);
    }
    cache_size++;
    low = ((uint32_t)low) << 8;
  }

  void encode_bit(uint16_t* prob, int bit) {
    uint32_t bound = (range >> KPROB_BITS) * (*prob);
    if (!bit) {
      range = bound;
      *prob = (uint16_t)(*prob + (((1 << KPROB_BITS) - *prob) >> ADAPT_SHIFT));
    } else {
      low += bound;
      range -= bound;
      *prob = (uint16_t)(*prob - (*prob >> ADAPT_SHIFT));
    }
    while (range < (1u << 24)) {
      range <<= 8;
      shift_low();
    }
  }

  void encode_bit_kt(uint32_t* cc, int bit) {
    uint32_t bound = (range >> KPROB_BITS) * kt_p0(*cc);
    if (!bit) {
      range = bound;
    } else {
      low += bound;
      range -= bound;
    }
    kt_update(cc, bit);
    while (range < (1u << 24)) {
      range <<= 8;
      shift_low();
    }
  }
};

struct AbcDecoder {
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;
  const uint8_t* ptr;
  const uint8_t* end;
  int mode = 0;
  std::vector<uint16_t> probs;
  std::vector<uint32_t> counts;

  uint8_t next() { return ptr < end ? *ptr++ : 0; }

  int decode_bit(uint16_t* prob) {
    uint32_t bound = (range >> KPROB_BITS) * (*prob);
    int bit;
    if (code < bound) {
      range = bound;
      *prob = (uint16_t)(*prob + (((1 << KPROB_BITS) - *prob) >> ADAPT_SHIFT));
      bit = 0;
    } else {
      code -= bound;
      range -= bound;
      *prob = (uint16_t)(*prob - (*prob >> ADAPT_SHIFT));
      bit = 1;
    }
    while (range < (1u << 24)) {
      range <<= 8;
      code = (code << 8) | next();
    }
    return bit;
  }

  int decode_bit_kt(uint32_t* cc) {
    uint32_t bound = (range >> KPROB_BITS) * kt_p0(*cc);
    int bit;
    if (code < bound) {
      range = bound;
      bit = 0;
    } else {
      code -= bound;
      range -= bound;
      bit = 1;
    }
    kt_update(cc, bit);
    while (range < (1u << 24)) {
      range <<= 8;
      code = (code << 8) | next();
    }
    return bit;
  }
};

void* abc_enc_new2(int n_ctx, int mode) {
  AbcEncoder* e = new AbcEncoder();
  e->mode = mode;
  if (mode == 1)
    e->counts.assign((size_t)n_ctx * 256, 0);
  else
    e->probs.assign((size_t)n_ctx * 256, PROB_INIT);
  return e;
}

void* abc_enc_new(int n_ctx) { return abc_enc_new2(n_ctx, 0); }

void abc_enc_bytes(void* h, const uint8_t* data, const uint32_t* ctxs, long n) {
  AbcEncoder* e = (AbcEncoder*)h;
  for (long i = 0; i < n; ++i) {
    int m = 1;
    uint8_t b = data[i];
    if (e->mode == 1) {
      uint32_t* tree = e->counts.data() + (size_t)ctxs[i] * 256;
      for (int k = 7; k >= 0; --k) {
        int bit = (b >> k) & 1;
        e->encode_bit_kt(&tree[m], bit);
        m = (m << 1) | bit;
      }
    } else {
      uint16_t* tree = e->probs.data() + (size_t)ctxs[i] * 256;
      for (int k = 7; k >= 0; --k) {
        int bit = (b >> k) & 1;
        e->encode_bit(&tree[m], bit);
        m = (m << 1) | bit;
      }
    }
  }
}

long abc_enc_finish(void* h, uint8_t* out, long cap) {
  AbcEncoder* e = (AbcEncoder*)h;
  for (int i = 0; i < 5; ++i) e->shift_low();
  long n = (long)e->bytes.size();
  if (n > cap) return -1;
  std::memcpy(out, e->bytes.data(), (size_t)n);
  return n;
}

void abc_enc_free(void* h) { delete (AbcEncoder*)h; }

void* abc_dec_new2(const uint8_t* in, long n_in, int n_ctx, int mode) {
  AbcDecoder* d = new AbcDecoder();
  d->ptr = in;
  d->end = in + n_in;
  d->mode = mode;
  if (mode == 1)
    d->counts.assign((size_t)n_ctx * 256, 0);
  else
    d->probs.assign((size_t)n_ctx * 256, PROB_INIT);
  for (int i = 0; i < 5; ++i) d->code = (d->code << 8) | d->next();
  return d;
}

void* abc_dec_new(const uint8_t* in, long n_in, int n_ctx) {
  return abc_dec_new2(in, n_in, n_ctx, 0);
}

void abc_dec_bytes(void* h, const uint32_t* ctxs, long n, uint8_t* out) {
  AbcDecoder* d = (AbcDecoder*)h;
  for (long i = 0; i < n; ++i) {
    int m = 1;
    if (d->mode == 1) {
      uint32_t* tree = d->counts.data() + (size_t)ctxs[i] * 256;
      for (int k = 7; k >= 0; --k) m = (m << 1) | d->decode_bit_kt(&tree[m]);
    } else {
      uint16_t* tree = d->probs.data() + (size_t)ctxs[i] * 256;
      for (int k = 7; k >= 0; --k) m = (m << 1) | d->decode_bit(&tree[m]);
    }
    out[i] = (uint8_t)(m & 0xff);
  }
}

void abc_dec_free(void* h) { delete (AbcDecoder*)h; }

// ---------------------------------------------------------------------------
// Geometric octree occupancy coder (stream v4, "PCO4").
//
// Codes each node's 8 child-occupancy bits individually, in ascending child
// slot order s = dx*4+dy*2+dz, each bit conditioned on the occupancy of its
// three -axis face-adjacent CELLS (G-PCC tmc3's core context idea):
//   * if the child sits on the + side of the node along axis a (da==1) the
//     adjacent cell is sibling s - {4,2,1}[a], already coded this byte;
//   * if da==0 it is child s + {4,2,1}[a] of the -a face-neighbor NODE.
//     A -a face neighbor always has a strictly smaller Morton key (the
//     interleaved key is monotone per coordinate), so its byte is already
//     coded — the caller passes nbr[i][a] = that node's index in this
//     level (or -1), and causality nbr[i][a] < i is guaranteed.
// Each direction is a 3-state (empty / occupied / no-node); with the child
// slot and a "no sibling occupied yet" flag that makes 8*27*2 = 432 KT
// contexts.  The final slot of an all-empty byte is not coded at all: a
// node exists only if it has >= 1 child, so the decoder infers the 1
// (G-PCC's inferred occupancy).  Measured on vox10-class bottleneck
// coords: 1.81 (v2 byte-tree) -> ~1.2 bits/node.
// ---------------------------------------------------------------------------

static const int OCT_NCTX = 8 * 27 * 2 * 4;
static const int OCT_W[3] = {4, 2, 1};

static inline int oct_ctx(int s, const uint8_t* done_byte, const uint8_t* nb,
                          const uint8_t* nb_has, int none_yet, int plus_cnt) {
  // done_byte: bits < s of the current byte; nb[a]: -a neighbor node's byte;
  // nb_has[a]: neighbor exists; plus_cnt: how many +axis face-neighbor
  // NODES exist (their bytes are non-causal, but existence is known from
  // the level-above occupancy — a free surface-orientation signal).
  int st[3];
  for (int a = 0; a < 3; ++a) {
    int w = OCT_W[a];
    if (s & w) {  // + side: sibling cell s - w, already coded
      st[a] = (*done_byte >> (s - w)) & 1;
    } else if (nb_has[a]) {
      st[a] = (nb[a] >> (s + w)) & 1;
    } else {
      st[a] = 2;
    }
  }
  return (((s * 27) + st[0] * 9 + st[1] * 3 + st[2]) * 2 + none_yet) * 4 +
         plus_cnt;
}

void* oct_enc_new() {
  AbcEncoder* e = new AbcEncoder();
  e->mode = 1;
  e->counts.assign(OCT_NCTX, 0);
  return e;
}

void oct_enc_level(void* h, const uint8_t* occ, const int32_t* nbr,
                   const uint8_t* plus_cnt, long n) {
  AbcEncoder* e = (AbcEncoder*)h;
  for (long i = 0; i < n; ++i) {
    uint8_t b = occ[i];
    uint8_t nb[3], nb_has[3];
    for (int a = 0; a < 3; ++a) {
      int32_t j = nbr[i * 3 + a];
      nb_has[a] = j >= 0;
      nb[a] = j >= 0 ? occ[j] : 0;
    }
    uint8_t done = 0;
    for (int s = 0; s < 8; ++s) {
      int none_yet = done == 0;
      int bit = (b >> s) & 1;
      if (s == 7 && none_yet) break;  // inferred: byte must be non-zero
      int c = oct_ctx(s, &done, nb, nb_has, none_yet, plus_cnt[i]);
      e->encode_bit_kt(&e->counts[c], bit);
      done |= (uint8_t)(bit << s);
    }
  }
}

long oct_enc_finish(void* h, uint8_t* out, long cap) {
  return abc_enc_finish(h, out, cap);
}

void oct_enc_free(void* h) { delete (AbcEncoder*)h; }

void* oct_dec_new(const uint8_t* in, long n_in) {
  AbcDecoder* d = new AbcDecoder();
  d->ptr = in;
  d->end = in + n_in;
  d->mode = 1;
  d->counts.assign(OCT_NCTX, 0);
  for (int i = 0; i < 5; ++i) d->code = (d->code << 8) | d->next();
  return d;
}

void oct_dec_level(void* h, const int32_t* nbr, const uint8_t* plus_cnt,
                   long n, uint8_t* occ) {
  AbcDecoder* d = (AbcDecoder*)h;
  for (long i = 0; i < n; ++i) {
    uint8_t nb[3], nb_has[3];
    for (int a = 0; a < 3; ++a) {
      int32_t j = nbr[i * 3 + a];
      nb_has[a] = j >= 0;
      nb[a] = j >= 0 ? occ[j] : 0;
    }
    uint8_t done = 0;
    for (int s = 0; s < 8; ++s) {
      int none_yet = done == 0;
      int bit;
      if (s == 7 && none_yet) {
        bit = 1;  // inferred
      } else {
        int c = oct_ctx(s, &done, nb, nb_has, none_yet, plus_cnt[i]);
        bit = d->decode_bit_kt(&d->counts[c]);
      }
      done |= (uint8_t)(bit << s);
    }
    occ[i] = done;
  }
}

void oct_dec_free(void* h) { delete (AbcDecoder*)h; }

// ---------------------------------------------------------------------------
// Packed-occupancy coordinate extraction (native twin of
// ops/blocks.py::host_extract).  Bits are MSB-first within each byte
// (np.packbits 'big' order); emission order matches the numpy LUT path
// exactly: row-major over blocks, then bytes, then bit position 0..7
// (i.e. bit 7 down to bit 0 of the byte value).
// ---------------------------------------------------------------------------

long popcount_bytes(const uint8_t* bits, long n) {
  long total = 0;
  long i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t w;
    __builtin_memcpy(&w, bits + i, 8);
    total += __builtin_popcountll(w);
  }
  for (; i < n; ++i) total += __builtin_popcount((uint32_t)bits[i]);
  return total;
}

long extract_coords(const int32_t* bcoords, const uint8_t* bits, long nb,
                    long bytes_per_block, int log_bs, int stride,
                    int32_t* out, long cap) {
  const int32_t bs_mask = (1 << log_bs) - 1;
  long n = 0;
  for (long r = 0; r < nb; ++r) {
    const uint8_t* row = bits + r * bytes_per_block;
    const int32_t bx = bcoords[r * 3 + 0] << log_bs;
    const int32_t by = bcoords[r * 3 + 1] << log_bs;
    const int32_t bz = bcoords[r * 3 + 2] << log_bs;
    for (long i = 0; i < bytes_per_block; ++i) {
      uint32_t v = row[i];
      if (!v) continue;
      const long base = i << 3;
      // highest set bit first == bit position p ascending (MSB-first)
      while (v) {
        const int msb = 31 - __builtin_clz(v);
        const long slot = base + (7 - msb);  // 0 .. VOL-1 within block
        if (n >= cap) return -1;  // cap is an exact popcount upstream
        out[n * 3 + 0] = (bx + (int32_t)(slot >> (2 * log_bs))) * stride;
        out[n * 3 + 1] = (by + (((int32_t)(slot >> log_bs)) & bs_mask)) * stride;
        out[n * 3 + 2] = (bz + ((int32_t)slot & bs_mask)) * stride;
        ++n;
        v &= ~(1u << msb);
      }
    }
  }
  return n;
}

}  // extern "C"
