// tpuzlib native runtime kernels (host side).
//
// The accelerator owns the data-parallel compute path (kernels/*.py); these C++
// routines are the native runtime components around it — the serial
// bitstream hot loops that a CPU does best:
//   * tz_inflate_raw: raw-DEFLATE decode (pass-1+2 fused serial loop),
//     capability parity with reference src/infcodes.ts inflate_fast +
//     src/infblocks.ts block FSM, rebuilt around a 64-bit bit buffer and
//     flat 15-bit LUTs.
//   * tz_deflate_tokenize: hash-chain LZ77 match search + greedy/lazy
//     parse emitting a token tape, capability parity with reference
//     src/deflate.ts longest_match/deflate_slow.
//
// Build: g++ -O3 -shared -fPIC (see build.py).  Exposed via ctypes; all
// functions are GIL-free so Python threads parallelize across chunks.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

namespace {

constexpr int MAX_BITS = 15;
constexpr int LUT_SIZE = 1 << MAX_BITS;
constexpr uint32_t F_LEN = 1u << 23;
constexpr uint32_t F_EOB = 1u << 24;
constexpr uint32_t F_INVALID = 1u << 31;

const int32_t LENGTH_BASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,
                                 35,43,51,59,67,83,99,115,131,163,195,227,258};
const int32_t LENGTH_EXTRA[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,
                                  4,4,4,4,5,5,5,5,0};
const int32_t DIST_BASE[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,
                               257,385,513,769,1025,1537,2049,3073,4097,6145,
                               8193,12289,16385,24577};
const int32_t DIST_EXTRA[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,9,9,
                                10,10,11,11,12,12,13,13};
const int CLC_ORDER[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,1,15};

struct BitIn {
  const uint8_t* data;
  int64_t nbits;
  int64_t pos;
  bool ok;
  BitIn(const uint8_t* d, int64_t bits, int64_t start)
      : data(d), nbits(bits), pos(start), ok(true) {}
  inline uint64_t peek64() const {
    int64_t byte = pos >> 3;
    uint64_t w = 0;
    // safe unaligned little-endian load with tail clamp
    int64_t avail_bytes = ((nbits + 7) >> 3) - byte;
    if (avail_bytes >= 8) {
      memcpy(&w, data + byte, 8);
    } else if (avail_bytes > 0) {
      memcpy(&w, data + byte, (size_t)avail_bytes);
    }
    return w >> (pos & 7);
  }
  inline uint32_t bits(int n) {
    if (pos + n > nbits) { ok = false; return 0; }
    uint32_t v = (uint32_t)(peek64() & ((1u << n) - 1));
    pos += n;
    return v;
  }
  inline void align() { pos = (pos + 7) & ~7LL; }
};

// canonical-Huffman flat LUT build; kind 0=litlen 1=dist 2=codelen
// returns 0 ok, 1 oversubscribed, 2 incomplete.  The table is sized to the
// longest code actually present (*out_bits entries of 2^bits) so typical
// dynamic tables stay L1/L2-resident instead of a fixed 128 KiB.
int build_lut(const int32_t* lengths, int nsym, int kind, uint32_t* lut,
              int* out_bits) {
  int32_t counts[MAX_BITS + 1] = {0};
  int ncodes = 0;
  int max_len = 0;
  for (int s = 0; s < nsym; s++) {
    if (lengths[s] < 0 || lengths[s] > MAX_BITS) return 1;
    if (lengths[s] > 0) {
      counts[lengths[s]]++;
      ncodes++;
      if (lengths[s] > max_len) max_len = lengths[s];
    }
  }
  if (max_len == 0) max_len = 1;
  int lut_size = 1 << max_len;
  *out_bits = max_len;
  for (int i = 0; i < lut_size; i++) lut[i] = F_INVALID;
  if (ncodes == 0) return kind == 1 ? 0 : 2;
  int64_t kraft = 0;
  for (int b = 1; b <= MAX_BITS; b++) kraft += (int64_t)counts[b] << (MAX_BITS - b);
  if (kraft > LUT_SIZE) return 1;
  if (kraft < LUT_SIZE && !(ncodes == 1 && kind != 2)) return 2;
  uint32_t next_code[MAX_BITS + 2] = {0};
  uint32_t code = 0;
  for (int b = 1; b <= MAX_BITS; b++) {
    code = (code + counts[b - 1]) << 1;
    next_code[b] = code;
  }
  for (int s = 0; s < nsym; s++) {
    int l = lengths[s];
    if (l == 0) continue;
    uint32_t c = next_code[l]++;
    // bit-reverse l bits
    uint32_t rev = 0;
    for (int b = 0; b < l; b++) { rev = (rev << 1) | ((c >> b) & 1); }
    uint32_t ent;
    if (kind == 0) {
      if (s < 256) ent = (uint32_t)s;
      else if (s == 256) ent = F_EOB;
      else if (s <= 285) {
        int li = s - 257;
        ent = (uint32_t)LENGTH_BASE[li] | ((uint32_t)LENGTH_EXTRA[li] << 19) | F_LEN;
      } else ent = F_INVALID;
    } else if (kind == 1) {
      if (s <= 29) ent = (uint32_t)DIST_BASE[s] | ((uint32_t)DIST_EXTRA[s] << 19);
      else ent = F_INVALID;
    } else {
      ent = (uint32_t)s;
    }
    if (!(ent & F_INVALID)) ent |= (uint32_t)l << 15;
    else ent = F_INVALID;  // keep invalid marker clean
    for (uint32_t idx = rev; idx < (uint32_t)lut_size; idx += (1u << l)) lut[idx] = ent;
  }
  return 0;
}

// Fixed-tree decode tables, built eagerly at load time (a namespace-scope
// constructor is guaranteed thread-safe; the previous lazy 'static bool
// built' flag raced when two threads decoded their first fixed block
// concurrently).
struct FixedDecodeTables {
  uint32_t flit[1 << 9];
  uint32_t fdist[1 << 5];
  int flit_bits = 0, fdist_bits = 0;
  FixedDecodeTables() {
    int32_t ll[288];
    for (int i = 0; i < 144; i++) ll[i] = 8;
    for (int i = 144; i < 256; i++) ll[i] = 9;
    for (int i = 256; i < 280; i++) ll[i] = 7;
    for (int i = 280; i < 288; i++) ll[i] = 8;
    build_lut(ll, 288, 0, flit, &flit_bits);
    int32_t dl[32];
    for (int i = 0; i < 32; i++) dl[i] = 5;
    build_lut(dl, 32, 1, fdist, &fdist_bits);
  }
};
const FixedDecodeTables g_fixed_dec;

void fixed_tables(uint32_t* lit, uint32_t* dist, int* lit_bits,
                  int* dist_bits) {
  memcpy(lit, g_fixed_dec.flit, sizeof(g_fixed_dec.flit));
  memcpy(dist, g_fixed_dec.fdist, sizeof(g_fixed_dec.fdist));
  *lit_bits = g_fixed_dec.flit_bits;
  *dist_bits = g_fixed_dec.fdist_bits;
}

struct TzState {
  uint32_t lit_lut[LUT_SIZE];
  uint32_t dist_lut[LUT_SIZE];
  int lit_bits;
  int dist_bits;
  int mode;  // 0=block header, 1=stored, 2=huffman, 3=done
  int last;
  int64_t stored_remaining;
};

}  // namespace

extern "C" {

void* tz_state_new() {
  TzState* st = new TzState();
  st->mode = 0;
  st->last = 0;
  st->stored_remaining = 0;
  return st;
}

void tz_state_free(void* p) { delete (TzState*)p; }

// error codes
// 0 ok; 1 need more input (truncated); 2 data error; 3 dst overflow
// On success or truncation, *out_len = bytes written, *consumed_bits set.
int tz_inflate_stream(void* state, const uint8_t* src, int64_t src_len,
                      int64_t start_bit, uint8_t* dst, int64_t dst_cap,
                      int64_t dict_len, int64_t* out_len,
                      int64_t* consumed_bits) {
  // dst buffer layout: dst[0..dict_len) preloaded with dictionary bytes;
  // new output begins at dict_len.  Window lookbacks go through dst.
  // The state persists Huffman tables + block mode so streaming callers
  // resume mid-block at symbol granularity (no partial-block re-decode).
  TzState* st = (TzState*)state;
  BitIn in(src, src_len * 8, start_bit);
  int64_t out = dict_len;
  uint32_t last = 0, btype = 0;
  uint32_t* lit_lut = st->lit_lut;
  uint32_t* dist_lut = st->dist_lut;
  uint32_t lit_mask, dist_mask;
  int64_t block_start = start_bit;
  int64_t block_start_out = out;

  if (st->mode == 3) { *out_len = 0; *consumed_bits = start_bit; return 0; }
  if (st->mode == 1) goto resume_stored;
  if (st->mode == 2) goto resume_huffman;

  for (;;) {
    block_start = in.pos;
    block_start_out = out;
    {
    last = in.bits(1);
    btype = in.bits(2);
    if (!in.ok) { in.pos = block_start; break; }
    if (btype == 3) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
    if (btype == 0) {
      in.align();
      {
        uint32_t len = in.bits(16);
        uint32_t nlen = in.bits(16);
        if (!in.ok) { in.pos = block_start; break; }
        if (len != (~nlen & 0xFFFF)) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
        st->stored_remaining = len;
        st->last = (int)last;
      }
      st->mode = 1;
resume_stored:
      {
        int64_t avail = src_len - (in.pos >> 3);
        int64_t take = st->stored_remaining < avail ? st->stored_remaining : avail;
        if (out + take > dst_cap) { *out_len = out - dict_len; *consumed_bits = in.pos; return 3; }
        if (take > 0) {
          memcpy(dst + out, src + (in.pos >> 3), (size_t)take);
          out += take;
          in.pos += take * 8;
          st->stored_remaining -= take;
        }
        if (st->stored_remaining > 0) {
          // need more input; resume in stored mode at a byte boundary
          *out_len = out - dict_len;
          *consumed_bits = in.pos;
          return 1;
        }
        st->mode = 0;
        if (st->last) { st->mode = 3; *out_len = out - dict_len; *consumed_bits = in.pos; return 0; }
        continue;
      }
    } else {
      if (btype == 1) {
        fixed_tables(lit_lut, dist_lut, &st->lit_bits, &st->dist_bits);
      } else {
        uint32_t hlit = in.bits(5) + 257;
        uint32_t hdist = in.bits(5) + 1;
        uint32_t hclen = in.bits(4) + 4;
        if (!in.ok) { in.pos = block_start; break; }
        if (hlit > 286 || hdist > 30) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
        int32_t clc[19] = {0};
        for (uint32_t i = 0; i < hclen; i++) clc[CLC_ORDER[i]] = (int32_t)in.bits(3);
        if (!in.ok) { in.pos = block_start; break; }
        static thread_local uint32_t clc_lut[LUT_SIZE];
        int clc_bits;
        if (build_lut(clc, 19, 2, clc_lut, &clc_bits) != 0) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
        const uint32_t clc_mask = (1u << clc_bits) - 1;
        int32_t lengths[286 + 30] = {0};
        uint32_t i = 0;
        while (i < hlit + hdist) {
          uint32_t ent = clc_lut[in.peek64() & clc_mask];
          if (ent & F_INVALID) { *out_len = out - dict_len; *consumed_bits = block_start; return in.pos + 7 >= in.nbits ? 1 : 2; }
          int nb = (ent >> 15) & 0xF;
          if (in.pos + nb > in.nbits) { in.pos = block_start; goto need_more; }
          uint32_t sym = ent & 0x7FFF;
          in.pos += nb;
          if (sym < 16) { lengths[i++] = (int32_t)sym; }
          else if (sym == 16) {
            if (i == 0) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
            uint32_t rep = 3 + in.bits(2);
            if (!in.ok) { in.pos = block_start; goto need_more; }
            if (i + rep > hlit + hdist) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
            int32_t prev = lengths[i - 1];
            for (uint32_t r = 0; r < rep; r++) lengths[i++] = prev;
          } else {
            uint32_t rep = sym == 17 ? 3 + in.bits(3) : 11 + in.bits(7);
            if (!in.ok) { in.pos = block_start; goto need_more; }
            if (i + rep > hlit + hdist) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
            i += rep;  // zeros already there
          }
        }
        if (lengths[256] == 0) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
        if (build_lut(lengths, (int)hlit, 0, lit_lut, &st->lit_bits) != 0) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
        if (build_lut(lengths + hlit, (int)hdist, 1, dist_lut, &st->dist_bits) != 0) { *out_len = out - dict_len; *consumed_bits = block_start; return 2; }
      }
      st->mode = 2;
      st->last = (int)last;
resume_huffman:
      lit_mask = (1u << st->lit_bits) - 1;
      dist_mask = (1u << st->dist_bits) - 1;
      // symbol loop: a bounds-check-free fast loop while input has >=64
      // spare bits and output >=266 spare bytes (one unaligned 64-bit
      // load covers a whole len+dist token: 15+5+15+13 = 48 bits <= 57
      // usable after sub-byte shift), then the careful suspend/resume
      // path near the margins (reference infcodes.ts inflate_fast
      // :57-301 vs the per-symbol slow path :314-676).
      for (;;) {
        {
          const int64_t fast_in = in.nbits - 64;
          const int64_t fast_out = dst_cap - 266;
          while (in.pos <= fast_in && out <= fast_out) {
            uint64_t w;
            memcpy(&w, in.data + (in.pos >> 3), 8);
            w >>= (in.pos & 7);
            uint32_t ent = lit_lut[w & lit_mask];
            if (ent & F_INVALID) {
              *out_len = out - dict_len; *consumed_bits = in.pos; return 2;
            }
            int nb = (ent >> 15) & 0xF;
            if (!(ent & (F_EOB | F_LEN))) {
              dst[out++] = (uint8_t)(ent & 0xFF);
              in.pos += nb;
              // second literal from the same load (<=30 bits used)
              w >>= nb;
              ent = lit_lut[w & lit_mask];
              if (!(ent & (F_INVALID | F_EOB | F_LEN))) {
                dst[out++] = (uint8_t)(ent & 0xFF);
                in.pos += (ent >> 15) & 0xF;
              }
              continue;
            }
            if (ent & F_EOB) { in.pos += nb; goto end_of_block; }
            int eb = (ent >> 19) & 0xF;
            int32_t length = (int32_t)(ent & 0x7FFF) +
                             (int32_t)((w >> nb) & ((1u << eb) - 1));
            int adv = nb + eb;
            uint32_t dent = dist_lut[(w >> adv) & dist_mask];
            if (dent & F_INVALID) {
              *out_len = out - dict_len; *consumed_bits = in.pos; return 2;
            }
            int dnb = (dent >> 15) & 0xF;
            int deb = (dent >> 19) & 0xF;
            int32_t dist = (int32_t)(dent & 0x7FFF) +
                           (int32_t)((w >> (adv + dnb)) & ((1u << deb) - 1));
            in.pos += adv + dnb + deb;
            if (dist > out) {
              *out_len = out - dict_len; *consumed_bits = in.pos; return 2;
            }
            const uint8_t* from = dst + out - dist;
            uint8_t* to = dst + out;
            out += length;
            if (dist >= 8) {
              // 8-byte chunked copy; may write up to 7 bytes past the
              // match end — the 266-byte output margin covers it
              for (int32_t j = 0; j < length; j += 8) {
                uint64_t v; memcpy(&v, from + j, 8); memcpy(to + j, &v, 8);
              }
            } else if (dist == 1) {
              memset(to, from[0], (size_t)length);
            } else {
              for (int32_t j = 0; j < length; j++) to[j] = from[j];
            }
          }
        }
        // careful path (input or output margin exhausted): one symbol
        {
        uint64_t w = in.peek64();
        uint32_t ent = lit_lut[w & lit_mask];
        if (ent & F_INVALID) {
          if (in.pos + MAX_BITS >= in.nbits) goto need_more_symbol;
          *out_len = out - dict_len; *consumed_bits = in.pos; return 2;
        }
        int nb = (ent >> 15) & 0xF;
        int eb = (ent >> 19) & 0xF;
        if (in.pos + nb + eb > in.nbits) goto need_more_symbol;
        if (ent & F_EOB) { in.pos += nb; break; }
        if (!(ent & F_LEN)) {
          if (out >= dst_cap) { *out_len = out - dict_len; *consumed_bits = in.pos; return 3; }
          dst[out++] = (uint8_t)(ent & 0xFF);
          in.pos += nb;
          continue;
        }
        int32_t length = (int32_t)(ent & 0x7FFF) + (int32_t)((w >> nb) & ((1u << eb) - 1));
        int adv = nb + eb;
        uint32_t dent = dist_lut[(w >> adv) & dist_mask];
        if (dent & F_INVALID) {
          if (in.pos + adv + MAX_BITS >= in.nbits) goto need_more_symbol;
          *out_len = out - dict_len; *consumed_bits = in.pos; return 2;
        }
        int dnb = (dent >> 15) & 0xF;
        int deb = (dent >> 19) & 0xF;
        if (in.pos + adv + dnb + deb > in.nbits) goto need_more_symbol;
        int32_t dist = (int32_t)(dent & 0x7FFF) +
                       (int32_t)((w >> (adv + dnb)) & ((1u << deb) - 1));
        if (dist > out) { *out_len = out - dict_len; *consumed_bits = in.pos; return 2; }
        if (out + length > dst_cap) {
          // overflow BEFORE consuming the symbol: callers resume at
          // consumed_bits with a larger buffer and must re-see this token
          *out_len = out - dict_len; *consumed_bits = in.pos; return 3;
        }
        in.pos += adv + dnb + deb;
        const uint8_t* from = dst + out - dist;
        uint8_t* to = dst + out;
        out += length;
        if (dist >= length) {
          memcpy(to, from, (size_t)length);
        } else if (dist >= 8 && out + 8 <= dst_cap) {
          for (int32_t j = 0; j < length; j += 8) {
            uint64_t v; memcpy(&v, from + j, 8); memcpy(to + j, &v, 8);
          }
        } else {
          for (int32_t j = 0; j < length; j++) to[j] = from[j];
        }
        }
      }
end_of_block:;
    }
    }
    st->mode = 0;
    if (st->last) { st->mode = 3; *out_len = out - dict_len; *consumed_bits = in.pos; return 0; }
  }
need_more:
  // header-stage truncation: resume at the block start
  st->mode = 0;
  *out_len = out - dict_len;
  *consumed_bits = block_start;
  return 1;
need_more_symbol:
  // mid-block truncation: tables live in the state; resume at this symbol
  *out_len = out - dict_len;
  *consumed_bits = in.pos;
  return 1;
}

int tz_inflate_raw(const uint8_t* src, int64_t src_len, int64_t start_bit,
                   uint8_t* dst, int64_t dst_cap, int64_t dict_len,
                   int64_t* out_len, int64_t* consumed_bits) {
  static thread_local TzState st;
  st.mode = 0;
  st.last = 0;
  st.stored_remaining = 0;
  return tz_inflate_stream(&st, src, src_len, start_bit, dst, dst_cap,
                           dict_len, out_len, consumed_bits);
}

namespace {
// length (3..258) -> length code 257..285 and dist -> dist code tables
struct SymTables {
  int32_t len2code[256];
  int32_t dist2code_small[256];
  int32_t dist2code_large[256];
  SymTables() {
    for (int c = 0; c < 29; c++) {
      int base = LENGTH_BASE[c] - 3;
      int span = 1 << LENGTH_EXTRA[c];
      for (int j = 0; j < span && base + j < 256; j++) len2code[base + j] = 257 + c;
    }
    len2code[255] = 285;
    for (int c = 0; c < 16; c++) {
      int lo = DIST_BASE[c] - 1;
      int hi = lo + (1 << DIST_EXTRA[c]);
      for (int j = lo; j < hi && j < 256; j++) dist2code_small[j] = c;
    }
    for (int c = 16; c < 30; c++) {
      int lo = (DIST_BASE[c] - 1) >> 7;
      int hi = (DIST_BASE[c] - 1 + (1 << DIST_EXTRA[c]) - 1) >> 7;
      for (int j = lo; j <= hi && j < 256; j++) dist2code_large[j] = c;
    }
  }
  inline int lsym(int32_t len) const { return len2code[len - 3]; }
  inline int dsym(int32_t d) const {
    return d <= 256 ? dist2code_small[d - 1] : dist2code_large[(d - 1) >> 7];
  }
};
const SymTables g_sym;
}  // namespace

}  // extern "C" (suspended: the tokenizer is a template, C linkage resumes below)

namespace {

// LZ77 hash-chain match search + greedy/lazy parse.
// data: ctx_len context bytes then n new bytes.  Writes token tape
// (litlen[i], dist[i]); fills per-stripe symbol histograms
// (lit_freq[stripe*286+s], dist_freq[stripe*30+s]) and records the
// cumulative output byte count at each stripe end in stripe_out_end.
// stripe = token_index / stripe_tokens.  Returns token count.
//
// TAGGED: chain entries pack an 11-bit second hash of the 4-gram into
// bits 21..31 (positions fit 21 bits for the chunk sizes the engine
// feeds).  Bucket collisions — the large majority of chain steps — are
// then rejected from the chain word alone, without touching data[cand]:
// the walk's dependent-load chain shrinks to prev[] itself.
template <bool TAGGED>
int64_t tz_tokenize_impl(const uint8_t* data, int64_t total, int64_t ctx_len,
                         int max_chain, int max_lazy, int nice_len, int lazy,
                         int32_t* out_litlen, int32_t* out_dist,
                         int32_t* lit_freq, int32_t* dist_freq,
                         int64_t* stripe_out_end, int64_t stripe_tokens) {
  constexpr int HASH_BITS = 17;
  constexpr int HASH_SIZE = 1 << HASH_BITS;
  constexpr int H3_BITS = 14;
  constexpr int H3_SIZE = 1 << H3_BITS;
  constexpr int32_t WINDOW = 1 << 15;
  constexpr int MIN_MATCH = 3;
  constexpr int MAX_MATCH = 258;
  constexpr int TOO_FAR3 = 128;
  constexpr int POS_BITS = 21;
  constexpr uint32_t POS_MASK = (1u << POS_BITS) - 1;

  // two-level search: 4-byte hash chains (sparser buckets than the
  // reference's 3-byte chains -> shorter walks for equal quality) plus a
  // single-slot 3-byte last-occurrence table for the close short matches
  // that the TOO_FAR3 rule admits.  Tables persist per thread (grow-only
  // prev) so repeated chunk calls skip the alloc + first-touch cost;
  // unique_ptr storage means glibc frees them at thread exit (callers
  // should still reuse threads to actually amortize).
  static thread_local std::unique_ptr<int32_t[]> head_tls;
  static thread_local std::unique_ptr<int32_t[]> last3_tls;
  static thread_local std::unique_ptr<int32_t[]> prev_tls;
  static thread_local int64_t prev_cap = 0;
  if (!head_tls) head_tls.reset(new int32_t[HASH_SIZE]);
  if (!last3_tls) last3_tls.reset(new int32_t[H3_SIZE]);
  if (total > prev_cap) {
    prev_cap = total + (total >> 2) + 4096;
    prev_tls.reset(new int32_t[prev_cap]);
  }
  int32_t* head = head_tls.get();
  int32_t* last3 = last3_tls.get();
  int32_t* prev = prev_tls.get();
  for (int i = 0; i < HASH_SIZE; i++) head[i] = -1;
  for (int i = 0; i < H3_SIZE; i++) last3[i] = -1;

  auto word_at = [&](int64_t i) -> uint32_t {
    uint32_t v;
    memcpy(&v, data + i, 4);
    return v;
  };
  auto hash4 = [](uint32_t v) -> uint32_t {
    return (v * 2654435761u) >> (32 - HASH_BITS);
  };
  auto hash3 = [](uint32_t v) -> uint32_t {
    return ((v & 0xFFFFFF) * 2654435761u) >> (32 - H3_BITS);
  };
  auto hash_at = [&](int64_t i) -> uint32_t { return hash4(word_at(i)); };
  auto hash3_at = [&](int64_t i) -> uint32_t { return hash3(word_at(i)); };
  // 11-bit second hash of the same 4-gram, packed above the position
  auto tag_of = [](uint32_t v) -> uint32_t {
    return TAGGED ? ((v * 0x85EBCA77u) >> 21) << POS_BITS : 0;
  };
  auto pack = [&](int64_t i, uint32_t v) -> int32_t {
    return TAGGED ? (int32_t)((uint32_t)i | tag_of(v)) : (int32_t)i;
  };
  auto insert = [&](int64_t i) {
    uint32_t v = word_at(i);
    uint32_t h = hash4(v);
    prev[i] = head[h];
    head[h] = pack(i, v);
    last3[hash3(v)] = (int32_t)i;
  };
  auto longest_match = [&](int64_t i, int32_t first_cand, int32_t* best_dist,
                           int chain_budget) -> int32_t {
    int64_t limit = total - i;
    if (limit > MAX_MATCH) limit = MAX_MATCH;
    if (limit < MIN_MATCH) return 0;
    int32_t best = 0;
    int64_t min_pos = i - WINDOW;
    if (min_pos < 0) min_pos = 0;
    int32_t cand = first_cand;
    const uint8_t* cur = data + i;
    uint32_t v0;
    memcpy(&v0, cur, 4);
    const uint32_t my_tag = tag_of(v0);
    while (chain_budget-- > 0) {
      if (TAGGED && cand == -1) break;
      int64_t cpos = TAGGED ? (int64_t)((uint32_t)cand & POS_MASK) : cand;
      if (cpos < min_pos) break;
      // chain entries are always < i (inserted before this call); a
      // position at/after i would mean a stale/corrupt chain — stop
      // rather than walk prev[] for a slot this call never inserted
      if (cpos >= i) break;
      if (TAGGED && (((uint32_t)cand ^ my_tag) >> POS_BITS) != 0) {
        // different 4-gram (or a 1/2048 tag alias): skip without
        // touching the candidate's data at all
        cand = prev[cpos];
        continue;
      }
      const uint8_t* c = data + cpos;
      if (!TAGGED) {
        // hide the chain walk's dependent-load latency: touch the next
        // candidate's bytes while this one is compared
        int32_t nxt = prev[cpos];
        if (nxt >= min_pos) __builtin_prefetch(data + nxt);
      }
      // two cheap rejects: the byte that would improve `best`, then the
      // first word (the tag leaves ~no collisions in TAGGED mode; the
      // word check also rejects tag aliases exactly)
      if (c[best] == cur[best]) {
        uint32_t w0;
        memcpy(&w0, c, 4);
        if (w0 != v0) { cand = prev[cpos]; continue; }
        int32_t len = 0;
        while (len + 8 <= limit) {
          uint64_t a, b;
          memcpy(&a, cur + len, 8);
          memcpy(&b, c + len, 8);
          uint64_t x = a ^ b;
          if (x) { len += (int32_t)(__builtin_ctzll(x) >> 3); goto donecmp; }
          len += 8;
        }
        while (len < limit && c[len] == cur[len]) len++;
      donecmp:
        if (len > best) {
          best = len;
          *best_dist = (int32_t)(i - cpos);
          if (best >= nice_len || best >= limit) break;
        }
      }
      cand = prev[cpos];
    }
    if (best < MIN_MATCH) {
      // no 4-byte match: try the close 3-byte slot
      int32_t c3 = last3[hash3_at(i)];
      if (c3 >= 0 && c3 < i && i - c3 <= TOO_FAR3 &&
          data[c3] == cur[0] && data[c3 + 1] == cur[1] && data[c3 + 2] == cur[2] &&
          limit >= MIN_MATCH) {
        *best_dist = (int32_t)(i - c3);
        return MIN_MATCH;
      }
      return 0;
    }
    if (best == MIN_MATCH && *best_dist > TOO_FAR3) return 0;
    return best;
  };

  // seed hash chains with the context
  for (int64_t i = 0; i + MIN_MATCH + 1 < ctx_len; i++) insert(i);

  int64_t ntok = 0;
  int64_t out_bytes = 0;
  // stripe bookkeeping without a per-token division
  int64_t stripe = 0;
  int64_t stripe_left = stripe_tokens;
  int32_t* lf_cur = lit_freq;
  int32_t* df_cur = dist_freq;
  auto put = [&](int32_t ll, int32_t dd) {
    out_litlen[ntok] = ll;
    out_dist[ntok] = dd;
    if (dd > 0) {
      lf_cur[g_sym.lsym(ll)]++;
      df_cur[g_sym.dsym(dd)]++;
      out_bytes += ll;
    } else {
      lf_cur[ll]++;
      out_bytes += 1;
    }
    ntok++;
    stripe_out_end[stripe] = out_bytes;
    if (--stripe_left == 0) {
      stripe++;
      stripe_left = stripe_tokens;
      lf_cur += 286;
      df_cur += 30;
    }
  };
  int64_t i = ctx_len;
  int32_t prev_len = 0, prev_dist = 0;
  bool have_prev = false;
  while (i < total) {
    int32_t dist = 0, len = 0;
    if (i + MIN_MATCH + 1 <= total) {
      // chain insert fused with the search: the walk starts at the OLD
      // head, and the single-slot last3 must still hold the previous
      // occurrence while position i is searched
      uint32_t v = word_at(i);
      uint32_t h = hash4(v);
      int32_t cand = head[h];
      prev[i] = cand;
      head[h] = pack(i, v);
      len = longest_match(i, cand, &dist,
                          (have_prev && prev_len >= max_lazy / 4)
                              ? max_chain / 4
                              : max_chain);
      last3[hash3(v)] = (int32_t)i;
    }
    if (lazy) {
      if (have_prev) {
        if (len > prev_len) {
          // defer: previous position becomes a literal
          put(data[i - 1], 0);
          prev_len = len; prev_dist = dist;
          i++;
          continue;
        }
        // emit previous match (covers i-1 .. i-1+prev_len-1)
        put(prev_len, prev_dist);
        int64_t end = i - 1 + prev_len;
        // insert skipped positions into the hash chains.  (Round 5
        // tried inserting every 2nd position inside long matches — ~1%
        // faster on text but it broke the <=zlib size invariant on the
        // repetitive large corpus; full insertion is load-bearing.)
        for (int64_t p = i + 1; p < end && p + MIN_MATCH + 1 <= total; p++) insert(p);
        i = end;
        have_prev = false;
        continue;
      }
      if (len >= MIN_MATCH && len < max_lazy) {
        prev_len = len; prev_dist = dist; have_prev = true;
        i++;
        continue;
      }
    }
    if (len >= MIN_MATCH) {
      put(len, dist);
      int64_t end = i + len;
      for (int64_t p = i + 1; p < end && p + MIN_MATCH + 1 <= total; p++) insert(p);
      i = end;
    } else {
      put(data[i], 0);
      i++;
    }
  }
  if (have_prev) {
    // stream ended while holding a deferred match: emit it
    put(prev_len, prev_dist);
  }
  return ntok;
}

}  // namespace

extern "C" {

int64_t tz_deflate_tokenize(const uint8_t* data, int64_t total, int64_t ctx_len,
                            int max_chain, int max_lazy, int nice_len, int lazy,
                            int32_t* out_litlen, int32_t* out_dist,
                            int32_t* lit_freq, int32_t* dist_freq,
                            int64_t* stripe_out_end, int64_t stripe_tokens) {
  // tagged chains need the position to fit 21 bits; the engine's chunks
  // (<= 512 KiB + 32 KiB context) always do, but arbitrary callers get
  // the untagged walk
  if (total < ((int64_t)1 << 21) - 1)
    return tz_tokenize_impl<true>(data, total, ctx_len, max_chain, max_lazy,
                                  nice_len, lazy, out_litlen, out_dist,
                                  lit_freq, dist_freq, stripe_out_end,
                                  stripe_tokens);
  return tz_tokenize_impl<false>(data, total, ctx_len, max_chain, max_lazy,
                                 nice_len, lazy, out_litlen, out_dist,
                                 lit_freq, dist_freq, stripe_out_end,
                                 stripe_tokens);
}

// Serial LSB-first bit emitter for a block body: token codes + EOB.
// ll/dl: code lengths; lcodes/dcodes: bit-reversed canonical codes.
// Writes into out (pre-zeroed) starting at start_bit; returns end bit
// position, or -1 if out_cap (bytes) would overflow.
int64_t tz_emit_tokens(const int32_t* litlen, const int32_t* dist, int64_t ntok,
                       const int32_t* ll, const uint32_t* lcodes,
                       const int32_t* dl, const uint32_t* dcodes,
                       uint8_t* out, int64_t out_cap, int64_t start_bit) {
  uint64_t acc = 0;
  int nacc = 0;
  int64_t byte_pos = start_bit >> 3;
  if (start_bit & 7) {
    acc = out[byte_pos];
    nacc = (int)(start_bit & 7);
  }
  auto putbits = [&](uint32_t v, int n) {
    acc |= (uint64_t)v << nacc;
    nacc += n;
    while (nacc >= 8) {
      if (byte_pos >= out_cap) return false;
      out[byte_pos++] = (uint8_t)acc;
      acc >>= 8;
      nacc -= 8;
    }
    return true;
  };
  for (int64_t t = 0; t < ntok; t++) {
    int32_t d = dist[t];
    if (d == 0) {
      int s = litlen[t];
      if (!putbits(lcodes[s], ll[s])) return -1;
    } else {
      int32_t len = litlen[t];
      int s = g_sym.lsym(len);
      if (!putbits(lcodes[s], ll[s])) return -1;
      int eb = LENGTH_EXTRA[s - 257];
      if (eb && !putbits((uint32_t)(len - LENGTH_BASE[s - 257]), eb)) return -1;
      int ds = g_sym.dsym(d);
      if (!putbits(dcodes[ds], dl[ds])) return -1;
      int deb = DIST_EXTRA[ds];
      if (deb && !putbits((uint32_t)(d - DIST_BASE[ds]), deb)) return -1;
    }
  }
  if (!putbits(lcodes[256], ll[256])) return -1;  // EOB
  int64_t end_bit = byte_pos * 8 + nacc;
  if (nacc) {
    if (byte_pos >= out_cap) return -1;
    out[byte_pos] = (uint8_t)acc;
  }
  return end_bit;
}

// Window-free tokenization for speculative parallel inflate: decode
// symbols from start_bit into a token tape (no output buffer, no window
// needed), stopping at the first block boundary at/after stop_bit or at
// the final block.  Returns token count; *end_bit/*finished report the
// chain position.  status: 0 ok, 2 data error, 3 tape overflow.
int64_t tz_inflate_tokenize(const uint8_t* src, int64_t src_len,
                            int64_t start_bit, int64_t stop_bit,
                            int32_t* out_litlen, int32_t* out_dist,
                            int64_t tape_cap, int64_t* end_bit,
                            int32_t* finished, int32_t* status) {
  BitIn in(src, src_len * 8, start_bit);
  static thread_local uint32_t lit_lut[LUT_SIZE];
  static thread_local uint32_t dist_lut[LUT_SIZE];
  int lit_bits = MAX_BITS, dist_bits = MAX_BITS;
  int64_t ntok = 0;
  *finished = 0;
  *status = 0;
  for (;;) {
    int64_t block_start = in.pos;
    uint32_t last = in.bits(1);
    uint32_t btype = in.bits(2);
    if (!in.ok || btype == 3) { *status = 2; *end_bit = block_start; return ntok; }
    if (btype == 0) {
      in.align();
      uint32_t len = in.bits(16);
      uint32_t nlen = in.bits(16);
      if (!in.ok || len != (~nlen & 0xFFFF)) { *status = 2; *end_bit = block_start; return ntok; }
      if ((in.pos >> 3) + len > (uint64_t)src_len) { *status = 2; *end_bit = block_start; return ntok; }
      if (ntok + (int64_t)len > tape_cap) { *status = 3; *end_bit = block_start; return ntok; }
      const uint8_t* p = src + (in.pos >> 3);
      for (uint32_t j = 0; j < len; j++) { out_litlen[ntok] = p[j]; out_dist[ntok] = 0; ntok++; }
      in.pos += (int64_t)len * 8;
    } else {
      if (btype == 1) {
        fixed_tables(lit_lut, dist_lut, &lit_bits, &dist_bits);
      } else {
        uint32_t hlit = in.bits(5) + 257;
        uint32_t hdist = in.bits(5) + 1;
        uint32_t hclen = in.bits(4) + 4;
        if (!in.ok || hlit > 286 || hdist > 30) { *status = 2; *end_bit = block_start; return ntok; }
        int32_t clc[19] = {0};
        for (uint32_t i = 0; i < hclen; i++) clc[CLC_ORDER[i]] = (int32_t)in.bits(3);
        if (!in.ok) { *status = 2; *end_bit = block_start; return ntok; }
        static thread_local uint32_t clc_lut[LUT_SIZE];
        int clc_bits;
        if (build_lut(clc, 19, 2, clc_lut, &clc_bits) != 0) { *status = 2; *end_bit = block_start; return ntok; }
        const uint32_t clc_mask = (1u << clc_bits) - 1;
        int32_t lengths[286 + 30] = {0};
        uint32_t i = 0;
        while (i < hlit + hdist) {
          uint32_t ent = clc_lut[in.peek64() & clc_mask];
          if (ent & F_INVALID) { *status = 2; *end_bit = block_start; return ntok; }
          int nb = (ent >> 15) & 0xF;
          if (in.pos + nb > in.nbits) { *status = 2; *end_bit = block_start; return ntok; }
          uint32_t sym = ent & 0x7FFF;
          in.pos += nb;
          if (sym < 16) { lengths[i++] = (int32_t)sym; }
          else if (sym == 16) {
            if (i == 0) { *status = 2; *end_bit = block_start; return ntok; }
            uint32_t rep = 3 + in.bits(2);
            if (!in.ok || i + rep > hlit + hdist) { *status = 2; *end_bit = block_start; return ntok; }
            int32_t prev = lengths[i - 1];
            for (uint32_t r = 0; r < rep; r++) lengths[i++] = prev;
          } else {
            uint32_t rep = sym == 17 ? 3 + in.bits(3) : 11 + in.bits(7);
            if (!in.ok || i + rep > hlit + hdist) { *status = 2; *end_bit = block_start; return ntok; }
            i += rep;
          }
        }
        if (lengths[256] == 0 ||
            build_lut(lengths, (int)hlit, 0, lit_lut, &lit_bits) != 0 ||
            build_lut(lengths + hlit, (int)hdist, 1, dist_lut, &dist_bits) != 0) {
          *status = 2; *end_bit = block_start; return ntok;
        }
      }
      const uint32_t lit_mask = (1u << lit_bits) - 1;
      const uint32_t dist_mask = (1u << dist_bits) - 1;
      for (;;) {
        uint64_t w = in.peek64();
        uint32_t ent = lit_lut[w & lit_mask];
        if (ent & F_INVALID) { *status = 2; *end_bit = in.pos; return ntok; }
        int nb = (ent >> 15) & 0xF;
        int eb = (ent >> 19) & 0xF;
        if (in.pos + nb + eb > in.nbits) { *status = 2; *end_bit = in.pos; return ntok; }
        if (ent & F_EOB) { in.pos += nb; break; }
        if (ntok >= tape_cap) { *status = 3; *end_bit = in.pos; return ntok; }
        if (!(ent & F_LEN)) {
          out_litlen[ntok] = (int32_t)(ent & 0xFF);
          out_dist[ntok] = 0;
          ntok++;
          in.pos += nb;
          continue;
        }
        int32_t length = (int32_t)(ent & 0x7FFF) + (int32_t)((w >> nb) & ((1u << eb) - 1));
        int adv = nb + eb;
        uint32_t dent = dist_lut[(w >> adv) & dist_mask];
        if (dent & F_INVALID) { *status = 2; *end_bit = in.pos; return ntok; }
        int dnb = (dent >> 15) & 0xF;
        int deb = (dent >> 19) & 0xF;
        if (in.pos + adv + dnb + deb > in.nbits) { *status = 2; *end_bit = in.pos; return ntok; }
        int32_t dist = (int32_t)(dent & 0x7FFF) +
                       (int32_t)((w >> (adv + dnb)) & ((1u << deb) - 1));
        in.pos += adv + dnb + deb;
        out_litlen[ntok] = length;
        out_dist[ntok] = dist;
        ntok++;
      }
    }
    if (last) { *finished = 1; *end_bit = in.pos; return ntok; }
    if (in.pos >= stop_bit) { *end_bit = in.pos; return ntok; }
  }
}

// Mid-block tokenize with caller-supplied code lengths (round-5 splice
// -repair bridge decoder).  The repair used the vectorized numpy
// decoder, which does O(segment_bits) work per chunk (it decodes a
// candidate at EVERY bit position); a bridge only needs the serial
// O(symbols) walk from a known chain position with the block's already
// -parsed tables.  Returns ntok; *hit_eob=1 when the block's EOB was
// consumed (end_bit then points past it); *status: 0 ok (cap reached
// or EOB), 2 data error/truncation.
int64_t tz_tokenize_midblock(const uint8_t* src, int64_t src_len,
                             int64_t start_bit,
                             const int32_t* litlens, int32_t nlit,
                             const int32_t* distlens, int32_t ndist,
                             int32_t* out_litlen, int32_t* out_dist,
                             int64_t cap, int64_t* end_bit,
                             int32_t* hit_eob, int32_t* status) {
  *hit_eob = 0;
  *status = 0;
  static thread_local uint32_t lit_lut[LUT_SIZE];
  static thread_local uint32_t dist_lut[LUT_SIZE];
  static thread_local int32_t cached_lit[288], cached_dist[32];
  static thread_local int32_t cached_nlit = -1, cached_ndist = -1;
  static thread_local int lit_bits = 0, dist_bits = 0;
  bool same = cached_nlit == nlit && cached_ndist == ndist;
  if (same) {
    for (int s = 0; s < nlit && same; s++) same = cached_lit[s] == litlens[s];
    for (int s = 0; s < ndist && same; s++)
      same = cached_dist[s] == distlens[s];
  }
  if (!same) {
    if (build_lut(litlens, nlit, 0, lit_lut, &lit_bits) != 0 ||
        build_lut(distlens, ndist, 1, dist_lut, &dist_bits) != 0) {
      *status = 2;
      *end_bit = start_bit;
      return 0;
    }
    cached_nlit = nlit;
    cached_ndist = ndist;
    for (int s = 0; s < nlit; s++) cached_lit[s] = litlens[s];
    for (int s = 0; s < ndist; s++) cached_dist[s] = distlens[s];
  }
  BitIn in(src, src_len * 8, start_bit);
  const uint32_t lit_mask = (1u << lit_bits) - 1;
  const uint32_t dist_mask = (1u << dist_bits) - 1;
  int64_t ntok = 0;
  while (ntok < cap) {
    uint64_t w = in.peek64();
    uint32_t ent = lit_lut[w & lit_mask];
    if (ent & F_INVALID) { *status = 2; *end_bit = in.pos; return ntok; }
    int nb = (ent >> 15) & 0xF;
    int eb = (ent >> 19) & 0xF;
    if (in.pos + nb + eb > in.nbits) { *status = 2; *end_bit = in.pos; return ntok; }
    if (ent & F_EOB) { in.pos += nb; *hit_eob = 1; break; }
    if (!(ent & F_LEN)) {
      out_litlen[ntok] = (int32_t)(ent & 0xFF);
      out_dist[ntok] = 0;
      ntok++;
      in.pos += nb;
      continue;
    }
    int32_t length = (int32_t)(ent & 0x7FFF) +
                     (int32_t)((w >> nb) & ((1u << eb) - 1));
    int adv = nb + eb;
    uint32_t dent = dist_lut[(w >> adv) & dist_mask];
    if (dent & F_INVALID) { *status = 2; *end_bit = in.pos; return ntok; }
    int dnb = (dent >> 15) & 0xF;
    int deb = (dent >> 19) & 0xF;
    if (in.pos + adv + dnb + deb > in.nbits) {
      *status = 2; *end_bit = in.pos; return ntok;
    }
    int32_t dist = (int32_t)(dent & 0x7FFF) +
                   (int32_t)((w >> (adv + dnb)) & ((1u << deb) - 1));
    in.pos += adv + dnb + deb;
    out_litlen[ntok] = length;
    out_dist[ntok] = dist;
    ntok++;
  }
  *end_bit = in.pos;
  return ntok;
}

// Full-stream dynamic-block header scan (speculative parallel-inflate
// pass 1; python counterpart: parallel/speculative.find_all_block_starts).
// For every bit position: cheap field checks (BTYPE==10, HLIT/HDIST in
// range, optional BFINAL==0), the code-length-code Kraft-completeness
// test (rapidgzip-style reject), then CONFIRMATION by a bounded decode
// through tz_inflate_tokenize (a real header parses and yields >=8
// symbols or overflows a 64-token cap).  Returns the number of
// confirmed header bit positions written to out_pos.
static int64_t tz_scan_headers_range(const uint8_t* src, int64_t src_len,
                                     int64_t from_bit, int64_t to_bit,
                                     int32_t allow_final,
                                     int64_t* out_pos, int64_t cap) {
  const int64_t nbits = src_len * 8;
  int64_t found = 0;
  // bound keeps both 8-byte memcpy windows in range (a real dynamic
  // header + EOB needs >100 bits, so nothing is missed at the tail)
  for (int64_t bit = from_bit; bit < to_bit && bit + 81 <= nbits; bit++) {
    const int64_t byte = bit >> 3;
    const int s = (int)(bit & 7);
    uint64_t w0;
    memcpy(&w0, src + byte, 8);
    const uint32_t w = (uint32_t)(w0 >> s);
    if (((w >> 1) & 3) != 2) continue;
    if (!allow_final && (w & 1)) continue;
    const uint32_t hlit = (w >> 3) & 31;
    const uint32_t hdist = (w >> 8) & 31;
    if (hlit > 29 || hdist > 29) continue;
    const int hclen = (int)((w >> 13) & 15) + 4;
    // 19 CLC entries start at bit+17 and span <=57 bits: one u64 window
    const int64_t cb = bit + 17;
    uint64_t k0;
    memcpy(&k0, src + (cb >> 3), 8);
    const uint64_t k = k0 >> (cb & 7);
    int kraft = 0, nz = 0;
    for (int j = 0; j < hclen; j++) {
      const int lj = (int)((k >> (3 * j)) & 7);
      if (lj) { kraft += 1 << (7 - lj); nz++; }
    }
    if (kraft != 128 || nz < 2) continue;
    int32_t ll[64], dd[64];
    int64_t eb;
    int32_t fin, st;
    int64_t n = tz_inflate_tokenize(src, src_len, bit, bit + 1, ll, dd, 64,
                                    &eb, &fin, &st);
    // confirm: tape overflow (plenty of symbols parse) OR a clean parse
    // of >=8 symbols OR a clean bounded parse straight through the final
    // EOB — the last case covers genuine tiny final blocks (<8 symbols),
    // which a count-only rule would silently never discover (ADVICE r4)
    if (st == 3 || (st == 0 && (n >= 8 || fin))) {
      out_pos[found++] = bit;
      if (found >= cap) return found;
    }
  }
  return found;
}

int64_t tz_find_headers(const uint8_t* src, int64_t src_len,
                        int64_t from_bit, int32_t allow_final,
                        int64_t* out_pos, int64_t cap) {
  const int64_t nbits = src_len * 8;
  // the scan is embarrassingly parallel per bit position (confirmation
  // decodes read the GLOBAL stream, so range splits have no boundary
  // effects): split across hardware threads for streams long enough to
  // amortize thread startup (~2x on the 2-core build host)
  int nt = (int)std::thread::hardware_concurrency();
  if (nt > 4) nt = 4;
  if (nt < 2 || nbits - from_bit < (1 << 21)) {
    return tz_scan_headers_range(src, src_len, from_bit, nbits, allow_final,
                                 out_pos, cap);
  }
  std::vector<std::vector<int64_t>> parts(nt);
  std::vector<std::thread> threads;
  const int64_t span = (nbits - from_bit + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    const int64_t lo = from_bit + t * span;
    const int64_t hi = std::min(lo + span, nbits);
    threads.emplace_back([&, t, lo, hi]() {
      std::vector<int64_t>& mine = parts[t];
      mine.resize((size_t)cap);
      int64_t n = tz_scan_headers_range(src, src_len, lo, hi, allow_final,
                                        mine.data(), cap);
      mine.resize((size_t)n);
    });
  }
  for (auto& th : threads) th.join();
  int64_t found = 0;
  for (int t = 0; t < nt; t++) {
    for (int64_t p : parts[t]) {
      out_pos[found++] = p;
      if (found >= cap) return found;
    }
  }
  return found;
}

// Token-tape expansion: the serial host counterpart of the device
// pointer-doubling expansion (codec/expand.py).  dst[0..dict_len) holds
// window context; returns output length (excluding context) or -1 on
// overflow / -2 on invalid distance.
int64_t tz_expand_tokens(const int32_t* litlen, const int32_t* dist,
                         int64_t ntok, uint8_t* dst, int64_t dst_cap,
                         int64_t dict_len) {
  int64_t out = dict_len;
  for (int64_t t = 0; t < ntok; t++) {
    int32_t d = dist[t];
    if (d == 0) {
      if (out >= dst_cap) return -1;
      dst[out++] = (uint8_t)litlen[t];
      continue;
    }
    int32_t len = litlen[t];
    if (d > out) return -2;
    if (out + len > dst_cap) return -1;
    const uint8_t* from = dst + out - d;
    uint8_t* to = dst + out;
    out += len;
    if (d >= len) {
      memcpy(to, from, (size_t)len);
    } else if (d >= 8 && out + 8 <= dst_cap) {
      for (int32_t j = 0; j < len; j += 8) {
        uint64_t v; memcpy(&v, from + j, 8); memcpy(to + j, &v, 8);
      }
    } else {
      for (int32_t j = 0; j < len; j++) to[j] = from[j];
    }
  }
  return out - dict_len;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Whole-chunk block emission (native mirror of codec/emit_native.py):
// package-merge trees, RLE'd dynamic headers, stored/static/dynamic choice,
// entropy-guided adaptive block splitting, LSB-first bit packing.  One call
// per chunk keeps the entire deflate emit GIL-free so chunks parallelize
// across host threads.  Semantics follow codec/deflate_blocks.py +
// codec/huffman_encode.py (the vectorized reference paths).
// ---------------------------------------------------------------------------

namespace {

struct BitWriter {
  uint8_t* out;
  int64_t cap;  // bytes
  uint64_t acc = 0;
  int nacc = 0;
  int64_t byte_pos = 0;
  bool overflow = false;

  BitWriter(uint8_t* o, int64_t c) : out(o), cap(c) {}
  inline int64_t bitpos() const { return byte_pos * 8 + nacc; }
  inline void put(uint32_t v, int n) {  // n <= 32
    acc |= (uint64_t)v << nacc;
    nacc += n;
    while (nacc >= 8) {
      if (byte_pos >= cap) { overflow = true; nacc = 0; return; }
      out[byte_pos++] = (uint8_t)acc;
      acc >>= 8;
      nacc -= 8;
    }
  }
  inline void align() { if (nacc) put(0, 8 - nacc); }
  inline void finish() { align(); }  // pad the last partial byte with zeros
};

// Optimal length-limited Huffman code lengths (package-merge), exact
// semantics of huffman_encode.package_merge: stable weight order, package
// pairs each round against the base list, first 2n-2 membership counts.
constexpr int PM_MAXN = 288;
constexpr int PM_MAXITEMS = 2 * PM_MAXN + 4;

void package_merge_c(const int64_t* freqs, int nsym, int max_len,
                     int32_t* lengths) {
  int used[PM_MAXN];
  int n = 0;
  for (int s = 0; s < nsym; s++) {
    lengths[s] = 0;
    if (freqs[s] > 0) used[n++] = s;
  }
  if (n == 0) return;
  if (n == 1) { lengths[used[0]] = 1; return; }

  // stable sort of used symbols by weight (insertion sort: n <= 288 and
  // inputs are small histograms)
  int order[PM_MAXN];
  for (int i = 0; i < n; i++) order[i] = i;
  for (int i = 1; i < n; i++) {
    int key = order[i];
    int64_t kw = freqs[used[key]];
    int j = i - 1;
    while (j >= 0 && freqs[used[order[j]]] > kw) { order[j + 1] = order[j]; j--; }
    order[j + 1] = key;
  }
  int64_t base_w[PM_MAXN];
  for (int i = 0; i < n; i++) base_w[i] = freqs[used[order[i]]];

  // membership counts per item over the n used symbols (<= max_len each)
  static thread_local uint8_t cnt_a[PM_MAXITEMS][PM_MAXN];
  static thread_local uint8_t cnt_b[PM_MAXITEMS][PM_MAXN];
  static thread_local int64_t w_a[PM_MAXITEMS];
  static thread_local int64_t w_b[PM_MAXITEMS];
  auto (*cur)[PM_MAXN] = cnt_a;
  auto (*nxt)[PM_MAXN] = cnt_b;
  int64_t* cw = w_a;
  int64_t* nw = w_b;
  int nitems = n;
  for (int i = 0; i < n; i++) {
    cw[i] = base_w[i];
    memset(cur[i], 0, n);
    cur[i][order[i]] = 1;
  }
  for (int round = 0; round < max_len - 1; round++) {
    int m = nitems / 2;
    // packages of adjacent pairs are themselves non-decreasing; merge the
    // (sorted) base list with them, base items first on ties — this is the
    // stable argsort over concat([base, packages]) the numpy path performs
    int bi = 0, pi = 0, k = 0;
    while (bi < n || pi < m) {
      bool take_base;
      if (bi >= n) take_base = false;
      else if (pi >= m) take_base = true;
      else take_base = base_w[bi] <= cw[2 * pi] + cw[2 * pi + 1];
      if (take_base) {
        nw[k] = base_w[bi];
        memset(nxt[k], 0, n);
        nxt[k][order[bi]] = 1;
        bi++;
      } else {
        nw[k] = cw[2 * pi] + cw[2 * pi + 1];
        for (int s = 0; s < n; s++)
          nxt[k][s] = (uint8_t)(cur[2 * pi][s] + cur[2 * pi + 1][s]);
        pi++;
      }
      k++;
    }
    nitems = k;
    auto tmpc = cur; cur = nxt; nxt = tmpc;
    int64_t* tmpw = cw; cw = nw; nw = tmpw;
  }
  int take = 2 * n - 2;
  for (int i = 0; i < take; i++)
    for (int s = 0; s < n; s++)
      if (cur[i][s]) lengths[used[s]] += cur[i][s];
}

// at least two nonzero code lengths (deflate_blocks._force_two_codes)
void force_two_codes(int32_t* lengths, int nsym) {
  int nz = 0, first = -1;
  for (int s = 0; s < nsym; s++)
    if (lengths[s] > 0) { if (first < 0) first = s; nz++; }
  if (nz >= 2) return;
  if (nz == 1) {
    lengths[first] = 1;
    lengths[first != 0 ? 0 : 1] = 1;
  } else {
    lengths[0] = 1;
    lengths[1] = 1;
  }
}

// canonical codes, bit-reversed for LSB-first emission
void canonical_lsb(const int32_t* lengths, int nsym, uint32_t* codes) {
  int32_t counts[MAX_BITS + 1] = {0};
  for (int s = 0; s < nsym; s++) if (lengths[s] > 0) counts[lengths[s]]++;
  uint32_t next_code[MAX_BITS + 2] = {0};
  uint32_t code = 0;
  for (int b = 1; b <= MAX_BITS; b++) {
    code = (code + counts[b - 1]) << 1;
    next_code[b] = code;
  }
  for (int s = 0; s < nsym; s++) {
    int l = lengths[s];
    if (l == 0) { codes[s] = 0; continue; }
    uint32_t c = next_code[l]++;
    uint32_t rev = 0;
    for (int b = 0; b < l; b++) rev = (rev << 1) | ((c >> b) & 1);
    codes[s] = rev;
  }
}

// RLE of code lengths with symbols 16/17/18 (huffman_encode.codelen_rle)
int codelen_rle_c(const int32_t* lengths, int n, int32_t* syms, int32_t* ev,
                  int32_t* eb) {
  int m = 0;
  int i = 0;
  while (i < n) {
    int cur = lengths[i];
    int run = 1;
    while (i + run < n && lengths[i + run] == cur) run++;
    if (cur == 0) {
      int left = run;
      while (left >= 11) {
        int t = left < 138 ? left : 138;
        syms[m] = 18; ev[m] = t - 11; eb[m] = 7; m++;
        left -= t;
      }
      while (left >= 3) {
        int t = left < 10 ? left : 10;
        syms[m] = 17; ev[m] = t - 3; eb[m] = 3; m++;
        left -= t;
      }
      for (; left > 0; left--) { syms[m] = 0; ev[m] = 0; eb[m] = 0; m++; }
    } else {
      syms[m] = cur; ev[m] = 0; eb[m] = 0; m++;
      int left = run - 1;
      while (left >= 3) {
        int t = left < 6 ? left : 6;
        syms[m] = 16; ev[m] = t - 3; eb[m] = 2; m++;
        left -= t;
      }
      for (; left > 0; left--) { syms[m] = cur; ev[m] = 0; eb[m] = 0; m++; }
    }
    i += run;
  }
  return m;
}

// RFC 1951 fixed code lengths: literals 0-143 -> 8, 144-255 -> 9,
// 256-279 -> 7, 280-287 -> 8; all 30 distance codes -> 5
struct FixedLens {
  int32_t ll[288];
  int32_t dl[30];
  FixedLens() {
    int i = 0;
    for (; i < 144; i++) ll[i] = 8;
    for (; i < 256; i++) ll[i] = 9;
    for (; i < 280; i++) ll[i] = 7;
    for (; i < 288; i++) ll[i] = 8;
    for (int j = 0; j < 30; j++) dl[j] = 5;
  }
};
const FixedLens g_fixed;
#define FIXED_LL g_fixed.ll
#define FIXED_DL30 g_fixed.dl

int64_t body_cost_c(const int64_t* lf, const int64_t* df, const int32_t* ll,
                    const int32_t* dl) {
  int64_t bits = 0;
  for (int s = 0; s < 286; s++) bits += lf[s] * ll[s];
  for (int s = 257; s < 286; s++) bits += lf[s] * LENGTH_EXTRA[s - 257];
  for (int s = 0; s < 30; s++) bits += df[s] * (dl[s] + DIST_EXTRA[s]);
  return bits;
}

constexpr int64_t MAX_STORED_C = 65535;

void emit_stored_c(BitWriter& bw, const uint8_t* raw, int64_t n, int last) {
  int64_t off = 0;
  for (;;) {
    int64_t take = n - off < MAX_STORED_C ? n - off : MAX_STORED_C;
    int final_piece = off + take == n;
    bw.put((last && final_piece) ? 1 : 0, 1);
    bw.put(0, 2);  // BTYPE=00
    bw.align();
    bw.put((uint32_t)take, 16);
    bw.put((uint32_t)take ^ 0xFFFF, 16);
    if (bw.overflow) return;
    if (take) {
      if (bw.byte_pos + take > bw.cap) { bw.overflow = true; return; }
      memcpy(bw.out + bw.byte_pos, raw + off, (size_t)take);
      bw.byte_pos += take;
    }
    off += take;
    if (final_piece) break;
  }
}

// emit one block: choose format, write headers + body (codec/emit_native
// _emit_leaf semantics, including the probe-costed dynamic header)
void emit_leaf_c(BitWriter& bw, const int32_t* litlen, const int32_t* dist,
                 int64_t ntok, const int64_t* lf, const int64_t* df,
                 const uint8_t* raw, int64_t nraw, int last) {
  int32_t ll[288] = {0}, dl[30] = {0};
  package_merge_c(lf, 286, 15, ll);
  force_two_codes(ll, 286);
  package_merge_c(df, 30, 15, dl);
  force_two_codes(dl, 30);
  int hlit = 257, hdist = 1;
  for (int s = 0; s < 286; s++) if (ll[s] > 0 && s + 1 > hlit) hlit = s + 1;
  for (int s = 0; s < 30; s++) if (dl[s] > 0 && s + 1 > hdist) hdist = s + 1;

  int32_t all_len[286 + 30];
  memcpy(all_len, ll, hlit * sizeof(int32_t));
  memcpy(all_len + hlit, dl, hdist * sizeof(int32_t));
  int32_t cl_syms[320], cl_ev[320], cl_eb[320];
  int ncl = codelen_rle_c(all_len, hlit + hdist, cl_syms, cl_ev, cl_eb);
  int64_t cl_freq[19] = {0};
  for (int i = 0; i < ncl; i++) cl_freq[cl_syms[i]]++;
  int32_t cl_len[19] = {0};
  package_merge_c(cl_freq, 19, 7, cl_len);
  force_two_codes(cl_len, 19);
  int hclen = 4;
  for (int pos = 0; pos < 19; pos++)
    if (cl_len[CLC_ORDER[pos]] > 0 && pos + 1 > hclen) hclen = pos + 1;

  int64_t hdr_bits = 14 + 3 * hclen;
  for (int i = 0; i < ncl; i++) hdr_bits += cl_len[cl_syms[i]] + cl_eb[i];
  int64_t dyn_body = body_cost_c(lf, df, ll, dl);
  int64_t static_body = body_cost_c(lf, df, FIXED_LL, FIXED_DL30);
  int64_t dyn_total = 3 + hdr_bits + dyn_body;
  int64_t static_total = 3 + static_body;
  int64_t align_pad = (-(bw.bitpos() + 3)) & 7;
  int64_t nstored = nraw > 0 ? (nraw + MAX_STORED_C - 1) / MAX_STORED_C : 1;
  int64_t stored_total =
      3 * nstored + align_pad + 32 * nstored + 8 * nraw + 5 * (nstored - 1);

  int64_t best_coded = dyn_total < static_total ? dyn_total : static_total;
  if (nraw > 0 && stored_total < best_coded) {
    emit_stored_c(bw, raw, nraw, last);
    return;
  }

  const int32_t* use_ll;
  const int32_t* use_dl;
  uint32_t lcodes[288], dcodes[30];
  bw.put(last ? 1 : 0, 1);
  if (static_total <= dyn_total) {
    bw.put(1, 2);  // BTYPE=01
    use_ll = FIXED_LL;
    use_dl = FIXED_DL30;
    canonical_lsb(FIXED_LL, 288, lcodes);
    canonical_lsb(FIXED_DL30, 30, dcodes);
  } else {
    bw.put(2, 2);  // BTYPE=10
    bw.put((uint32_t)(hlit - 257), 5);
    bw.put((uint32_t)(hdist - 1), 5);
    bw.put((uint32_t)(hclen - 4), 4);
    for (int pos = 0; pos < hclen; pos++)
      bw.put((uint32_t)cl_len[CLC_ORDER[pos]], 3);
    uint32_t cl_codes[19];
    canonical_lsb(cl_len, 19, cl_codes);
    for (int i = 0; i < ncl; i++) {
      bw.put(cl_codes[cl_syms[i]], cl_len[cl_syms[i]]);
      if (cl_eb[i]) bw.put((uint32_t)cl_ev[i], cl_eb[i]);
    }
    use_ll = ll;
    use_dl = dl;
    canonical_lsb(ll, 286, lcodes);
    canonical_lsb(dl, 30, dcodes);
  }
  for (int64_t t = 0; t < ntok; t++) {
    int32_t d = dist[t];
    if (d == 0) {
      int s = litlen[t];
      bw.put(lcodes[s], use_ll[s]);
    } else {
      int32_t len = litlen[t];
      int s = g_sym.lsym(len);
      bw.put(lcodes[s], use_ll[s]);
      int eb = LENGTH_EXTRA[s - 257];
      if (eb) bw.put((uint32_t)(len - LENGTH_BASE[s - 257]), eb);
      int ds = g_sym.dsym(d);
      bw.put(dcodes[ds], use_dl[ds]);
      int deb = DIST_EXTRA[ds];
      if (deb) bw.put((uint32_t)(d - DIST_BASE[ds]), deb);
    }
    if (bw.overflow) return;
  }
  bw.put(lcodes[256], use_ll[256]);  // EOB
}

struct ChunkEmit {
  const int32_t* litlen;
  const int32_t* dist;
  int64_t ntok;
  const int64_t* lf_prefix;  // (nstripes+1) x 286
  const int64_t* df_prefix;  // (nstripes+1) x 30
  const int64_t* soe;
  int64_t stripe_tokens;
  const uint8_t* raw;
  int max_stripes_per_block;

  // entropy-estimate of a stripe segment's best-format cost
  // (emit_native.seg_cost, incl. the int truncation + 250 header estimate)
  int64_t seg_cost(int64_t s0, int64_t s1) const {
    int64_t lfx[286], dfx[30];
    seg_freqs(s0, s1, lfx, dfx);
    double bits = 0.0;
    int64_t tot = 0;
    for (int s = 0; s < 286; s++) tot += lfx[s];
    if (tot)
      for (int s = 0; s < 286; s++)
        if (lfx[s]) bits += (double)lfx[s] * log2((double)tot / (double)lfx[s]);
    tot = 0;
    for (int s = 0; s < 30; s++) tot += dfx[s];
    if (tot)
      for (int s = 0; s < 30; s++)
        if (dfx[s]) bits += (double)dfx[s] * log2((double)tot / (double)dfx[s]);
    int64_t ibits = (int64_t)bits;
    for (int s = 257; s < 286; s++) ibits += lfx[s] * LENGTH_EXTRA[s - 257];
    for (int s = 0; s < 30; s++) ibits += dfx[s] * DIST_EXTRA[s];
    int64_t nraw = soe[s1 - 1] - (s0 ? soe[s0 - 1] : 0);
    int64_t stored = 40 + 8 * nraw;
    int64_t cost = ibits + 250;
    return cost < stored ? cost : stored;
  }

  void seg_freqs(int64_t s0, int64_t s1, int64_t* lfx, int64_t* dfx) const {
    for (int s = 0; s < 286; s++)
      lfx[s] = lf_prefix[s1 * 286 + s] - lf_prefix[s0 * 286 + s];
    lfx[256] += 1;  // EOB
    for (int s = 0; s < 30; s++)
      dfx[s] = df_prefix[s1 * 30 + s] - df_prefix[s0 * 30 + s];
  }

  void emit_range(BitWriter& bw, int64_t s0, int64_t s1, int seg_last,
                  int64_t known) const {
    if (bw.overflow) return;
    if (s1 - s0 > 1) {
      if (s1 - s0 > max_stripes_per_block) {
        int64_t mid = (s0 + s1) / 2;
        emit_range(bw, s0, mid, 0, -1);
        emit_range(bw, mid, s1, seg_last, -1);
        return;
      }
      if (known < 0) known = seg_cost(s0, s1);
      int64_t mid = (s0 + s1) / 2;
      int64_t ca = seg_cost(s0, mid);
      int64_t cb = seg_cost(mid, s1);
      if (ca + cb + 1024 < known) {
        emit_range(bw, s0, mid, 0, ca);
        emit_range(bw, mid, s1, seg_last, cb);
        return;
      }
    }
    int64_t t0 = s0 * stripe_tokens;
    int64_t t1 = s1 * stripe_tokens < ntok ? s1 * stripe_tokens : ntok;
    int64_t r0 = s0 ? soe[s0 - 1] : 0;
    int64_t r1 = soe[s1 - 1];
    int64_t lfx[286], dfx[30];
    seg_freqs(s0, s1, lfx, dfx);
    emit_leaf_c(bw, litlen + t0, dist + t0, t1 - t0, lfx, dfx, raw + r0,
                r1 - r0, seg_last);
  }
};

}  // namespace

extern "C" {

// Emit a whole chunk's blocks (adaptively split) into `out`, starting at
// byte 0.  lit_freq/dist_freq: per-stripe histograms from
// tz_deflate_tokenize (no EOB).  Appends an empty stored block when
// sync_flush (chunk boundary alignment); pads the final byte when `last`.
// Returns the end bit position, or -1 on output overflow.
int64_t tz_emit_chunk(const int32_t* litlen, const int32_t* dist, int64_t ntok,
                      const int32_t* lit_freq, const int32_t* dist_freq,
                      const int64_t* soe, int64_t nstripes,
                      int64_t stripe_tokens, const uint8_t* raw,
                      int64_t raw_len, int last, int sync_flush, uint8_t* out,
                      int64_t out_cap) {
  BitWriter bw(out, out_cap);
  if (ntok == 0) {
    if (last) {
      int64_t lfx[286] = {0}, dfx[30] = {0};
      lfx[256] = 1;
      emit_leaf_c(bw, litlen, dist, 0, lfx, dfx, raw, 0, 1);
    }
  } else {
    // stripe prefix sums (int64) for segment histograms; RAII thread_local
    // so thread exit releases them
    static thread_local std::unique_ptr<int64_t[]> lf_prefix_tls;
    static thread_local std::unique_ptr<int64_t[]> df_prefix_tls;
    static thread_local int64_t prefix_cap = 0;
    if (nstripes + 1 > prefix_cap) {
      prefix_cap = nstripes + 1 + 64;
      lf_prefix_tls.reset(new int64_t[prefix_cap * 286]);
      df_prefix_tls.reset(new int64_t[prefix_cap * 30]);
    }
    int64_t* lf_prefix = lf_prefix_tls.get();
    int64_t* df_prefix = df_prefix_tls.get();
    memset(lf_prefix, 0, 286 * sizeof(int64_t));
    memset(df_prefix, 0, 30 * sizeof(int64_t));
    for (int64_t st = 0; st < nstripes; st++) {
      for (int s = 0; s < 286; s++)
        lf_prefix[(st + 1) * 286 + s] =
            lf_prefix[st * 286 + s] + lit_freq[st * 286 + s];
      for (int s = 0; s < 30; s++)
        df_prefix[(st + 1) * 30 + s] =
            df_prefix[st * 30 + s] + dist_freq[st * 30 + s];
    }
    ChunkEmit ce{litlen, dist,          ntok, lf_prefix, df_prefix,
                 soe,    stripe_tokens, raw,  8};
    ce.emit_range(bw, 0, nstripes, last, -1);
  }
  if (sync_flush) {
    bw.put(0, 1);
    bw.put(0, 2);
    bw.align();
    bw.put(0, 16);
    bw.put(0xFFFF, 16);
  }
  if (last) bw.finish();
  if (bw.overflow) return -1;
  return bw.bitpos();
}

// ---------------------------------------------------------------------------
// Host checksums: serial-stream mirrors of the device kernels
// (kernels/adler32.py, kernels/crc32.py).  Seed-chainable like the
// reference API (adler32.ts:17, crc32.ts:17).
// ---------------------------------------------------------------------------

uint32_t tz_adler32(const uint8_t* p, int64_t n, uint32_t seed) {
  constexpr uint32_t BASE = 65521;
  constexpr int64_t NMAX = 5552;  // max bytes before s2 can overflow u32
  uint32_t s1 = seed & 0xFFFF;
  uint32_t s2 = (seed >> 16) & 0xFFFF;
  int64_t i = 0;
  while (i < n) {
    int64_t blk = n - i < NMAX ? n - i : NMAX;
    int64_t j = 0;
    for (; j + 16 <= blk; j += 16) {
      const uint8_t* q = p + i + j;
      for (int k = 0; k < 16; k++) { s1 += q[k]; s2 += s1; }
    }
    for (; j < blk; j++) { s1 += p[i + j]; s2 += s1; }
    s1 %= BASE;
    s2 %= BASE;
    i += blk;
  }
  return (s2 << 16) | s1;
}

namespace {
struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (int s = 1; s < 8; s++)
      for (uint32_t i = 0; i < 256; i++)
        t[s][i] = t[0][t[s - 1][i] & 0xFF] ^ (t[s - 1][i] >> 8);
  }
};
const CrcTables g_crc;
}  // namespace

uint32_t tz_crc32(const uint8_t* p, int64_t n, uint32_t seed) {
  uint32_t c = ~seed;
  int64_t i = 0;
  // slice-by-8
  for (; i + 8 <= n; i += 8) {
    uint32_t lo, hi;
    memcpy(&lo, p + i, 4);
    memcpy(&hi, p + i + 4, 4);
    lo ^= c;
    c = g_crc.t[7][lo & 0xFF] ^ g_crc.t[6][(lo >> 8) & 0xFF] ^
        g_crc.t[5][(lo >> 16) & 0xFF] ^ g_crc.t[4][lo >> 24] ^
        g_crc.t[3][hi & 0xFF] ^ g_crc.t[2][(hi >> 8) & 0xFF] ^
        g_crc.t[1][(hi >> 16) & 0xFF] ^ g_crc.t[0][hi >> 24];
  }
  for (; i < n; i++) c = g_crc.t[0][(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return ~c;
}

int tz_version() { return 5; }

}  // extern "C"
