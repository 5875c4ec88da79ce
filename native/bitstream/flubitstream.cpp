// flubitstream — host-side entropy coding for the device codec path.
//
// The device (JAX) produces zigzagged, quantized DCT coefficients as
// int16 arrays; this module turns them into standard JPEG entropy-coded
// scans (Huffman, byte-stuffed) and FVC (flu video codec) frame payloads.
// Entropy coding is inherently serial per scan, so it lives on the host in
// C++ — the analog of the reference's native encoder delegates.
//
// Built as a plain C ABI shared library; Python binds via ctypes
// (flutpu/native.py). No GIL interaction: pure buffers in/out, safe to call
// from multiple Python threads concurrently (one encoder state per call).

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

struct BitWriter {
    uint8_t* out;
    long cap;
    long pos;
    uint64_t acc;   // bits accumulate high-to-low
    int nbits;
    bool overflow;
    bool stuff;     // JPEG 0xFF00 byte stuffing

    BitWriter(uint8_t* o, long c, bool stuff_) :
        out(o), cap(c), pos(0), acc(0), nbits(0), overflow(false), stuff(stuff_) {}

    inline void put_byte(uint8_t b) {
        if (pos >= cap) { overflow = true; return; }
        out[pos++] = b;
        if (stuff && b == 0xFF) {
            if (pos >= cap) { overflow = true; return; }
            out[pos++] = 0x00;
        }
    }

    inline void put_bits(uint32_t code, int len) {
        // len <= 26 guaranteed by callers (16-bit huffman + up to 16 extra
        // written separately)
        acc = (acc << len) | (uint64_t)(code & ((1u << len) - 1));
        nbits += len;
        while (nbits >= 8) {
            nbits -= 8;
            put_byte((uint8_t)((acc >> nbits) & 0xFF));
        }
    }

    inline void flush_ones() {
        // pad final partial byte with 1-bits (JPEG convention)
        if (nbits > 0) {
            int pad = 8 - nbits;
            put_bits((1u << pad) - 1, pad);
        }
    }
};

struct HuffTable {
    uint32_t code[256];
    uint8_t len[256];
};

inline int magnitude(int v) {
    unsigned a = (unsigned)(v < 0 ? -v : v);
    int n = 0;
    while (a) { n++; a >>= 1; }
    return n;
}

// Encode one 64-coef zigzagged block. Returns new DC predictor.
inline int encode_block(BitWriter& bw, const int16_t* z, int pred,
                        const HuffTable& dc, const HuffTable& ac) {
    int dcval = z[0];
    int diff = dcval - pred;
    int s = magnitude(diff);
    bw.put_bits(dc.code[s], dc.len[s]);
    if (s) {
        int bits = diff < 0 ? diff + ((1 << s) - 1) : diff;
        bw.put_bits((uint32_t)bits, s);
    }
    int run = 0;
    for (int k = 1; k < 64; k++) {
        int v = z[k];
        if (v == 0) { run++; continue; }
        while (run > 15) {
            bw.put_bits(ac.code[0xF0], ac.len[0xF0]);  // ZRL
            run -= 16;
        }
        int sz = magnitude(v);
        int sym = (run << 4) | sz;
        bw.put_bits(ac.code[sym], ac.len[sym]);
        int bits = v < 0 ? v + ((1 << sz) - 1) : v;
        bw.put_bits((uint32_t)bits, sz);
        run = 0;
    }
    if (run > 0) {
        bw.put_bits(ac.code[0x00], ac.len[0x00]);  // EOB
    }
    return dcval;
}

}  // namespace

extern "C" {

// Encode a baseline JPEG entropy scan.
//   y:  ybh*ybw blocks of 64 int16 (zigzag order, quantized)
//   cb/cr: cbh*cbw blocks each (nullable when ncomp==1)
//   subsample: 1 = 4:2:0 (ybw==2*cbw, ybh==2*cbh, MCU = 4Y+Cb+Cr)
//              0 = 4:4:4 (MCU = Y+Cb+Cr)
//   tables: dc_luma/ac_luma/dc_chroma/ac_chroma as (code[256], len[256])
// Returns bytes written, or -1 on overflow.
long flu_jpeg_encode_scan(
    const int16_t* y, int ybw, int ybh,
    const int16_t* cb, const int16_t* cr, int cbw, int cbh,
    int subsample, int ncomp,
    const uint32_t* dcl_code, const uint8_t* dcl_len,
    const uint32_t* acl_code, const uint8_t* acl_len,
    const uint32_t* dcc_code, const uint8_t* dcc_len,
    const uint32_t* acc_code, const uint8_t* acc_len,
    uint8_t* out, long out_cap) {

    HuffTable dcl, acl, dcc, acc;
    memcpy(dcl.code, dcl_code, sizeof(dcl.code));
    memcpy(dcl.len, dcl_len, sizeof(dcl.len));
    memcpy(acl.code, acl_code, sizeof(acl.code));
    memcpy(acl.len, acl_len, sizeof(acl.len));
    memcpy(dcc.code, dcc_code, sizeof(dcc.code));
    memcpy(dcc.len, dcc_len, sizeof(dcc.len));
    memcpy(acc.code, acc_code, sizeof(acc.code));
    memcpy(acc.len, acc_len, sizeof(acc.len));

    BitWriter bw(out, out_cap, /*stuff=*/true);
    int pred_y = 0, pred_cb = 0, pred_cr = 0;

    if (ncomp == 1) {
        for (int by = 0; by < ybh; by++)
            for (int bx = 0; bx < ybw; bx++)
                pred_y = encode_block(bw, y + ((long)by * ybw + bx) * 64,
                                      pred_y, dcl, acl);
    } else if (subsample) {
        int mh = ybh / 2, mw = ybw / 2;
        for (int my = 0; my < mh; my++) {
            for (int mx = 0; mx < mw; mx++) {
                for (int sy = 0; sy < 2; sy++)
                    for (int sx = 0; sx < 2; sx++) {
                        long idx = ((long)(2 * my + sy) * ybw + (2 * mx + sx)) * 64;
                        pred_y = encode_block(bw, y + idx, pred_y, dcl, acl);
                    }
                long cidx = ((long)my * cbw + mx) * 64;
                pred_cb = encode_block(bw, cb + cidx, pred_cb, dcc, acc);
                pred_cr = encode_block(bw, cr + cidx, pred_cr, dcc, acc);
            }
        }
    } else {
        for (int by = 0; by < ybh; by++) {
            for (int bx = 0; bx < ybw; bx++) {
                long idx = ((long)by * ybw + bx) * 64;
                pred_y = encode_block(bw, y + idx, pred_y, dcl, acl);
                pred_cb = encode_block(bw, cb + idx, pred_cb, dcc, acc);
                pred_cr = encode_block(bw, cr + idx, pred_cr, dcc, acc);
            }
        }
    }
    bw.flush_ones();
    return bw.overflow ? -1 : bw.pos;
}

// Segment-layout host half (round 4): merge word-aligned bit segments into
// the final contiguous stream, pad the last partial byte with 1-bits, and
// (optionally) JPEG-byte-stuff — compact_aligned_segments +
// stuff_and_finalize in one pass. The vectorized-numpy pair measured
// 0.96 ms/frame on the threaded finalize pool; this loop is GIL-free and
// an order of magnitude cheaper, so the host half stops eating into the
// finalize overlap budget.
//   seg_bits: per-segment bit counts (zeros = padding segments, skipped)
//   words:    uint32 segments back to back, ceil(bits/32) words each,
//             bits packed MSB-first within each word
// Returns bytes written, -1 on output overflow, -2 on words underrun.
long flu_compact_segments_finalize(
    const uint32_t* seg_bits, long n_segs,
    const uint32_t* words, long n_words,
    int stuff, uint8_t* out, long out_cap) {
    BitWriter bw(out, out_cap, stuff != 0);
    long src = 0;
    for (long s = 0; s < n_segs; s++) {
        uint32_t bits = seg_bits[s];
        if (!bits) continue;
        long wcnt = ((long)bits + 31) >> 5;
        if (src + wcnt > n_words) return -2;
        for (long k = 0; k < wcnt; k++) {
            uint32_t w = words[src + k];
            long left = (long)bits - k * 32;
            if (left >= 32) {
                bw.put_bits(w >> 16, 16);
                bw.put_bits(w & 0xFFFFu, 16);
            } else if (left > 16) {
                uint32_t v = w >> (32 - left);
                bw.put_bits(v >> 16, (int)left - 16);
                bw.put_bits(v & 0xFFFFu, 16);
            } else {
                bw.put_bits(w >> (32 - left), (int)left);
            }
        }
        src += wcnt;
    }
    bw.flush_ones();
    return bw.overflow ? -1 : bw.pos;
}

// FVC plane payload: same Huffman machinery without byte stuffing, plane
// encoded block-row-major with DC prediction within the plane.
long flu_fvc_encode_plane(
    const int16_t* blocks, int bw_, int bh_,
    const uint32_t* dc_code, const uint8_t* dc_len,
    const uint32_t* ac_code, const uint8_t* ac_len,
    uint8_t* out, long out_cap) {
    HuffTable dc, ac;
    memcpy(dc.code, dc_code, sizeof(dc.code));
    memcpy(dc.len, dc_len, sizeof(dc.len));
    memcpy(ac.code, ac_code, sizeof(ac.code));
    memcpy(ac.len, ac_len, sizeof(ac.len));
    BitWriter w(out, out_cap, /*stuff=*/false);
    int pred = 0;
    for (long i = 0; i < (long)bw_ * bh_; i++)
        pred = encode_block(w, blocks + i * 64, pred, dc, ac);
    w.flush_ones();
    return w.overflow ? -1 : w.pos;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Scan decoding — the inverse of flu_jpeg_encode_scan. Used by the FVC
// decoder and tests (PSNR/bit-exactness verification without external
// decoders). Input is the byte-stuffed entropy segment; output is zigzagged
// quantized coefficients per block with ABSOLUTE DC values (prediction
// undone).
// ---------------------------------------------------------------------------

namespace {

struct BitReader {
  const uint8_t* data;
  long size;
  long pos = 0;
  uint32_t acc = 0;
  int nbits = 0;
  bool destuff;
  bool error = false;

  BitReader(const uint8_t* d, long s, bool destuff_) :
      data(d), size(s), destuff(destuff_) {}

  inline void fill() {
    while (nbits <= 24 && pos < size) {
      uint8_t b = data[pos++];
      if (destuff && b == 0xFF && pos < size && data[pos] == 0x00) pos++;
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }

  inline int peek(int n) {
    fill();
    if (nbits < n) {
      // pad with 1s (decoder-side mirror of flush_ones)
      return (int)(((acc << (n - nbits)) | ((1u << (n - nbits)) - 1)) &
                   ((1u << n) - 1));
    }
    return (int)((acc >> (nbits - n)) & ((1u << n) - 1));
  }

  inline void skip(int n) {
    fill();
    if (nbits < n) { error = true; nbits = 0; return; }
    nbits -= n;
  }
};

struct DecTable {
  // canonical decode: per length, first code value and symbol offset
  int32_t min_code[17];
  int32_t max_code[17];   // inclusive; -1 when no codes of this length
  int32_t val_off[17];
  uint8_t symbols[256];
  int n_symbols = 0;

  void build(const uint8_t* bits /*16*/, const uint8_t* vals, int nvals) {
    int code = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
      int n = bits[len - 1];
      if (n == 0) {
        min_code[len] = 0;
        max_code[len] = -1;
        val_off[len] = 0;
      } else {
        min_code[len] = code;
        val_off[len] = k;
        for (int i = 0; i < n && k < nvals; i++, k++) symbols[k] = vals[k];
        max_code[len] = code + n - 1;
        code += n;
      }
      code <<= 1;
    }
    n_symbols = k;
  }

  int decode(BitReader& br) const {
    int code = 0;
    for (int len = 1; len <= 16; len++) {
      code = (code << 1) | br.peek(1);
      br.skip(1);
      if (max_code[len] >= 0 && code >= min_code[len] && code <= max_code[len])
        return symbols[val_off[len] + code - min_code[len]];
      if (br.error) return -1;
    }
    return -1;
  }
};

inline int extend_value(int bits, int size) {
  // JPEG EXTEND: interpret `size` magnitude bits as a signed value
  if (size == 0) return 0;
  if (bits < (1 << (size - 1))) return bits - (1 << size) + 1;
  return bits;
}

int decode_block(BitReader& br, int16_t* z, int pred, const DecTable& dc,
                 const DecTable& ac) {
  memset(z, 0, 64 * sizeof(int16_t));
  int s = dc.decode(br);
  if (s < 0) return INT32_MIN;
  int diff = s ? extend_value(br.peek(s), s) : 0;
  if (s) br.skip(s);
  int dcval = pred + diff;
  z[0] = (int16_t)dcval;
  int k = 1;
  while (k < 64) {
    int sym = ac.decode(br);
    if (sym < 0) return INT32_MIN;
    if (sym == 0x00) break;        // EOB
    int run = sym >> 4;
    int size = sym & 15;
    if (sym == 0xF0) { k += 16; continue; }  // ZRL
    k += run;
    if (k >= 64) break;
    int v = extend_value(br.peek(size), size);
    br.skip(size);
    z[k++] = (int16_t)v;
  }
  return dcval;
}

}  // namespace

extern "C" {

// Decode a baseline scan back into zigzagged coefficient blocks (absolute
// DC). Geometry mirrors flu_jpeg_encode_scan. Returns 0 on success.
long flu_jpeg_decode_scan(
    const uint8_t* scan, long scan_len, int destuff,
    int16_t* y, int ybw, int ybh,
    int16_t* cb, int16_t* cr, int cbw, int cbh,
    int subsample, int ncomp,
    const uint8_t* dcl_bits, const uint8_t* dcl_vals, int dcl_n,
    const uint8_t* acl_bits, const uint8_t* acl_vals, int acl_n,
    const uint8_t* dcc_bits, const uint8_t* dcc_vals, int dcc_n,
    const uint8_t* acc_bits, const uint8_t* acc_vals, int acc_n) {
  DecTable dcl, acl, dcc, acc;
  dcl.build(dcl_bits, dcl_vals, dcl_n);
  acl.build(acl_bits, acl_vals, acl_n);
  dcc.build(dcc_bits, dcc_vals, dcc_n);
  acc.build(acc_bits, acc_vals, acc_n);
  BitReader br(scan, scan_len, destuff != 0);
  int pred_y = 0, pred_cb = 0, pred_cr = 0;

  if (ncomp == 1) {
    for (long i = 0; i < (long)ybw * ybh; i++) {
      pred_y = decode_block(br, y + i * 64, pred_y, dcl, acl);
      if (pred_y == INT32_MIN) return -1;
    }
    return 0;
  }
  if (subsample) {
    int mh = ybh / 2, mw = ybw / 2;
    for (int my = 0; my < mh; my++) {
      for (int mx = 0; mx < mw; mx++) {
        for (int sy = 0; sy < 2; sy++)
          for (int sx = 0; sx < 2; sx++) {
            long idx = ((long)(2 * my + sy) * ybw + (2 * mx + sx)) * 64;
            pred_y = decode_block(br, y + idx, pred_y, dcl, acl);
            if (pred_y == INT32_MIN) return -1;
          }
        long cidx = ((long)my * cbw + mx) * 64;
        pred_cb = decode_block(br, cb + cidx, pred_cb, dcc, acc);
        if (pred_cb == INT32_MIN) return -1;
        pred_cr = decode_block(br, cr + cidx, pred_cr, dcc, acc);
        if (pred_cr == INT32_MIN) return -1;
      }
    }
  } else {
    for (int by = 0; by < ybh; by++) {
      for (int bx = 0; bx < ybw; bx++) {
        long idx = ((long)by * ybw + bx) * 64;
        pred_y = decode_block(br, y + idx, pred_y, dcl, acl);
        pred_cb = decode_block(br, cb + idx, pred_cb, dcc, acc);
        pred_cr = decode_block(br, cr + idx, pred_cr, dcc, acc);
        if (pred_y == INT32_MIN || pred_cb == INT32_MIN ||
            pred_cr == INT32_MIN)
          return -1;
      }
    }
  }
  return 0;
}

}  // extern "C"
