// JPEG entropy coding on the host: marker parsing and Huffman decoding
// into quantised DCT coefficients, and Huffman encoding of quantised
// coefficients into a JFIF file. The pixel stages (dequantisation, the
// inverse and forward DCT, resampling, colour conversion) are not here:
// data/jpeg.py runs them in torch on the caller's device.
//
// Decoding follows libjpeg(-turbo): baseline and extended-sequential
// 8-bit Huffman files and progressive ones (spectral selection and
// successive approximation, jdphuff.c), restart markers, one, three or four
// components with sampling factors 1..4; a scan that names a Huffman
// table the file never defined gets the Annex K table (Motion-JPEG
// frames carry none). Encoding follows jchuff.c / jcphuff.c / jcmarker.c
// as libjpeg-turbo writes a file from jpeg_set_defaults: JFIF 1.01 APP0,
// DQT per table, SOF0 (or SOF2), DHT per table, DRI, SOS; Annex K tables
// for sequential files, per-scan optimal tables (jpeg_gen_optimal_table)
// for progressive ones with jpeg_simple_progression's scan script.
//
// Coefficient layout shared with data/jpeg.py: per component, a
// [bh, bw, 64] int16 array in natural (row-major) order, bh x bw being
// the component's blocks padded to whole MCUs.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // past the end: a corrupt run may step beyond 63 (libjpeg pads alike)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Annex K.3 tables: DC / AC, luminance / chrominance (bits[1..16], vals)
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChrVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffSpec {
  uint8_t bits[17];
  uint8_t vals[256];
  bool defined = false;
};

void std_spec(HuffSpec* h, bool ac, int index) {
  const uint8_t* bits = ac ? (index ? kAcChrBits : kAcLumBits)
                           : (index ? kDcChrBits : kDcLumBits);
  const uint8_t* vals = ac ? (index ? kAcChrVals : kAcLumVals)
                           : (index ? kDcChrVals : kDcLumVals);
  std::memcpy(h->bits, bits, 17);
  int n = 0;
  for (int i = 1; i <= 16; ++i) n += bits[i];
  std::memset(h->vals, 0, 256);
  std::memcpy(h->vals, vals, n);
  h->defined = true;
}

// ---------------------------------------------------------------- decoder

struct DecTable {  // jdhuff.c's d_derived_tbl, without the lookahead
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

bool derive_dec(const HuffSpec& h, DecTable* t) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int i = h.bits[l];
    if (p + i > 256) return false;
    while (i--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if (code >= (1 << si)) return false;
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (h.bits[l]) {
      t->valoffset[l] = p - huffcode[p];
      p += h.bits[l];
      t->maxcode[l] = huffcode[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  std::memcpy(t->vals, h.vals, 256);
  return true;
}

struct BitReader {
  const uint8_t* d;
  int64_t n, pos;
  uint64_t buf = 0;
  int bits = 0;
  bool hit_marker = false;
  int marker = 0;

  void fill(int need) {
    while (bits < need) {
      int byte = 0;
      if (!hit_marker && pos < n) {
        byte = d[pos];
        if (byte == 0xFF) {
          int64_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;
          int next = q < n ? d[q] : 0xD9;
          if (next == 0) {
            pos = q + 1;
          } else {
            hit_marker = true;
            marker = next;
            pos = q - 1;  // the marker's last 0xFF
            byte = 0;
          }
        } else {
          pos++;
        }
      }
      buf = (buf << 8) | (uint64_t)byte;
      bits += 8;
    }
  }
  int get(int k) {
    if (k == 0) return 0;
    fill(k);
    bits -= k;
    return (int)((buf >> bits) & ((1u << k) - 1));
  }
  int decode(const DecTable& t) {
    int code = get(1);
    int l = 1;
    while (l <= 16 && code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    if (l > 16) return 0;  // corrupt: libjpeg warns and yields 0
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  // discard the bits left in the buffer, then read the RSTn marker
  bool restart(int expect) {
    bits = 0;
    buf = 0;
    if (!hit_marker) {
      // skip to the next marker
      while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0 &&
                              d[pos + 1] != 0xFF))
        ++pos;
      if (pos + 1 >= n) return false;
      marker = d[pos + 1];
    }
    hit_marker = false;
    if (marker != 0xD0 + expect) return false;
    pos += 2;
    return true;
  }
};

int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Comp {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int bw, bh;           // blocks padded to whole MCUs
  int wblocks, hblocks; // blocks of the component's own extent
  int dw, dh;           // downsampled width and height
  int16_t* coef;
  int dc_pred;
  uint16_t qt[64];
  bool qt_latched = false;
  int scans = 0;
};

struct Decoder {
  const uint8_t* d;
  int64_t n, pos = 0;
  int width = 0, height = 0, ncomp = 0, progressive = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0, restart_interval = 0;
  int adobe = -1, jfif = 0, sof = -1;
  Comp comp[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffSpec hs[2][4];  // [dc/ac][index]
  bool frame = false;
  int eobrun = 0;

  bool fail(const std::string& m) {
    g_error = m;
    return false;
  }
  int u16(int64_t p) const { return (d[p] << 8) | d[p + 1]; }

  bool read_sof(int64_t p, int len, int marker) {
    if (d[p] != 8)
      return fail("sample precision " + std::to_string(d[p]) +
                  " (only 8-bit JPEG is read)");
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = d[p + 5];
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      return fail(std::to_string(ncomp) +
                  " components (one, three or four are read)");
    if (len < 6 + 3 * ncomp) return fail("short SOF segment");
    if (width == 0 || height == 0)
      return fail("zero image size (DNL is not supported)");
    for (int c = 0; c < ncomp; ++c) {
      comp[c].id = d[p + 6 + 3 * c];
      comp[c].h = d[p + 7 + 3 * c] >> 4;
      comp[c].v = d[p + 7 + 3 * c] & 15;
      comp[c].tq = d[p + 8 + 3 * c];
      if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4)
        return fail("bad sampling factor");
      if (comp[c].tq > 3) return fail("bad quantisation table index");
      if (comp[c].h > hmax) hmax = comp[c].h;
      if (comp[c].v > vmax) vmax = comp[c].v;
    }
    progressive = marker == 0xC2;
    sof = marker;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      Comp& k = comp[c];
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.dw = (int)(((int64_t)width * k.h + hmax - 1) / hmax);
      k.dh = (int)(((int64_t)height * k.v + vmax - 1) / vmax);
      k.wblocks = (k.dw + 7) / 8;
      k.hblocks = (k.dh + 7) / 8;
    }
    frame = true;
    return true;
  }

  bool read_headers_until_sos() {
    // walks markers from pos; stops at SOS (pos at its segment) or EOI
    while (pos + 4 <= n) {
      if (d[pos] != 0xFF) {
        ++pos;  // libjpeg skips garbage before a marker
        continue;
      }
      int m = d[pos + 1];
      if (m == 0xFF) {
        ++pos;
        continue;
      }
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        pos += 2;
        continue;
      }
      if (m == 0xD9) return true;
      int len = u16(pos + 2);
      int64_t p = pos + 4;
      if (pos + 2 + len > n) return fail("truncated marker segment");
      if (m == 0xDA) return true;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        if (frame) return fail("two frames in one file");
        if (!read_sof(p, len - 2, m)) return false;
      } else if ((m >= 0xC3 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
                 m != 0xCC) {
        char b[96];
        std::snprintf(b, sizeof b,
                      "SOF%d (%s) is not supported: baseline, extended "
                      "and progressive Huffman files only",
                      m - 0xC0, m >= 0xC9 ? "arithmetic coding"
                                          : "lossless or hierarchical");
        return fail(b);
      } else if (m == 0xC4) {
        int64_t q = p, end = pos + 2 + len;
        while (q < end) {
          int tc = d[q] >> 4, th = d[q] & 15;
          if (tc > 1 || th > 3) return fail("bad DHT table class or index");
          HuffSpec& h = hs[tc][th];
          int cnt = 0;
          h.bits[0] = 0;
          for (int i = 1; i <= 16; ++i) {
            h.bits[i] = d[q + i];
            cnt += h.bits[i];
          }
          if (cnt > 256 || q + 17 + cnt > end) return fail("bad DHT segment");
          std::memset(h.vals, 0, 256);
          std::memcpy(h.vals, d + q + 17, cnt);
          h.defined = true;
          q += 17 + cnt;
        }
      } else if (m == 0xDB) {
        int64_t q = p, end = pos + 2 + len;
        while (q < end) {
          int pq = d[q] >> 4, tq = d[q] & 15;
          if (tq > 3) return fail("bad DQT table index");
          for (int i = 0; i < 64; ++i)
            qt[tq][kZigzag[i]] =
                pq ? (uint16_t)u16(q + 1 + 2 * i) : (uint16_t)d[q + 1 + i];
          qt_defined[tq] = true;
          q += 1 + 64 * (pq ? 2 : 1);
        }
      } else if (m == 0xDD) {
        restart_interval = u16(p);
      } else if (m == 0xE0) {
        if (len >= 16 && std::memcmp(d + p, "JFIF\0", 5) == 0) jfif = 1;
      } else if (m == 0xEE) {
        if (len >= 14 && std::memcmp(d + p, "Adobe", 5) == 0)
          adobe = d[p + 11];
      } else if (m == 0xDC) {
        return fail("DNL marker is not supported");
      }
      pos += 2 + len;
    }
    return fail("no SOS / EOI marker (truncated file)");
  }

  bool decode_scan() {
    // pos at the SOS marker
    int len = u16(pos + 2);
    int64_t p = pos + 4;
    int ns = d[p];
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) return fail("bad SOS segment");
    Comp* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = d[p + 1 + 2 * i];
      int c = 0;
      while (c < ncomp && comp[c].id != id) ++c;
      if (c == ncomp) return fail("SOS names an unknown component");
      sc[i] = &comp[c];
      sc[i]->td = d[p + 2 + 2 * i] >> 4;
      sc[i]->ta = d[p + 2 + 2 * i] & 15;
      if (sc[i]->td > 3 || sc[i]->ta > 3)
        return fail("bad Huffman table index in SOS");
    }
    int ss = d[p + 1 + 2 * ns], se = d[p + 2 + 2 * ns];
    int ah = d[p + 3 + 2 * ns] >> 4, al = d[p + 3 + 2 * ns] & 15;
    pos += 2 + len;
    if (!progressive) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        return fail("bad spectral selection in a sequential scan");
    } else {
      if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) ||
          al > 13 || (ah != 0 && ah != al + 1))
        return fail("bad progressive scan parameters");
    }
    for (int i = 0; i < ns; ++i) {
      Comp& k = *sc[i];
      if (!k.qt_latched) {
        if (!qt_defined[k.tq]) return fail("no quantisation table defined");
        std::memcpy(k.qt, qt[k.tq], sizeof k.qt);
        k.qt_latched = true;
      }
      k.dc_pred = 0;
      k.scans++;
    }
    DecTable dct[4], act[4];
    bool need_dc = !progressive || (ss == 0 && ah == 0);
    bool need_ac = !progressive || ss > 0;
    for (int i = 0; i < ns; ++i) {
      if (need_dc) {
        HuffSpec& h = hs[0][sc[i]->td];
        if (!h.defined) std_spec(&h, false, sc[i]->td ? 1 : 0);
        if (!derive_dec(h, &dct[i])) return fail("bad Huffman table");
      }
      if (need_ac) {
        HuffSpec& h = hs[1][sc[i]->ta];
        if (!h.defined) std_spec(&h, true, sc[i]->ta ? 1 : 0);
        if (!derive_dec(h, &act[i])) return fail("bad Huffman table");
      }
    }
    BitReader br{d, n, pos};
    eobrun = 0;
    int restarts_to_go = restart_interval, next_rst = 0;
    int64_t mcus;
    int mw;
    if (ns == 1) {
      mw = sc[0]->wblocks;
      mcus = (int64_t)sc[0]->wblocks * sc[0]->hblocks;
    } else {
      mw = mcux;
      mcus = (int64_t)mcux * mcuy;
    }
    for (int64_t m = 0; m < mcus; ++m) {
      if (restart_interval) {
        if (restarts_to_go == 0) {
          if (!br.restart(next_rst)) return fail("missing restart marker");
          next_rst = (next_rst + 1) & 7;
          restarts_to_go = restart_interval;
          for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
          eobrun = 0;
        }
        restarts_to_go--;
      }
      int mx = (int)(m % mw), my = (int)(m / mw);
      for (int i = 0; i < ns; ++i) {
        Comp& k = *sc[i];
        int bx0 = ns == 1 ? mx : mx * k.h, by0 = ns == 1 ? my : my * k.v;
        int nh = ns == 1 ? 1 : k.h, nv = ns == 1 ? 1 : k.v;
        for (int yy = 0; yy < nv; ++yy)
          for (int xx = 0; xx < nh; ++xx) {
            int16_t* blk =
                k.coef + ((int64_t)(by0 + yy) * k.bw + (bx0 + xx)) * 64;
            decode_block(br, k, blk, dct[i], act[i], ss, se, ah, al);
          }
      }
    }
    // continue after the entropy-coded data: at the next marker
    pos = br.pos;
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0 &&
                            d[pos + 1] != 0xFF &&
                            !(d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)))
      ++pos;
    return true;
  }

  void decode_block(BitReader& br, Comp& k, int16_t* blk, const DecTable& dt,
                    const DecTable& at, int ss, int se, int ah, int al) {
    if (!progressive) {
      int s = br.decode(dt);
      int diff = s ? extend(br.get(s), s) : 0;
      k.dc_pred += diff;
      blk[0] = (int16_t)k.dc_pred;
      for (int kk = 1; kk < 64; ++kk) {
        int rs = br.decode(at);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          kk += r;
          if (kk > 63) break;
          blk[kZigzag[kk]] = (int16_t)extend(br.get(s), s);
        } else {
          if (r != 15) break;
          kk += 15;
        }
      }
      return;
    }
    if (ss == 0) {
      if (ah == 0) {
        int s = br.decode(dt);
        int diff = s ? extend(br.get(s), s) : 0;
        k.dc_pred += diff;
        blk[0] = (int16_t)((uint32_t)k.dc_pred << al);
      } else {
        if (br.get(1)) blk[0] |= (int16_t)(1 << al);
      }
      return;
    }
    if (ah == 0) {
      if (eobrun > 0) {
        eobrun--;
        return;
      }
      for (int kk = ss; kk <= se; ++kk) {
        int rs = br.decode(at);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          kk += r;
          if (kk > 63) break;
          blk[kZigzag[kk]] =
              (int16_t)((uint32_t)extend(br.get(s), s) << al);
        } else {
          if (r == 15) {
            kk += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            eobrun--;
            break;
          }
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int kk = ss;
    if (eobrun == 0) {
      for (; kk <= se; kk++) {
        int rs = br.decode(at);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* c = blk + kZigzag[kk];
          if (*c != 0) {
            if (br.get(1)) {
              if ((*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
            }
          } else {
            if (--r < 0) break;
          }
          kk++;
        } while (kk <= se);
        if (s) blk[kZigzag[kk]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; kk <= se; kk++) {
        int16_t* c = blk + kZigzag[kk];
        if (*c != 0) {
          if (br.get(1)) {
            if ((*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
          }
        }
      }
      eobrun--;
    }
  }
};

// ---------------------------------------------------------------- encoder

struct EncTable {
  uint32_t code[256];
  uint8_t size[256];
};

void derive_enc(const HuffSpec& h, EncTable* t) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < h.bits[l]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  int lastp = p, code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    code <<= 1;
    si++;
  }
  std::memset(t->size, 0, sizeof t->size);
  std::memset(t->code, 0, sizeof t->code);
  for (p = 0; p < lastp; ++p) {
    t->code[h.vals[p]] = huffcode[p];
    t->size[h.vals[p]] = huffsize[p];
  }
}

// jchuff.c jpeg_gen_optimal_table
void gen_optimal(const int64_t* freq_in, HuffSpec* h) {
  const int MAX_CLEN = 32;
  uint8_t bits[MAX_CLEN + 1];
  int codesize[257], others[257];
  int64_t freq[257];
  std::memset(bits, 0, sizeof bits);
  for (int i = 0; i < 257; ++i) {
    codesize[i] = 0;
    others[i] = -1;
    freq[i] = i < 256 ? freq_in[i] : 0;
  }
  freq[256] = 1;
  for (;;) {
    int c1 = -1, c2 = -1;
    int64_t v = 1000000000L;
    for (int i = 0; i <= 256; i++)
      if (freq[i] && freq[i] <= v) {
        v = freq[i];
        c1 = i;
      }
    v = 1000000000L;
    for (int i = 0; i <= 256; i++)
      if (freq[i] && freq[i] <= v && i != c1) {
        v = freq[i];
        c2 = i;
      }
    if (c2 < 0) break;
    freq[c1] += freq[c2];
    freq[c2] = 0;
    codesize[c1]++;
    while (others[c1] >= 0) {
      c1 = others[c1];
      codesize[c1]++;
    }
    others[c1] = c2;
    codesize[c2]++;
    while (others[c2] >= 0) {
      c2 = others[c2];
      codesize[c2]++;
    }
  }
  for (int i = 0; i <= 256; i++)
    if (codesize[i]) bits[codesize[i]]++;
  for (int i = MAX_CLEN; i > 16; i--) {
    while (bits[i] > 0) {
      int j = i - 2;
      while (bits[j] == 0) j--;
      bits[i] -= 2;
      bits[i - 1]++;
      bits[j + 1] += 2;
      bits[j]--;
    }
  }
  int i = 16;
  while (bits[i] == 0) i--;
  bits[i]--;
  std::memset(h->bits, 0, 17);
  std::memcpy(h->bits, bits, 17);
  int p = 0;
  for (i = 1; i <= MAX_CLEN; i++)
    for (int j = 0; j <= 255; j++)
      if (codesize[j] == i) h->vals[p++] = (uint8_t)j;
  h->defined = true;
}

struct Writer {
  std::vector<uint8_t> out;
  uint64_t put_buffer = 0;
  int put_bits = 0;
  bool gather = false;       // statistics pass: no output
  int64_t* dc_freq = nullptr;
  int64_t* ac_freq = nullptr;

  void byte(int b) { out.push_back((uint8_t)b); }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 0xFF);
  }
  void emit_bits(uint32_t code, int size) {
    if (gather || size == 0) return;
    put_buffer = (put_buffer << size) | (code & ((1u << size) - 1));
    put_bits += size;
    while (put_bits >= 8) {
      int c = (int)((put_buffer >> (put_bits - 8)) & 0xFF);
      byte(c);
      if (c == 0xFF) byte(0);
      put_bits -= 8;
    }
  }
  void flush_bits() {
    if (gather) return;
    emit_bits(0x7F, 7);
    put_buffer = 0;
    put_bits = 0;
  }
};

int nbits_of(int v) {
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

struct EncComp {
  int id, h, v, tq;
  int bw, bh, wblocks, hblocks;
  const int16_t* coef;
  int last_dc;
};

struct Encoder {
  Writer w;
  int ncomp, width, height, hmax, vmax, mcux, mcuy, restart_interval;
  EncComp comp[4];
  // progressive state (jcphuff.c)
  int eobrun = 0, be_count = 0;
  std::vector<char> bit_buffer;
  const EncTable* ac_tbl = nullptr;
  int64_t* ac_stats = nullptr;

  void emit_symbol_ac(int sym) {
    if (w.gather)
      ac_stats[sym]++;
    else
      w.emit_bits(ac_tbl->code[sym], ac_tbl->size[sym]);
  }
  void emit_buffered_bits(const char* buf, int n) {
    if (w.gather) return;
    for (int i = 0; i < n; ++i) w.emit_bits((uint32_t)buf[i], 1);
  }
  void emit_eobrun() {
    if (eobrun > 0) {
      int temp = eobrun, nb = 0;
      while ((temp >>= 1)) nb++;
      emit_symbol_ac(nb << 4);
      if (nb) w.emit_bits((uint32_t)eobrun, nb);
      eobrun = 0;
      emit_buffered_bits(bit_buffer.data(), be_count);
      be_count = 0;
    }
  }
};

void write_dqt(Writer& w, const uint16_t* qt, int index) {
  bool prec = false;
  for (int i = 0; i < 64; ++i)
    if (qt[i] > 255) prec = true;
  w.byte(0xFF);
  w.byte(0xDB);
  w.u16(prec ? 64 * 2 + 3 : 64 + 3);
  w.byte(index + (prec ? 0x10 : 0));
  for (int i = 0; i < 64; ++i) {
    int v = qt[kZigzag[i]];
    if (prec) w.byte(v >> 8);
    w.byte(v & 0xFF);
  }
}

void write_dht(Writer& w, const HuffSpec& h, int index, bool ac) {
  int len = 0;
  for (int i = 1; i <= 16; ++i) len += h.bits[i];
  w.byte(0xFF);
  w.byte(0xC4);
  w.u16(len + 2 + 1 + 16);
  w.byte(index + (ac ? 0x10 : 0));
  for (int i = 1; i <= 16; ++i) w.byte(h.bits[i]);
  for (int i = 0; i < len; ++i) w.byte(h.vals[i]);
}

}  // namespace

extern "C" {

const char* jpeg_error() { return g_error.c_str(); }

// Header of a JPEG file. info (int32 [48]): 0 width, 1 height, 2 ncomp,
// 3 progressive, 4 hmax, 5 vmax, 6 mcux, 7 mcuy, 8 Adobe transform (-1:
// no APP14), 9 JFIF APP0 seen, 10 restart interval, 11 SOF marker; per
// component c at 16 + 8c: id, h, v, tq, bw, bh, dw, dh. Returns 0, or -1
// with jpeg_error() set.
int jpeg_info(const uint8_t* data, int64_t n, int32_t* info) {
  Decoder dec;
  dec.d = data;
  dec.n = n;
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) {
    g_error = "not a JPEG file (no SOI marker)";
    return -1;
  }
  if (!dec.read_headers_until_sos()) return -1;
  if (!dec.frame) {
    g_error = "no frame header (SOF) before the first scan";
    return -1;
  }
  std::memset(info, 0, 48 * sizeof(int32_t));
  info[0] = dec.width;
  info[1] = dec.height;
  info[2] = dec.ncomp;
  info[3] = dec.progressive;
  info[4] = dec.hmax;
  info[5] = dec.vmax;
  info[6] = dec.mcux;
  info[7] = dec.mcuy;
  info[8] = dec.adobe;
  info[9] = dec.jfif;
  info[10] = dec.restart_interval;
  info[11] = dec.sof;
  for (int c = 0; c < dec.ncomp; ++c) {
    const Comp& k = dec.comp[c];
    int32_t* r = info + 16 + 8 * c;
    r[0] = k.id;
    r[1] = k.h;
    r[2] = k.v;
    r[3] = k.tq;
    r[4] = k.bw;
    r[5] = k.bh;
    r[6] = k.dw;
    r[7] = k.dh;
  }
  return 0;
}

// Entropy-decode every scan into coef (the components' [bh, bw, 64]
// arrays one after another, zeroed here) and return each component's
// quantisation table (natural order) in qt [ncomp, 64]. Returns 0, or -1
// with jpeg_error() set.
int jpeg_decode(const uint8_t* data, int64_t n, int16_t* coef,
                uint16_t* qt) {
  Decoder dec;
  dec.d = data;
  dec.n = n;
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) {
    g_error = "not a JPEG file (no SOI marker)";
    return -1;
  }
  dec.pos = 2;
  if (!dec.read_headers_until_sos()) return -1;
  if (!dec.frame) {
    g_error = "no frame header (SOF) before the first scan";
    return -1;
  }
  int64_t off = 0;
  for (int c = 0; c < dec.ncomp; ++c) {
    dec.comp[c].coef = coef + off;
    off += (int64_t)dec.comp[c].bw * dec.comp[c].bh * 64;
  }
  std::memset(coef, 0, off * sizeof(int16_t));
  int scans = 0;
  for (;;) {
    if (dec.pos + 4 > n || dec.d[dec.pos + 1] != 0xDA) break;
    if (!dec.decode_scan()) return -1;
    scans++;
    if (!dec.read_headers_until_sos()) {
      // a truncated tail after complete scans: libjpeg warns and outputs
      g_error.clear();
      break;
    }
  }
  if (scans == 0) {
    g_error = "no scan in the file";
    return -1;
  }
  for (int c = 0; c < dec.ncomp; ++c) {
    if (!dec.comp[c].qt_latched) {
      g_error = "a component appears in no scan";
      return -1;
    }
    std::memcpy(qt + 64 * c, dec.comp[c].qt, 64 * sizeof(uint16_t));
  }
  return 0;
}

// Encode quantised coefficients (natural order, the [bh, bw, 64] layout
// above, blocks padded to whole MCUs) into a JFIF file (one or three
// components) or an Adobe CMYK file (four, sequential only). comps (int32
// [ncomp, 4]): id, h, v, quantisation table index (0 or 1); qt [2, 64]
// natural order. progressive: 0 sequential (Annex K tables), 1
// jpeg_simple_progression with optimal tables. Returns the byte count
// written to out (at most cap), or -1 with jpeg_error() set.
int64_t jpeg_encode(const int16_t* coef, int width, int height, int ncomp,
                    const int32_t* comps, const uint16_t* qt,
                    int restart_interval, int progressive, uint8_t* out,
                    int64_t cap) {
  Encoder e;
  e.ncomp = ncomp;
  e.width = width;
  e.height = height;
  e.restart_interval = restart_interval;
  e.hmax = e.vmax = 1;
  if (ncomp != 1 && ncomp != 3 && !(ncomp == 4 && !progressive)) {
    g_error = "one or three components are written (four in a sequential "
              "file)";
    return -1;
  }
  for (int c = 0; c < ncomp; ++c) {
    e.comp[c].id = comps[4 * c];
    e.comp[c].h = comps[4 * c + 1];
    e.comp[c].v = comps[4 * c + 2];
    e.comp[c].tq = comps[4 * c + 3];
    if (e.comp[c].h > e.hmax) e.hmax = e.comp[c].h;
    if (e.comp[c].v > e.vmax) e.vmax = e.comp[c].v;
  }
  e.mcux = (width + 8 * e.hmax - 1) / (8 * e.hmax);
  e.mcuy = (height + 8 * e.vmax - 1) / (8 * e.vmax);
  int64_t off = 0;
  for (int c = 0; c < ncomp; ++c) {
    EncComp& k = e.comp[c];
    k.bw = e.mcux * k.h;
    k.bh = e.mcuy * k.v;
    int dw = (int)(((int64_t)width * k.h + e.hmax - 1) / e.hmax);
    int dh = (int)(((int64_t)height * k.v + e.vmax - 1) / e.vmax);
    k.wblocks = (dw + 7) / 8;
    k.hblocks = (dh + 7) / 8;
    k.coef = coef + off;
    off += (int64_t)k.bw * k.bh * 64;
  }
  Writer& w = e.w;
  w.out.reserve((size_t)(off / 4 + 1024));
  // SOI, JFIF APP0 (jpeg_set_defaults: version 1.01, aspect 1:1)
  w.byte(0xFF);
  w.byte(0xD8);
  const uint8_t app0[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0,
                          1,    1,    0,    0,    1,   0,   1,   0,   0};
  // four components: CMYK with an Adobe APP14 marker instead (transform 0,
  // jcmarker.c emit_adobe_app14), as jpeg_set_colorspace(JCS_CMYK) writes
  const uint8_t app14[] = {0xFF, 0xEE, 0x00, 0x0E, 'A', 'd', 'o', 'b',
                           'e',  0,    100,  0,    0,   0,   0,   0};
  if (ncomp == 4)
    for (uint8_t b : app14) w.byte(b);
  else
    for (uint8_t b : app0) w.byte(b);
  bool sent_qt[4] = {false, false, false, false};
  for (int c = 0; c < ncomp; ++c) {
    int t = e.comp[c].tq;
    if (!sent_qt[t]) {
      write_dqt(w, qt + 64 * t, t);
      sent_qt[t] = true;
    }
  }
  // SOF0 / SOF2
  w.byte(0xFF);
  w.byte(progressive ? 0xC2 : 0xC0);
  w.u16(3 * ncomp + 2 + 5 + 1);
  w.byte(8);
  w.u16(height);
  w.u16(width);
  w.byte(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    w.byte(e.comp[c].id);
    w.byte((e.comp[c].h << 4) + e.comp[c].v);
    w.byte(e.comp[c].tq);
  }
  int last_restart = 0;
  auto dri = [&]() {
    if (restart_interval != last_restart) {
      w.byte(0xFF);
      w.byte(0xDD);
      w.u16(4);
      w.u16(restart_interval);
      last_restart = restart_interval;
    }
  };
  auto sos = [&](int ns, const int* ci, int ss, int se, int ah, int al) {
    w.byte(0xFF);
    w.byte(0xDA);
    w.u16(2 * ns + 2 + 1 + 3);
    w.byte(ns);
    for (int i = 0; i < ns; ++i) {
      int c = ci[i];
      int t = c ? 1 : 0;
      // emit_sos: no DC table in a refinement or AC scan, no AC table
      // in a DC scan
      int td = ss == 0 && ah == 0 ? t : 0, ta = se ? t : 0;
      w.byte(e.comp[c].id);
      w.byte((td << 4) + ta);
    }
    w.byte(ss);
    w.byte(se);
    w.byte((ah << 4) + al);
  };

  if (!progressive) {
    HuffSpec dc[2], ac[2];
    EncTable edc[2], eac[2];
    for (int t = 0; t < 2; ++t) {
      std_spec(&dc[t], false, t);
      std_spec(&ac[t], true, t);
      derive_enc(dc[t], &edc[t]);
      derive_enc(ac[t], &eac[t]);
    }
    int ntab = ncomp > 1 ? 2 : 1;
    for (int t = 0; t < ntab; ++t) {
      write_dht(w, dc[t], t, false);
      write_dht(w, ac[t], t, true);
    }
    dri();
    int ci[4] = {0, 1, 2, 3};
    if (ncomp == 1) {
      // a non-interleaved scan covers the component's own blocks
      sos(1, ci, 0, 63, 0, 0);
    } else {
      sos(ncomp, ci, 0, 63, 0, 0);
    }
    int restarts_to_go = restart_interval, next_rst = 0;
    int64_t mcus = ncomp == 1 ? (int64_t)e.comp[0].wblocks * e.comp[0].hblocks
                              : (int64_t)e.mcux * e.mcuy;
    int mw = ncomp == 1 ? e.comp[0].wblocks : e.mcux;
    for (int c = 0; c < ncomp; ++c) e.comp[c].last_dc = 0;
    for (int64_t m = 0; m < mcus; ++m) {
      if (restart_interval && restarts_to_go == 0) {
        w.flush_bits();
        w.byte(0xFF);
        w.byte(0xD0 + next_rst);
        for (int c = 0; c < ncomp; ++c) e.comp[c].last_dc = 0;
        next_rst = (next_rst + 1) & 7;
        restarts_to_go = restart_interval;
      }
      int mx = (int)(m % mw), my = (int)(m / mw);
      for (int c = 0; c < ncomp; ++c) {
        EncComp& k = e.comp[c];
        int t = c ? 1 : 0;
        int nh = ncomp == 1 ? 1 : k.h, nv = ncomp == 1 ? 1 : k.v;
        int bx0 = ncomp == 1 ? mx : mx * k.h, by0 = ncomp == 1 ? my : my * k.v;
        for (int yy = 0; yy < nv; ++yy)
          for (int xx = 0; xx < nh; ++xx) {
            const int16_t* b =
                k.coef + ((int64_t)(by0 + yy) * k.bw + bx0 + xx) * 64;
            int temp = b[0] - k.last_dc, temp2 = temp;
            k.last_dc = b[0];
            if (temp < 0) {
              temp = -temp;
              temp2--;
            }
            int nb = nbits_of(temp);
            w.emit_bits(edc[t].code[nb], edc[t].size[nb]);
            if (nb) w.emit_bits((uint32_t)temp2, nb);
            int r = 0;
            for (int kk = 1; kk < 64; ++kk) {
              int v = b[kZigzag[kk]];
              if (v == 0) {
                r++;
                continue;
              }
              while (r > 15) {
                w.emit_bits(eac[t].code[0xF0], eac[t].size[0xF0]);
                r -= 16;
              }
              int a = v < 0 ? -v : v, v2 = v < 0 ? v - 1 : v;
              int nbb = 1;
              while ((a >>= 1)) nbb++;
              int sym = (r << 4) + nbb;
              w.emit_bits(eac[t].code[sym], eac[t].size[sym]);
              w.emit_bits((uint32_t)v2, nbb);
              r = 0;
            }
            if (r > 0) w.emit_bits(eac[t].code[0], eac[t].size[0]);
          }
      }
      if (restart_interval) restarts_to_go--;
    }
    w.flush_bits();
  } else {
    // jpeg_simple_progression's script
    struct Scan { int ns; int ci[3]; int ss, se, ah, al; };
    std::vector<Scan> script;
    if (ncomp == 3) {
      script = {{3, {0, 1, 2}, 0, 0, 0, 1}, {1, {0}, 1, 5, 0, 2},
                {1, {2}, 1, 63, 0, 1},      {1, {1}, 1, 63, 0, 1},
                {1, {0}, 6, 63, 0, 2},      {1, {0}, 1, 63, 2, 1},
                {3, {0, 1, 2}, 0, 0, 1, 0}, {1, {2}, 1, 63, 1, 0},
                {1, {1}, 1, 63, 1, 0},      {1, {0}, 1, 63, 1, 0}};
    } else {
      script = {{1, {0}, 0, 0, 0, 1},  {1, {0}, 1, 5, 0, 2},
                {1, {0}, 6, 63, 0, 2}, {1, {0}, 1, 63, 2, 1},
                {1, {0}, 0, 0, 1, 0},  {1, {0}, 1, 63, 1, 0}};
    }
    e.bit_buffer.resize(1000);
    for (const Scan& s : script) {
      bool dc_scan = s.ss == 0;
      int64_t dc_freq[2][257], ac_freq[257];
      HuffSpec dcs[2], acs;
      EncTable edc[2], eac;
      // pass 0 gathers statistics, pass 1 writes
      for (int pass = 0; pass < 2; ++pass) {
        w.gather = pass == 0;
        if (pass == 0) {
          std::memset(dc_freq, 0, sizeof dc_freq);
          std::memset(ac_freq, 0, sizeof ac_freq);
        } else {
          if (dc_scan && s.ah == 0) {
            bool done[2] = {false, false};
            for (int i = 0; i < s.ns; ++i) {
              int t = s.ci[i] ? 1 : 0;
              if (done[t]) continue;
              done[t] = true;
              gen_optimal(dc_freq[t], &dcs[t]);
              derive_enc(dcs[t], &edc[t]);
              write_dht(w, dcs[t], t, false);
            }
          } else if (!dc_scan) {
            int t = s.ci[0] ? 1 : 0;
            gen_optimal(ac_freq, &acs);
            derive_enc(acs, &eac);
            write_dht(w, acs, t, true);
          }
          dri();
          sos(s.ns, s.ci, s.ss, s.se, s.ah, s.al);
        }
        e.ac_tbl = &eac;
        e.ac_stats = ac_freq;
        e.eobrun = 0;
        e.be_count = 0;
        for (int c = 0; c < ncomp; ++c) e.comp[c].last_dc = 0;
        int restarts_to_go = restart_interval, next_rst = 0;
        int64_t mcus = s.ns == 1 ? (int64_t)e.comp[s.ci[0]].wblocks *
                                       e.comp[s.ci[0]].hblocks
                                 : (int64_t)e.mcux * e.mcuy;
        int mw = s.ns == 1 ? e.comp[s.ci[0]].wblocks : e.mcux;
        for (int64_t m = 0; m < mcus; ++m) {
          if (restart_interval && restarts_to_go == 0) {
            // emit_restart (jcphuff.c)
            e.emit_eobrun();
            if (!w.gather) {
              w.flush_bits();
              w.byte(0xFF);
              w.byte(0xD0 + next_rst);
            }
            if (s.ss == 0)
              for (int c = 0; c < ncomp; ++c) e.comp[c].last_dc = 0;
            else
              e.eobrun = 0, e.be_count = 0;
            next_rst = (next_rst + 1) & 7;
            restarts_to_go = restart_interval;
          }
          int mx = (int)(m % mw), my = (int)(m / mw);
          for (int i = 0; i < s.ns; ++i) {
            EncComp& k = e.comp[s.ci[i]];
            int t = s.ci[i] ? 1 : 0;
            int nh = s.ns == 1 ? 1 : k.h, nv = s.ns == 1 ? 1 : k.v;
            int bx0 = s.ns == 1 ? mx : mx * k.h;
            int by0 = s.ns == 1 ? my : my * k.v;
            for (int yy = 0; yy < nv; ++yy)
              for (int xx = 0; xx < nh; ++xx) {
                const int16_t* b =
                    k.coef + ((int64_t)(by0 + yy) * k.bw + bx0 + xx) * 64;
                if (dc_scan && s.ah == 0) {
                  int temp2 = b[0] >> s.al;   // IRIGHT_SHIFT
                  int temp = temp2 - k.last_dc;
                  k.last_dc = temp2;
                  temp2 = temp;
                  if (temp < 0) {
                    temp = -temp;
                    temp2--;
                  }
                  int nb = nbits_of(temp);
                  if (w.gather)
                    dc_freq[t][nb]++;
                  else
                    w.emit_bits(edc[t].code[nb], edc[t].size[nb]);
                  if (nb) w.emit_bits((uint32_t)temp2, nb);
                } else if (dc_scan) {
                  w.emit_bits((uint32_t)(b[0] >> s.al), 1);
                } else if (s.ah == 0) {
                  // encode_mcu_AC_first
                  int r = 0;
                  for (int kk = s.ss; kk <= s.se; ++kk) {
                    int temp = b[kZigzag[kk]];
                    if (temp == 0) {
                      r++;
                      continue;
                    }
                    int temp2;
                    if (temp < 0) {
                      temp = -temp;
                      temp >>= s.al;
                      temp2 = ~temp;
                    } else {
                      temp >>= s.al;
                      temp2 = temp;
                    }
                    if (temp == 0) {
                      r++;
                      continue;
                    }
                    if (e.eobrun > 0) e.emit_eobrun();
                    while (r > 15) {
                      e.emit_symbol_ac(0xF0);
                      r -= 16;
                    }
                    int nb = 1;
                    while ((temp >>= 1)) nb++;
                    e.emit_symbol_ac((r << 4) + nb);
                    w.emit_bits((uint32_t)temp2, nb);
                    r = 0;
                  }
                  if (r > 0) {
                    e.eobrun++;
                    if (e.eobrun == 0x7FFF) e.emit_eobrun();
                  }
                } else {
                  // encode_mcu_AC_refine
                  int absvalues[64];
                  int eob = 0;
                  for (int kk = s.ss; kk <= s.se; ++kk) {
                    int temp = b[kZigzag[kk]];
                    if (temp < 0) temp = -temp;
                    temp >>= s.al;
                    absvalues[kk] = temp;
                    if (temp == 1) eob = kk;
                  }
                  int r = 0, br = 0;
                  char* bbuf = e.bit_buffer.data() + e.be_count;
                  for (int kk = s.ss; kk <= s.se; ++kk) {
                    int temp = absvalues[kk];
                    if (temp == 0) {
                      r++;
                      continue;
                    }
                    while (r > 15 && kk <= eob) {
                      e.emit_eobrun();
                      e.emit_symbol_ac(0xF0);
                      r -= 16;
                      e.emit_buffered_bits(bbuf, br);
                      bbuf = e.bit_buffer.data();
                      br = 0;
                    }
                    if (temp > 1) {
                      bbuf[br++] = (char)(temp & 1);
                      continue;
                    }
                    e.emit_eobrun();
                    e.emit_symbol_ac((r << 4) + 1);
                    temp = (b[kZigzag[kk]] < 0) ? 0 : 1;
                    w.emit_bits((uint32_t)temp, 1);
                    e.emit_buffered_bits(bbuf, br);
                    bbuf = e.bit_buffer.data();
                    br = 0;
                    r = 0;
                  }
                  if (r > 0 || br > 0) {
                    e.eobrun++;
                    e.be_count += br;
                    if (e.eobrun == 0x7FFF ||
                        e.be_count > (1000 - 64 + 1))
                      e.emit_eobrun();
                  }
                }
              }
          }
          if (restart_interval) restarts_to_go--;
        }
        e.emit_eobrun();
        w.flush_bits();
      }
    }
    w.gather = false;
  }
  w.byte(0xFF);
  w.byte(0xD9);
  if ((int64_t)w.out.size() > cap) {
    g_error = "output buffer too small";
    return -1;
  }
  std::memcpy(out, w.out.data(), w.out.size());
  return (int64_t)w.out.size();
}

}  // extern "C"
