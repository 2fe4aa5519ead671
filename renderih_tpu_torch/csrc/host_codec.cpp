// Host image codec and resampling for the dataset tools: baseline JPEG
// decoding, PNG row unfiltering, bilinear resize and affine warp of uint8
// images, each reproducing what the tools' cv2 calls return, bit for bit.
//
// JPEG follows libjpeg-turbo's default decompression path: Huffman
// (sequential, interleaved or not, restart markers), the integer "islow"
// IDCT (jidctint.c) with its range-limit table, fancy (triangle) chroma
// upsampling (jdsample.c: h2v1, h1v2 and h2v2; plain replication where the
// component is at most 2 samples wide or the factors are other integers),
// edge rows and columns replicated as jdmainct.c does, and the fixed-point
// YCbCr->RGB tables of jdcolor.c. Progressive, arithmetic-coded, lossless,
// 12-bit and CMYK files are refused with a message.
//
// Resize is cv::resize(INTER_LINEAR) on 8U: 11-bit fixed-point horizontal
// taps, then the vertical blend of its vector path
// ((S >> 4) * beta >> 16, summed, (+2) >> 2); an exact 2x downscale in both
// axes is INTER_AREA's rounded 2x2 mean, as cv::resize switches to it.
// Warp is cv::warpAffine(INTER_LINEAR, BORDER_CONSTANT 0) on 8U as OpenCV 5
// computes it on an AVX2 host: the inverse matrix in double, float32 source
// coordinates (fma(m0, x, y*m1 + m2) in blocks of 16 destination columns,
// fma(x, m0, y*m1) + m2 in the scalar tail), and a float32 fma bilinear
// blend rounded half to even.
//
// Plain C interface (ctypes, renderih_tpu_torch/data/image_io.py). Build:
//   g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off host_codec.cpp
// (-ffp-contract=off: every fused multiply-add is an explicit std::fmaf).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

// zigzag index -> natural index, with 16 extra entries so a corrupt run
// length past 63 lands on 63 (jutils.c jpeg_natural_order).
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  // canonical decoding tables (jdhuff.c): maxcode[l] is the largest code of
  // length l (-1 if none), valoffset[l] maps a code of length l to its
  // index in vals.
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | symbol, 0 if the code is longer.
  uint16_t look[512];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;         // tables of the current scan
  int bw = 0, bh = 0;         // blocks across and down, padded to whole MCUs
  int dw = 0, dh = 0;         // downsampled width and height in samples
  int pred = 0;
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  std::vector<uint8_t> pix;   // (bh * 8) x (bw * 8) samples after the IDCT
};

struct Jpeg {
  const uint8_t* data = nullptr;
  size_t len = 0, pos = 0;
  int width = 0, height = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0, restart = 0;
  bool sof = false, adobe = false, jfif = false;
  int adobe_transform = -1;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;
  std::string err;
  // bit reader
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;
};

bool fail(Jpeg& j, const std::string& msg) {
  if (j.err.empty()) j.err = msg;
  return false;
}

int read_u16(Jpeg& j) {
  if (j.pos + 2 > j.len) return -1;
  int v = (j.data[j.pos] << 8) | j.data[j.pos + 1];
  j.pos += 2;
  return v;
}

bool build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* symbols,
                   int nsym) {
  // code sizes and codes in canonical order (Annex C)
  std::vector<int> sizes, codes;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) sizes.push_back(l);
  if ((int)sizes.size() != nsym) return false;
  int code = 0, si = sizes.empty() ? 0 : sizes[0];
  for (size_t k = 0; k < sizes.size();) {
    while (k < sizes.size() && sizes[k] == si) {
      codes.push_back(code++);
      ++k;
    }
    if (code >= (1 << si)) return false;  // over-subscribed
    code <<= 1;
    ++si;
  }
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      t.valoffset[l] = p - codes[p];
      p += counts[l - 1];
      t.maxcode[l] = codes[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0x7fffffff;
  std::memcpy(t.vals, symbols, nsym);
  std::memset(t.look, 0, sizeof(t.look));
  for (int k = 0; k < nsym; ++k) {
    int l = sizes[k];
    if (l > 9) continue;
    int base = codes[k] << (9 - l);
    for (int r = 0; r < (1 << (9 - l)); ++r)
      t.look[base + r] = (uint16_t)((l << 8) | symbols[k]);
  }
  t.defined = true;
  return true;
}

// Entropy-coded bytes: 0xFF00 is a stuffed 0xFF; any other marker ends the
// data, after which zeros are fed (libjpeg's behaviour on a short segment).
inline void fill_bits(Jpeg& j) {
  while (j.bitcnt <= 24) {
    uint32_t byte = 0;
    if (!j.hit_marker && j.pos < j.len) {
      byte = j.data[j.pos];
      if (byte == 0xFF) {
        uint8_t next = j.pos + 1 < j.len ? j.data[j.pos + 1] : 0xD9;
        if (next == 0x00) {
          j.pos += 2;
        } else {
          j.hit_marker = true;
          byte = 0;
        }
      } else {
        j.pos += 1;
      }
    }
    j.bitbuf |= byte << (24 - j.bitcnt);
    j.bitcnt += 8;
  }
}

inline int get_bits(Jpeg& j, int n) {
  if (n == 0) return 0;
  fill_bits(j);
  int v = (int)(j.bitbuf >> (32 - n));
  j.bitbuf <<= n;
  j.bitcnt -= n;
  return v;
}

inline int extend(int v, int n) {
  return v < (1 << (n - 1)) ? v - (1 << n) + 1 : v;
}

inline int decode_symbol(Jpeg& j, const Huffman& t) {
  fill_bits(j);
  int peek = (int)(j.bitbuf >> 23);
  int e = t.look[peek];
  if (e) {
    int l = e >> 8;
    j.bitbuf <<= l;
    j.bitcnt -= l;
    return e & 0xFF;
  }
  int code = (int)(j.bitbuf >> 31);
  int l = 1;
  j.bitbuf <<= 1;
  j.bitcnt -= 1;
  while (code > t.maxcode[l]) {
    if (l >= 16) return -1;
    code = (code << 1) | (int)(j.bitbuf >> 31);
    j.bitbuf <<= 1;
    j.bitcnt -= 1;
    ++l;
  }
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

bool decode_block(Jpeg& j, Component& c, int16_t* blk) {
  const Huffman& dct = j.dc[c.td];
  const Huffman& act = j.ac[c.ta];
  int s = decode_symbol(j, dct);
  if (s < 0 || s > 15) return fail(j, "corrupt DC code");
  int diff = s ? extend(get_bits(j, s), s) : 0;
  c.pred += diff;
  blk[0] = (int16_t)c.pred;
  for (int k = 1; k < 64; ++k) {
    int rs = decode_symbol(j, act);
    if (rs < 0) return fail(j, "corrupt AC code");
    int r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      blk[kNatural[k]] = (int16_t)extend(get_bits(j, sz), sz);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return true;
}

// Restart: drop the bits left in the buffer, step over RSTn, reset the
// DC predictions.
void process_restart(Jpeg& j, const std::vector<int>& scomps) {
  j.bitbuf = 0;
  j.bitcnt = 0;
  j.hit_marker = false;
  while (j.pos + 1 < j.len) {
    if (j.data[j.pos] == 0xFF && j.data[j.pos + 1] >= 0xD0 &&
        j.data[j.pos + 1] <= 0xD7) {
      j.pos += 2;
      break;
    }
    if (j.data[j.pos] == 0xFF && j.data[j.pos + 1] != 0x00 &&
        j.data[j.pos + 1] != 0xFF)
      break;  // some other marker: leave it for the segment parser
    ++j.pos;
  }
  for (int ci : scomps) j.comps[ci].pred = 0;
}

bool decode_scan(Jpeg& j, const std::vector<int>& scomps) {
  for (int ci : scomps) j.comps[ci].pred = 0;
  j.bitbuf = 0;
  j.bitcnt = 0;
  j.hit_marker = false;
  int todo_restart = j.restart;
  if (scomps.size() == 1) {
    // non-interleaved: one block per MCU over the component's own blocks
    Component& c = j.comps[scomps[0]];
    int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
    for (int by = 0; by < nby; ++by) {
      for (int bx = 0; bx < nbx; ++bx) {
        if (j.restart && todo_restart == 0) {
          process_restart(j, scomps);
          todo_restart = j.restart;
        }
        if (!decode_block(j, c, &c.coef[((size_t)by * c.bw + bx) * 64]))
          return false;
        if (j.restart) --todo_restart;
      }
    }
  } else {
    for (int my = 0; my < j.mcuy; ++my) {
      for (int mx = 0; mx < j.mcux; ++mx) {
        if (j.restart && todo_restart == 0) {
          process_restart(j, scomps);
          todo_restart = j.restart;
        }
        for (int ci : scomps) {
          Component& c = j.comps[ci];
          for (int v = 0; v < c.v; ++v) {
            for (int h = 0; h < c.h; ++h) {
              size_t by = (size_t)my * c.v + v, bx = (size_t)mx * c.h + h;
              if (!decode_block(j, c, &c.coef[(by * c.bw + bx) * 64]))
                return false;
            }
          }
        }
        if (j.restart) --todo_restart;
      }
    }
  }
  // step to the next marker
  j.hit_marker = false;
  while (j.pos + 1 < j.len &&
         !(j.data[j.pos] == 0xFF && j.data[j.pos + 1] != 0x00 &&
           !(j.data[j.pos + 1] >= 0xD0 && j.data[j.pos + 1] <= 0xD7)))
    ++j.pos;
  return true;
}

// --- jidctint.c: jpeg_idct_islow ------------------------------------------

constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// jdmaster.c prepare_range_limit_table, post-IDCT part: index x & 1023 of
// the centred result.
uint8_t kIdctLimit[1024];
void init_idct_limit() {
  for (int i = 0; i < 1024; ++i) {
    int v;
    if (i < 128) v = i + 128;
    else if (i < 512) v = 255;
    else if (i < 896) v = 0;
    else v = i - 896;
    kIdctLimit[i] = (uint8_t)v;
  }
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = (int)((int64_t)ip[0] * qp[0]) << PASS1_BITS;
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = (int)descale(tmp10 + tmp3, sh);
    wp[56] = (int)descale(tmp10 - tmp3, sh);
    wp[8] = (int)descale(tmp11 + tmp2, sh);
    wp[48] = (int)descale(tmp11 - tmp2, sh);
    wp[16] = (int)descale(tmp12 + tmp1, sh);
    wp[40] = (int)descale(tmp12 - tmp1, sh);
    wp[24] = (int)descale(tmp13 + tmp0, sh);
    wp[32] = (int)descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t v = kIdctLimit[(int)descale(wp[0], PASS1_BITS + 3) & 1023];
      for (int k = 0; k < 8; ++k) op[k] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    op[0] = kIdctLimit[(int)descale(tmp10 + tmp3, sh) & 1023];
    op[7] = kIdctLimit[(int)descale(tmp10 - tmp3, sh) & 1023];
    op[1] = kIdctLimit[(int)descale(tmp11 + tmp2, sh) & 1023];
    op[6] = kIdctLimit[(int)descale(tmp11 - tmp2, sh) & 1023];
    op[2] = kIdctLimit[(int)descale(tmp12 + tmp1, sh) & 1023];
    op[5] = kIdctLimit[(int)descale(tmp12 - tmp1, sh) & 1023];
    op[3] = kIdctLimit[(int)descale(tmp13 + tmp0, sh) & 1023];
    op[4] = kIdctLimit[(int)descale(tmp13 - tmp0, sh) & 1023];
  }
}

// --- jdsample.c: one component to full size ------------------------------

// Output row y (0 <= y < H) of component c upsampled to `width` columns.
void upsample_row(const Jpeg& j, const Component& c, int y, uint8_t* out,
                  int width) {
  const int stride = c.bw * 8;
  const int fh = j.hmax / c.h, fv = j.vmax / c.v;
  auto row = [&](int r) {
    r = r < 0 ? 0 : (r >= c.dh ? c.dh - 1 : r);
    return c.pix.data() + (size_t)r * stride;
  };
  const int dw = c.dw;
  if (fh == 1 && fv == 1) {
    std::memcpy(out, row(y), width);
    return;
  }
  if (fh == 2 && fv == 1 && dw > 2) {  // h2v1_fancy_upsample
    const uint8_t* in = row(y);
    std::vector<uint8_t> tmp((size_t)dw * 2);
    uint8_t* o = tmp.data();
    int v0 = in[0];
    *o++ = (uint8_t)v0;
    *o++ = (uint8_t)((v0 * 3 + in[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; ++x) {
      int v = in[x] * 3;
      *o++ = (uint8_t)((v + in[x - 1] + 1) >> 2);
      *o++ = (uint8_t)((v + in[x + 1] + 2) >> 2);
    }
    int vl = in[dw - 1];
    *o++ = (uint8_t)((vl * 3 + in[dw - 2] + 1) >> 2);
    *o++ = (uint8_t)vl;
    std::memcpy(out, tmp.data(), width);
    return;
  }
  if (fh == 1 && fv == 2) {  // h1v2_fancy_upsample
    int r = y >> 1;
    const uint8_t* in0 = row(r);
    const uint8_t* in1 = (y & 1) ? row(r + 1) : row(r - 1);
    int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < width; ++x)
      out[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    return;
  }
  if (fh == 2 && fv == 2 && dw > 2) {  // h2v2_fancy_upsample
    int r = y >> 1;
    const uint8_t* in0 = row(r);
    const uint8_t* in1 = (y & 1) ? row(r + 1) : row(r - 1);
    std::vector<uint8_t> tmp((size_t)dw * 2);
    uint8_t* o = tmp.data();
    int thiscol = in0[0] * 3 + in1[0];
    int nextcol = in0[1] * 3 + in1[1];
    *o++ = (uint8_t)((thiscol * 4 + 8) >> 4);
    *o++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
    int lastcol = thiscol;
    thiscol = nextcol;
    for (int x = 2; x < dw; ++x) {
      nextcol = in0[x] * 3 + in1[x];
      *o++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
      *o++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
    }
    *o++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
    *o++ = (uint8_t)((thiscol * 4 + 7) >> 4);
    std::memcpy(out, tmp.data(), width);
    return;
  }
  // h2v1/h2v2 at most 2 samples wide and every other integral factor:
  // replication (h2v1_upsample, h2v2_upsample, int_upsample)
  const uint8_t* in = row(y / fv);
  for (int x = 0; x < width; ++x) {
    int sx = x / fh;
    out[x] = in[sx < dw ? sx : dw - 1];
  }
}

// --- jdcolor.c tables -----------------------------------------------------

int kCrR[256], kCbB[256];
int64_t kCrG[256], kCbG[256];
void init_color_tables() {
  const int SCALEBITS = 16;
  const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
  auto FIX = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
  for (int i = 0, x = -128; i < 256; ++i, ++x) {
    kCrR[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
    kCbB[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
    kCrG[i] = (-FIX(0.71414)) * x;
    kCbG[i] = (-FIX(0.34414)) * x + ONE_HALF;
  }
}

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

bool parse_and_decode(Jpeg& j, uint8_t* rgb, bool header_only) {
  if (j.len < 4 || j.data[0] != 0xFF || j.data[1] != 0xD8)
    return fail(j, "not a JPEG file (no SOI marker)");
  j.pos = 2;
  for (;;) {
    // find the next marker
    while (j.pos < j.len && j.data[j.pos] != 0xFF) ++j.pos;
    while (j.pos < j.len && j.data[j.pos] == 0xFF) ++j.pos;
    if (j.pos >= j.len) return fail(j, "truncated JPEG (no EOI marker)");
    int marker = j.data[j.pos++];
    if (marker == 0xD9) break;                       // EOI
    if (marker >= 0xD0 && marker <= 0xD7) continue;  // stray RSTn
    int seglen = read_u16(j);
    if (seglen < 2 || j.pos + seglen - 2 > j.len)
      return fail(j, "truncated JPEG segment");
    size_t seg = j.pos, end = j.pos + seglen - 2;
    const uint8_t* d = j.data;
    if (marker == 0xC0 || marker == 0xC1) {  // baseline / extended Huffman
      if (d[seg] != 8)
        return fail(j, "unsupported JPEG: " + std::to_string(d[seg]) +
                           "-bit samples");
      j.height = (d[seg + 1] << 8) | d[seg + 2];
      j.width = (d[seg + 3] << 8) | d[seg + 4];
      int nc = d[seg + 5];
      if (j.width <= 0 || j.height <= 0)
        return fail(j, "unsupported JPEG: zero or deferred image height");
      if (nc != 1 && nc != 3)
        return fail(j, "unsupported JPEG: " + std::to_string(nc) +
                           " components (CMYK/YCCK)");
      if ((size_t)(6 + 3 * nc) > (size_t)(seglen - 2))
        return fail(j, "truncated JPEG frame header");
      j.comps.resize(nc);
      for (int i = 0; i < nc; ++i) {
        Component& c = j.comps[i];
        c.id = d[seg + 6 + 3 * i];
        c.h = d[seg + 7 + 3 * i] >> 4;
        c.v = d[seg + 7 + 3 * i] & 15;
        c.tq = d[seg + 8 + 3 * i] & 3;
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
          return fail(j, "corrupt JPEG sampling factors");
        j.hmax = std::max(j.hmax, c.h);
        j.vmax = std::max(j.vmax, c.v);
      }
      for (Component& c : j.comps) {
        if (j.hmax % c.h || j.vmax % c.v)
          return fail(j, "unsupported JPEG: fractional sampling factors");
      }
      j.mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
      j.mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
      for (Component& c : j.comps) {
        c.bw = j.mcux * c.h;
        c.bh = j.mcuy * c.v;
        c.dw = (int)(((int64_t)j.width * c.h + j.hmax - 1) / j.hmax);
        c.dh = (int)(((int64_t)j.height * c.v + j.vmax - 1) / j.vmax);
      }
      j.sof = true;
      if (header_only) return true;
      for (Component& c : j.comps)
        c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    } else if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA ||
               marker == 0xCE) {
      return fail(j, "unsupported JPEG: progressive");
    } else if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB ||
               marker == 0xCF) {
      return fail(j, "unsupported JPEG: lossless");
    } else if (marker == 0xC9 || marker == 0xCA || marker == 0xCD ||
               marker == 0xCC) {
      return fail(j, "unsupported JPEG: arithmetic coding");
    } else if (marker == 0xC5) {
      return fail(j, "unsupported JPEG: hierarchical");
    } else if (marker == 0xC4) {  // DHT
      size_t p = seg;
      while (p < end) {
        int tc = d[p] >> 4, th = d[p] & 15;
        if (tc > 1 || th > 3 || p + 17 > end)
          return fail(j, "corrupt JPEG Huffman table");
        const uint8_t* counts = d + p + 1;
        int n = 0;
        for (int l = 0; l < 16; ++l) n += counts[l];
        if (n > 256 || p + 17 + n > end)
          return fail(j, "corrupt JPEG Huffman table");
        Huffman& t = tc == 0 ? j.dc[th] : j.ac[th];
        if (!build_huffman(t, counts, d + p + 17, n))
          return fail(j, "corrupt JPEG Huffman table");
        p += 17 + n;
      }
    } else if (marker == 0xDB) {  // DQT
      size_t p = seg;
      while (p < end) {
        int pq = d[p] >> 4, tq = d[p] & 15;
        if (tq > 3) return fail(j, "corrupt JPEG quantization table");
        size_t need = 1 + 64 * (pq ? 2 : 1);
        if (p + need > end) return fail(j, "corrupt JPEG quantization table");
        for (int k = 0; k < 64; ++k) {
          int v = pq ? (d[p + 1 + 2 * k] << 8) | d[p + 2 + 2 * k]
                     : d[p + 1 + k];
          j.qt[tq][kNatural[k]] = (uint16_t)v;
        }
        j.qt_defined[tq] = true;
        p += need;
      }
    } else if (marker == 0xDD) {  // DRI
      j.restart = (d[seg] << 8) | d[seg + 1];
    } else if (marker == 0xE0) {  // APP0 (JFIF)
      if (seglen >= 7 && std::memcmp(d + seg, "JFIF\0", 5) == 0) j.jfif = true;
    } else if (marker == 0xEE) {  // APP14 (Adobe)
      if (seglen >= 14 && std::memcmp(d + seg, "Adobe", 5) == 0) {
        j.adobe = true;
        j.adobe_transform = d[seg + 11];
      }
    } else if (marker == 0xDA) {  // SOS
      if (!j.sof) return fail(j, "corrupt JPEG: scan before frame header");
      int ns = d[seg];
      if (ns < 1 || ns > 4 || (size_t)(1 + 2 * ns + 3) > (size_t)(seglen - 2))
        return fail(j, "corrupt JPEG scan header");
      std::vector<int> scomps;
      for (int i = 0; i < ns; ++i) {
        int id = d[seg + 1 + 2 * i], tables = d[seg + 2 + 2 * i];
        int ci = -1;
        for (size_t k = 0; k < j.comps.size(); ++k)
          if (j.comps[k].id == id) ci = (int)k;
        if (ci < 0) return fail(j, "corrupt JPEG scan component");
        j.comps[ci].td = (tables >> 4) & 3;
        j.comps[ci].ta = tables & 3;
        if (!j.dc[j.comps[ci].td].defined || !j.ac[j.comps[ci].ta].defined)
          return fail(j, "corrupt JPEG: undefined Huffman table");
        scomps.push_back(ci);
      }
      j.pos = end;
      if (!decode_scan(j, scomps)) return false;
      continue;
    }
    j.pos = end;
  }
  if (!j.sof) return fail(j, "corrupt JPEG: no frame header");
  if (header_only) return true;

  // IDCT every block of every component
  for (Component& c : j.comps) {
    if (!j.qt_defined[c.tq])
      return fail(j, "corrupt JPEG: undefined quantization table");
    const int stride = c.bw * 8;
    c.pix.assign((size_t)stride * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], j.qt[c.tq],
                   c.pix.data() + (size_t)by * 8 * stride + bx * 8, stride);
  }

  const int W = j.width, H = j.height;
  if (j.comps.size() == 1) {
    std::vector<uint8_t> g(W);
    for (int y = 0; y < H; ++y) {
      upsample_row(j, j.comps[0], y, g.data(), W);
      uint8_t* o = rgb + (size_t)y * W * 3;
      for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
    }
    return true;
  }
  // jdapimin.c default_decompress_parms: JFIF / Adobe transform / ids R,G,B
  bool is_rgb = false;
  if (j.jfif) {
    is_rgb = false;
  } else if (j.adobe) {
    is_rgb = j.adobe_transform == 0;
  } else if (j.comps[0].id == 'R' && j.comps[1].id == 'G' &&
             j.comps[2].id == 'B') {
    is_rgb = true;
  }
  std::vector<uint8_t> c0(W), c1(W), c2(W);
  for (int y = 0; y < H; ++y) {
    upsample_row(j, j.comps[0], y, c0.data(), W);
    upsample_row(j, j.comps[1], y, c1.data(), W);
    upsample_row(j, j.comps[2], y, c2.data(), W);
    uint8_t* o = rgb + (size_t)y * W * 3;
    if (is_rgb) {
      for (int x = 0; x < W; ++x) {
        o[3 * x] = c0[x];
        o[3 * x + 1] = c1[x];
        o[3 * x + 2] = c2[x];
      }
      continue;
    }
    for (int x = 0; x < W; ++x) {
      int yy = c0[x], cb = c1[x], cr = c2[x];
      o[3 * x] = clamp255(yy + kCrR[cr]);
      o[3 * x + 1] = clamp255(yy + (int)((kCbG[cb] + kCrG[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + kCbB[cb]);
    }
  }
  return true;
}

struct Init {
  Init() {
    init_idct_limit();
    init_color_tables();
  }
} init_once;

void copy_err(const std::string& msg, char* err, int errlen) {
  if (err && errlen > 0) {
    std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
  }
}

inline int round_half_even(float v) { return (int)std::nearbyint(v); }

}  // namespace

extern "C" {

// Header only: image size and component count. 0 on success.
int hc_jpeg_info(const uint8_t* data, int64_t len, int* width, int* height,
                 int* ncomp, char* err, int errlen) {
  Jpeg j;
  j.data = data;
  j.len = (size_t)len;
  if (!parse_and_decode(j, nullptr, true)) {
    copy_err(j.err, err, errlen);
    return 1;
  }
  *width = j.width;
  *height = j.height;
  *ncomp = (int)j.comps.size();
  return 0;
}

// Decode to RGB (height, width, 3) in `rgb`, sized by hc_jpeg_info.
int hc_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* rgb, int width,
                   int height, char* err, int errlen) {
  Jpeg j;
  j.data = data;
  j.len = (size_t)len;
  if (!parse_and_decode(j, rgb, false)) {
    copy_err(j.err, err, errlen);
    return 1;
  }
  if (j.width != width || j.height != height) {
    copy_err("JPEG size changed between header and decode", err, errlen);
    return 1;
  }
  return 0;
}

// PNG row unfiltering in place: `data` holds height rows of
// (1 + rowbytes) bytes (filter type, then the filtered row); the
// unfiltered rows are written to `out` (height * rowbytes). bpp is the
// filter's byte distance (bytes per complete pixel, at least 1).
int hc_png_unfilter(const uint8_t* data, int64_t height, int64_t rowbytes,
                    int bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = data + y * (rowbytes + 1);
    int ft = in[0];
    ++in;
    uint8_t* o = out + y * rowbytes;
    switch (ft) {
      case 0:
        std::memcpy(o, in, (size_t)rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          o[i] = (uint8_t)(in[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          o[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0, b = prev ? prev[i] : 0;
          o[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0, b = prev ? prev[i] : 0;
          int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[i] = (uint8_t)(in[i] + pred);
        }
        break;
      default:
        return 1;  // unknown filter type
    }
    prev = o;
  }
  return 0;
}

}  // extern "C"

namespace {

// The separable two-tap resampler of cv::resize on 8U (resizeGeneric_ with
// HResizeLinear and VResizeLinear): 11-bit fixed-point horizontal taps
// a0/a1 at source column xofs (one tap, x 2048, where `edge`), then the
// vertical blend of its vector path ((S >> 4) * beta >> 16, summed,
// (+2) >> 2) of source rows yofs and yofs + 1 (clamped) with b0/b1.
// INTER_LINEAR and INTER_AREA's upscaling differ only in the tables.
struct LinearTables {
  std::vector<int> xofs, a0, a1, yofs, b0, b1;
  std::vector<char> edge;
};

void resize_linear_core(const uint8_t* src, int sh, int sw, int cn, uint8_t* dst,
                        int dh, int dw, const LinearTables& t) {
  std::vector<int> hrow0((size_t)dw * cn), hrow1((size_t)dw * cn);
  auto hpass = [&](int sy, int* out) {
    sy = sy < 0 ? 0 : (sy >= sh ? sh - 1 : sy);
    const uint8_t* r = src + (size_t)sy * sw * cn;
    for (int x = 0; x < dw; ++x) {
      const uint8_t* p = r + (size_t)t.xofs[x] * cn;
      for (int k = 0; k < cn; ++k)
        out[x * cn + k] = t.edge[x] ? p[k] * 2048 : p[k] * t.a0[x] + p[k + cn] * t.a1[x];
    }
  };
  auto sat16 = [](int v) { return v < -32768 ? -32768 : (v > 32767 ? 32767 : v); };
  for (int y = 0; y < dh; ++y) {
    hpass(t.yofs[y], hrow0.data());
    hpass(t.yofs[y] + 1, hrow1.data());
    uint8_t* o = dst + (size_t)y * dw * cn;
    for (int i = 0; i < dw * cn; ++i) {
      int s0 = sat16(hrow0[i] >> 4), s1 = sat16(hrow1[i] >> 4);
      int m = sat16(((s0 * t.b0[y]) >> 16) + ((s1 * t.b1[y]) >> 16));
      o[i] = clamp255((m + 2) >> 2);
    }
  }
}

// cv::resize's "fast" INTER_AREA for integer factors kx, ky (resizeAreaFast):
// the k x k sum; 2 x 2 is its SIMD path's (sum + 2) >> 2, any other factor
// the scalar sum * (1.f / area) rounded half to even.
void resize_area_fast(const uint8_t* src, int sw, int cn, uint8_t* dst, int dh, int dw,
                      int kx, int ky) {
  const int area = kx * ky;
  const float scale = 1.f / (float)area;
  for (int y = 0; y < dh; ++y) {
    uint8_t* o = dst + (size_t)y * dw * cn;
    for (int x = 0; x < dw; ++x)
      for (int k = 0; k < cn; ++k) {
        int sum = 0;
        for (int sy = 0; sy < ky; ++sy) {
          const uint8_t* r = src + (size_t)(y * ky + sy) * sw * cn;
          for (int sx = 0; sx < kx; ++sx) sum += r[(size_t)(x * kx + sx) * cn + k];
        }
        o[x * cn + k] = area == 4 ? (uint8_t)((sum + 2) >> 2)
                                  : clamp255(round_half_even((float)sum * scale));
      }
  }
}

struct AreaTap {
  int di, si;
  float alpha;
};

// computeResizeAreaTab: each destination cell's source samples and their
// weights (in double, stored as float).
std::vector<AreaTap> area_tab(int ssize, int dsize, int cn, double scale) {
  std::vector<AreaTap> tab;
  for (int dx = 0; dx < dsize; ++dx) {
    double fsx1 = dx * scale, fsx2 = fsx1 + scale;
    double cell = std::min(scale, ssize - fsx1);
    int sx1 = (int)std::ceil(fsx1), sx2 = (int)std::floor(fsx2);
    sx2 = std::min(sx2, ssize - 1);
    sx1 = std::min(sx1, sx2);
    if (sx1 - fsx1 > 1e-3) tab.push_back({dx * cn, (sx1 - 1) * cn, (float)((sx1 - fsx1) / cell)});
    for (int sx = sx1; sx < sx2; ++sx) tab.push_back({dx * cn, sx * cn, (float)(1.0 / cell)});
    if (fsx2 - sx2 > 1e-3)
      tab.push_back({dx * cn, sx2 * cn, (float)(std::min(std::min(fsx2 - sx2, 1.), cell) / cell)});
  }
  return tab;
}

// cv::resize's general INTER_AREA downscale (ResizeArea_Invoker<uchar,
// float>): each source row's weighted horizontal sums in float, folded
// into the destination row with the row's weight, in OpenCV's order.
void resize_area_tables(const uint8_t* src, int sh, int sw, int cn, uint8_t* dst, int dh,
                        int dw, double scale_x, double scale_y) {
  const std::vector<AreaTap> xtab = area_tab(sw, dw, cn, scale_x);
  const std::vector<AreaTap> ytab = area_tab(sh, dh, 1, scale_y);
  const int width = dw * cn;
  std::vector<float> buf(width), sum(width, 0.f);
  int prev_dy = ytab.empty() ? 0 : ytab[0].di;
  auto store = [&](int dy) {
    uint8_t* o = dst + (size_t)dy * width;
    for (int i = 0; i < width; ++i) o[i] = clamp255(round_half_even(sum[i]));
  };
  for (const AreaTap& yt : ytab) {
    const float beta = yt.alpha;
    const uint8_t* s = src + (size_t)yt.si * sw * cn;
    std::fill(buf.begin(), buf.end(), 0.f);
    for (const AreaTap& xt : xtab)
      for (int k = 0; k < cn; ++k) buf[xt.di + k] = buf[xt.di + k] + (float)s[xt.si + k] * xt.alpha;
    if (yt.di != prev_dy) {
      store(prev_dy);
      for (int i = 0; i < width; ++i) sum[i] = beta * buf[i];
      prev_dy = yt.di;
    } else {
      for (int i = 0; i < width; ++i) sum[i] += beta * buf[i];
    }
  }
  store(prev_dy);
}

}  // namespace

extern "C" {

// cv::resize(src, (dw, dh), INTER_LINEAR) on uint8 HWC.
int hc_resize_bilinear_u8(const uint8_t* src, int sh, int sw, int cn,
                          uint8_t* dst, int dh, int dw) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || cn <= 0) return 1;
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, (size_t)sh * sw * cn);
    return 0;
  }
  const double inv_x = (double)dw / sw, inv_y = (double)dh / sh;
  const double scale_x = 1. / inv_x, scale_y = 1. / inv_y;
  if (scale_x == 2.0 && scale_y == 2.0) {  // INTER_AREA's fast 2x path
    resize_area_fast(src, sw, cn, dst, dh, dw, 2, 2);
    return 0;
  }
  const float ONE = 2048.f;
  LinearTables t;
  t.xofs.resize(dw), t.a0.resize(dw), t.a1.resize(dw), t.edge.resize(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (float)((x + 0.5) * scale_x - 0.5);
    int sx = (int)std::floor(fx);
    fx -= (float)sx;
    if (sx < 0) fx = 0.f, sx = 0;
    t.edge[x] = sx >= sw - 1;
    if (t.edge[x]) fx = 0.f, sx = sw - 1;
    t.xofs[x] = sx;
    t.a0[x] = round_half_even((1.f - fx) * ONE);
    t.a1[x] = round_half_even(fx * ONE);
  }
  t.yofs.resize(dh), t.b0.resize(dh), t.b1.resize(dh);
  for (int y = 0; y < dh; ++y) {
    float fy = (float)((y + 0.5) * scale_y - 0.5);
    int sy = (int)std::floor(fy);
    fy -= (float)sy;
    t.yofs[y] = sy;
    t.b0[y] = round_half_even((1.f - fy) * ONE);
    t.b1[y] = round_half_even(fy * ONE);
  }
  resize_linear_core(src, sh, sw, cn, dst, dh, dw, t);
  return 0;
}

// cv::resize(src, (dw, dh), INTER_AREA) on uint8 HWC: a copy at equal
// size; integer factors down in both axes: the fast k x k mean; any other
// downscale in both axes: the area tables; otherwise (an axis scaled up)
// the two-tap resampler with INTER_AREA's coefficients.
int hc_resize_area_u8(const uint8_t* src, int sh, int sw, int cn, uint8_t* dst, int dh,
                      int dw) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || cn <= 0) return 1;
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, (size_t)sh * sw * cn);
    return 0;
  }
  const double inv_x = (double)dw / sw, inv_y = (double)dh / sh;
  const double scale_x = 1. / inv_x, scale_y = 1. / inv_y;
  const int ix = (int)std::lrint(scale_x), iy = (int)std::lrint(scale_y);
  const bool fast = std::fabs(scale_x - ix) < 2.220446049250313e-16 &&
                    std::fabs(scale_y - iy) < 2.220446049250313e-16;
  if (scale_x >= 1 && scale_y >= 1) {
    if (fast)
      resize_area_fast(src, sw, cn, dst, dh, dw, ix, iy);
    else
      resize_area_tables(src, sh, sw, cn, dst, dh, dw, scale_x, scale_y);
    return 0;
  }
  const float ONE = 2048.f;
  LinearTables t;
  t.xofs.resize(dw), t.a0.resize(dw), t.a1.resize(dw), t.edge.resize(dw);
  for (int x = 0; x < dw; ++x) {
    int sx = (int)std::floor(x * scale_x);
    float fx = (float)((x + 1) - (sx + 1) * inv_x);
    fx = fx <= 0 ? 0.f : fx - std::floor(fx);
    t.edge[x] = sx >= sw - 1;
    if (t.edge[x]) fx = 0.f, sx = sw - 1;
    t.xofs[x] = sx;
    t.a0[x] = round_half_even((1.f - fx) * ONE);
    t.a1[x] = round_half_even(fx * ONE);
  }
  t.yofs.resize(dh), t.b0.resize(dh), t.b1.resize(dh);
  for (int y = 0; y < dh; ++y) {
    int sy = (int)std::floor(y * scale_y);
    float fy = (float)((y + 1) - (sy + 1) * inv_y);
    fy = fy <= 0 ? 0.f : fy - std::floor(fy);
    t.yofs[y] = sy;
    t.b0[y] = round_half_even((1.f - fy) * ONE);
    t.b1[y] = round_half_even(fy * ONE);
  }
  resize_linear_core(src, sh, sw, cn, dst, dh, dw, t);
  return 0;
}

// cv::warpAffine(src, M, (dw, dh)) with INTER_LINEAR and a constant-0
// border, on uint8 HWC; M is the 2x3 forward matrix, row-major.
int hc_warp_affine_u8(const uint8_t* src, int sh, int sw, int cn,
                      const double* M, uint8_t* dst, int dh, int dw) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || cn <= 0) return 1;
  double m[6] = {M[0], M[1], M[2], M[3], M[4], M[5]};
  double D = m[0] * m[4] - m[1] * m[3];
  D = D != 0 ? 1. / D : 0;
  double A11 = m[4] * D, A22 = m[0] * D;
  m[0] = A11;
  m[1] *= -D;
  m[3] *= -D;
  m[4] = A22;
  double b1 = -m[0] * m[2] - m[1] * m[5];
  double b2 = -m[3] * m[2] - m[4] * m[5];
  m[2] = b1;
  m[5] = b2;
  float f[6];
  for (int i = 0; i < 6; ++i) f[i] = (float)m[i];
  const float limit = 1e7f;
  const int tail = dw / 16 * 16;
  for (int y = 0; y < dh; ++y) {
    const float yf = (float)y;
    const float cx = yf * f[1] + f[2];
    const float cy = yf * f[4] + f[5];
    uint8_t* o = dst + (size_t)y * dw * cn;
    const float ry = yf * f[1], ry3 = yf * f[4];
    for (int x = 0; x < dw; ++x) {
      // blocks of 16 (cv2's AVX2 vector loop): fma(m0, x, y*m1 + m2);
      // the scalar tail: fma(x, m0, y*m1) + m2
      const bool vec = x < tail;
      float sx = vec ? std::fmaf(f[0], (float)x, cx) : std::fmaf((float)x, f[0], ry) + f[2];
      float sy = vec ? std::fmaf(f[3], (float)x, cy) : std::fmaf((float)x, f[3], ry3) + f[5];
      if (!(std::fabs(sx) < limit && std::fabs(sy) < limit)) {
        std::memset(o + (size_t)x * cn, 0, cn);
        continue;
      }
      int ix = (int)std::floor(sx), iy = (int)std::floor(sy);
      float ax = sx - (float)ix, ay = sy - (float)iy;
      const bool in_x0 = ix >= 0 && ix < sw, in_x1 = ix + 1 >= 0 && ix + 1 < sw;
      const bool in_y0 = iy >= 0 && iy < sh, in_y1 = iy + 1 >= 0 && iy + 1 < sh;
      const uint8_t* r0 = src + (size_t)(in_y0 ? iy : 0) * sw * cn;
      const uint8_t* r1 = src + (size_t)(in_y1 ? iy + 1 : 0) * sw * cn;
      for (int k = 0; k < cn; ++k) {
        float p00 = (in_y0 && in_x0) ? r0[(size_t)ix * cn + k] : 0.f;
        float p01 = (in_y0 && in_x1) ? r0[(size_t)(ix + 1) * cn + k] : 0.f;
        float p10 = (in_y1 && in_x0) ? r1[(size_t)ix * cn + k] : 0.f;
        float p11 = (in_y1 && in_x1) ? r1[(size_t)(ix + 1) * cn + k] : 0.f;
        float v0 = std::fmaf(ax, p01 - p00, p00);
        float v1 = std::fmaf(ax, p11 - p10, p10);
        float v = std::fmaf(ay, v1 - v0, v0);
        o[(size_t)x * cn + k] = clamp255(round_half_even(v));
      }
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG encoding (cv::imwrite's defaults through libjpeg-turbo)
// ---------------------------------------------------------------------------

namespace {

// Annex K tables, natural order (jcparam.c std_luminance_quant_tbl and
// std_chrominance_quant_tbl).
const uint16_t kStdQuant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

// jstdhuff.c: code counts by length 1..16, then the symbols.
const uint8_t kDcBits[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcBits[2][16] = {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
                                {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
     0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
     0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
     0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
     0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
     0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
     0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
     0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
     0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
     0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
     0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
     0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
     0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
     0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
     0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
     0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
     0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

struct HuffCode {
  uint16_t code[256];
  uint8_t size[256];
};

// jchuff.c jpeg_make_c_derived_tbl: canonical codes from the counts.
void make_huff_code(const uint8_t* bits, const uint8_t* vals, HuffCode& t) {
  std::memset(t.size, 0, sizeof(t.size));
  uint32_t code = 0;
  int p = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++p) {
      t.code[vals[p]] = (uint16_t)code++;
      t.size[vals[p]] = (uint8_t)len;
    }
    code <<= 1;
  }
}

// Quantiser of jcdctmgr.c (8-bit samples, 16-bit DCTELEM as in a SIMD
// build): reciprocal, correction and shift of compute_reciprocal for the
// islow divisor quantval << 3.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor compute_reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};  // identity (not reached at <= 255 << 3)
  int b = 0;
  while ((1u << (b + 1)) <= divisor) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t)(((uint64_t)1 << r) / divisor);
  uint32_t fr = (uint32_t)(((uint64_t)1 << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r - 16};
}

// jfdctint.c jpeg_fdct_islow: the integer LL&M forward DCT, results scaled
// up by 8.
void fdct_islow(int* d) {
  const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373,
                F1_175 = 9633, F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
  auto descale = [](int64_t x, int n) { return (int)((x + ((int64_t)1 << (n - 1))) >> n); };
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    const int odd_shift = pass == 0 ? 13 - 2 : 13 + 2;
    for (int c = 0; c < 8; ++c) {
      int* p = d + c * stride;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        p[0] = (int)((tmp10 + tmp11) * 4);
        p[4 * step] = (int)((tmp10 - tmp11) * 4);
      } else {
        p[0] = descale(tmp10 + tmp11, 2);
        p[4 * step] = descale(tmp10 - tmp11, 2);
      }
      int64_t z1 = (tmp12 + tmp13) * F0_541;
      p[2 * step] = descale(z1 + tmp13 * F0_765, odd_shift);
      p[6 * step] = descale(z1 + tmp12 * -F1_847, odd_shift);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1_175;
      tmp4 *= F0_298;
      tmp5 *= F2_053;
      tmp6 *= F3_072;
      tmp7 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, odd_shift);
      p[5 * step] = descale(tmp5 + z2 + z4, odd_shift);
      p[3 * step] = descale(tmp6 + z2 + z3, odd_shift);
      p[step] = descale(tmp7 + z1 + z4, odd_shift);
    }
  }
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t buf = 0;
  int bits = 0;
  void put(uint32_t code, int size) {
    buf = (buf << size) | (code & ((1u << size) - 1));
    bits += size;
    while (bits >= 8) {
      uint8_t c = (uint8_t)(buf >> (bits - 8));
      out.push_back(c);
      if (c == 0xFF) out.push_back(0);  // byte stuffing
      bits -= 8;
    }
  }
  void flush() {  // pad the last byte with ones (jchuff.c flush_bits)
    if (bits) put(0x7F, 7);
    buf = 0;
    bits = 0;
  }
};

// jchuff.c encode_one_block.
void encode_block(BitWriter& w, const int16_t* blk, int& last_dc, const HuffCode& dc,
                  const HuffCode& ac) {
  int temp = blk[0] - last_dc, temp2 = temp;
  last_dc = blk[0];
  if (temp < 0) temp = -temp, --temp2;
  int nbits = 0;
  while (temp) ++nbits, temp >>= 1;
  w.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) w.put((uint32_t)temp2, nbits);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kNatural[k]];
    if (temp == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    temp2 = temp;
    if (temp < 0) temp = -temp, --temp2;
    nbits = 1;
    while (temp >>= 1) ++nbits;
    const int sym = (run << 4) + nbits;
    w.put(ac.code[sym], ac.size[sym]);
    w.put((uint32_t)temp2, nbits);
    run = 0;
  }
  if (run > 0) w.put(ac.code[0], ac.size[0]);
}

void put_u16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}

}  // namespace

extern "C" {

// Baseline JPEG of an RGB uint8 (height, width, 3) image as cv::imwrite
// writes it with its defaults through libjpeg-turbo: a JFIF 1.01 header,
// YCbCr 4:2:0 (jccolor.c's fixed-point conversion, jcsample.c's h2v2
// downsampling with its alternating bias 1, 2, edges replicated as
// jcprepct.c pads them), the islow forward DCT, jcdctmgr.c's reciprocal
// quantisation of the Annex K tables scaled to `quality` (baseline-limited),
// the standard Huffman tables, dummy blocks at the right and bottom edges
// of the last MCUs as jccoefct.c makes them. Writes up to `cap` bytes to
// `out` and their count to `out_len`; 1 if `cap` is too small, 2 on bad
// arguments.
int hc_jpeg_encode(const uint8_t* rgb, int height, int width, int quality, uint8_t* out,
                   int64_t cap, int64_t* out_len) {
  if (height <= 0 || width <= 0 || height > 65535 || width > 65535 || quality < 1 ||
      quality > 100)
    return 2;
  // quantisation tables (jcparam.c jpeg_set_quality, force_baseline)
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qt[2][64];
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) {
      int64_t v = ((int64_t)kStdQuant[t][i] * scale + 50) / 100;
      v = v < 1 ? 1 : (v > 255 ? 255 : v);
      qt[t][i] = (uint16_t)v;
      div[t][i] = compute_reciprocal((uint32_t)v << 3);
    }
  HuffCode dc[2], ac[2];
  for (int t = 0; t < 2; ++t) {
    make_huff_code(kDcBits[t], kDcVals, dc[t]);
    make_huff_code(kAcBits[t], kAcVals[t], ac[t]);
  }

  // colour conversion (jccolor.c rgb_ycc_convert), full size
  const int64_t ONE_HALF = (int64_t)1 << 15, CBCR_OFFSET = (int64_t)128 << 16;
  auto FIX = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
  const size_t npix = (size_t)height * width;
  std::vector<uint8_t> plane[3];
  for (auto& p : plane) p.resize(npix);
  for (size_t i = 0; i < npix; ++i) {
    const int64_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    plane[0][i] = (uint8_t)((FIX(0.29900) * r + FIX(0.58700) * g + FIX(0.11400) * b + ONE_HALF) >> 16);
    plane[1][i] = (uint8_t)((-FIX(0.16874) * r - FIX(0.33126) * g + FIX(0.50000) * b +
                             CBCR_OFFSET + ONE_HALF - 1) >> 16);
    plane[2][i] = (uint8_t)((FIX(0.50000) * r - FIX(0.41869) * g - FIX(0.08131) * b +
                             CBCR_OFFSET + ONE_HALF - 1) >> 16);
  }
  // component sample arrays, padded as libjpeg pads them for the DCT
  const int mcux = (width + 15) / 16, mcuy = (height + 15) / 16;
  const int ybw = (width + 7) / 8, ybh = (height + 7) / 8;  // real Y blocks
  const int yw = mcux * 16, yh = mcuy * 16, cw = mcux * 8, ch = mcuy * 8;
  std::vector<uint8_t> ys((size_t)yh * yw), cs[2];
  for (int y = 0; y < yh; ++y)
    for (int x = 0; x < yw; ++x)
      ys[(size_t)y * yw + x] =
          plane[0][(size_t)std::min(y, height - 1) * width + std::min(x, width - 1)];
  const int crows = (height + 1) / 2;  // chroma rows from image rows
  for (int c = 0; c < 2; ++c) {
    cs[c].resize((size_t)ch * cw);
    const uint8_t* p = plane[c + 1].data();
    for (int y = 0; y < ch; ++y) {
      if (y >= crows) {  // jcprepct.c: the last downsampled row, repeated
        std::memcpy(&cs[c][(size_t)y * cw], &cs[c][(size_t)(crows - 1) * cw], cw);
        continue;
      }
      const uint8_t* r0 = p + (size_t)(2 * y) * width;
      const uint8_t* r1 = p + (size_t)std::min(2 * y + 1, height - 1) * width;
      int bias = 1;
      for (int x = 0; x < cw; ++x) {
        const int x0 = std::min(2 * x, width - 1), x1 = std::min(2 * x + 1, width - 1);
        cs[c][(size_t)y * cw + x] = (uint8_t)((r0[x0] + r0[x1] + r1[x0] + r1[x1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }
  auto dct_block = [&](const std::vector<uint8_t>& s, int stride, int bx, int by,
                       const Divisor* dv, int16_t* blk) {
    int d[64];
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x)
        d[y * 8 + x] = (int)s[(size_t)(by * 8 + y) * stride + bx * 8 + x] - 128;
    fdct_islow(d);
    for (int i = 0; i < 64; ++i) {  // jcdctmgr.c quantize
      int t = d[i];
      const bool neg = t < 0;
      if (neg) t = -t;
      uint32_t prod = ((uint32_t)(uint16_t)(t + dv[i].corr)) * dv[i].recip;
      t = (int)(prod >> (16 + dv[i].shift));
      blk[i] = (int16_t)(neg ? -t : t);
    }
  };

  std::vector<uint8_t> o;
  o.reserve((size_t)std::min<int64_t>(cap, (int64_t)npix + 1024));
  const uint8_t header[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                            0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), header, header + sizeof(header));
  for (int t = 0; t < 2; ++t) {  // DQT, zigzag order
    o.push_back(0xFF), o.push_back(0xDB), put_u16(o, 67), o.push_back((uint8_t)t);
    for (int i = 0; i < 64; ++i) o.push_back((uint8_t)qt[t][kNatural[i]]);
  }
  o.push_back(0xFF), o.push_back(0xC0), put_u16(o, 17), o.push_back(8);
  put_u16(o, height), put_u16(o, width), o.push_back(3);
  const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), comps, comps + 9);
  for (int t = 0; t < 2; ++t)  // DHT: DC then AC of luma, then of chroma
    for (int is_ac = 0; is_ac < 2; ++is_ac) {
      const uint8_t* bits = is_ac ? kAcBits[t] : kDcBits[t];
      const uint8_t* vals = is_ac ? kAcVals[t] : kDcVals;
      int n = 0;
      for (int i = 0; i < 16; ++i) n += bits[i];
      o.push_back(0xFF), o.push_back(0xC4), put_u16(o, 2 + 17 + n);
      o.push_back((uint8_t)((is_ac << 4) | t));
      o.insert(o.end(), bits, bits + 16);
      o.insert(o.end(), vals, vals + n);
    }
  const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00, 0x02,
                         0x11, 0x03, 0x11, 0x00, 0x3F, 0x00};
  o.insert(o.end(), sos, sos + sizeof(sos));

  BitWriter w{o};
  int last_dc[3] = {0, 0, 0};
  int16_t mcu[6][64];
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      // luma: 2 x 2 blocks; past the image's blocks, jccoefct.c's dummies
      // (zero AC, the DC of the block before)
      for (int yi = 0; yi < 2; ++yi)
        for (int xi = 0; xi < 2; ++xi) {
          int16_t* blk = mcu[yi * 2 + xi];
          const int bx = mx * 2 + xi, by = my * 2 + yi;
          if (by < ybh && bx < ybw) {
            dct_block(ys, yw, bx, by, div[0], blk);
          } else {
            std::memset(blk, 0, sizeof(mcu[0]));
            blk[0] = mcu[yi * 2 + xi - 1][0];
          }
        }
      dct_block(cs[0], cw, mx, my, div[1], mcu[4]);
      dct_block(cs[1], cw, mx, my, div[1], mcu[5]);
      for (int b = 0; b < 4; ++b) encode_block(w, mcu[b], last_dc[0], dc[0], ac[0]);
      encode_block(w, mcu[4], last_dc[1], dc[1], ac[1]);
      encode_block(w, mcu[5], last_dc[2], dc[1], ac[1]);
    }
  w.flush();
  o.push_back(0xFF), o.push_back(0xD9);
  *out_len = (int64_t)o.size();
  if ((int64_t)o.size() > cap) return 1;
  std::memcpy(out, o.data(), o.size());
  return 0;
}

}  // extern "C"
