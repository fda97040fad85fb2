// Interpret's two bulk loads: the depth model's .dist table (ProcessDist,
// RUFUS.interpret.cpp:5117-5179, with ProcessHighAndLowDist 5181-5233)
// and the k-mer count pulls, whose Python statement is the JAX package's
// interpret/model.py:DepthModel and interpret/driver.py:_load_counts_file.
// The text arrives decoded and newline-translated by Python (UTF-8), so
// lines end at '\n' alone.
//
// Numbers parse as Python's float() and int() parse ASCII text: surrounding
// whitespace, a sign, digits with single underscores between them, and for
// floats inf/infinity/nan; strtod in the C locale then rounds exactly as
// float() does. A field outside that grammar is an error the caller raises.
//
// API (extern "C", consumed by rufus_tpu_torch/interpret/model.py and
// driver.py):
//   dist_columns(text, len, ncols, counts, out, err) -> 0, or 1 with the
//       bad field's byte range in err[0..1]: the numeric fields of the
//       .dist's rows after the first; field i >= 1 of a non-empty row, when
//       not empty and i - 1 < ncols, goes to column i - 1. With out null,
//       only counts[c] is filled (the column's values); else column c's
//       values go to out[counts[c]...] in row order (counts then holds the
//       columns' start offsets).
//   high_low(flat, starts, sums, ncols, percent, out) -> 0: each column's
//       (lower, upper) of GetHighAndLowForDist around its first maximum,
//       sums[c] being the column's Python sum().
//   count_pulls(text, len, keys, vals, err) -> records, or -1 with the bad
//       line's byte range in err[0..1] and in err[2] 1 for its count, 0
//       for its k-mer: lines split on ' ', those of one
//       field skipped; the first field packed LSB-first two bits a base
//       (non-ACGT characters take a position and add no bits) and its
//       reverse complement (anything but ACGTNacgtn becomes N), to
//       keys[2r] and keys[2r+1]; int() of the second to vals[r]. A key whose
//       packing needs more than 64 bits is an error.

#include <clocale>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <locale.h>
#include <string>

namespace {

// Python's str.isspace() over ASCII (Py_UNICODE_ISSPACE).
inline bool py_space(unsigned char c) {
  return c == ' ' || (c >= '\t' && c <= '\r') || (c >= 0x1c && c <= 0x1f);
}

inline bool digit(unsigned char c) { return c >= '0' && c <= '9'; }

inline void strip(const char*& s, const char*& e) {
  while (s < e && py_space((unsigned char)*s)) ++s;
  while (e > s && py_space((unsigned char)e[-1])) --e;
}

// digitpart ::= digit (["_"] digit)*, appended to out without underscores.
bool digitpart(const char*& s, const char* e, std::string& out) {
  if (s == e || !digit((unsigned char)*s)) return false;
  out.push_back(*s++);
  while (s < e) {
    if (digit((unsigned char)*s)) {
      out.push_back(*s++);
    } else if (*s == '_' && s + 1 < e && digit((unsigned char)s[1])) {
      out.push_back(s[1]);
      s += 2;
    } else {
      break;
    }
  }
  return true;
}

bool iequal(const char* s, const char* e, const char* word) {
  size_t n = strlen(word);
  if ((size_t)(e - s) != n) return false;
  for (size_t i = 0; i < n; ++i)
    if ((s[i] | 0x20) != word[i]) return false;
  return true;
}

locale_t c_locale() {
  static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  return loc;
}

// Clinger's fast path: a decimal whose digits make an integer M <= 2^53 and
// whose power of ten is within 10^22 is M * 10^e or M / 10^-e, one
// correctly rounded operation on two exact doubles, as strtod would round
// it. `buf` is a validated [-]digits[.digits][e[+-]digits]; false where
// the fast path does not apply.
bool exact_decimal(const std::string& buf, double* v) {
  static const double p10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                               1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                               1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
  size_t i = 0, n = buf.size();
  const bool neg = n > 0 && buf[0] == '-';
  if (neg) ++i;
  uint64_t m = 0;
  int digits = 0;  // significant digits in m
  long long dexp = 0;
  bool frac = false;
  for (; i < n && buf[i] != 'e' && buf[i] != 'E'; ++i) {
    if (buf[i] == '.') {
      frac = true;
      continue;
    }
    if (m || buf[i] != '0') {
      if (++digits > 18) return false;
      m = m * 10 + (uint64_t)(buf[i] - '0');
    }
    if (frac) --dexp;
  }
  if (i < n) {  // the exponent
    ++i;
    bool eneg = false;
    if (buf[i] == '+' || buf[i] == '-') eneg = buf[i++] == '-';
    long long x = 0;
    for (; i < n; ++i) {
      x = x * 10 + (buf[i] - '0');
      if (x > 100000) return false;
    }
    dexp += eneg ? -x : x;
  }
  double r;
  if (m == 0) {
    r = 0.0;
  } else {
    if (m > (1ull << 53) || dexp < -22 || dexp > 22) return false;
    r = dexp >= 0 ? (double)m * p10[dexp] : (double)m / p10[-dexp];
  }
  *v = neg ? -r : r;
  return true;
}

// float(field) for an ASCII field; false where float() would raise.
bool py_float(const char* s, const char* e, std::string& buf, double* v) {
  if (e - s == 1 && *s == '0') {  // most of a depth model's table
    *v = 0.0;
    return true;
  }
  strip(s, e);
  if (s == e) return false;
  bool neg = false;
  const char* p = s;
  if (*p == '+' || *p == '-') neg = *p++ == '-';
  if (iequal(p, e, "inf") || iequal(p, e, "infinity")) {
    *v = neg ? -HUGE_VAL : HUGE_VAL;
    return true;
  }
  if (iequal(p, e, "nan")) {
    *v = std::copysign(NAN, neg ? -1.0 : 1.0);
    return true;
  }
  buf.clear();
  if (neg) buf.push_back('-');
  // number ::= [digitpart] "." digitpart | digitpart ["."]
  bool lead = false;
  if (p < e && digit((unsigned char)*p)) lead = digitpart(p, e, buf);
  if (p < e && *p == '.') {
    buf.push_back(*p++);
    bool frac = p < e && digit((unsigned char)*p) && digitpart(p, e, buf);
    if (!lead && !frac) return false;
  } else if (!lead) {
    return false;
  }
  // exponent ::= ("e" | "E") [sign] digitpart
  if (p < e && (*p == 'e' || *p == 'E')) {
    buf.push_back(*p++);
    if (p < e && (*p == '+' || *p == '-')) buf.push_back(*p++);
    if (!digitpart(p, e, buf)) return false;
  }
  if (p != e) return false;
  if (!exact_decimal(buf, v)) *v = strtod_l(buf.c_str(), nullptr, c_locale());
  return true;
}

// int(field) for an ASCII field in base 10; false where int() would raise
// or the value leaves int64.
bool py_int(const char* s, const char* e, long long* v) {
  strip(s, e);
  bool neg = false;
  if (s < e && (*s == '+' || *s == '-')) neg = *s++ == '-';
  std::string digits;
  if (!digitpart(s, e, digits) || s != e) return false;
  unsigned long long mag = 0;
  const unsigned long long lim =
      neg ? (unsigned long long)INT64_MAX + 1 : (unsigned long long)INT64_MAX;
  for (char c : digits) {
    unsigned d = (unsigned)(c - '0');
    if (mag > (lim - d) / 10) return false;
    mag = mag * 10 + d;
  }
  *v = neg ? (long long)(0 - mag) : (long long)mag;
  return true;
}

// "ACGT".find(c) for a byte, -1 for anything else.
inline int base_code(unsigned char c) {
  switch (c) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return -1;
  }
}

}  // namespace

extern "C" {

int dist_columns(const char* text, long long len, long long ncols,
                 long long* counts, double* out, long long* err) {
  const char* end = text + len;
  std::string buf;
  if (!out)
    for (long long c = 0; c < ncols; ++c) counts[c] = 0;
  for (const char* line = text; line <= end;) {
    const char* eol = (const char*)memchr(line, '\n', end - line);
    if (!eol) eol = end;
    if (eol > line) {
      const char* f = line;
      for (long long i = 0; f <= eol; ++i) {
        const char* fe = (const char*)memchr(f, '\t', eol - f);
        if (!fe) fe = eol;
        if (i >= 1) {
          if (i - 1 >= ncols) break;
          if (fe > f) {
            if (out) {
              double v;
              if (!py_float(f, fe, buf, &v)) {
                err[0] = f - text;
                err[1] = fe - text;
                return 1;
              }
              out[counts[i - 1]++] = v;
            } else {
              ++counts[i - 1];
            }
          }
        }
        f = fe + 1;
      }
    }
    line = eol + 1;
  }
  return 0;
}

int high_low(const double* flat, const long long* starts, const double* sums,
             long long ncols, double percent, long long* out) {
  for (long long c = 0; c < ncols; ++c) {
    const double* d = flat + starts[c];
    const long long n = starts[c + 1] - starts[c];
    long long lower = 0, upper = 0;
    if (n > 0) {
      const double s = sums[c];
      long long max_k = 0;  // max()'s first index of the greatest
      for (long long i = 1; i < n; ++i)
        if (d[i] > d[max_k]) max_k = i;
      double cumulative = d[max_k];
      lower = upper = max_k;
      while (lower > 0 && upper < n && (s == 0 || cumulative / s < percent)) {
        --lower;
        ++upper;
        cumulative += d[lower];
        if (upper < n) cumulative += d[upper];
      }
      while (lower > 0 && (s == 0 || cumulative / s < percent)) {
        --lower;
        cumulative += d[lower];
      }
      while (upper < n && (s == 0 || cumulative / s < percent)) {
        ++upper;
        if (upper < n) cumulative += d[upper];
      }
    }
    out[2 * c] = lower;
    out[2 * c + 1] = upper;
  }
  return 0;
}

long long count_pulls(const char* text, long long len, uint64_t* keys,
                      long long* vals, long long* err) {
  const char* end = text + len;
  long long r = 0;
  for (const char* line = text; line < end;) {
    const char* eol = (const char*)memchr(line, '\n', end - line);
    const char* next = eol ? eol + 1 : end;
    if (!eol) eol = end;
    const char* sp = (const char*)memchr(line, ' ', eol - line);
    if (sp) {
      // the second field runs to the next space, or to the line's end
      // with its '\n' (int() strips it)
      const char* v0 = sp + 1;
      const char* v1 = (const char*)memchr(v0, ' ', next - v0);
      if (!v1) v1 = next;
      long long v;
      // characters, not bytes, take positions: skip UTF-8 continuations
      long long nchar = 0;
      for (const char* p = line; p < sp; ++p)
        if (((unsigned char)*p & 0xC0) != 0x80) ++nchar;
      uint64_t fwd = 0, rev = 0;
      bool wide = false;
      long long pos = 0;
      for (const char* p = line; p < sp; ++p) {
        const unsigned char ch = (unsigned char)*p;
        if ((ch & 0xC0) == 0x80) continue;
        const int c = base_code(ch);
        if (c >= 0) {
          const long long rpos = nchar - 1 - pos;
          if (c != 0) {
            if (pos >= 32) wide = true; else fwd |= (uint64_t)c << (2 * pos);
          }
          if (c != 3) {
            if (rpos >= 32) wide = true;
            else rev |= (uint64_t)(3 - c) << (2 * rpos);
          }
        }
        ++pos;
      }
      const bool bad_count = !py_int(v0, v1, &v);
      if (bad_count || wide) {
        err[0] = line - text;
        err[1] = eol - text;
        err[2] = bad_count;
        return -1;
      }
      keys[2 * r] = fwd;
      keys[2 * r + 1] = rev;
      vals[r] = v;
      ++r;
    }
    line = next;
  }
  return r;
}

}  // extern "C"
