// A double laid out as Python's repr(float) writes it (which
// str(numpy.float64) equals), for the native CSV writers
// (timetrace_csv.cpp, trackrows_csv.cpp): the shortest round-trip digits
// (std::to_chars), fixed notation for decimal exponents -4 <= e < 16 with
// ".0" on integral values, otherwise d[.ddd]e+XX with at least two
// exponent digits; nan, inf, -inf, -0.0.

#ifndef PYREPR_H_
#define PYREPR_H_

#include <charconv>
#include <cmath>
#include <cstring>

namespace pyrepr {

// repr(float) into p; returns the end. At most 24 characters.
inline char* put_double(char* p, double v) {
    if (std::isnan(v)) {
        std::memcpy(p, "nan", 3);
        return p + 3;
    }
    if (std::isinf(v)) {
        if (v < 0) *p++ = '-';
        std::memcpy(p, "inf", 3);
        return p + 3;
    }
    char s[40];
    char* end = std::to_chars(s, s + sizeof s, v,
                              std::chars_format::scientific).ptr;
    const char* q = s;
    if (*q == '-') {
        *p++ = '-';
        ++q;
    }
    char digits[24];
    int n = 0;
    for (; *q != 'e'; ++q) {
        if (*q != '.') digits[n++] = *q;
    }
    ++q;  // past 'e'
    bool neg_exp = *q == '-';
    ++q;  // past the sign
    int exp = 0;
    std::from_chars(q, end, exp);
    if (neg_exp) exp = -exp;
    int decpt = exp + 1;  // digits are 0.ddd x 10^decpt
    if (decpt <= -4 || decpt > 16) {
        *p++ = digits[0];
        if (n > 1) {
            *p++ = '.';
            std::memcpy(p, digits + 1, n - 1);
            p += n - 1;
        }
        *p++ = 'e';
        *p++ = exp < 0 ? '-' : '+';
        int a = exp < 0 ? -exp : exp;
        if (a < 10) *p++ = '0';
        return std::to_chars(p, p + 4, a).ptr;
    }
    if (decpt <= 0) {
        *p++ = '0';
        *p++ = '.';
        std::memset(p, '0', -decpt);
        p += -decpt;
        std::memcpy(p, digits, n);
        return p + n;
    }
    if (decpt >= n) {
        std::memcpy(p, digits, n);
        p += n;
        std::memset(p, '0', decpt - n);
        p += decpt - n;
        *p++ = '.';
        *p++ = '0';
        return p;
    }
    std::memcpy(p, digits, decpt);
    p += decpt;
    *p++ = '.';
    std::memcpy(p, digits + decpt, n - decpt);
    return p + (n - decpt);
}

}  // namespace pyrepr

#endif  // PYREPR_H_
