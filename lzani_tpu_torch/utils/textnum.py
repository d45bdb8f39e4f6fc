"""Number -> text rendering with the exact semantics of the reference output layer.

The reference (refresh-bio/LZ-ANI) renders floating-point columns with
``refresh::real_to_pchar`` (libs/refresh/conversions/lib/numeric_conversions.h:229-300,
341-388): dragonbox shortest-decimal digits, rounded half-up to ``prec``
*significant digits*, then laid out plain/scientific according to the decimal
exponent.  We reproduce that contract on top of Python's ``repr(float)``,
which — like dragonbox — yields the shortest decimal string that round-trips
under IEEE-754 round-to-nearest-even.  Both therefore produce the same
(significand, exponent) pair for every double, which we verify in tests
against the reference golden TSVs.

Rules (citations into the reference source tree):
  * val == 0             -> "0"        (numeric_conversions.h:344-347)
  * nan  -> "nan", +/-inf -> "inf"/"-inf"                       (:349-372)
  * precision clamped to [1, 15] for double                      (:376-383)
  * significand rounded half-up to `prec` significant digits     (:240-253)
  * layout                                                        (:255-296)
      exp == 0                      -> digits
      exp > 0 or -exp >= ndig + 4   -> scientific d[.ddd]e±XX
      -exp < ndig                   -> digits with '.' inserted
      otherwise                     -> "0." + zeros + digits
"""

from __future__ import annotations

import math

_POW10 = tuple(10**i for i in range(20))


def _shortest_decimal(val: float) -> tuple[int, int]:
    """Return (significand, exponent10) with significand * 10**exponent == val,
    significand having no trailing zeros — the dragonbox ``to_decimal`` pair."""
    s = repr(float(val))
    if "e" in s or "E" in s:
        mant, _, exp_s = s.lower().partition("e")
        exp10 = int(exp_s)
    else:
        mant, exp10 = s, 0
    if "." in mant:
        int_part, _, frac = mant.partition(".")
        digits = int_part + frac
        exp10 -= len(frac)
    else:
        digits = mant
    sig = int(digits)
    # strip trailing zeros into the exponent (dragonbox trailing-zero removal)
    while sig and sig % 10 == 0:
        sig //= 10
        exp10 += 1
    return sig, exp10


def format_real(val: float, prec: int = 6) -> str:
    """Render a double exactly like ``refresh::real_to_pchar(val, out, prec)``."""
    if val == 0:
        return "0"
    if math.isnan(val):
        return "nan"
    if math.isinf(val):
        return "-inf" if val < 0 else "inf"

    prec = min(max(prec, 1), 15)

    neg = val < 0
    sig, exp10 = _shortest_decimal(abs(val))

    n_dig = len(str(sig))
    if n_dig > prec:
        # round half-up on decimal digits (numeric_conversions.h:240-253)
        drop = n_dig - prec
        sig = (sig + _POW10[drop] // 2) // _POW10[drop]
        exp10 += drop
        n_dig = prec
        if sig >= _POW10[prec]:
            sig //= 10
            exp10 += 1

    digits = str(sig)
    if exp10 == 0:
        body = digits
    elif exp10 > 0 or -exp10 >= n_dig + 4:
        # scientific
        if n_dig == 1:
            mant = digits
            e = exp10
        else:
            mant = digits[0] + "." + digits[1:]
            e = exp10 + n_dig - 1
        sign = "-" if e < 0 else "+"
        body = f"{mant}e{sign}{abs(e):02d}"
    elif -exp10 < n_dig:
        dot = n_dig + exp10
        body = digits[:dot] + "." + digits[dot:]
    else:
        body = "0." + "0" * (-exp10 - n_dig) + digits

    return "-" + body if neg else body


def format_int(val: int) -> str:
    return str(int(val))
