"""The Phred substitution model PAMLD scores a read with (a frozen copy of
the reference Pheniqs phred.cpp model that the program also follows).

For quality q, expected base e and observed base o, the cost in phred
units is -10 log10(1 - 10^(-q/10)) where e == o (both A/C/G/T), q where
they differ, 10 log10(4) where either is ambiguous, and 0 at q == 0. A
barcode's likelihood is 10^(-sigma/10), sigma the sum of the costs over
its positions.
"""

from __future__ import annotations

import numpy as np

#: 10^(-1/10): probability = PHRED_BASE ** phred
PHRED_BASE = float(pow(10.0, -0.1))
UNIFORM_BASE_QUALITY = 10.0 * np.log10(4.0)
STRICT_CODES = (1, 2, 4, 8)


def substitution_lut() -> np.ndarray:
    """(128, 16, 16) float64: [quality, expected code, observed code] -> cost."""
    q = np.arange(128, dtype=np.float64)
    error = np.zeros(128)
    error[1:] = np.power(10.0, -0.1 * q[1:])
    match = np.zeros(128)
    match[1:] = -10.0 * np.log10(1.0 - error[1:])
    lut = np.zeros((128, 16, 16), dtype=np.float64)
    for qq in range(1, 128):
        lut[qq] = UNIFORM_BASE_QUALITY
        for e in STRICT_CODES:
            for o in STRICT_CODES:
                lut[qq, e, o] = match[qq] if e == o else float(qq)
    return lut
