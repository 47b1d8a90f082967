"""Base encoding shared by the device kernels.

ASCII bases map to codes A=0, C=1, G=2, T=3; every other character
(N, IUPAC ambiguity codes, '-') collapses to 4. The CUDA aligner and POA
kernels take one code per byte.
"""

import numpy as np

_LUT = np.full(256, 4, dtype=np.uint8)
for i, c in enumerate(b"ACGT"):
    _LUT[c] = i
for i, c in enumerate(b"acgt"):
    _LUT[c] = i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(ascii_bases: np.ndarray) -> np.ndarray:
    """uint8 ASCII -> uint8 codes 0..4."""
    return _LUT[ascii_bases]


def decode(codes: np.ndarray) -> bytes:
    """uint8/int codes 0..4 -> ASCII bytes."""
    return _DECODE[np.asarray(codes, dtype=np.int64).clip(0, 4)].tobytes()
