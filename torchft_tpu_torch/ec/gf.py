"""Vectorized GF(256) arithmetic for the Reed-Solomon shard codec.

A copy of ``torchft_tpu/ec/gf.py`` (host numpy, as there): the tables, the
encode and the decode are bit for bit the JAX package's.

The field is GF(2^8) with the primitive polynomial x^8 + x^4 + x^3 + x^2 + 1
(0x11D, the classic Reed-Solomon field; generator 2).  Two table families:

  - ``_EXP``/``_LOG``: scalar multiply/divide/invert via logarithms (the
    textbook construction, used for matrix algebra on tiny k x k systems);
  - ``_MUL``: the full 256 x 256 product table (64 KB), so multiplying a
    CONSTANT into a multi-hundred-MB shard is one ``np.take`` per shard —
    numpy fancy-indexing runs at memory bandwidth, which is what makes the
    encode affordable inside the overlapped snapshot window.

Addition in GF(2^8) is XOR, so accumulation across data shards is
``np.bitwise_xor`` — also a bandwidth-bound numpy primitive.

Everything here is pure numpy; no device, no dependency beyond the stdlib.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = [
    "addmul_into",
    "cauchy_matrix",
    "gf_inv",
    "gf_matmul",
    "gf_mat_inv",
    "gf_mul",
    "mul_const",
]

_POLY = 0x11D


def _build_tables():
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[0:255]  # wraparound so log[a] + log[b] never reduces
    # Full product table: MUL[a, b] = a * b in GF(256).
    a = np.arange(256, dtype=np.int32)
    la = log[a][:, None]  # (256, 1)
    lb = log[a][None, :]  # (1, 256)
    mul = exp[la + lb].astype(np.uint8)
    mul[0, :] = 0
    mul[:, 0] = 0
    return exp, log, mul


_EXP, _LOG, _MUL = _build_tables()


def gf_mul(a: int, b: int) -> int:
    """Scalar product in GF(256)."""
    return int(_MUL[a & 0xFF, b & 0xFF])


def gf_inv(a: int) -> int:
    """Multiplicative inverse (raises on 0, which has none)."""
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(256)")
    return int(_EXP[255 - _LOG[a]])


# Per-constant uint16 PAIR tables, built lazily and cached: T16[c][hi<<8|lo]
# = (c*hi)<<8 | (c*lo).  Gathering through a uint16 view halves the element
# count fancy indexing walks (the JAX package's note: about twice the byte
# table's rate on its CPU host), at 64 KB per constant (only the handful of Cauchy/inverse
# coefficients a deployment actually uses get built).
_PAIR_TABLES: dict = {}


def _pair_table(c: int) -> np.ndarray:
    t = _PAIR_TABLES.get(c)
    if t is None:
        row = _MUL[c].astype(np.uint16)
        t = (row[:, None] << 8 | row[None, :]).ravel()
        _PAIR_TABLES[c] = t
    return t


def _mul_gather(c: int, vec: np.ndarray) -> np.ndarray:
    """``c * vec`` for c >= 2 via the fastest available gather."""
    if vec.nbytes % 2 == 0:
        return _pair_table(c)[vec.view(np.uint16)].view(np.uint8)
    return _MUL[c][vec]


def mul_const(c: int, vec: np.ndarray) -> np.ndarray:
    """``c * vec`` elementwise over a uint8 array (one table gather)."""
    if c == 0:
        return np.zeros_like(vec)
    if c == 1:
        return vec.copy()
    return _mul_gather(c, vec)


def addmul_into(acc: np.ndarray, c: int, vec: np.ndarray) -> None:
    """``acc ^= c * vec`` in place — the encode/decode inner loop."""
    if c == 0:
        return
    if c == 1:
        np.bitwise_xor(acc, vec, out=acc)
        return
    np.bitwise_xor(acc, _mul_gather(c, vec), out=acc)


def gf_matmul(mat: np.ndarray, shards: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Rows of ``mat`` (r x k, uint8) applied to ``k`` equal-length uint8
    shards: ``out[i] = XOR_j mat[i, j] * shards[j]``."""
    r, k = mat.shape
    assert k == len(shards), f"matrix is {r}x{k} but {len(shards)} shards given"
    out: List[np.ndarray] = []
    for i in range(r):
        acc = np.zeros_like(shards[0])
        for j in range(k):
            addmul_into(acc, int(mat[i, j]), shards[j])
        out.append(acc)
    return out


def gf_mat_inv(mat: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a k x k uint8 matrix over GF(256).

    Raises ValueError on a singular matrix — with the Cauchy construction
    below that never happens for a legal shard subset, so a singularity here
    means corrupted shard indices, and decode must fail loudly."""
    k = mat.shape[0]
    assert mat.shape == (k, k)
    a = mat.astype(np.uint8).copy()
    inv = np.eye(k, dtype=np.uint8)
    for col in range(k):
        pivot = -1
        for row in range(col, k):
            if a[row, col] != 0:
                pivot = row
                break
        if pivot < 0:
            raise ValueError("singular matrix over GF(256)")
        if pivot != col:
            a[[col, pivot]] = a[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        pinv = gf_inv(int(a[col, col]))
        a[col] = _MUL[pinv].take(a[col])
        inv[col] = _MUL[pinv].take(inv[col])
        for row in range(k):
            if row == col or a[row, col] == 0:
                continue
            c = int(a[row, col])
            a[row] ^= _MUL[c].take(a[col])
            inv[row] ^= _MUL[c].take(inv[col])
    return inv


def cauchy_matrix(m: int, k: int) -> np.ndarray:
    """The m x k Cauchy matrix P[i, j] = 1 / (x_i + y_j) with x_i = k + i,
    y_j = j.  The systematic generator [I_k ; P] built from it is MDS: every
    k x k submatrix of the stacked matrix is invertible, so ANY k of the
    k + m shards reconstruct the data (the property the every-k-subset
    decode test pins).  Requires k + m <= 256."""
    if k + m > 256:
        raise ValueError(f"k + m = {k + m} exceeds the GF(256) field size")
    out = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            out[i, j] = gf_inv((k + i) ^ j)
    return out
