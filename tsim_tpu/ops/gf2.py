"""GF(2) linear algebra: basis extraction (host) and parity matmul (device).

The parity matmul is the FLOP core of sampling (reference
``tsim/utils/linalg.py:81-102``). ``matmul_gf2`` is a float GEMM then
mod 2: exact because operands are 0/1 and inner products are small
integers (at most P), which every float format the dot may use holds
exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import Array


def find_basis(vectors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Greedy GF(2) row-reduction: ``V = T @ B (mod 2)``.

    Returns ``(basis, transform)`` where ``basis`` is the subset of rows of
    ``V`` (in first-seen order) that are linearly independent, and
    ``transform[i]`` expresses row i of ``V`` over that basis.

    Bit-packed elimination over uint64 words; rows up to ~10^5 columns are
    fine host-side.
    """
    vecs = np.asarray(vectors, dtype=np.uint8)
    n, d = vecs.shape
    words = max(1, (d + 63) // 64)
    packed = np.zeros((n, words), dtype=np.uint64)
    for w in range(words):
        chunk = vecs[:, w * 64 : (w + 1) * 64]
        weights = (np.uint64(1) << np.arange(chunk.shape[1], dtype=np.uint64))
        packed[:, w] = (chunk.astype(np.uint64) * weights[None, :]).sum(axis=1)

    basis_rows: list[int] = []
    reduced: list[np.ndarray] = []  # reduced basis vectors (packed)
    pivots: list[int] = []
    expansions: list[np.ndarray] = []  # expansion of each reduced vec over basis
    t_rows: list[np.ndarray] = []

    def _pivot(row: np.ndarray) -> int:
        for w in range(words):
            if row[w]:
                x = int(row[w])
                return w * 64 + ((x & -x).bit_length() - 1)
        return -1

    for idx in range(n):
        v = packed[idx].copy()
        dep = np.zeros(len(basis_rows) + 1, dtype=np.uint8)
        for j, b in enumerate(reduced):
            p = pivots[j]
            if (v[p >> 6] >> np.uint64(p & 63)) & np.uint64(1):
                v ^= b
                e = expansions[j]
                dep[: len(e)] ^= e
        if v.any():
            basis_rows.append(idx)
            reduced.append(v)
            pivots.append(_pivot(v))
            dep = dep.copy()
            dep[len(basis_rows) - 1] = 1
            expansions.append(dep[: len(basis_rows)])
            t = np.zeros(len(basis_rows), dtype=np.uint8)
            t[-1] = 1
            t_rows.append(t)
        else:
            t_rows.append(dep[: len(basis_rows)].copy())

    rank = len(basis_rows)
    transform = np.zeros((n, rank), dtype=np.uint8)
    for i, row in enumerate(t_rows):
        transform[i, : len(row)] = row
    return vecs[basis_rows], transform


def static_take_columns(x: Array, idx) -> Array:
    """Column selection with STATIC indices, gather-free.

    Narrow selections compile to slices + one concat; wide ones (hundreds
    of columns, e.g. surface-code direct detectors) use a one-hot f32
    matmul instead of a program-bloating concat of single-column slices.
    The one-hot dot is exact: one 0/1 weight per output column.
    """
    idx = [int(i) for i in np.asarray(idx).ravel()]
    if not idx:
        return x[:, :0]
    if len(idx) <= 32:
        return jnp.concatenate([x[:, i : i + 1] for i in idx], axis=1)
    sel = np.zeros((x.shape[1], len(idx)), dtype=np.float32)
    sel[idx, np.arange(len(idx))] = 1.0
    return (x.astype(jnp.float32) @ sel).astype(x.dtype)


def matmul_gf2(a: Array, b: Array) -> Array:
    """Binary dot products mod 2: ``a_(T,G,P) x b_(B,P) -> (B,T,G)``.

    float32 GEMM then mod 2. The mod must run in float32: float->uint8
    casts saturate rather than wrap, which would corrupt parities for inner
    products above 255. The graph axis G stays trailing, matching the term
    families' (T, G) layout.
    """
    T, G, _ = a.shape
    if G * T == 0:
        return jnp.zeros((b.shape[0], T, G), dtype=jnp.uint8)
    sum_f32 = b.astype(jnp.float32) @ a.astype(jnp.float32).reshape(T * G, -1).T
    return (sum_f32.reshape(-1, T, G) % 2).astype(jnp.uint8)
