"""Small-matrix linear algebra, fully unrolled for batching.

XLA lowers `jnp.linalg.solve` / `cho_factor` on small batched systems
to LAPACK-style library routines that handle many tiny matrices
poorly (the PnP Gauss-Newton loop, ops/pnp.py, solves tens of
thousands of 6x6/8x8 systems per batch). These helpers unroll Cholesky
factorization and triangular substitution over a *static* dimension,
so a batch of N solves becomes a handful of fused elementwise ops (a
few hundred scalar multiplies per solve), with no per-matrix control
flow.

All functions broadcast over arbitrary leading batch dims.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-20


def _chol_factors(a: jnp.ndarray) -> list[list[jnp.ndarray]]:
    """Lower-triangular Cholesky factors of SPD a (..., n, n) as a
    list-of-lists of batched scalars (static n unroll)."""
    n = a.shape[-1]
    l: list[list[jnp.ndarray]] = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = jnp.sqrt(jnp.maximum(s, _EPS))
            else:
                l[i][j] = s / l[j][j]
    return l


def _chol_substitute(l: list[list[jnp.ndarray]], b: jnp.ndarray
                     ) -> jnp.ndarray:
    """Solve L Lᵀ x = b given unrolled factors; b (..., n)."""
    n = len(l)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return jnp.stack(x, axis=-1)


def solve_spd(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """x = a⁻¹ b for SPD a (..., n, n), b (..., n). Static small n."""
    return _chol_substitute(_chol_factors(a), b)


def solve_spd_entries(a: list[list[jnp.ndarray]],
                      b: list[jnp.ndarray]) -> list[jnp.ndarray]:
    """Cholesky solve on *scalar entries*: a[i][j] (j ≤ i filled) and
    b[i] are batched scalars; returns x as a list of scalars. The
    structure-of-arrays form — no (..., n, n) tensor is ever
    materialized, so vmapped callers never pay tile padding on tiny
    trailing dims (the PnP Gauss-Newton loop at serving batch
    sizes)."""
    n = len(b)
    l: list[list[jnp.ndarray]] = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = jnp.sqrt(jnp.maximum(s, _EPS))
            else:
                l[i][j] = s / l[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return x


def solve_normal(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Least-squares / square solve via normal equations:
    x = (aᵀa)⁻¹ aᵀ b for a (..., m, n), b (..., m)."""
    ata = jnp.einsum("...mi,...mj->...ij", a, a)
    atb = jnp.einsum("...mi,...m->...i", a, b)
    return solve_spd(ata, atb)


def inv3x3(a: jnp.ndarray) -> jnp.ndarray:
    """Closed-form adjugate inverse of (..., 3, 3) matrices."""
    m = a
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = (m[..., 0, 0] * c00 + m[..., 0, 1] * c01
           + m[..., 0, 2] * c02)
    det = jnp.where(jnp.abs(det) < _EPS,
                    jnp.sign(det) * _EPS + _EPS, det)
    adj = jnp.stack([
        jnp.stack([c00, c10, c20], -1),
        jnp.stack([c01, c11, c21], -1),
        jnp.stack([c02, c12, c22], -1),
    ], -2)
    return adj / det[..., None, None]
