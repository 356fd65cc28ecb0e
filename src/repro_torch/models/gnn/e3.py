"""Minimal E(3) toolkit for MACE (``repro.models.gnn.e3`` counterpart):
real spherical harmonics up to l_max=2 and numerically-exact Gaunt coupling
tensors.

Gaunt coefficients G[(l1,m1),(l2,m2),(l3,m3)] = integral Y1 Y2 Y3 dOmega give
the equivariant coupling of products of spherical-harmonic-indexed features
(the even-parity subset of the Clebsch-Gordan paths; odd-parity paths such as
(1 x 1 -> 1) vanish -- a documented simplification vs full MACE, see
DESIGN.md).  They are computed once at import by least-squares projection of
real-SH products onto the real-SH basis over random unit vectors; the
integrands are degree <= 6 polynomials on S^2, so the projection is exact up
to solver precision (~1e-12).

The numpy half (``real_sh_np``, ``gaunt_tensor``, ``rotation_matrix``) is the
reference's own code; ``real_sh``, ``bessel_rbf`` and ``cutoff_envelope``
are its formulas on torch tensors.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

L_MAX = 2
DIMS = {0: 1, 1: 3, 2: 5}
OFFSET = {0: 0, 1: 1, 2: 4}
TOTAL_DIM = 9  # 1 + 3 + 5


def real_sh_np(v: np.ndarray) -> np.ndarray:
    """v [*, 3] unit vectors -> [*, 9] real SH (l=0,1,2), Racah normalized so
    that Y_00 = 1 (MACE convention is unit-less; norms fold into weights)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    one = np.ones_like(x)
    return np.stack(
        [
            one,
            x,
            y,
            z,
            x * y * np.sqrt(3.0),
            y * z * np.sqrt(3.0),
            (3 * z * z - 1) / 2.0,
            x * z * np.sqrt(3.0),
            (x * x - y * y) * np.sqrt(3.0) / 2.0,
        ],
        axis=-1,
    )


def real_sh(v: torch.Tensor) -> torch.Tensor:
    """torch version of real_sh_np (same formulas)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    one = torch.ones_like(x)
    s3 = math.sqrt(3.0)
    return torch.stack(
        [
            one,
            x,
            y,
            z,
            x * y * s3,
            y * z * s3,
            (3 * z * z - 1) / 2.0,
            x * z * s3,
            (x * x - y * y) * s3 / 2.0,
        ],
        dim=-1,
    )


# The 9 real SH as polynomials in (x, y, z) restricted to the sphere:
# dict (i, j, k) exponents -> coefficient.
_S3 = np.sqrt(3.0)
_SH_POLY = [
    {(0, 0, 0): 1.0},  # Y_00
    {(1, 0, 0): 1.0},  # Y_1x
    {(0, 1, 0): 1.0},  # Y_1y
    {(0, 0, 1): 1.0},  # Y_1z
    {(1, 1, 0): _S3},  # Y_2,xy
    {(0, 1, 1): _S3},  # Y_2,yz
    {(0, 0, 2): 1.5, (0, 0, 0): -0.5},  # Y_2,z2
    {(1, 0, 1): _S3},  # Y_2,xz
    {(2, 0, 0): _S3 / 2, (0, 2, 0): -_S3 / 2},  # Y_2,x2-y2
]


def _dfact(n: int) -> float:
    return 1.0 if n <= 0 else n * _dfact(n - 2)


def _mono_integral(i: int, j: int, k: int) -> float:
    """Exact integral of x^i y^j z^k over the unit sphere."""
    if i % 2 or j % 2 or k % 2:
        return 0.0
    return (
        4.0
        * np.pi
        * _dfact(i - 1)
        * _dfact(j - 1)
        * _dfact(k - 1)
        / _dfact(i + j + k + 1)
    )


def _poly_mul(p: dict, q: dict) -> dict:
    out: dict = {}
    for (a, b, c), u in p.items():
        for (d, e, f), v in q.items():
            key = (a + d, b + e, c + f)
            out[key] = out.get(key, 0.0) + u * v
    return out


def _poly_integral(p: dict) -> float:
    return sum(v * _mono_integral(*m) for m, v in p.items())


@functools.lru_cache(maxsize=1)
def gaunt_tensor() -> np.ndarray:
    """G [9, 9, 9]: Y_a * Y_b = sum_c G[a,b,c] Y_c + (l=3,4 terms).

    Exact: G[a,b,c] = (integral Y_a Y_b Y_c dOmega) / (integral Y_c^2 dOmega),
    computed by closed-form monomial integration over the sphere (the real SH
    basis is orthogonal, so this projection is the expansion coefficient)."""
    g = np.zeros((9, 9, 9))
    norms = [_poly_integral(_poly_mul(p, p)) for p in _SH_POLY]
    for a in range(9):
        for b in range(9):
            pab = _poly_mul(_SH_POLY[a], _SH_POLY[b])
            for c in range(9):
                num = _poly_integral(_poly_mul(pab, _SH_POLY[c]))
                if abs(num) > 1e-12:
                    g[a, b, c] = num / norms[c]
    return g


def rotation_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    k = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def bessel_rbf(r: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """Radial Bessel basis (DimeNet/MACE standard): sin(n pi r / rc) / r."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    rr = torch.clamp(r[..., None], min=1e-9)
    return math.sqrt(2.0 / r_cut) * torch.sin(n * math.pi * rr / r_cut) / rr


def _integer_pow(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x**k`` by squaring, in the order the reference's ``x**k`` (XLA's
    integer power) multiplies: the envelope's terms cancel to a small
    value near the cutoff, where another order shows in float32."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def cutoff_envelope(r: torch.Tensor, r_cut: float, p: int = 6) -> torch.Tensor:
    """Smooth polynomial cutoff (DimeNet envelope)."""
    x = torch.clamp(r / r_cut, 0.0, 1.0)
    return (
        1.0
        - (p + 1) * (p + 2) / 2 * _integer_pow(x, p)
        + p * (p + 2) * _integer_pow(x, p + 1)
        - p * (p + 1) / 2 * _integer_pow(x, p + 2)
    )
