"""Batched P3P minimal solver, Grunert's method (the counterpart of
``simpleslam_tpu/ops/p3p.py``).

With unit bearings j1..j3 and inter-point distances a, b, c, the distance
ratios satisfy a quartic in v. Its coefficients come from evaluating the
factored polynomial at five nodes through a constant inverse Vandermonde;
the roots come from Ferrari's method in complex arithmetic, are polished by
Newton steps on the factored form, and each positive real root gives a
pose by the triad method. Up to four poses per sample, all scored by the
caller's RANSAC.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from simpleslam_tpu_torch.ops import se3
from simpleslam_tpu_torch.utils.precision import highest_precision

_EPS = 1e-12
_NODES = np.array([0.0, 1.0, -1.0, 2.0, -2.0])
_VINV = np.linalg.inv(np.stack([_NODES ** k for k in range(5)], axis=1))


@functools.lru_cache(maxsize=None)
def _constants(dtype: torch.dtype, device: torch.device):
    """The nodes and the inverse Vandermonde on ``device``, copied there
    once (a copy from the host waits for the device)."""
    return (torch.as_tensor(_NODES, dtype=dtype, device=device),
            torch.as_tensor(_VINV.T, dtype=dtype, device=device))


def _solve_cubic_all(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """All 3 complex roots of t^3 + p t + q = 0 (Cardano), (..., 3)."""
    pc = p.to(torch.complex64)
    qc = q.to(torch.complex64)
    sq = torch.sqrt((qc / 2) ** 2 + (pc / 3) ** 3)
    u = (-qc / 2 + sq) ** (1.0 / 3.0)
    u = torch.where(u.abs() < 1e-20, torch.full_like(u, 1e-20), u)
    omega = complex(math.cos(2 * math.pi / 3), math.sin(2 * math.pi / 3))
    us = torch.stack([u, u * omega, u * omega ** 2], -1)
    return us - pc[..., None] / (3 * us)


def solve_quartic_real(c4, c3, c2, c1, c0):
    """Real parts of the 4 roots of c4 x^4 + ... + c0 (Ferrari) and an
    is_real flag per root (imaginary-magnitude test)."""
    c4s = torch.where(c4.abs() < _EPS, torch.full_like(c4, _EPS), c4)
    b, c, d, e = c3 / c4s, c2 / c4s, c1 / c4s, c0 / c4s
    p = c - 3 * b * b / 8
    q = d - b * c / 2 + b ** 3 / 8
    r = e - b * d / 4 + b * b * c / 16 - 3 * b ** 4 / 256
    A, B, C = p, p * p / 4 - r, -q * q / 8
    pp = B - A * A / 3
    qq = 2 * A ** 3 / 27 - A * B / 3 + C
    ms = _solve_cubic_all(pp, qq) - (A / 3).to(torch.complex64)[..., None]
    real_ok = ms.imag.abs() < 1e-4 * (1.0 + ms.real.abs())
    m = torch.where(real_ok, ms.real,
                    torch.full_like(ms.real, -float("inf"))).amax(-1)
    m = torch.clamp(m, min=1e-12)
    sqrt2m = torch.sqrt(2 * m).to(torch.complex64)
    q_c, p_c, m_c = (x.to(torch.complex64) for x in (q, p, m))
    t1 = p_c / 2 + m_c - q_c / (2 * sqrt2m)
    t2 = p_c / 2 + m_c + q_c / (2 * sqrt2m)
    d1 = torch.sqrt(sqrt2m ** 2 - 4 * t1)
    d2 = torch.sqrt(sqrt2m ** 2 - 4 * t2)
    y = torch.stack([(-sqrt2m + d1) / 2, (-sqrt2m - d1) / 2,
                     (sqrt2m + d2) / 2, (sqrt2m - d2) / 2], -1)
    x = y - (b / 4).to(torch.complex64)[..., None]
    return x.real, x.imag.abs() < 1e-3 * (1.0 + x.real.abs())


def _triad(P: torch.Tensor):
    """Orthonormal frame (columns) of three points (..., 3, 3) and the
    non-colinearity measure."""
    u1 = P[..., 1, :] - P[..., 0, :]
    u2 = P[..., 2, :] - P[..., 0, :]
    e1 = u1 / torch.clamp(torch.linalg.norm(u1, dim=-1, keepdim=True),
                          min=_EPS)
    e3 = torch.linalg.cross(e1, u2, dim=-1)
    n3 = torch.linalg.norm(e3, dim=-1)
    e3 = e3 / torch.clamp(n3, min=_EPS)[..., None]
    e2 = torch.linalg.cross(e3, e1, dim=-1)
    return torch.stack([e1, e2, e3], -1), n3


@highest_precision()
def p3p_grunert(X: torch.Tensor, bearings: torch.Tensor):
    """World points X (..., 3, 3) + unit camera bearings (..., 3, 3) ->
    (poses (..., 4, 4, 4) T_cw, valid (..., 4) bool)."""
    X1, X2, X3 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
    j1, j2, j3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    a = torch.linalg.norm(X2 - X3, dim=-1)[..., None]
    b = torch.linalg.norm(X1 - X3, dim=-1)[..., None]
    c = torch.linalg.norm(X1 - X2, dim=-1)[..., None]
    ca = (j2 * j3).sum(-1)[..., None]
    cb = (j1 * j3).sum(-1)[..., None]
    cg = (j1 * j2).sum(-1)[..., None]
    b2 = torch.clamp(b * b, min=_EPS)
    ab = a * a / b2
    cb2 = c * c / b2

    def w_of(v):
        return 1.0 + v * v - 2.0 * v * cb

    def u_of(v):
        num = (cb2 - ab) * w_of(v) + v * v - 1.0
        den = 2.0 * (v * ca - cg)
        return num / torch.where(den.abs() < 1e-9,
                                 torch.full_like(den, 1e-9), den)

    def gden2(v):
        """g(v) den(v)^2: the quartic in its stable, unexpanded form, and
        its derivative in v."""
        w = w_of(v)
        den = 2.0 * (v * ca - cg)
        u_num = (cb2 - ab) * w + v * v - 1.0
        g = den * den * (1.0 - cb2 * w) + u_num * u_num \
            - 2.0 * cg * u_num * den
        dw = 2.0 * v - 2.0 * cb
        dden = 2.0 * ca
        du = (cb2 - ab) * dw + 2.0 * v
        dg = (2.0 * den * dden * (1.0 - cb2 * w) - den * den * cb2 * dw
              + 2.0 * u_num * du - 2.0 * cg * (du * den + u_num * dden))
        return g, dg

    nodes, vinv_t = _constants(X.dtype, X.device)
    vals = gden2(nodes.expand(*X.shape[:-2], 5))[0]          # (..., 5)
    coeffs = vals @ vinv_t
    v, is_real = solve_quartic_real(coeffs[..., 4], coeffs[..., 3],
                                    coeffs[..., 2], coeffs[..., 1],
                                    coeffs[..., 0])           # (..., 4)
    for _ in range(6):
        g, dg = gden2(v)
        dg = torch.where(dg.abs() < 1e-12, torch.full_like(dg, 1e-12), dg)
        v = v - torch.clamp(g / dg, -0.5, 0.5)

    u = u_of(v)
    s1 = torch.sqrt(torch.clamp(b2 / torch.clamp(w_of(v), min=_EPS),
                                min=_EPS))
    s2, s3 = u * s1, v * s1
    ok = is_real & (s1 > 0) & (s2 > 0) & (s3 > 0)
    pc = torch.stack([s1[..., None] * j1[..., None, :],
                      s2[..., None] * j2[..., None, :],
                      s3[..., None] * j3[..., None, :]], -2)  # (..., 4, 3, 3)
    Fw, nw = _triad(X)
    Fc, nc = _triad(pc)
    ok = ok & (nw[..., None] > 1e-9) & (nc > 1e-9)
    R = Fc @ Fw[..., None, :, :].transpose(-1, -2)
    t = pc.mean(-2) - (R @ X.mean(-2)[..., None, :, None])[..., 0]
    T = se3.rt_to_T(R, t)
    eye = torch.eye(4, dtype=X.dtype, device=X.device)
    return torch.where(ok[..., None, None], T, eye), ok
