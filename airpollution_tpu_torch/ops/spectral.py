"""FFT-based spectral preconditioner for the structured CRBE system,
PyTorch counterpart of ``airpollution_tpu/ops/spectral.py``.

On the structured triangulation with constant (v, D) the assembled
operator ``S = M + c dt (K + A)`` is translation-invariant in the mesh
interior: every interior row of an edge family (H, V, D, ops/stencil.py)
carries the same 5 coefficients. Embedded in three (n, n) canvases, the
interior operator is a 3x3-block circulant stencil, which a 2D FFT
diagonalises: per Fourier mode k it is the dense 3x3 complex "symbol"

    S_hat(k)[F, G] = sum_terms c_term * exp(-2 pi i k . s_term / n)

with s_term the canvas roll shift of that term. The preconditioner inverts
the (n, n, 3, 3) symbol once (one batched ``torch.linalg.inv``) and applies
``M^-1 r`` as 3 forward FFTs, one 3x3 product per mode and 3 inverse
FFTs. It is exact for the periodic interior operator and approximate on
Dirichlet and wrap-around rows, which the Krylov solver absorbs.

The symbol is built and inverted in complex64 whatever the solve's dtype,
as the JAX package does, so the preconditioner is float32-accurate under
float64 too: it changes the iteration count, and the converged solve
agrees with the Jacobi one to the solver's tolerance.
"""

from __future__ import annotations

import math

import torch

from airpollution_tpu_torch.ops.fused_solver import from_canvases, to_canvases
from airpollution_tpu_torch.ops.stencil import StencilPattern

# Term tables: (out_family, in_family, canvas roll shift (s0, s1)) in the
# order of ops/stencil.py's 15 extracted coefficient grids. A term
# y = roll(x, s) has the symbol factor exp(-2 pi i k . s / n).
_FAM = {"H": 0, "V": 1, "D": 2}
_TERMS = (
    # H rows
    ("H", "H", (0, 0)),
    ("H", "V", (0, -1)),   # V(i+1, j)
    ("H", "D", (0, 0)),
    ("H", "V", (1, 0)),    # V(i, j-1)
    ("H", "D", (1, 0)),    # D(i, j-1)
    # V rows
    ("V", "V", (0, 0)),
    ("V", "D", (0, 1)),    # D(i-1, j)
    ("V", "H", (0, 1)),    # H(i-1, j)
    ("V", "H", (-1, 0)),   # H(i, j+1)
    ("V", "D", (0, 0)),
    # D rows
    ("D", "D", (0, 0)),
    ("D", "V", (0, -1)),   # V(i+1, j)
    ("D", "H", (0, 0)),
    ("D", "H", (-1, 0)),   # H(i, j+1)
    ("D", "V", (0, 0)),
)


def interior_coefficients(pattern: StencilPattern, coeffs: tuple):
    """The 15 translation-invariant interior values (one per term), read
    at a deep-interior cell of each coefficient grid."""
    i = pattern.c // 2
    return tuple(g[i, i] for g in coeffs)


def build_symbol(pattern: StencilPattern, coeffs: tuple):
    """(n, n, 3, 3) complex64 symbol of the interior operator: each phase
    evaluated in complex128 and rounded, each coefficient rounded to
    complex64, the terms summed in complex64 in table order."""
    n = pattern.n
    vals = interior_coefficients(pattern, coeffs)
    device = vals[0].device
    k0 = torch.arange(n, dtype=torch.float64, device=device)[:, None]
    k1 = torch.arange(n, dtype=torch.float64, device=device)[None, :]
    sym = torch.zeros((n, n, 3, 3), dtype=torch.complex64, device=device)
    for (fo, fi, (s0, s1)), v in zip(_TERMS, vals):
        angle = (-2.0 * math.pi / n) * (k0 * s0 + k1 * s1)
        phase = torch.polar(torch.ones_like(angle), angle).to(torch.complex64)
        sym[:, :, _FAM[fo], _FAM[fi]] += (
            v.detach().to(torch.complex64) * phase)
    return sym


def spectral_preconditioner(pattern: StencilPattern, coeffs: tuple):
    """``precond(x_fam) -> z_fam`` applying the inverse symbol to a
    family-layout vector: the inverse is computed once here; each
    application is 3 FFTs, one 3x3 product per mode and 3 inverse FFTs,
    in the complex type of ``x_fam``'s FFT."""
    inv_sym = torch.linalg.inv(build_symbol(pattern, coeffs))

    def apply(x_fam):
        xh = torch.fft.fft2(to_canvases(pattern, x_fam))  # (3, n, n)
        zh = torch.einsum("nmfg,gnm->fnm", inv_sym.to(xh.dtype), xh)
        z = torch.fft.ifft2(zh).real.to(x_fam.dtype)
        return from_canvases(pattern, z)

    return apply
