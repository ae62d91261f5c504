"""The five-point Poisson operator on an (ny, nx) grid and its plain
references: the stencil as diagonals, its products in float32 (to make a
right-hand side) and float64 (to judge an answer), and the first Galerkin
coarse operator of vertex-centred bilinear interpolation, worked out in
float64 from the 1-D factors.

The operator is pyamg's ``gallery.poisson((ny, nx))`` times ``scale``:
4 on the diagonal and -1 for each grid neighbour, rows ordered
``iy * nx + ix``.
"""

from __future__ import annotations

import numpy as np
import torch


def offsets(nx: int) -> tuple:
    """The stencil's diagonal offsets, ascending."""
    return (-nx, -1, 0, 1, nx)


def diagonals(ny: int, nx: int, device, dtype=torch.float32) -> torch.Tensor:
    """(5, ny*nx) diagonals: ``data[d, i] = A[i, i + offsets[d]]``, 0 where
    the neighbour lies outside the grid."""
    iy = torch.arange(ny, device=device)[:, None].expand(ny, nx).reshape(-1)
    ix = torch.arange(nx, device=device)[None, :].expand(ny, nx).reshape(-1)
    neg = torch.tensor(-1.0, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.stack([
        torch.where(iy > 0, neg, zero),
        torch.where(ix > 0, neg, zero),
        torch.full((ny * nx,), 4.0, dtype=dtype, device=device),
        torch.where(ix < nx - 1, neg, zero),
        torch.where(iy < ny - 1, neg, zero),
    ])


def apply(x: torch.Tensor, ny: int, nx: int, scale: float = 1.0) -> torch.Tensor:
    """scale * A x in x's dtype, on x's device."""
    X = x.reshape(ny, nx)
    Y = 4.0 * X
    Y[1:, :] -= X[:-1, :]
    Y[:-1, :] -= X[1:, :]
    Y[:, 1:] -= X[:, :-1]
    Y[:, :-1] -= X[:, 1:]
    Y = Y.reshape(-1)
    return Y if scale == 1.0 else Y * scale


def relative_residual(x: torch.Tensor, b: torch.Tensor, ny: int, nx: int, scale: float) -> float:
    """||b - scale A x|| / ||b|| in float64 from x's and b's values."""
    b64 = b.double()
    r = b64 - apply(x.double(), ny, nx, float(scale))
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def _factors(n: int):
    """(M, K) = (P1^T P1, P1^T T P1) as scipy matrices, P1 the (n, n/2)
    1-D bilinear factor: coarse node j sits on fine node 2j+1 with weight
    1, fine nodes 2j and 2j+2 take 1/2, the wall is zero."""
    import scipy.sparse as sp

    j = np.arange(n // 2)
    rows = np.concatenate([2 * j + 1, 2 * j, 2 * j[:-1] + 2])
    cols = np.concatenate([j, j, j[:-1]])
    vals = np.concatenate([np.ones(n // 2), np.full(n // 2, 0.5), np.full(n // 2 - 1, 0.5)])
    P1 = sp.csr_matrix((vals, (rows, cols)), shape=(n, n // 2))
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n), format="csr")
    return (P1.T @ P1).tocsr(), (P1.T @ T @ P1).tocsr()


def _band(M, k: int) -> np.ndarray:
    """M[i, i + k] for every row i, 0 where i + k is outside."""
    n = M.shape[0]
    out = np.zeros(n)
    d = M.diagonal(k)
    if k >= 0:
        out[: n - k] = d
    else:
        out[-k:] = d
    return out


def coarse_diagonals(ny: int, nx: int, scale: float, device, dtype=torch.float64) -> dict:
    """{(Dy, Dx): (ny/2, nx/2) tensor} of P^T (scale A) P, P = P_y (x) P_x
    bilinear: with A = I (x) T + T (x) I (T the 1-D [-1, 2, -1]),
    P^T A P = M_y (x) K_x + K_y (x) M_x, M = P1^T P1, K = P1^T T P1.
    ``dtype`` below float64 rounds the scale, the factors and each product
    to it (the control)."""
    My, Ky = _factors(ny)
    Mx, Kx = (My, Ky) if nx == ny else _factors(nx)
    to = lambda v: torch.as_tensor(v, dtype=torch.float64, device=device).to(dtype)
    s = to(float(scale))
    out = {}
    for Dy in (-1, 0, 1):
        for Dx in (-1, 0, 1):
            a = torch.outer(to(_band(My, Dy)), to(_band(Kx, Dx))).to(dtype)
            b = torch.outer(to(_band(Ky, Dy)), to(_band(Mx, Dx))).to(dtype)
            out[(Dy, Dx)] = ((a + b).to(dtype) * s).to(dtype)
    return out


def coarse_error(offsets_prog, data_prog: torch.Tensor, ny: int, nx: int, scale: float) -> float:
    """max |A_H(program) - A_H(reference)| / max |A_H(reference)| over the
    whole coarse operator.  The program's DIA (``data[d, i] = A_H[i, i +
    off]``) is read on the coarse grid; a diagonal that the reference lacks
    counts whole, one the program lacks counts as zeros."""
    ncy, ncx = ny // 2, nx // 2
    k = ncy * ncx
    dev = data_prog.device
    ref = coarse_diagonals(ny, nx, scale, dev)
    if tuple(data_prog.shape) != (len(offsets_prog), k):
        return float("inf")
    by_off = {int(o): data_prog[d].double().reshape(ncy, ncx) for d, o in enumerate(offsets_prog)}
    worst = torch.zeros((), dtype=torch.float64, device=dev)
    top = max(float(v.double().abs().max()) for v in ref.values())
    for (Dy, Dx), want in ref.items():
        got = by_off.pop(Dy * ncx + Dx, None)
        diff = want.double().abs() if got is None else (got - want.double()).abs()
        worst = torch.maximum(worst, diff.max())
    for extra in by_off.values():
        worst = torch.maximum(worst, extra.abs().max())
    return float(worst) / top


def coarse_dia(ny: int, nx: int, scale: float, device, dtype) -> tuple:
    """(offsets, (9, k) data) of :func:`coarse_diagonals` in the DIA layout
    the package stores (offsets Dy * nx/2 + Dx, ascending)."""
    ncx = nx // 2
    diags = coarse_diagonals(ny, nx, scale, device, dtype)
    keys = sorted(diags, key=lambda d: d[0] * ncx + d[1])
    return tuple(Dy * ncx + Dx for Dy, Dx in keys), torch.stack([diags[d].reshape(-1) for d in keys])
