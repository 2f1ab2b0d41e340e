"""SO(3) machinery for EquiformerV2's eSCN convolution.

Port of ``repro.models.gnn.so3``.  The eSCN trick (arXiv:2302.03655 /
2306.12059): rotate each edge's source irreps into a frame where the edge
direction is +z; there the SO(3) tensor product degenerates into
independent SO(2) mixes per |m| (O(L^3) instead of O(L^6)), truncated at
m_max.

Wigner rotation matrices are built two ways:

* ``wigner_solve``   — the oracle: for any rotation R, solve
  D^l = Y^l(R S) @ pinv(Y^l(S)) on a fixed set S of sample directions.
  Convention-free and exact to fp precision; used in tests and to
  precompute the J^l constants.
* ``wigner_align_z`` — the fast per-edge path: decompose the align-to-z
  rotation as Ry(-beta) Rz(-alpha) and use the e3nn J-matrix identity
  D_y(b) = J D_z(b) J with J^l = D^l(R_swap) precomputed once via the
  oracle.  Per-edge cost is two small dense matmuls per l.

The constants (``_sample_dirs``, ``_sh_pinv``, ``j_matrices``) are numpy,
computed once and cached, as the reference's; the per-edge path is torch.
The J^l reach a device once per (l_max, device, dtype) and stay there, so
a step on the card copies nothing from the host.

Real spherical harmonics use the standard orthonormal basis, ordering
m = -l..l, flat index l*l + l + m; D^l is orthogonal in this basis.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


def num_coeffs(l_max: int) -> int:
    return (l_max + 1) ** 2


def flat_index(l: int, m: int) -> int:
    return l * l + l + m


# ---------------------------------------------------------------------------
# real spherical harmonics (torch, or numpy for the constants)
# ---------------------------------------------------------------------------

def real_sph_harm(l_max: int, dirs):
    """dirs: (..., 3) unit vectors -> (..., (l_max+1)^2) real SH values.

    ``dirs`` is a torch tensor on the per-edge path, or a numpy array for
    the Wigner oracle's constants; the result is of the same kind.
    """
    xp = np if isinstance(dirs, np.ndarray) else torch
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    rxy = xp.sqrt(xp.clip(x * x + y * y, 1e-24, None))
    ct = xp.clip(z, -1.0, 1.0)             # cos(theta)
    st = rxy                               # sin(theta) >= 0
    cp, sp = x / rxy, y / rxy              # cos/sin(phi)

    # cos(m phi), sin(m phi) by recurrence
    cos_m = [xp.ones_like(cp), cp]
    sin_m = [xp.zeros_like(sp), sp]
    for m in range(2, l_max + 1):
        cos_m.append(2 * cp * cos_m[-1] - cos_m[-2])
        sin_m.append(2 * cp * sin_m[-1] - sin_m[-2])

    # associated Legendre P_l^m(ct) with sin^m factors, standard recurrences
    p = {}
    p[(0, 0)] = xp.ones_like(ct)
    for m in range(1, l_max + 1):
        p[(m, m)] = -(2 * m - 1) * st * p[(m - 1, m - 1)]
    for m in range(0, l_max):
        p[(m + 1, m)] = (2 * m + 1) * ct * p[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            p[(l, m)] = ((2 * l - 1) * ct * p[(l - 1, m)]
                         - (l + m - 1) * p[(l - 2, m)]) / (l - m)

    out = []
    for l in range(l_max + 1):
        row = [None] * (2 * l + 1)
        for m in range(0, l + 1):
            n = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                row[l] = n * p[(l, 0)]
            else:
                row[l + m] = math.sqrt(2) * n * p[(l, m)] * cos_m[m]
                row[l - m] = math.sqrt(2) * n * p[(l, m)] * sin_m[m]
        out.extend(row)
    return xp.stack(out, -1)


# ---------------------------------------------------------------------------
# Wigner-D via numeric solve (oracle) and J-matrix fast path
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _sample_dirs(l_max: int) -> np.ndarray:
    """Well-spread fixed sample directions (Fibonacci sphere)."""
    n = max(2 * num_coeffs(l_max), 32)
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], axis=-1)


@lru_cache(maxsize=None)
def _sh_pinv(l_max: int):
    """Per-l pseudo-inverse of Y^l at the sample dirs (numpy)."""
    s = _sample_dirs(l_max)
    ys = real_sph_harm(l_max, s)                            # (n_s, (L+1)^2)
    pinvs = []
    for l in range(l_max + 1):
        block = ys[:, l * l:(l + 1) ** 2]                   # (n_s, 2l+1)
        pinvs.append(np.linalg.pinv(block))                 # (2l+1, n_s)
    return pinvs


def wigner_solve(l_max: int, rot):
    """Oracle Wigner blocks for rotation matrices rot: (..., 3, 3), a
    torch tensor or a numpy array.

    Returns list per l of (..., 2l+1, 2l+1) with
    Y^l(R r) = D^l(R) @ Y^l(r).
    """
    if isinstance(rot, np.ndarray):
        xp, asarray = np, lambda a: np.asarray(a, dtype=rot.dtype)
    else:
        xp = torch
        asarray = lambda a: torch.as_tensor(a, dtype=rot.dtype,
                                            device=rot.device)
    s = asarray(_sample_dirs(l_max))                        # (n_s, 3)
    rs = xp.einsum("...ij,nj->...ni", rot, s)               # (..., n_s, 3)
    y_rs = real_sph_harm(l_max, rs)                         # (..., n_s, K)
    blocks = []
    for l in range(l_max + 1):
        pinv = asarray(_sh_pinv(l_max)[l])
        yb = y_rs[..., l * l:(l + 1) ** 2]                  # (..., n_s, 2l+1)
        # D^l: rows = rotated SH index: Y(R s) = D Y(s) =>
        # y_rs[n, i] = sum_j D[i, j] Y[n, j]  =>  D = (pinv @ y_rs)^T
        d = xp.swapaxes(xp.einsum("jn,...ni->...ji", pinv, yb), -1, -2)
        blocks.append(d)
    return blocks


@lru_cache(maxsize=None)
def j_matrices(l_max: int) -> tuple:
    """J^l = D^l(R_swap) as numpy constants (via the numpy oracle).

    R_swap is the INVOLUTIVE 180-degree rotation about (y+z)/sqrt(2)
    (y<->z, x->-x), the e3nn convention: Ry(b) = R_swap Rz(b) R_swap
    holds exactly (conjugation by an involution), hence
    D(Ry(b)) = J D(Rz(b)) J with J^2 = I.  (Ry(pi/2) does NOT satisfy
    this identity — conjugating Rz by it yields Rx, not Ry.)
    """
    r_swap = np.array([[-1.0, 0.0, 0.0],
                       [0.0, 0.0, 1.0],
                       [0.0, 1.0, 0.0]])
    blocks = wigner_solve(l_max, r_swap)
    return tuple(np.asarray(b) for b in blocks)


@lru_cache(maxsize=16)
def _j_on(l_max: int, device: torch.device, dtype: torch.dtype) -> tuple:
    """The J^l on ``device`` in ``dtype``, copied there once."""
    return tuple(torch.from_numpy(j).to(dtype).to(device)
                 for j in j_matrices(l_max))


def _dz_blocks(l_max: int, ang):
    """D^l(Rz(ang)) blocks; ang: (...,) -> list of (..., 2l+1, 2l+1).

    D^l is cos(m ang) on its diagonal and -sin(m ang) / sin(m ang) at
    (l+m, l-m) / (l-m, l+m): the diagonal of cos(m ang) over m = -l..l
    plus the anti-diagonal of -sin(m ang) (0 at its centre), built
    without writing into a tensor autograd needs: the diagonal's columns
    taken in reverse (an ``index_select``, which DTensor shards where it
    has no rule for ``flip``).
    """
    blocks = []
    for l in range(l_max + 1):
        m = torch.arange(-l, l + 1, dtype=ang.dtype, device=ang.device)
        m_ang = ang[..., None] * m
        anti = torch.diag_embed(-torch.sin(m_ang))
        rev = torch.arange(2 * l, -1, -1, device=ang.device)
        d = (torch.diag_embed(torch.cos(m_ang))
             + anti.index_select(anti.dim() - 1, rev))
        blocks.append(d)
    return blocks


def wigner_align_z(l_max: int, dirs):
    """Wigner blocks of the rotation taking each dir to +z (fast path).

    dirs: (..., 3) unit vectors.  R = Ry(-beta) @ Rz(-alpha) with
    alpha = atan2(y, x), beta = arccos(z);  D = [J Dz(-beta) J] Dz(-alpha).
    """
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    alpha = torch.atan2(y, x)
    beta = torch.arccos(z.clamp(-1.0, 1.0))
    dz_a = _dz_blocks(l_max, -alpha)
    dz_b = _dz_blocks(l_max, -beta)
    js = _j_on(l_max, dirs.device, dirs.dtype)
    blocks = []
    for l in range(l_max + 1):
        j = js[l]
        dy = j @ dz_b[l] @ j
        blocks.append(dy @ dz_a[l])
    return blocks


def split_l(feats, l_max: int):
    """(..., (l_max+1)^2, C) -> the l = 0..l_max blocks of 2l+1 rows.

    One ``split``, whose backward is one ``cat``: a slice per l would
    make autograd allocate and fill a zero gradient of the whole tensor
    for each l, which at an edge tensor's size (E x 49 x 128) costs more
    than the rotation itself.
    """
    return feats.split([2 * l + 1 for l in range(l_max + 1)], dim=-2)


def apply_wigner(blocks, feats, *, transpose: bool = False):
    """Rotate irrep features. feats: (..., (l_max+1)^2, C)."""
    outs = []
    for d, xl in zip(blocks, split_l(feats, len(blocks) - 1)):
        outs.append((d.transpose(-1, -2) if transpose else d) @ xl)
    return torch.cat(outs, -2)


def truncated_size(l_max: int, m_max: int) -> int:
    """Number of irrep components with |m| <= m_max."""
    return sum(min(2 * l + 1, 2 * m_max + 1) for l in range(l_max + 1))


def apply_wigner_truncated(blocks, feats, m_max: int):
    """Rotate INTO the edge frame keeping only |m| <= m_max output rows.

    The eSCN SO(2) conv reads and writes only the |m| <= m_max components
    of the rotated features (everything else is zeroed), so the full
    (2l+1)x(2l+1) rotation wastes compute and bytes: for l_max=6/m_max=2
    only 29 of 49 rows are live.  Returns (..., truncated_size, C) in
    per-l blocks of min(2l+1, 2m_max+1) rows, ordered m = -m_max..m_max.
    """
    outs = []
    for l, (d, xl) in enumerate(zip(blocks, split_l(feats, len(blocks) - 1))):
        lo = max(0, l - m_max)
        hi = min(2 * l, l + m_max)
        outs.append(d[..., lo:hi + 1, :] @ xl)
    return torch.cat(outs, -2)


def apply_wigner_expand(blocks, feats_trunc, m_max: int):
    """Rotate BACK from the truncated edge frame: y = D^T y_trunc, using
    only the |m| <= m_max columns of each D^l (inverse of
    apply_wigner_truncated)."""
    rows = [min(2 * l + 1, 2 * m_max + 1) for l in range(len(blocks))]
    outs = []
    for l, (d, yl) in enumerate(zip(blocks, feats_trunc.split(rows, dim=-2))):
        lo = max(0, l - m_max)
        hi = min(2 * l, l + m_max)
        outs.append(d[..., lo:hi + 1, :].transpose(-1, -2) @ yl)
    return torch.cat(outs, -2)


def truncated_index(l: int, m: int, l_max: int, m_max: int) -> int:
    """Flat index of (l, m) within the truncated layout."""
    if abs(m) > min(l, m_max):
        raise ValueError(f"(l={l}, m={m}) is not in the layout truncated "
                         f"at m_max={m_max}")
    off = sum(min(2 * ll + 1, 2 * m_max + 1) for ll in range(l))
    lo = max(0, l - m_max)          # first stored row is m = lo - l
    return off + (l + m) - lo


def rotation_matrices(axis_angles):
    """Rodrigues: (..., 3) axis*angle -> (..., 3, 3). For tests."""
    theta = torch.linalg.vector_norm(axis_angles, dim=-1, keepdim=True)
    k = axis_angles / theta.clamp_min(1e-12)
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    kmat = torch.stack([
        torch.stack([zero, -kz, ky], -1),
        torch.stack([kz, zero, -kx], -1),
        torch.stack([-ky, kx, zero], -1)], -2)
    t = theta[..., None]
    eye = torch.eye(3, dtype=axis_angles.dtype, device=axis_angles.device)
    return eye + torch.sin(t) * kmat + (1 - torch.cos(t)) * (kmat @ kmat)
