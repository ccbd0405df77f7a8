"""Trilinear / fluid-aware interpolation and MAC-grid sampling.

Port of fluidnet_tpu.ops.interp:
  - build_index       (third_party/grid.cc:82-130, Manta's BUILD_INDEX)
  - interpol          (RealGrid::interpol, grid.cc:182-202)
  - interpol_with_fluid (RealGrid::interpolWithFluid, grid.cc:224-332)
  - interpol_component (MACGrid::interpolComponent, grid.cc:435-456)
  - get_at_mac_x/y/z  (grid.cc:374-417): the transverse components are
    averaged around a face; shifted reads fill 0 at the domain edge.

Positions are in Manta grid coordinates (the centre of cell (i, j, k) is
at (i+0.5, j+0.5, k+0.5)), shaped (b, z, y, x); fields are (b, c, z, y, x).
The JAX package leaves the gathers to XLA; here they are torch.gather on
the flattened grid, in plain PyTorch: no kernel of the TPU package does
this work.
"""

import functools
from typing import NamedTuple

import torch

from fluidnet_tpu_torch.core.celltype import is_fluid
from fluidnet_tpu_torch.core.grids import resolve_device
from fluidnet_tpu_torch.ops import stencil as st


class Index(NamedTuple):
    """Lower corner indices and the two lerp weights per axis."""
    xi: torch.Tensor
    yi: torch.Tensor
    zi: torch.Tensor
    s0: torch.Tensor
    s1: torch.Tensor
    t0: torch.Tensor
    t1: torch.Tensor
    f0: torch.Tensor
    f1: torch.Tensor


def build_index(px, py, pz, shape, is_3d, z0=0):
    """The BUILD_INDEX clamp logic (grid.cc:82-130). px/py/pz: float
    positions (b, z, y, x); shape: the grid's (Z, Y, X). z0: the global
    index of the grid's first z plane (a slab of a z-sharded grid): pz is
    global, its clamps sit at the slab's ends expressed globally, and the
    returned zi is the slab's own index."""
    Z, Y, X = shape

    def one_axis(p, n, o=0):
        p = p - 0.5
        i = torch.floor(p).to(torch.int32)
        w1 = p - i.to(p.dtype)
        w0 = 1.0 - w1
        neg = p < float(o)      # clamp to the border (grid.cc:97-129)
        i = torch.where(neg, o, i)
        w0 = torch.where(neg, 1.0, w0)
        w1 = torch.where(neg, 0.0, w1)
        hi = i >= o + n - 1
        i = torch.where(hi, o + n - 2, i)
        w0 = torch.where(hi, 0.0, w0)
        w1 = torch.where(hi, 1.0, w1)
        return (i - o if o else i), w0, w1

    xi, s0, s1 = one_axis(px, X)
    yi, t0, t1 = one_axis(py, Y)
    if is_3d:
        zi, f0, f1 = one_axis(pz, Z, int(z0))
    else:
        zi = torch.zeros_like(xi)
        f0 = torch.ones_like(s0)
        f1 = torch.zeros_like(s0)
    return Index(xi, yi, zi, s0, s1, t0, t1, f0, f1)


def gather3d(fields, xi, yi, zi):
    """fields[b, :, zi, yi, xi] with per-cell integer indices.

    fields: (b, c, Z, Y, X); xi/yi/zi: (b or 1, z, y, x) integers, in range
    (the flat index is clamped, as JAX's take_along_axis(mode="clip")).
    Returns (b, c, z, y, x)."""
    b, c, Z, Y, X = fields.shape
    lin = ((zi * Y + yi) * X + xi).to(torch.int64)
    out_shape = (b, c) + tuple(lin.shape[1:])
    lin = lin.clamp(0, Z * Y * X - 1).reshape(lin.shape[0], 1, -1)
    flat = fields.reshape(b, c, Z * Y * X)
    return torch.gather(flat, 2, lin.expand(b, c, lin.shape[2])).reshape(
        out_shape)


def _corners(idx, is_3d):
    """The 8 (4 in 2-D) corner index triples, in the reference's combine
    order: y (t) first, then x (s), then z (f)."""
    xi, yi, zi = idx.xi, idx.yi, idx.zi
    c = [(xi, yi, zi), (xi, yi + 1, zi), (xi + 1, yi, zi),
         (xi + 1, yi + 1, zi)]
    if is_3d:
        c += [(xi, yi, zi + 1), (xi, yi + 1, zi + 1), (xi + 1, yi, zi + 1),
              (xi + 1, yi + 1, zi + 1)]
    return c


def _combine(g, idx, is_3d):
    """The plain (tri)linear combination of the gathered corners."""
    s0, s1 = idx.s0[:, None], idx.s1[:, None]
    t0, t1 = idx.t0[:, None], idx.t1[:, None]
    lo = (g[0] * t0 + g[1] * t1) * s0 + (g[2] * t0 + g[3] * t1) * s1
    if not is_3d:
        return lo
    hi = (g[4] * t0 + g[5] * t1) * s0 + (g[6] * t0 + g[7] * t1) * s1
    return lo * idx.f0[:, None] + hi * idx.f1[:, None]


def interpol(field, px, py, pz, is_3d, z0=0):
    """Plain (tri)linear interpolation, RealGrid::interpol semantics, of
    every channel of field (b, c, Z, Y, X) at the same positions (z0:
    build_index's). Returns (b, c, z, y, x)."""
    idx = build_index(px, py, pz, field.shape[2:], is_3d, z0)
    return _combine([gather3d(field, *c) for c in _corners(idx, is_3d)],
                    idx, is_3d)


def _lerp1d_with_fluid(va, fa, vb, fb, ta, tb):
    """interpol1DWithFluid (grid.cc:204-222): lerp only between fluid
    samples; fall back to the fluid one; zero (and not fluid) if neither."""
    val = torch.where(fa & fb, va * ta + vb * tb,
                      torch.where(fa, va, torch.where(fb, vb, 0.0)))
    return val, fa | fb


def interpol_with_fluid(field, flags, px, py, pz, is_3d, z0=0):
    """RealGrid::interpolWithFluid (grid.cc:224-332): combines the corner
    values along y, then x, then z, each time lerping only between fluid
    samples; with no fluid corner at all, the plain interpolation of the
    same corners. field: (b, 1, Z, Y, X); z0: build_index's."""
    idx = build_index(px, py, pz, field.shape[2:], is_3d, z0)
    packed = torch.cat([field, is_fluid(flags).to(field.dtype)], dim=1)
    g = [gather3d(packed, *c) for c in _corners(idx, is_3d)]
    vals = [x[:, 0:1] for x in g]
    fm = [x[:, 1:2] > 0.5 for x in g]
    s0, s1 = idx.s0[:, None], idx.s1[:, None]
    t0, t1 = idx.t0[:, None], idx.t1[:, None]
    v_ab, f_ab = _lerp1d_with_fluid(vals[0], fm[0], vals[1], fm[1], t0, t1)
    v_cd, f_cd = _lerp1d_with_fluid(vals[2], fm[2], vals[3], fm[3], t0, t1)
    v, f = _lerp1d_with_fluid(v_ab, f_ab, v_cd, f_cd, s0, s1)
    if is_3d:
        v_ef, f_ef = _lerp1d_with_fluid(vals[4], fm[4], vals[5], fm[5], t0,
                                        t1)
        v_gh, f_gh = _lerp1d_with_fluid(vals[6], fm[6], vals[7], fm[7], t0,
                                        t1)
        v_hi, f_hi = _lerp1d_with_fluid(v_ef, f_ef, v_gh, f_gh, s0, s1)
        v, f = _lerp1d_with_fluid(v, f, v_hi, f_hi, idx.f0[:, None],
                                  idx.f1[:, None])
    return torch.where(f, v, _combine(vals, idx, is_3d))


def interpol_component(u, c, px, py, pz, is_3d, z0=0):
    """MACGrid::getInterpolatedComponentHi, order 1: the plain
    interpolation of MAC component c (grid.cc:435-456); z0: build_index's.
    Returns (b, z, y, x)."""
    return interpol(u[:, c:c + 1], px, py, pz, is_3d, z0)[:, 0]


def get_at_mac_x(u, is_3d):
    vx = u[:, 0]
    vy = 0.25 * (u[:, 1] + st.xm(u[:, 1]) + st.yp(u[:, 1]) +
                 st.xm(st.yp(u[:, 1])))
    if is_3d:
        vz = 0.25 * (u[:, 2] + st.xm(u[:, 2]) + st.zp(u[:, 2]) +
                     st.xm(st.zp(u[:, 2])))
    else:
        vz = torch.zeros_like(vx)
    return torch.stack([vx, vy, vz], dim=1)


def get_at_mac_y(u, is_3d):
    vx = 0.25 * (u[:, 0] + st.ym(u[:, 0]) + st.xp(u[:, 0]) +
                 st.ym(st.xp(u[:, 0])))
    vy = u[:, 1]
    if is_3d:
        vz = 0.25 * (u[:, 2] + st.ym(u[:, 2]) + st.zp(u[:, 2]) +
                     st.ym(st.zp(u[:, 2])))
    else:
        vz = torch.zeros_like(vx)
    return torch.stack([vx, vy, vz], dim=1)


def get_at_mac_z(u, is_3d):
    if not is_3d:
        raise ValueError("get_at_mac_z is 3-D only")
    vx = 0.25 * (u[:, 0] + st.zm(u[:, 0]) + st.xp(u[:, 0]) +
                 st.zm(st.xp(u[:, 0])))
    vy = 0.25 * (u[:, 1] + st.zm(u[:, 1]) + st.yp(u[:, 1]) +
                 st.zm(st.yp(u[:, 1])))
    vz = u[:, 2]
    return torch.stack([vx, vy, vz], dim=1)


def cell_center_positions(shape, dtype=torch.float32, device=None, z0=0):
    """(px, py, pz) tensors of cell-center coordinates, each (1, z, y, x),
    on resolve_device(device); built once per shape, dtype, device and z
    origin (they are read-only expanded views). z0 is the global index of
    the first z plane (a slab of a z-sharded grid): pz = z0 + k + 0.5."""
    _, _, Z, Y, X = shape
    return _cell_centers(int(Z), int(Y), int(X), dtype,
                         resolve_device(device), int(z0))


@functools.lru_cache(maxsize=64)
def _cell_centers(Z, Y, X, dtype, device, z0):
    px = torch.arange(X, dtype=dtype, device=device).view(1, 1, 1, X) + 0.5
    py = torch.arange(Y, dtype=dtype, device=device).view(1, 1, Y, 1) + 0.5
    pz = torch.arange(z0, z0 + Z, dtype=dtype,
                      device=device).view(1, Z, 1, 1) + 0.5
    return (px.expand(1, Z, Y, X), py.expand(1, Z, Y, X),
            pz.expand(1, Z, Y, X))
