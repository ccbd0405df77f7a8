"""What the scene generators share: the flags' cell types, the walled
empty domain, solids (boxes and spheres) and the plume's inflow, each
made on the device in a few large calls."""

import torch

TYPE_FLUID, TYPE_OBSTACLE = 1, 2


def grid(shape, device):
    """Index grids (z, y, x), each broadcastable to (Z, Y, X)."""
    Z, Y, X = shape
    return (torch.arange(Z, device=device).view(Z, 1, 1),
            torch.arange(Y, device=device).view(1, Y, 1),
            torch.arange(X, device=device).view(1, 1, X))


def empty_flags(batch, shape, device):
    """Fluid inside, obstacle on the one-cell border: (b, 1, Z, Y, X)
    int32 (core.grids.empty_domain)."""
    zz, yy, xx = grid(shape, device)
    Z, Y, X = shape
    wall = (xx < 1) | (xx > X - 2) | (yy < 1) | (yy > Y - 2) | \
        (zz < 1) | (zz > Z - 2)
    flags = torch.where(wall, TYPE_OBSTACLE, TYPE_FLUID).to(torch.int32)
    return flags.expand(batch, 1, Z, Y, X).contiguous()


def plume_bcs(batch, shape, density, u_scale, radius, device):
    """The frozen inflow of create_plume_bcs (simulate.lua:47-123): in the
    bottom 4 rows, u = (0, u_scale, 0) and the density inside a circle of
    radius `radius` * X about the domain's centre, u = 0 outside it.
    Returns {"u": (bc, inv), "density": (bc, inv)}, (b, c, Z, 4, X)."""
    Z, Y, X = shape
    zz, _, xx = grid(shape, device)
    YB = min(4, Y)
    rad = int(X * radius)
    dx_ = (X // 2 - 1) - xx
    dz_ = (max(Z // 2, 1) - 1) - zz
    inside = ((dx_ * dx_ + dz_ * dz_) <= rad * rad).expand(Z, YB, X)
    f32 = torch.float32
    u_bc = torch.stack([torch.zeros_like(inside, dtype=f32),
                        torch.where(inside, float(u_scale), 0.0),
                        torch.zeros_like(inside, dtype=f32)])
    u_bc = u_bc[None].expand(batch, 3, Z, YB, X).contiguous()
    u_inv = torch.zeros_like(u_bc)
    d_bc = torch.where(inside, float(density), 0.0)
    d_inv = torch.where(inside, 0.0, 1.0)
    d_bc, d_inv = (t[None, None].expand(batch, 1, Z, YB, X).contiguous()
                   for t in (d_bc, d_inv))
    return {"u": (u_bc, u_inv), "density": (d_bc, d_inv)}


def solids(is_box, size, centre, shape):
    """The cells of one solid a sample: a box (half extent `size`) where
    `is_box`, else a sphere (radius `size`), about `centre` (z, y, x);
    each argument a tensor with one entry a sample (centre (b, 3)).
    Returns (b, Z, Y, X) bool."""
    zz, yy, xx = grid(shape, size.device)
    b = size.shape[0]
    cz, cy, cx = (centre[:, i].view(b, 1, 1, 1) for i in range(3))
    r = size.view(b, 1, 1, 1)
    dz, dy, dx = (zz - cz).abs(), (yy - cy).abs(), (xx - cx).abs()
    box = (dz <= r) & (dy <= r) & (dx <= r)
    sphere = dz * dz + dy * dy + dx * dx <= r * r
    return torch.where(is_box.view(b, 1, 1, 1), box, sphere)
