"""Operations of a configuration's ConvNet trunk, counted from its layer
table: a frozen copy of fluidnet_tpu_torch/utils/flops.py's model_flops
at commit a3725f6 (torch.CalculateFlops, calc_flops.lua:30) for a trunk
of one bank: multiply-adds, 2 operations each, of every convolution,
with the spatial size divided at each pool and multiplied at each
upsampling."""

import math


def model_flops(layers, in_channels, size_xyz):
    """Operations of one forward pass of the trunk on one sample of
    (x, y, z) cells."""
    osize, ksize = layers["osize"], layers["ksize"]
    psize, usize = layers["psize"], layers["usize"]
    spatial = list(size_xyz)
    in_c, flops = in_channels, 0

    def conv_flops(sp, ic, oc, k, up):
        return 2 * math.prod(sp) * oc * up ** 3 * ic * k ** 3

    for lid in range(len(osize) - 1):
        flops += conv_flops(spatial, in_c, osize[lid], ksize[lid], usize[lid])
        if psize[lid] > 1:
            spatial = [s // psize[lid] for s in spatial]
        if usize[lid] > 1:
            spatial = [s * usize[lid] for s in spatial]
        in_c = osize[lid]
    return flops + conv_flops(spatial, in_c, 1, ksize[-1], usize[-1])
