"""Operations of a banked ConvNet trunk, counted from its layer table and
the mconf's banks (model.lua:266-331 as reference/model_banks.py runs
them): multiply-adds, 2 operations each, of every convolution at its
output's size. Each bank keeps its own size from the split to the join:
a dilate bank its input's (a dilated convolution does the operations of
an undilated one), an mres bank the pyramid's (halved once a bank); each
pool divides it and each upsampling multiplies it; from the join on the
trunk runs at bank 0's size, with banks_num times the channels after a
concat. One bank is tog's trunk as flops.py counts it."""

import math


def _banks(mconf, i, n_stage):
    n = mconf["banks_num"]
    if i < n_stage - 1 and n > 1 and \
            mconf["banks_split_stage"] <= i + 1 < mconf["banks_join_stage"]:
        return n
    return 1


def conv_ops(layers, mconf, in_channels, size_xyz):
    """[(stage, bank, operations)] of one forward pass on one sample of
    (x, y, z) cells, in the trunk's order; the head is the last stage."""
    osize, ksize = layers["osize"], layers["ksize"]
    psize, usize = layers["psize"], layers["usize"]
    n = len(osize)
    sizes = [list(size_xyz)]
    in_c, out = in_channels, []
    for i in range(n):
        nb = _banks(mconf, i, n)
        if nb > 1 and len(sizes) == 1:
            mres = mconf["banks_type"] == "mres"
            sizes = [[s // 2 ** ib if mres else s for s in sizes[0]]
                     for ib in range(nb)]
        if nb == 1 and len(sizes) > 1:
            sizes = sizes[:1]
            if mconf["banks_aggregate_method"] == "concat":
                in_c *= mconf["banks_num"]
        for ib, sp in enumerate(sizes):
            up = usize[i]
            ops = 2 * math.prod(sp) * osize[i] * up ** 3 * in_c * \
                ksize[i] ** 3
            out.append((i, ib, ops))
            sizes[ib] = [s // psize[i] * up for s in sp]
        in_c = osize[i]
    return out


def model_flops(layers, mconf, in_channels, size_xyz):
    """Operations of one forward pass of the trunk on one sample."""
    return sum(ops for _, _, ops in conv_ops(layers, mconf, in_channels,
                                             size_xyz))


def bank_flops(layers, mconf, in_channels, size_xyz, bank):
    """Operations of bank `bank`'s convolutions between the split and the
    join, one forward pass on one sample."""
    n = len(layers["osize"])
    return sum(ops for i, ib, ops in conv_ops(layers, mconf, in_channels,
                                              size_xyz)
               if ib == bank and _banks(mconf, i, n) > 1)
