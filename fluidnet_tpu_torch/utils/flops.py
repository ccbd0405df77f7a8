"""Analytic FLOP count and peak activation memory for the projection net.

Copy of fluidnet_tpu.utils.flops (backend-free) on the port's layer_spec.
Equivalent of torch.CalculateFlops (torch/lib/calc_flops.lua:30): a static
walk of the conv trunk counting multiply-adds (2 FLOPs each) and
activation elements, used at startup profiling (fluid_net_train.lua:144-189)
and recorded next to checkpoints. Reference value to sanity-check against:
the bundled 2-D default model reports 243,793,922 FLOPs/frame at 128x128
(data/models/myModel2D_mconf.txt:17, BASELINE.md).
"""

import math

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.models.fluidnet import layer_spec, num_input_channels


def model_flops(mconf: ModelConfig, size_xyz):
    """FLOPs for one frame (batch 1) at grid size (x, y, z). Each bank
    runs at its own size: a dilate bank at its input's, an mres bank at
    the pyramid's (halved once a bank), each carried through its own
    pools and upsampling; the join goes on at bank 0's size (mres
    upsamples the others to it)."""
    osize, ksize, psize, usize = layer_spec(mconf)
    nd = 3 if mconf.is_3d else 2
    X, Y, Z = size_xyz
    spatial = [X, Y] + ([Z] if mconf.is_3d else [])
    in_c = num_input_channels(mconf)
    flops = 0
    n_banks = 1
    bank_spatial = {0: list(spatial)}

    def conv_flops(sp, ic, oc, k, up):
        n_out = math.prod(sp) * oc * (up ** nd)
        return 2 * n_out * ic * (k ** nd)

    n_stage = len(osize)
    for lid in range(n_stage - 1):
        if mconf.banks_num > 1 and lid + 1 == mconf.banks_split_stage:
            n_banks = mconf.banks_num
            mres = mconf.banks_type == "mres"
            for ib in range(1, n_banks):
                bank_spatial[ib] = [s // (2 ** ib) if mres else s
                                    for s in bank_spatial[0]]
        if mconf.banks_num > 1 and lid + 1 == mconf.banks_join_stage:
            n_banks = 1
            bank_spatial = {0: bank_spatial[0]}
            if mconf.banks_aggregate_method == "concat":
                in_c = in_c * mconf.banks_num
        for ib in range(n_banks):
            sp = bank_spatial[ib]
            flops += conv_flops(sp, in_c, osize[lid], ksize[lid], usize[lid])
            if psize[lid] > 1:
                bank_spatial[ib] = [s // psize[lid] for s in sp]
            if usize[lid] > 1:
                bank_spatial[ib] = [s * usize[lid] for s in sp]
        in_c = osize[lid]
    if mconf.add_pressure_skip:
        in_c += 1
    flops += conv_flops(bank_spatial[0], in_c, 1, ksize[-1], usize[-1])
    return flops


def model_peak_activation(mconf: ModelConfig, size_xyz):
    """Peak activation element count across stages (calc_flops.lua's memory
    walk): max over stages of (input + output) activation elements."""
    osize, ksize, psize, usize = layer_spec(mconf)
    nd = 3 if mconf.is_3d else 2
    X, Y, Z = size_xyz
    spatial = math.prod([X, Y] + ([Z] if mconf.is_3d else []))
    in_c = num_input_channels(mconf)
    peak = 0
    for lid in range(len(osize)):
        oc = osize[lid] if lid < len(osize) - 1 else 1
        out_spatial = spatial * (usize[lid] ** nd) // (psize[lid] ** nd)
        peak = max(peak, spatial * in_c + out_spatial * oc)
        spatial = out_spatial
        in_c = oc
    return peak
