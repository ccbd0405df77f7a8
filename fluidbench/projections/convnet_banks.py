"""The banked ConvNet projection ("projection": "convnet_banks"): the
configuration's layer table (`layers`) with the mconf's banks, as the
port's FluidNet on the program's side and as reference/model_banks.py on
the reference's, with the same weights.

The weights are drawn from the seed on the device under the banked
names ("stages/<i>/<bank>/conv/{w,b}", "final/conv/{w,b}"), torch's
default conv init (models.fluidnet.random_model's law): U(-s, s) with
s = 1 / sqrt(fan in) for a conv's weight and bias alike, in one call,
every bank a draw of its own (no configuration shares a bank's weights).
The reference
convolves in the configuration's compute type, the control in the type
below it (projections/convnet.py's PRECISIONS).
"""

import numpy as np
import torch

from fluidbench import weights as _weights
from fluidbench.projections.convnet import PRECISIONS
from fluidbench.reference import model_banks
from fluidbench.reference.step import namespace


def shapes(config):
    """{name: shape} of the configuration's weights, in the port's
    order."""
    mconf = namespace(config["mconf"])
    return model_banks.param_shapes(mconf, config["layers"],
                                    _weights.in_channels(config["mconf"]))


def weights(config, seed, device, training):
    """{name: float32 tensor on the device}, the port's names."""
    table = shapes(config)
    sizes = [int(np.prod(s)) for s in table.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for (name, shape), n in zip(table.items(), sizes):
        w_shape = table[name[:-1] + "w"]
        s = 1.0 / float(np.sqrt(np.prod(w_shape[1:])))
        out[name] = (flat[at:at + n] * s).view(shape)
        at += n
    return out


def program(mconf, params, device):
    """The port's FluidNet with `params` loaded."""
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    return _weights.load_into(FluidNet(mconf, device=device), params)


def precisions(config):
    """(the configuration's precision, the control's)."""
    return PRECISIONS[config["mconf"]["conv_compute_dtype"]]


# The reference's projection: (p, u) of (pDiv, UDiv, flags); see
# reference/step.py.
reference = model_banks.forward
