"""A configuration's weights: a checkpoint's, read by the benchmark's own
msgpack reader, or drawn from the seed on the device.

Either way the result is a dict {name: float32 tensor on the device}
under the port's names (FluidNet.jax_named_parameters), which the
benchmark hands to the port and, as its own copy, to the reference.
"""

import os

import numpy as np
import torch

from fluidbench import msgpack
from fluidbench.reference.model import param_names, param_shapes

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "configs")


def in_channels(mconf):
    ic = mconf["input_channels"]
    return int(ic["p_div"]) + 3 * int(ic["u_div"]) + 1 + int(ic["div"])


def from_checkpoint(config, device):
    """The weights of the checkpoint file named by the configuration's
    `rollout_weights` (a flax state.msgpack)."""
    path = os.path.join(CONFIGS, config["rollout_weights"])
    with open(path, "rb") as f:
        params = msgpack._lists(msgpack.unpackb(f.read()))["params"]
    out = {}
    for name in param_names(config["layers"]):
        i, leaf = name.split("/")[1], name.split("/")[-1]
        node = params["final"] if name.startswith("final") else \
            params["stages"][int(i)][0]
        out[name] = torch.tensor(np.asarray(node["conv"][leaf]),
                                 dtype=torch.float32, device=device)
    return out


def from_seed(config, seed, device):
    """Weights drawn from `seed` in one call on the device: torch's
    default conv init (models.fluidnet.random_model's law), U(-s, s) with
    s = 1 / sqrt(fan in) for a conv's weight and bias alike."""
    shapes = param_shapes(config["layers"], in_channels(config["mconf"]))
    sizes = [int(np.prod(s)) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        w_shape = shapes[name[:-1] + "w"]
        s = 1.0 / float(np.sqrt(np.prod(w_shape[1:])))
        out[name] = (flat[at:at + n] * s).view(shape)
        at += n
    return out


def load_into(model, weights):
    """Copies the weights into the port's FluidNet, name by name."""
    with torch.no_grad():
        for name, p in model.jax_named_parameters():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: the model's shape "
                                 f"{tuple(p.shape)}, the weights' "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
    return model
