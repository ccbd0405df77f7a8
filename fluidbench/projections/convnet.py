"""The ConvNet projection ("projection": "convnet"): the configuration's
layer table (`layers`) as the port's FluidNet on the program's side and
as reference/model.py on the reference's, with the same weights.

The weights: a rollout runs the checkpoint that the configuration names
(`rollout_weights`), where it names one; otherwise, and in training,
weights drawn from the seed on the device. The reference convolves in
the configuration's compute type (`mconf.conv_compute_dtype`), the
control in the type below it.
"""

from fluidbench import weights as _weights
from fluidbench.reference import model

# conv_compute_dtype: (the reference's precision, the control's).
PRECISIONS = {"bfloat16": ("bf16", "fp8")}


def weights(config, seed, device, training):
    """{name: float32 tensor on the device}, the port's names."""
    if config.get("rollout_weights") and not training:
        return _weights.from_checkpoint(config, device)
    return _weights.from_seed(config, seed, device)


def program(mconf, params, device):
    """The port's FluidNet with `params` loaded."""
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    return _weights.load_into(FluidNet(mconf, device=device), params)


def precisions(config):
    """(the configuration's precision, the control's), as reference/model.py
    names them."""
    return PRECISIONS[config["mconf"]["conv_compute_dtype"]]


# The reference's projection: (p, u) of (pDiv, UDiv, flags); see
# reference/step.py.
reference = model.forward
