"""The ConvNet's convolutions: cuDNN's and CUTLASS's kernels (the port
has no convolution of its own), by the name fragments of
scripts/torch_profile_step.py's GROUPS, none of the port's kernels."""

FRAGMENTS = ("conv", "xmma", "gemm", "cudnn", "cutlass")


def matches(name):
    low = name.lower()
    return "convert" not in low and any(f in low for f in FRAGMENTS)
