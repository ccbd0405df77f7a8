"""K5, the windowed warp (csrc/warp.cu)."""


def matches(name):
    return "warp_direct" in name
