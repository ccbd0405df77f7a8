"""K4, vorticity confinement without density: the prologue template's
form <false, false, ...> (csrc/prologue.cu)."""


def matches(name):
    return "prologue_kernel<false, false," in name or \
        "prologue_kernelILb0ELb0E" in name
