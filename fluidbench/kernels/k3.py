"""K3, the Jacobi solve (csrc/jacobi.cu)."""


def matches(name):
    return "jacobi_sweep" in name or "jacobi_persistent" in name
