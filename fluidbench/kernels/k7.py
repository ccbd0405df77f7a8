"""K7, the dynamic gather probe (csrc/dyngather.cu)."""


def matches(name):
    return "dyngather" in name
