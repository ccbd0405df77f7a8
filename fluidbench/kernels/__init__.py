"""One file a kernel group of the port: the fragments of its kernels'
names in a device trace (mangled or demangled, as
scripts/torch_profile_step.py's GROUPS match them) and, where a metric
needs it, the bytes and operations its work needs at a cell's shapes."""
