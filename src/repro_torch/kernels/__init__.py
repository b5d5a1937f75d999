"""Hand-written Hopper kernels of the port, one package each.

``<name>/csrc/<name>.cu`` is the CUDA C++ kernel (built by ``_build``),
``<name>/ref.py`` its plain torch version and ``<name>/ops.py`` the
wrapper: a CUDA tensor launches the kernel (or raises), a CPU tensor takes
the plain version.  Each wrapper counts its kernel launches in a
``launches`` attribute.
"""
