"""Hand-written Hopper kernels, their plain PyTorch versions and builds.

``ops`` holds the wrappers (one launch counter each, in ``ops.LAUNCHES``),
``ref`` the plain versions, ``build`` the ``nvcc`` build of ``csrc/``.
"""
from . import ops, ref  # noqa: F401
