"""Layers of the LM side branch (port of ``repro.nn``).

Parameters are plain nested dicts of tensors with the JAX package's tree
layout, so a JAX tree crosses over leaf for leaf
(:func:`repro_torch.bridge.lm_params_from_numpy`), and each layer has its
``*_spec``, the reference's PartitionSpec tree.  ``sharding`` holds the
mesh context (``use_mesh``), the map from specs to DTensor placements
and the reference's ``constrain`` points, which are no-ops without a
mesh.
"""
from . import attention, core, mla, mlp, moe, rotary, sharding, ssm  # noqa: F401
