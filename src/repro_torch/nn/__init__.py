"""Layers of the LM side branch (port of ``repro.nn``).

Parameters are plain nested dicts of tensors with the JAX package's tree
layout, so a JAX tree crosses over leaf for leaf
(:func:`repro_torch.bridge.lm_params_from_numpy`).  The JAX ``constrain``
sharding hints are single-device no-ops here and are dropped; the mesh
context is ``sharding`` (``use_mesh``), which the expert-parallel MoE
reads.
"""
from . import attention, core, mla, mlp, moe, rotary, sharding, ssm  # noqa: F401
