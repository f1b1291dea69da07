"""Checkpoints in the JAX package's msgpack format, with the port's own
codec (no ``msgpack`` package): ``save_train_state`` /
``load_train_state`` for train states and policies, ``save_pytree`` /
``load_pytree`` for plain trees, ``bf16_safe_cast`` for a tree with bf16
leaves."""
from .msgpack_ckpt import bf16_safe_cast, load_pytree, save_pytree  # noqa: F401
from .train_state import (FORMAT_VERSION, load_train_state,  # noqa: F401
                          save_train_state)
