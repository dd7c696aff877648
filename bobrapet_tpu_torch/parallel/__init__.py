"""Training on the port: device meshes over process-group ranks
(mesh.py), optax's AdamW (optim.py) and the data-parallel train step
(train.py)."""

from .mesh import (
    DCN_AXIS,
    build_mesh,
    build_mesh_from_env,
    build_two_level_mesh,
    distributed_init_args,
    span_facts,
)
from .optim import AdamW, EmptyState, ScaleByAdamState, adamw
from .train import (
    cross_entropy_loss,
    init_train_state,
    make_multislice_train_step,
    make_token_batch,
    make_train_step,
)

__all__ = [
    "AdamW",
    "DCN_AXIS",
    "EmptyState",
    "ScaleByAdamState",
    "adamw",
    "build_mesh",
    "build_mesh_from_env",
    "build_two_level_mesh",
    "cross_entropy_loss",
    "distributed_init_args",
    "init_train_state",
    "make_multislice_train_step",
    "make_token_batch",
    "make_train_step",
    "span_facts",
]
