"""The distributed half of the engram context: span facts, the process
group and the mesh, from an env mapping and a host id.

Counterpart of ``bobrapet_tpu/sdk/context.py:123-170``
(``dcn_replicas``, ``dcn_replica_index``, ``initialize_distributed``,
``mesh``). The rest of the JAX ``EngramContext`` is control plane and is
not here; the backend-fallback analytics (``check_backend_expectation``)
are left out, since the port has no CPU fallback to report.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import DeviceLike, resolve_device
from ..parallel.mesh import (
    build_mesh,
    build_two_level_mesh,
    distributed_init_args,
    span_facts,
)
from . import contract


class DistributedContext:
    """The span of one engram process: ``env`` (default ``os.environ``) and
    its ``host_id`` (default ``BOBRA_TPU_HOST_ID``, else 0)."""

    def __init__(self, env: Optional[Mapping[str, str]] = None, host_id: Optional[int] = None):
        self.env = dict(os.environ if env is None else env)
        if host_id is None:
            try:
                host_id = int(self.env.get(contract.ENV_TPU_HOST_ID, "0") or 0)
            except ValueError:
                host_id = 0
        self.host_id = host_id

    @property
    def mesh_axes(self) -> dict[str, int]:
        return span_facts(self.env)["mesh_axes"] or {}

    @property
    def dcn_replicas(self) -> int:
        """DCN replica count of the spanning gang this step is a member of
        (1: a classic single grant)."""
        return span_facts(self.env)["replicas"]

    @property
    def dcn_replica_index(self) -> int:
        return span_facts(self.env)["replica"]

    def initialize_distributed(self, device: DeviceLike = None) -> bool:
        """Join the span's process group: ``init_process_group`` with
        ``init_method="tcp://<coordinator>"``, the span's process count and
        ``rank = process_base + host_id``; NCCL on a card, gloo when the
        caller asks for the CPU. No span (one process): a no-op, False."""
        args = distributed_init_args(self.env, host_id=self.host_id)
        if args is None:
            return False
        backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
        dist.init_process_group(backend, init_method=f"tcp://{args['coordinator_address']}",
                                world_size=args["num_processes"], rank=args["process_id"])
        return True

    def mesh(self, axes: Optional[dict[str, int]] = None,
             device_type: Optional[str] = None) -> DeviceMesh:
        """The granted mesh: ``axes`` or the granted ones; a spanning-gang
        member gets the two-level ``dcn`` x inner mesh."""
        inner = axes or self.mesh_axes or None
        if self.dcn_replicas > 1:
            return build_two_level_mesh(self.dcn_replicas, inner, device_type=device_type)
        return build_mesh(inner, device_type=device_type)
