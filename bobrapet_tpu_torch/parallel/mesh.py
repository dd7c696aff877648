"""Device meshes from granted logical axes, over ranks of a process group.

Counterpart of ``bobrapet_tpu/parallel/mesh.py``: the same axis names,
sizes, checks and messages, but a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, one rank a device (a card, or a CPU process in the tests),
where JAX's is a ``Mesh`` over its local devices. With no process group
yet, :func:`build_mesh` starts a one-rank group of this process alone (an
in-memory store: no address, no file), the port's counterpart of JAX's one
local device. A span's process group comes from
:func:`sdk.context.initialize_distributed`, fed by :func:`distributed_init_args`.

Two-level meshes (multi-slice): :func:`build_two_level_mesh` puts a
``dcn`` outer axis over each replica's inner axes; ranks are ordered
replica-major (a rank is its replica's process base plus its host id), so
each ``dcn`` row is one replica's ranks. :func:`build_mesh_from_env` picks
the constructor from the env contract alone.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..sdk import contract

#: the outer (slower, data-center network) mesh axis of a two-level mesh
DCN_AXIS = "dcn"


def _resolve_axes(axes: Mapping[str, int], n: int) -> tuple[list[str], list[int]]:
    """Validate explicit axes against ``n`` devices (ranks).

    Single-axis grants keep the convenience fill (the axis scales up to
    absorb every device). Multi-axis grants are explicit: sizes are kept
    as given, and a product that exceeds ``n`` or does not divide it fails
    (JAX's rule and messages)."""
    names = list(axes.keys())
    sizes = [max(1, int(axes[a])) for a in names]
    prod = math.prod(sizes)
    if len(sizes) == 1 and prod < n and n % prod == 0:
        sizes[0] = n  # convenience fill: one axis over everything
        prod = n
    if prod > n:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} need {prod} devices, "
            f"have {n}"
        )
    if prod < n and n % prod != 0:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} cover {prod} devices "
            f"which does not divide the {n} available — explicit "
            f"multi-axis grants must divide the device count (pass "
            f"axes=None or a single axis for the implicit fill)"
        )
    return names, sizes


def default_device_type() -> str:
    """``"cuda"`` where a card is visible, else ``"cpu"``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def world_ranks(device_type: str) -> list[int]:
    """The ranks of the default process group; without one, a one-rank
    group of this process alone is started (gloo on the CPU, NCCL on a
    card; an in-memory store), JAX's one local device."""
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return list(range(dist.get_world_size()))


def _mesh(device_type: str, ranks: Sequence[int], sizes: Sequence[int],
          names: Sequence[str]) -> DeviceMesh:
    grid = torch.tensor(list(ranks), dtype=torch.int).reshape(list(sizes))
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(names))


def build_mesh(axes: Optional[dict[str, int]] = None, ranks: Optional[Sequence[int]] = None,
               device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over the process group's ranks (or ``ranks``).

    ``axes`` maps logical axis name -> size (``{"data": 2, "model": 4}``).
    None: a 1-D mesh over every rank on axis ``"data"``; a single axis
    scales up to absorb every rank. Explicit multi-axis grants are kept as
    given: a product smaller than (but dividing) the rank count takes a
    prefix of the ranks, one that does not divide fails (JAX's rules)."""
    device_type = device_type or default_device_type()
    ranks = list(ranks) if ranks is not None else world_ranks(device_type)
    n = len(ranks)
    if not axes:
        return _mesh(device_type, ranks, [n], ["data"])
    names, sizes = _resolve_axes(axes, n)
    return _mesh(device_type, ranks[:math.prod(sizes)], sizes, names)


def build_two_level_mesh(replicas: int, ici_axes: Optional[dict[str, int]] = None,
                         ranks: Optional[Sequence[int]] = None,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """Two-level ``dcn`` x inner mesh for a spanning gang: ``replicas``
    is the DCN axis size (one per member grant), ``ici_axes`` the inner
    axes of each replica (None: one ``"data"`` axis over each replica's
    ranks). Ranks are replica-major, so each ``dcn`` row is one replica's;
    a grant smaller than a replica's share takes a prefix of each."""
    replicas = int(replicas)
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    device_type = device_type or default_device_type()
    ranks = list(ranks) if ranks is not None else world_ranks(device_type)
    n = len(ranks)
    if n % replicas != 0:
        raise ValueError(
            f"{n} devices do not divide over {replicas} DCN replicas"
        )
    per = n // replicas
    if not ici_axes:
        names, sizes = ["data"], [per]
    else:
        names, sizes = _resolve_axes(ici_axes, per)
        if DCN_AXIS in names:
            raise ValueError(
                f"ici_axes must not contain the reserved {DCN_AXIS!r} axis"
            )
    prod = math.prod(sizes)
    ranks = [r for i in range(replicas) for r in ranks[i * per: i * per + prod]]
    return _mesh(device_type, ranks, [replicas, *sizes], [DCN_AXIS, *names])


def mesh_axes(mesh: Any) -> dict[str, int]:
    """A mesh's axis names and sizes, in its order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def span_facts(environ: Optional[Mapping[str, str]] = None) -> dict[str, Any]:
    """Decode the multi-grant half of the env contract (one shape for
    every consumer: the SDK context, :func:`build_mesh_from_env`, tests)."""
    env = os.environ if environ is None else environ
    raw_axes = env.get(contract.ENV_MESH_AXES)
    axes = None
    if raw_axes:
        try:
            parsed = json.loads(raw_axes)
            if isinstance(parsed, dict):
                axes = {str(k): int(v) for k, v in parsed.items()}
        except (ValueError, TypeError):
            axes = None

    def _int(key: str, default: int) -> int:
        try:
            return int(env.get(key, "") or default)
        except ValueError:
            return default

    return {
        "replicas": max(1, _int(contract.ENV_DCN_REPLICAS, 1)),
        "replica": _int(contract.ENV_DCN_REPLICA_INDEX, 0),
        "span_id": env.get(contract.ENV_SPAN_ID) or None,
        "processes": _int(contract.ENV_SPAN_PROCESSES, 0),
        "process_base": _int(contract.ENV_SPAN_PROCESS_BASE, 0),
        "coordinator": env.get(contract.ENV_COORDINATOR_ADDRESS) or None,
        "mesh_axes": axes,
    }


def build_mesh_from_env(environ: Optional[Mapping[str, str]] = None,
                        device_type: Optional[str] = None) -> DeviceMesh:
    """The mesh from the env contract alone: a spanning gang
    (``BOBRA_DCN_REPLICAS`` > 1) gets the two-level ``dcn`` x inner mesh, a
    classic grant the flat mesh of ``BOBRA_MESH_AXES``."""
    facts = span_facts(environ)
    if facts["replicas"] > 1:
        return build_two_level_mesh(facts["replicas"], facts["mesh_axes"],
                                    device_type=device_type)
    return build_mesh(facts["mesh_axes"], device_type=device_type)


def distributed_init_args(environ: Optional[Mapping[str, str]] = None,
                          host_id: Optional[int] = None) -> Optional[dict[str, Any]]:
    """The process group of one span member host, from the multi-grant
    env contract, under JAX's keys: ``coordinator_address``,
    ``num_processes`` and ``process_id`` (the member's process base plus
    the local host id); None when the step is not a multi-process gang."""
    env = os.environ if environ is None else environ
    facts = span_facts(environ)
    if host_id is None:
        try:
            host_id = int(env.get(contract.ENV_TPU_HOST_ID, "0") or 0)
        except ValueError:
            host_id = 0
    try:
        hosts = int(env.get(contract.ENV_TPU_HOSTS, "1") or 1)
    except ValueError:
        hosts = 1
    processes = facts["processes"] or hosts
    if processes <= 1 or not facts["coordinator"]:
        return None
    return {
        "coordinator_address": facts["coordinator"],
        "num_processes": processes,
        "process_id": facts["process_base"] + host_id,
    }
