"""The train step: loss, gradients and an AdamW update, data-parallel over
a mesh's ``dcn`` and ``data`` axes.

Counterpart of ``bobrapet_tpu/parallel/train.py``. The forward is
:func:`models.llama.forward`; on a card its attention and every norm run
the port's kernels forward and backward (``ops.attention``,
``ops.rmsnorm``, ``ops.add_rmsnorm`` through their ``autograd.Function``s).
Where JAX's ``jit`` places a gradient ``psum`` over the batch axes, each
rank here takes its rows of the batch and the gradients are averaged with
``all_reduce`` over the ``dcn`` and ``data`` groups before the update.

The sharded half (FSDP and TP through DTensor, ring and Ulysses sequence
parallelism) is not ported yet: a mesh with another axis above 1, ring
attention or a ``seq_parallel`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..models.llama import LlamaConfig, forward, init_params
from .mesh import build_two_level_mesh, mesh_axes
from .optim import AdamW, adamw, tree_leaves, tree_map

#: the axes the batch is split over, in mesh-major order (JAX's BATCH_AXES
#: but ``fsdp``, which waits for the sharded slice)
BATCH_AXES = ("dcn", "data")
SEQ_AXIS = "seq"
NOT_PORTED = ("the sharded train step (FSDP, TP, ring and Ulysses attention) is not "
              "ported yet: ROADMAP Queue 1 item 8")


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return -ll.mean()


def mesh_device(mesh: Any) -> torch.device:
    """This rank's device of the mesh: the current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_train_step(
    cfg: LlamaConfig,
    mesh: Any,
    optimizer: Optional[AdamW] = None,
    use_ring_attention: Optional[bool] = None,
    remat: bool = False,
    seq_parallel: Optional[str] = None,
) -> Callable:
    """A train step ``(params, opt_state, tokens) -> (params, opt_state,
    loss)``, with JAX's arguments and ``ValueError``s.

    tokens: the global batch [B, S+1]; the loss predicts tokens[:, 1:] from
    tokens[:, :-1]. Each rank takes its B / n rows, n the product of the
    mesh's ``dcn`` and ``data`` sizes, in mesh-major order, and the
    gradients and the loss are averaged over those ranks. ``remat`` wraps
    the whole forward in ``torch.utils.checkpoint`` (JAX wraps its
    ``model_fwd`` whole). The inputs are not written; new trees come back.

    The step's ``phase_hook``, when set, is called with ``"forward"``,
    ``"backward"`` (gradients averaged) and ``"update"`` as each part ends
    (a caller times the parts with it)."""
    if seq_parallel not in (None, "ring", "ulysses"):
        raise ValueError(f"seq_parallel must be ring|ulysses, got {seq_parallel!r}")
    if use_ring_attention is False and seq_parallel is not None:
        raise ValueError(
            "use_ring_attention=False disables sequence parallelism — it "
            f"contradicts the explicit seq_parallel={seq_parallel!r}"
        )
    optimizer = optimizer or adamw(3e-4, weight_decay=0.1)
    axes = mesh_axes(mesh)
    ring = (use_ring_attention if use_ring_attention is not None
            else axes.get(SEQ_AXIS, 1) > 1)
    if ring and seq_parallel == "ulysses":
        seq_size = axes.get(SEQ_AXIS, 1)
        if cfg.n_heads % seq_size != 0:
            raise ValueError(
                f"ulysses needs n_heads ({cfg.n_heads}) divisible by the "
                f"seq axis size ({seq_size}); use seq_parallel='ring'"
            )
    sharded = {a: n for a, n in axes.items() if a not in BATCH_AXES and n > 1}
    if sharded or ring or seq_parallel is not None:
        raise NotImplementedError(
            f"{NOT_PORTED} (mesh {axes}, ring {ring}, seq_parallel {seq_parallel!r})")

    batch_axes = [a for a in BATCH_AXES if axes.get(a, 1) > 1]
    shards = math.prod(axes[a] for a in batch_axes)
    shard = 0
    if shards > 1:
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        for a in batch_axes:
            shard = shard * axes[a] + coord[a]
    groups = [mesh.get_group(a) for a in batch_axes]

    def model_fwd(params: Any, tokens_in: torch.Tensor) -> torch.Tensor:
        logits, _ = forward(params, tokens_in, cfg)
        return logits

    def loss_fn(params: Any, tokens: torch.Tensor) -> torch.Tensor:
        if remat:
            logits = checkpoint(model_fwd, params, tokens[:, :-1], use_reentrant=False)
        else:
            logits = model_fwd(params, tokens[:, :-1])
        return cross_entropy_loss(logits, tokens[:, 1:])

    def average(t: torch.Tensor) -> torch.Tensor:
        for group in groups:
            dist.all_reduce(t, group=group)
        return t.div_(shards)

    def mark(name: str) -> None:
        if train_step.phase_hook is not None:
            train_step.phase_hook(name)

    def train_step(params: Any, opt_state: Any, tokens: torch.Tensor):
        if tokens.shape[0] % shards:
            raise ValueError(f"a batch of {tokens.shape[0]} rows does not split over "
                             f"{shards} data-parallel ranks")
        rows = tokens.shape[0] // shards
        local = tokens[shard * rows:(shard + 1) * rows]
        live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        it = iter(live)
        loss = loss_fn(tree_map(lambda _: next(it), params), local)
        mark("forward")
        grads = list(torch.autograd.grad(loss, live))
        del live
        loss = loss.detach()
        if shards > 1:
            grads = [average(g) for g in grads]
            loss = average(loss.clone())
        mark("backward")
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        del it
        with torch.no_grad():
            params, opt_state = optimizer.step(grads, opt_state, params)
        mark("update")
        return params, opt_state, loss

    train_step.phase_hook = None
    # the sequence-parallel decision, as JAX's step exposes it (never on here)
    train_step.ring_active = ring
    return train_step


def make_multislice_train_step(
    cfg: LlamaConfig,
    replicas: int,
    ici_axes: Optional[dict[str, int]] = None,
    ranks=None,
    device_type: Optional[str] = None,
    **kwargs: Any,
) -> tuple[Any, Callable]:
    """The multi-slice training config: the batch data-parallel over the
    ``dcn`` outer axis, the inner axes per replica. Builds the two-level
    mesh (one ``dcn`` row per span replica) and the train step over it."""
    mesh = build_two_level_mesh(replicas, ici_axes, ranks=ranks, device_type=device_type)
    return mesh, make_train_step(cfg, mesh, **kwargs)


def init_train_state(cfg: LlamaConfig, mesh: Any, generator: torch.Generator,
                     optimizer: Optional[AdamW] = None) -> tuple[Any, Any, AdamW]:
    """``(params, opt_state, optimizer)``: weights from ``generator`` (on
    the mesh's device: ``init_params``), the optimizer's zero state. The
    JAX package's ``init_sharded_train_state``; weights differ from JAX's
    (another generator), so parity runs through :mod:`models.bridge`."""
    optimizer = optimizer or adamw(3e-4, weight_decay=0.1)
    params = init_params(cfg, generator, device=mesh_device(mesh))
    return params, optimizer.init(params), optimizer


def make_token_batch(generator: torch.Generator, cfg: LlamaConfig, batch: int, seq_len: int,
                     mesh: Any, sequence_sharded: bool = False) -> torch.Tensor:
    """The global batch [batch, seq_len + 1] of token ids from ``generator``
    (on the mesh's device), the same on every rank that seeds it alike;
    each rank's train step takes its own rows."""
    if sequence_sharded:
        raise NotImplementedError(NOT_PORTED)
    return torch.randint(0, cfg.vocab_size, (batch, seq_len + 1), generator=generator,
                         device=mesh_device(mesh))
