"""Speculative decoding inside the paged serving engine.

Counterpart of ``bobrapet_tpu/serving/spec_decode.py``: the
continuous-batching version of speculative decoding, per-slot draft and
verify over the paged KV cache. For every greedy slot with block coverage:

1. **draft**: a second model proposes ``k`` tokens, ``k + 1`` chained
   single-token steps over its own pools (the same block geometry and block
   tables as the target: one allocator, two pool sets); the last step only
   writes ``p_k``'s K/V, so that after a full accept the next round's draft
   does not attend a hole;
2. **verify**: one target step of ``k + 1`` tokens a slot (``[last, p_1 ..
   p_k]``) through the paged cache, so one read of the target's weights
   serves every accepted token;
3. **accept**: the longest prefix of proposals equal to the target's own
   argmax is committed, plus the target's correction (or bonus) token: the
   output is token for token the target's greedy decode.

The port runs every piece over the pools in place (it has no
``gather_views`` / ``scatter_window``): a write that is masked off lands in
``SCRATCH_BLOCK`` at offset 0, where the JAX package's views have a scratch
column, and a row whose position lies past the slot's covered pages reads
the scratch block there too. Neither can reach a committed token: rows past
a slot's coverage belong to lanes that do not speculate or to tokens past
the budget, and their outputs are dropped. The JAX horizon's round
functions, which run over gathered views, are :func:`_spec_draft` and
:func:`_spec_verify` here, over the pools and the engine's device lane
state.

A lane with ``temperature > 0`` never speculates: it commits one token a
round, drawn from the verify's position-0 logits (the plain step's) with
the same (rid, token index) key as the plain step, so a sampled stream is
the same with speculation on or off. Every pick (the draft's proposals,
the verify's choices and draws) is :func:`~bobrapet_tpu_torch.ops.pick_tokens`.

On a card a T = 1 step's attention is the paged kernel and a T > 1 step's
(a verify, a draft catch-up) the T-query entry of the same source
(:func:`~bobrapet_tpu_torch.ops.paged_attention_multi`); an int8 draft's
products are the int8 kernel; every pick is the pick kernel.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..models.llama import LlamaConfig, _freqs_table, _logits, _lora_mm, _mlp_block, _qkv
from ..ops.paged_attention import paged_attention, paged_attention_multi
from ..ops.pick_tokens import pick_tokens
from .paged_cache import SCRATCH_BLOCK, PagedConfig


@torch.no_grad()
def _model_append(params: dict[str, Any], pools: dict[str, torch.Tensor], tokens: torch.Tensor,
                  pos0: torch.Tensor, write_ok: torch.Tensor, block_tables: torch.Tensor,
                  loras: Optional[Any] = None, adapter_idx: Optional[torch.Tensor] = None, *,
                  cfg: LlamaConfig, pcfg: PagedConfig, T: int, lora_scale: float = 1.0
                  ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Append T tokens per slot: ``tokens`` [S, T] at positions
    ``pos0 + t``. Each token's K/V is written into the pools through the
    block table (to ``SCRATCH_BLOCK`` offset 0 where ``write_ok`` [S, T] is
    False or the position lies past the table) before the layer's attention, which reads the pools in place:
    query t of slot s sees the positions up to ``pos0[s] + t``. With a
    stacked ``loras`` tree each slot adds its own adapter's deltas
    (``adapter_idx`` [S]). Returns ``(pools, logits [S, T, V] fp32)``; the
    pools are written in place. T = 1 is the classic decode step without
    its argmax."""
    S = tokens.shape[0]
    dev = tokens.device
    freqs = _freqs_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, cfg.rope_scaling, dev)
    positions = pos0.long()[:, None] + torch.arange(T, device=dev)[None, :]       # [S, T]
    x = params["embed"]["weight"][tokens.long()].to(cfg.dtype)                      # [S, T, D]

    block_idx = (positions // pcfg.block_size).clamp(0, block_tables.shape[1] - 1)
    row = block_tables.long().gather(1, block_idx)
    # a row past the table (a verify or draft step running past the slot's
    # capacity) writes the scratch block: the clamped index would otherwise
    # land it on the lane's own committed positions
    write_ok = write_ok & (positions < block_tables.shape[1] * pcfg.block_size)
    write_block = torch.where(write_ok, row, SCRATCH_BLOCK)
    write_off = torch.where(write_ok, positions % pcfg.block_size, 0)
    # query t at lens - T + t: the paged kernels' rule
    lens = (pos0 + T).to(torch.int32)
    # positions past the RoPE table (rows that are dropped) take its last
    # entry, as JAX's gather clamps
    rope_pos = positions.clamp(max=cfg.max_seq_len - 1)

    delta = None  # the pending residual delta, added by the next norm
    for layer_i, layer in enumerate(params["layers"]):
        lora_layer = loras["layers"][layer_i] if loras is not None else None
        lora = (lora_layer, lora_scale, adapter_idx)
        x, q, k, v = _qkv(layer, x, delta, freqs, cfg, rope_pos, *lora)
        pools["k"][layer_i, write_block, write_off] = k.to(pools["k"].dtype)
        pools["v"][layer_i, write_block, write_off] = v.to(pools["v"].dtype)
        if T == 1:
            out = paged_attention(q[:, 0], pools["k"][layer_i], pools["v"][layer_i],
                                  block_tables, lens)[:, None]
        else:
            out = paged_attention_multi(q, pools["k"][layer_i], pools["v"][layer_i],
                                        block_tables, lens)
        delta = _lora_mm(out.reshape(S, T, cfg.dim), layer["attn"]["wo"], lora_layer, "wo",
                         lora_scale, adapter_idx)
        x, delta = _mlp_block(layer, x, delta, cfg, *lora)
    return pools, _logits(params, x, delta, cfg)


@torch.no_grad()
def _spec_step(params: dict[str, Any], draft_params: dict[str, Any],
               pools: dict[str, torch.Tensor], dpools: dict[str, torch.Tensor],
               last_tokens: torch.Tensor, seq_lens: torch.Tensor, active: torch.Tensor,
               spec_ok: torch.Tensor, block_tables: torch.Tensor, loras: Optional[Any] = None,
               adapter_idx: Optional[torch.Tensor] = None, *, cfg: LlamaConfig,
               dcfg: LlamaConfig, pcfg: PagedConfig, k: int, lora_scale: float = 1.0,
               temps: Optional[torch.Tensor] = None, rids: Optional[torch.Tensor] = None,
               emitted: Optional[torch.Tensor] = None):
    """One fused speculative tick (see the module docstring): the draft's
    :func:`_spec_draft`, then one ``k + 1``-token verify. Returns ``(pools,
    dpools, proposals [S, k], choice [S, k + 1])``: ``choice[:, t]`` is the
    target's argmax after token t of ``[last, p_1 .. p_k]``, so ``choice[:,
    0]`` is the plain decode step's token (a draw at ``temps > 0``, keyed by
    ``rids`` and the token indices ``emitted``)."""
    dpools, proposals = _spec_draft(draft_params, dpools, last_tokens, seq_lens, active,
                                    spec_ok, block_tables, dcfg=dcfg, pcfg=pcfg, k=k)
    pools, choice = _verify_choice(params, pools, proposals, spec_ok, last_tokens, seq_lens,
                                   active, adapter_idx, block_tables, loras, cfg=cfg, pcfg=pcfg,
                                   k=k, lora_scale=lora_scale, temps=temps, rids=rids,
                                   emitted=emitted)
    return pools, dpools, proposals, choice


@torch.no_grad()
def _draft_append(draft_params: dict[str, Any], dpools: dict[str, torch.Tensor],
                  last_tokens: torch.Tensor, seq_lens: torch.Tensor, active: torch.Tensor,
                  block_tables: torch.Tensor, *, dcfg: LlamaConfig,
                  pcfg: PagedConfig) -> dict[str, torch.Tensor]:
    """The draft's T = 1 append of the tick's input token, without
    proposing: a plain tick on a draft-capable engine keeps the draft cache
    lag-one current, so a slot that speculates later attends no hole."""
    dpools, _ = _model_append(draft_params, dpools, last_tokens[:, None], seq_lens - 1,
                              active[:, None], block_tables, cfg=dcfg, pcfg=pcfg, T=1)
    return dpools


@torch.no_grad()
def _draft_sync_block(draft_params: dict[str, Any], dpools: dict[str, torch.Tensor],
                      toks: torch.Tensor, last0: torch.Tensor, seq0: torch.Tensor,
                      em0: torch.Tensor, em1: torch.Tensor, block_tables: torch.Tensor, *,
                      dcfg: LlamaConfig, pcfg: PagedConfig, H: int) -> dict[str, torch.Tensor]:
    """Catch the draft pools up on one plain horizon's commits in a single
    T = H pass: step t's input token (``last0`` at t = 0, the step t - 1
    token ``toks [H, S]`` after) is appended at position ``seq0 - 1 + t``
    for every lane that took step t (``t < em1 - em0``)."""
    toks_t = toks.T                                                     # [S, H]
    ins = torch.cat([last0[:, None], toks_t[:, :H - 1]], dim=1)
    taken = em1 - em0
    wok = torch.arange(H, device=toks.device)[None, :] < taken[:, None]
    dpools, _ = _model_append(draft_params, dpools, ins, seq0 - 1, wok, block_tables, cfg=dcfg,
                              pcfg=pcfg, T=H)
    return dpools


@torch.no_grad()
def _spec_draft(draft_params: dict[str, Any], dpools: dict[str, torch.Tensor],
                last: torch.Tensor, seq: torch.Tensor, act: torch.Tensor, spec_ok: torch.Tensor,
                tables: torch.Tensor, *, dcfg: LlamaConfig, pcfg: PagedConfig, k: int):
    """The draft half of a speculative tick or round (JAX's
    ``make_spec_horizon_fns`` ``_draft``): ``k + 1`` chained single-token
    draft steps from ``last`` at ``seq - 1``; step 0 writes for every live
    lane, later steps only where the lane speculates. Returns ``(dpools,
    proposals [S, k])``. The last step only writes ``p_k``'s K/V: its
    token is not picked."""
    tok, pos, props = last, seq - 1, []
    for i in range(k + 1):
        wok = (act & (spec_ok | (i == 0)))[:, None]
        dpools, lg = _model_append(draft_params, dpools, tok[:, None], pos, wok, tables,
                                   cfg=dcfg, pcfg=pcfg, T=1)
        if i < k:
            tok = pick_tokens(lg[:, 0])
            props.append(tok)
        pos = pos + 1
    return dpools, torch.stack(props, dim=1)


def _verify_choice(params: dict[str, Any], pools: dict[str, torch.Tensor], props: torch.Tensor,
                   spec_ok: torch.Tensor, last: torch.Tensor, seq: torch.Tensor,
                   act: torch.Tensor, adapters: Optional[torch.Tensor], tables: torch.Tensor,
                   loras: Optional[Any] = None, *, cfg: LlamaConfig, pcfg: PagedConfig, k: int,
                   lora_scale: float = 1.0, temps: Optional[torch.Tensor] = None,
                   rids: Optional[torch.Tensor] = None, emitted: Optional[torch.Tensor] = None
                   ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """The target's ``k + 1``-token step of ``[last, p_1 .. p_k]`` (row 0
    writes for every live lane, later rows only where it speculates), and
    one pick over its ``S x (k + 1)`` rows: the argmax, but at position 0 of
    a lane with ``temps > 0`` a draw keyed by its rid and token index
    ``emitted``. Returns ``(pools, choice [S, k + 1])``."""
    S = last.shape[0]
    ar = torch.arange(k + 1, device=last.device)[None, :]
    verify_tokens = torch.cat([last[:, None], props], dim=1)
    wok = act[:, None] & (spec_ok[:, None] | (ar == 0))
    pools, logits = _model_append(params, pools, verify_tokens, seq - 1, wok, tables, loras,
                                  adapters, cfg=cfg, pcfg=pcfg, T=k + 1, lora_scale=lora_scale)
    rows = logits.reshape(S * (k + 1), -1)
    if temps is None:
        return pools, pick_tokens(rows).reshape(S, k + 1)
    per_row = (torch.where(ar == 0, temps[:, None], 0.0).reshape(-1),
               rids[:, None].expand(S, k + 1).reshape(-1),
               emitted[:, None].expand(S, k + 1).reshape(-1))
    return pools, pick_tokens(rows, *per_row).reshape(S, k + 1)


def _spec_accept(props: torch.Tensor, choice: torch.Tensor, spec_ok: torch.Tensor,
                 act: torch.Tensor, emitted: torch.Tensor, budget: torch.Tensor,
                 eos: torch.Tensor, *, k: int):
    """The accept of a verify, on the device: the longest prefix of
    proposals equal to the target's argmax plus its correction (a lane that
    does not speculate takes ``choice[:, 0]``, the plain step's token or
    draw), cut
    by eos and the budget (token j is emitted when j < the raw commit count
    and no earlier token stopped the request; the stopping token is
    emitted). Returns ``(c_out [S, k + 1] (-1 past the commit count),
    ncommit [S], done [S], stats [2] = (drafted, accepted))``, accepted
    counted after the cut."""
    ar = torch.arange(k + 1, device=choice.device)[None, :]
    # m: the longest prefix of proposals equal to the target's argmax
    m = torch.cumprod((props == choice[:, :k]).to(torch.int32), dim=1).sum(dim=1,
                                                                         dtype=torch.int32)
    padded = torch.cat([props, torch.zeros_like(props[:, :1])], dim=1)
    correction = choice.gather(1, m.clamp(max=k).long()[:, None])
    cand_spec = torch.where(ar < m[:, None], padded, correction)
    cand = torch.where(spec_ok[:, None], cand_spec,
                       torch.where(ar == 0, choice[:, :1], torch.zeros_like(choice)))
    n_raw = torch.where(spec_ok, m + 1, 1) * act.to(torch.int32)
    valid = ar < n_raw[:, None]
    stop = valid & (((eos[:, None] >= 0) & (cand == eos[:, None]))
                    | (emitted[:, None] + ar + 1 >= budget[:, None]))
    stop_i = stop.to(torch.int32)
    emit = valid & (torch.cumsum(stop_i, dim=1) - stop_i == 0)
    ncommit = emit.sum(dim=1, dtype=torch.int32)
    drafted = torch.where(spec_ok, k, 0).sum(dtype=torch.int32)
    accepted = torch.where(spec_ok, torch.minimum(m, ncommit), 0).sum(dtype=torch.int32)
    return (torch.where(emit, cand, -1), ncommit, (stop & emit).any(dim=1),
            torch.stack([drafted, accepted]))


@torch.no_grad()
def _spec_verify(params: dict[str, Any], pools: dict[str, torch.Tensor], props: torch.Tensor,
                 spec_ok: torch.Tensor, last: torch.Tensor, seq: torch.Tensor, act: torch.Tensor,
                 emitted: torch.Tensor, budget: torch.Tensor, eos: torch.Tensor,
                 adapters: Optional[torch.Tensor], tables: torch.Tensor,
                 loras: Optional[Any] = None, *, cfg: LlamaConfig, pcfg: PagedConfig, k: int,
                 lora_scale: float = 1.0, temps: Optional[torch.Tensor] = None,
                 rids: Optional[torch.Tensor] = None):
    """The verify half of one round (JAX's ``_verify``): one ``k + 1``-token
    target step (a lane at ``temps > 0`` drawing its one token), then on the
    device :func:`_spec_accept` and the lane advance. Returns ``(pools,
    last, seq, act, emitted, c_out [S, k + 1], ncommit [S], stats [2])``."""
    pools, choice = _verify_choice(params, pools, props, spec_ok, last, seq, act, adapters,
                                   tables, loras, cfg=cfg, pcfg=pcfg, k=k,
                                   lora_scale=lora_scale, temps=temps, rids=rids,
                                   emitted=emitted if temps is not None else None)
    c_out, ncommit, done, stats = _spec_accept(props, choice, spec_ok, act, emitted, budget,
                                               eos, k=k)
    last_tok = c_out.gather(1, (ncommit - 1).clamp(min=0).long()[:, None])[:, 0]
    new_last = torch.where(act & (ncommit > 0), last_tok, last)
    return (pools, new_last, seq + ncommit, act & ~done, emitted + ncommit, c_out, ncommit,
            stats)
