"""Speculative decoding, standalone: draft-model proposals, target verify.

Counterpart of ``bobrapet_tpu/models/speculative.py``. Greedy decode reads
every target weight per token; a small draft model proposes ``k`` tokens a
round and the target verifies all of them in one forward of ``k + 1``
tokens, so the accepted proposals share one read of the target's weights.
A proposal is accepted only when it equals the target's own argmax, and the
first mismatch is replaced by the target's choice: the output is token for
token the target's greedy decode (the tests hold it to
:func:`~.llama.greedy_generate`).

Single sequence (batch 1), over the port's contiguous caches with a device
cursor each (:func:`~.llama.device_cursor`): a round sets both cursors to
the committed context (the rewind: the rows past it are stale and masked
by the cursor's length), runs ``k + 1`` draft steps (the last only writes
the last proposal's K/V, so a full accept leaves no hole) and one verify of
``[last, p_1 .. p_k]``; the host then reads the round's proposals and the
target's argmax once (one copy) and commits. The JAX package runs the
rounds in a ``lax.while_loop`` on the device; here the loop is on the host,
one read a round. On a card the draft step and the verify are each one
CUDA graph, replayed every round, and the verify's
attention over the cache is the cached entry at ``k + 1`` queries.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..graphs import GraphedStep
from .llama import LlamaConfig, device_cursor, forward, init_cache


class SpecResult(NamedTuple):
    tokens: torch.Tensor     # [max_new_tokens] int32 committed tokens
    rounds: int              # verify rounds executed
    drafted: int             # proposals made
    accepted: int            # proposals accepted


@torch.no_grad()
def speculative_generate(
    target_params: dict[str, Any],
    draft_params: dict[str, Any],
    prompt: torch.Tensor,  # [1, P]
    cfg: LlamaConfig,
    draft_cfg: LlamaConfig,
    max_new_tokens: int = 32,
    k: int = 4,
    cache_capacity: int | None = None,
) -> SpecResult:
    """Greedy speculative decode of ``prompt`` (see the module docstring).
    Tokens stay on the prompt's device; ``rounds``, ``drafted`` and
    ``accepted`` count as the JAX package does (``accepted`` is cut at the
    budget)."""
    b, prompt_len = prompt.shape
    if b != 1:
        raise ValueError("speculative_generate is single-sequence (batch 1)")
    # never past the RoPE table (the JAX package's rule)
    cap = cache_capacity or min(min(cfg.max_seq_len, draft_cfg.max_seq_len),
                                prompt_len + max_new_tokens + k + 1)
    if prompt_len + max_new_tokens + k + 1 > cap:
        raise ValueError(
            f"prompt({prompt_len}) + new({max_new_tokens}) + k+1({k + 1}) "
            f"exceeds capacity {cap} (bounded by max_seq_len)")
    dev = prompt.device

    # -- prefill both models; commit the target's first token
    positions = torch.arange(prompt_len, device=dev)[None, :]
    t_cache = init_cache(cfg, 1, cap, device=dev)
    t_logits, _ = forward(target_params, prompt, cfg, cache=t_cache, positions=positions)
    first = t_logits[0, -1].argmax()
    d_cache = init_cache(draft_cfg, 1, cap, device=dev)
    forward(draft_params, prompt, draft_cfg, cache=d_cache, positions=positions)
    if max_new_tokens == 0:
        return SpecResult(torch.zeros((0,), dtype=torch.int32, device=dev), 0, 0, 0)
    t_cursor, d_cursor = device_cursor(t_cache), device_cursor(d_cache)

    # the round's static tensors: the draft's next input and its position,
    # the proposals and the target's argmax of the round (read together)
    dtok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    dpos = torch.zeros((1, 1), dtype=torch.long, device=dev)
    vtok = torch.zeros((1, k + 1), dtype=torch.int32, device=dev)
    vpos = torch.zeros((1, k + 1), dtype=torch.long, device=dev)
    found = torch.zeros((2 * k + 1,), dtype=torch.int32, device=dev)  # proposals, then argmax

    def draft_step(tok: torch.Tensor, pos: torch.Tensor) -> None:
        logits, _ = forward(draft_params, tok, draft_cfg, cache=d_cache, positions=pos)
        tok.copy_(logits[:, -1:].argmax(dim=-1))
        pos.add_(1)

    def verify_step(tok: torch.Tensor, pos: torch.Tensor, found: torch.Tensor) -> None:
        logits, _ = forward(target_params, tok, cfg, cache=t_cache, positions=pos)
        found[k:] = logits[0].argmax(dim=-1)

    drafts = GraphedStep(draft_step, dtok, dpos)
    verify = GraphedStep(verify_step, vtok, vpos, found)
    ar = torch.arange(k + 1, device=dev)[None, :]

    host = [int(first)] + [0] * (max_new_tokens - 1)
    n_out, n_ctx = 1, prompt_len
    rounds = drafted = accepted = 0
    while n_out < max_new_tokens:
        # rewind both caches to the committed context; `last` is not in
        # either cache yet (the lag-one invariant)
        d_cursor.fill_(n_ctx)
        t_cursor.fill_(n_ctx)
        dtok.fill_(host[n_out - 1])
        dpos.fill_(n_ctx)
        for i in range(k):
            drafts()
            found[i] = dtok[0, 0]
        drafts()  # ingests p_k: a full accept leaves no hole behind it
        vtok[0, 0] = host[n_out - 1]
        vtok[0, 1:] = found[:k]
        vpos.copy_(ar + n_ctx)
        verify()
        got = found.tolist()
        proposals, target_next = got[:k], got[k:]
        m = 0
        while m < k and proposals[m] == target_next[m]:
            m += 1
        commit = min(m + 1, max_new_tokens - n_out)
        round_tokens = proposals[:m] + [target_next[m]]
        host[n_out:n_out + commit] = round_tokens[:commit]
        accepted += min(m, max_new_tokens - n_out)
        n_out += commit
        n_ctx += commit
        rounds += 1
        drafted += k
    return SpecResult(torch.tensor(host, dtype=torch.int32, device=dev), rounds, drafted,
                      accepted)
