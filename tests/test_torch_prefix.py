"""The port's prefix caching and chunked prefill against the JAX package, on
the CPU.

Inputs come from numpy seeds and JAX's weights are carried over with the
bridge. Held here:

- ``chain_hashes``: the same bytes as JAX's (blake2b), for every block
  size, salt and length tried;
- ``PrefixCache`` under random ``alloc`` / ``free`` / ``register`` /
  ``match_prefix`` / ``reserve`` sequences (hypothesis): the same return
  values, blocks, refcounts, free list, hash maps and hit/miss tokens as
  JAX's after every operation, refusals included;
- ``init_cache_seed`` bit-identical; ``BlockAllocator.reserve`` as JAX's;
- ``_prefill_bucket`` (the prefix-seeded prefill) at fp32: logits within
  2e-3 of JAX's, the written K/V within 2e-3 (the fp32 model tolerance of
  test_torch_llama.py; a K/V row is a matmul whose sum order differs
  between XLA and torch, so it is not held bit for bit) and every pool row
  outside the target blocks untouched;
- ``_chunk_size`` and ``_whole_block_bucket`` equal to JAX's;
- whole engines in lockstep with JAX's at H = 1, 2 and 8
  (``dispatch_depth=1``) on the scenarios of tests/test_serving.py's
  TestPrefixCaching, TestChunkedPrefill, TestLongContextServing and the
  long-shared-prefix regression, and on a preemption whose recompute
  matches its whole tail (the ``sp == 1`` admission, no prefill at all):
  the same slots, ingest positions, blocks, free list, prefix-cache state
  and outputs after every step (see tests/torch_lockstep.py).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.serving import PagedConfig as JPagedConfig
from bobrapet_tpu.serving import engine as jengine
from bobrapet_tpu.serving import paged_cache as jpaged
from bobrapet_tpu.serving import prefix_cache as jprefix
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.serving import PagedConfig
from bobrapet_tpu_torch.serving import engine as tengine
from bobrapet_tpu_torch.serving import paged_cache as tpaged
from bobrapet_tpu_torch.serving import prefix_cache as tprefix
from tests.torch_lockstep import bridge, engines, prompt, run_lockstep


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jllama.llama_tiny()
    params_j = jllama.init_params(jax.random.PRNGKey(0), cfg_j)
    return {"cfg_j": cfg_j, "cfg_t": tllama.llama_tiny(), "params": (params_j, bridge(params_j))}


@pytest.fixture(autouse=True)
def _einsum_route(monkeypatch):
    # JAX's default paged route; the Pallas route would need a TPU anyway
    monkeypatch.delenv("BOBRA_PALLAS_PAGED", raising=False)


class TestChainHashes:
    @pytest.mark.parametrize("block_size", [1, 4, 8, 16])
    @pytest.mark.parametrize("salt", [0, 1, 7])
    def test_bytes_equal_jax(self, block_size, salt):
        rng = np.random.default_rng(block_size * 10 + salt)
        for n in (0, 1, block_size, block_size + 1, 3 * block_size, 3 * block_size + 1, 77):
            toks = rng.integers(0, 128_256, n).tolist()
            want = jprefix.chain_hashes(toks, block_size, salt)
            assert tprefix.chain_hashes(toks, block_size, salt) == want
            assert all(isinstance(h, bytes) and len(h) == 16 for h in want)
        assert tprefix.ROOT == jprefix.ROOT
        assert tprefix._chain_hash(b"x", [1, 2]) == jprefix._chain_hash(b"x", [1, 2])


def _cache_state(cache):
    return (dict(cache._by_hash), dict(cache._hash_of), dict(cache._refs),
            list(cache.allocator._free), cache.hit_tokens, cache.miss_tokens)


# one operation: (kind, a, b) with small ints that each kind reads its own way
_OPS = st.lists(st.tuples(st.sampled_from(["alloc", "free", "register", "match", "reserve",
                                          "stats", "probe"]),
                          st.integers(0, 40), st.integers(0, 3)), max_size=40)


class TestPrefixCache:
    @settings(max_examples=60, deadline=None, derandomize=True)
    @given(ops=_OPS)
    def test_random_sequences_leave_the_state_of_jax(self, ops):
        """Prompts drawn from a few shared stems, so matches, lazy
        invalidation and reserve-backs all happen; a block reserved from
        outside the cache makes a later match refuse it and invalidate."""
        block, n_blocks = 4, 12
        stems = [list(range(100 + 10 * i, 100 + 10 * i + 13)) for i in range(3)]

        def apply(cache, kind, a, b, claims):
            if kind == "alloc":
                got = cache.alloc(a % 5)
                if got:
                    claims.append(got)
                return got
            if kind == "reserve":
                got = cache.allocator.reserve(a % n_blocks)
                if got:
                    claims.append([a % n_blocks])
                return got
            if kind == "free":
                blocks = claims.pop(a % len(claims)) if claims else [1 + a % (n_blocks - 1)]
                try:
                    cache.free(blocks)
                except ValueError:  # a reserved block, or no claim at all
                    return "refused"
                return blocks
            toks = stems[b % 3][:1 + a % 13] + [a]
            if kind == "register":
                if claims:
                    cache.register(toks, claims[a % len(claims)], salt=b % 2)
                return None
            if kind == "match":
                blocks, n = cache.match_prefix(toks, salt=b % 2)
                if blocks:
                    claims.append(blocks)
                return blocks, n
            if kind == "stats":
                cache.record_stats(a, a % 7)
                return None
            return cache.longest_local_match(toks, salt=b % 2)

        caches = [jprefix.PrefixCache(jpaged.BlockAllocator(n_blocks), block),
                  tprefix.PrefixCache(tpaged.BlockAllocator(n_blocks), block)]
        claims: list[list] = [[], []]
        for kind, a, b in ops:
            got = [apply(c, kind, a, b, cl) for c, cl in zip(caches, claims)]
            assert got[1] == got[0], kind
            assert _cache_state(caches[1]) == _cache_state(caches[0]), kind

    def test_double_free_refused(self):
        cache = tprefix.PrefixCache(tpaged.BlockAllocator(8), 4)
        got = cache.alloc(2)
        cache.free(got)
        with pytest.raises(ValueError, match="no refcount"):
            cache.free(got[:1])

    def test_match_takes_a_freed_block_back_off_the_free_list(self):
        for mod, alloc in ((jprefix, jpaged.BlockAllocator), (tprefix, tpaged.BlockAllocator)):
            cache = mod.PrefixCache(alloc(8), 4)
            toks = list(range(9))
            blocks = cache.alloc(3)
            cache.register(toks, blocks)
            cache.free(blocks)
            assert cache.allocator.free_blocks == 7
            got, n = cache.match_prefix(toks)
            assert (got, n) == (blocks[:2], 8)
            assert cache.allocator.free_blocks == 5 and blocks[0] not in cache.allocator._free


class TestPagedCacheSeed:
    def test_reserve_matches_jax(self):
        a, b = jpaged.BlockAllocator(10), tpaged.BlockAllocator(10)
        for blk in (3, 3, 0, 9, 12, 5):
            assert a.reserve(blk) == b.reserve(blk)
            assert a._free == b._free
        assert a.alloc(4) == b.alloc(4)

    @pytest.mark.parametrize("prefix_len,table", [(0, [0]), (8, [4, 0]), (12, [5, 9, 3, 0]),
                                                  (32, [1, 2, 3, 4])])
    def test_init_cache_seed_is_bit_identical(self, prefix_len, table):
        rng = np.random.default_rng(prefix_len)
        pools = {n: rng.standard_normal((2, 12, 4, 2, 32), dtype=np.float32) for n in "kv"}
        t = np.asarray(table, np.int32)
        want = jpaged.init_cache_seed({n: jnp.asarray(a) for n, a in pools.items()},
                                      jnp.asarray(t), prefix_len, 16)
        got = tpaged.init_cache_seed({n: torch.from_numpy(a) for n, a in pools.items()},
                                     torch.from_numpy(t), prefix_len, 16)
        assert len(got) == len(want) == 2
        for gl, wl in zip(got, want):
            assert gl["cursor"] == int(wl["cursor"]) == prefix_len
            for n in "kv":
                assert gl[n].dtype == torch.float32
                np.testing.assert_array_equal(gl[n].numpy(), np.asarray(wl[n]))


class TestPrefillBucket:
    @pytest.mark.parametrize("prefix_blocks,prefix_bucket,bucket", [
        ([5], 1, 8), ([5, 9, 3], 4, 16), ([2, 7, 4, 6], 4, 32)])
    def test_matches_jax_and_writes_only_its_blocks(self, tiny, prefix_blocks, prefix_bucket,
                                                    bucket):
        params_j, params_t = tiny["params"]
        cfg_j, cfg_t = tiny["cfg_j"], tiny["cfg_t"]
        rng = np.random.default_rng(len(prefix_blocks) * 100 + bucket)
        L, N, B = 2, 24, 8
        pools = {n: rng.standard_normal((L, N, B, 2, 32), dtype=np.float32) for n in "kv"}
        table = np.asarray(prefix_blocks + [0] * (prefix_bucket - len(prefix_blocks)), np.int32)
        prefix_len = len(prefix_blocks) * B
        suffix = np.asarray([11 + i for i in range(bucket // B)], np.int32)
        toks = rng.integers(0, cfg_j.vocab_size, (1, bucket)).astype(np.int32)
        kw = dict(max_slots=2, block_size=B, num_blocks=N, max_blocks_per_seq=8)
        jpools, jlogits = jengine._prefill_bucket(
            params_j, {n: jnp.asarray(a) for n, a in pools.items()}, jnp.asarray(toks),
            jnp.asarray(table), jnp.asarray(prefix_len, jnp.int32), jnp.asarray(suffix), None,
            cfg=cfg_j, pcfg=JPagedConfig(**kw), bucket=bucket)
        tpools = {n: torch.from_numpy(a.copy()) for n, a in pools.items()}
        tpools, tlogits = tengine._prefill_bucket(
            params_t, tpools, torch.from_numpy(toks).long(), torch.from_numpy(table).long(),
            prefix_len, torch.from_numpy(suffix).long(), cfg=cfg_t, pcfg=PagedConfig(**kw),
            bucket=bucket)
        assert tlogits.shape == (1, bucket, cfg_t.vocab_size)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=2e-3, rtol=0)
        others = np.setdiff1d(np.arange(N), suffix)
        for n in "kv":
            got, want = tpools[n].numpy(), np.asarray(jpools[n])
            np.testing.assert_allclose(got[:, suffix], want[:, suffix], atol=2e-3, rtol=0)
            assert not np.array_equal(got[:, suffix], pools[n][:, suffix])
            np.testing.assert_array_equal(got[:, others], pools[n][:, others])
            np.testing.assert_array_equal(want[:, others], pools[n][:, others])


class TestSizes:
    @pytest.mark.parametrize("block_size", [1, 4, 8, 16, 32])
    def test_chunk_size_and_whole_block_bucket_equal_jax(self, block_size):
        for chunk in (None, 1, 7, 8, 16, 33, 64, 100, 128, 500):
            pc = types.SimpleNamespace(pcfg=dataclasses.replace(
                PagedConfig(), block_size=block_size, prefill_chunk=chunk))
            assert tengine.ServingEngine._chunk_size(pc) == \
                jengine.ServingEngine._chunk_size(pc)
        pc = types.SimpleNamespace(pcfg=PagedConfig(block_size=block_size))
        for sp in range(1, 300, 7):
            for room in range(block_size, 700, 9 * block_size):
                assert tengine.ServingEngine._whole_block_bucket(pc, sp, room) == \
                    jengine.ServingEngine._whole_block_bucket(pc, sp, room)


def _waves_prefix_reused(vocab):
    rng = np.random.default_rng(10)
    system = prompt(rng, 16, vocab)
    a, b = system + prompt(rng, 5, vocab), system + prompt(rng, 9, vocab)
    return [([(a, 6, {})], None), ([(b, 6, {})], None)]


def _waves_concurrent_sharers(vocab):
    rng = np.random.default_rng(11)
    system = prompt(rng, 16, vocab)
    a, b = system + prompt(rng, 3, vocab), system + prompt(rng, 4, vocab)
    return [([(a, 3, {}), (b, 12, {})], None)]


def _waves_freed_prefix_survives(vocab):
    rng = np.random.default_rng(12)
    system = prompt(rng, 16, vocab)
    return [([(system + [1, 2, 3], 2, {})], None), ([(system + [4, 5], 2, {})], None)]


def _waves_repeat(vocab):
    rng = np.random.default_rng(13)
    p = prompt(rng, 16, vocab) + [7]
    return [([(p, 4, {})], None), ([(p, 4, {})], None)]


def _waves_mismatch(vocab):
    rng = np.random.default_rng(14)
    a = prompt(rng, 20, vocab)
    b = list(a)
    b[3] = (b[3] + 1) % vocab  # diverges inside block 0
    return [([(a, 4, {})], None), ([(b, 4, {})], None)]


def _waves_long_shared_prefix(vocab):
    rng = np.random.default_rng(32)
    base = prompt(rng, 47, vocab)  # 5 full blocks
    b = base[:40] + prompt(rng, 7, vocab)
    return [([(base, 1, {})], None), ([(b, 1, {})], None)]


def _waves_chunked(vocab):
    rng = np.random.default_rng(60)
    return [([(prompt(rng, n, vocab), 5, {}) for n in (40, 7, 33)], None)]


def _waves_decode_while_ingest(vocab):
    rng = np.random.default_rng(61)
    return [([(prompt(rng, 48, vocab), 3, {}), (prompt(rng, 5, vocab), 3, {})], None)]


def _waves_chunked_with_prefix(vocab):
    rng = np.random.default_rng(62)
    system = prompt(rng, 24, vocab)  # 3 blocks
    return [([(system + [1], 2, {})], None), ([(system + prompt(rng, 30, vocab), 4, {})], None)]


def _waves_long_context(vocab):
    rng = np.random.default_rng(80)
    return [([(prompt(rng, 230, vocab), 6, {}), (prompt(rng, 5, vocab), 6, {})], None)]


def _waves_recompute_matches_its_tail(vocab):
    """A 32-token prompt ingests in two chunks (the unit rounds 8 up to 16)
    beside a decoding 15-token request. Its last chunk samples its first
    token and registers its four blocks; in the same tick (a classic tick
    even at H > 1, since a slot ingested) the older request's growth
    preempts it, and its recompute matches all four blocks: one token
    left, already sampled, so no prefill runs."""
    rng = np.random.default_rng(90)
    return [([(prompt(rng, 15, vocab), 5, {}), (prompt(rng, 32, vocab), 2, {}),
              (prompt(rng, 8, vocab), 3, {})], None)]


#: name: (the function making the waves, PagedConfig kwargs)
SCENARIOS = {
    "prefix_reused": (_waves_prefix_reused, dict(max_slots=2, block_size=8, num_blocks=32,
                                                 max_blocks_per_seq=6)),
    "prefix_concurrent_sharers": (_waves_concurrent_sharers, dict(
        max_slots=2, block_size=8, num_blocks=32, max_blocks_per_seq=6)),
    "prefix_freed_survives": (_waves_freed_prefix_survives, dict(
        max_slots=2, block_size=8, num_blocks=32, max_blocks_per_seq=6)),
    "prefix_disabled": (_waves_repeat, dict(max_slots=2, block_size=8, num_blocks=32,
                                            max_blocks_per_seq=6, prefix_caching=False)),
    "prefix_mismatch": (_waves_mismatch, dict(max_slots=2, block_size=8, num_blocks=32,
                                              max_blocks_per_seq=6)),
    "long_shared_prefix_table_width": (_waves_long_shared_prefix, dict(
        max_slots=2, block_size=8, num_blocks=32, max_blocks_per_seq=6)),
    "chunked": (_waves_chunked, dict(max_slots=3, block_size=8, num_blocks=64,
                                     max_blocks_per_seq=8, prefill_chunk=16)),
    "decode_while_ingest": (_waves_decode_while_ingest, dict(
        max_slots=2, block_size=8, num_blocks=64, max_blocks_per_seq=8, prefill_chunk=8)),
    "chunked_with_prefix": (_waves_chunked_with_prefix, dict(
        max_slots=2, block_size=8, num_blocks=64, max_blocks_per_seq=8, prefill_chunk=16)),
    "long_context": (_waves_long_context, dict(max_slots=2, block_size=16, num_blocks=64,
                                               max_blocks_per_seq=16, prefill_chunk=64)),
    "recompute_matches_its_tail": (_waves_recompute_matches_its_tail, dict(
        max_slots=3, block_size=8, num_blocks=8, max_blocks_per_seq=8, prefill_chunk=8)),
}
#: hit tokens at the end, where the JAX test pins them
HITS = {"prefix_reused": 16, "prefix_freed_survives": 16, "prefix_disabled": 0,
        "prefix_mismatch": 0, "long_shared_prefix_table_width": 40, "chunked_with_prefix": 24}


class TestEngineLockstep:
    @pytest.mark.parametrize("horizon", [1, 2, 8])
    @pytest.mark.parametrize("name", list(SCENARIOS))
    def test_same_state_as_jax_after_every_step(self, tiny, name, horizon):
        build, pcfg = SCENARIOS[name]
        params_j, params_t = tiny["params"]
        jeng, teng = engines(params_j, params_t, tiny["cfg_j"], tiny["cfg_t"], pcfg, horizon)
        # the admissions whose whole effective prompt but its last (sampled)
        # token matched: they run no prefill
        no_prefill = []
        prefill = teng._prefill

        def spy(slot_idx, req, shared, shared_tokens, fresh):
            if len(req.prompt) + len(req.output) - shared_tokens == 1 and req.output:
                no_prefill.append(req.rid)
            prefill(slot_idx, req, shared, shared_tokens, fresh)

        teng._prefill = spy
        waves = build(tiny["cfg_t"].vocab_size)
        run_lockstep(jeng, teng, waves)
        n_requests = sum(len(reqs) for reqs, _ in waves)
        assert len(teng.finished) == n_requests
        if name in HITS:
            assert teng.blocks.hit_tokens == HITS[name]
        chunked = pcfg.get("prefill_chunk") is not None
        assert (teng.phase_counts["chunks"] > 0) == chunked
        if not chunked:
            admissions = n_requests + sum(r.preemptions for r in teng.finished)
            assert teng.phase_counts["prefills"] == admissions
        if name == "recompute_matches_its_tail":
            assert no_prefill == [1]
            assert {r.rid: r.preemptions for r in teng.finished}[1] == 1
        else:
            assert no_prefill == []
        if name == "decode_while_ingest" and horizon == 1:
            # the short request decoded while the long one still ingested
            (long_r, short_r) = sorted(teng.finished, key=lambda r: r.rid)
            assert short_r.first_token_at < long_r.first_token_at
