"""PagedKVCache of the port against the JAX package's: one scripted
grow / register / release / lookup / adopt / fork / trim / evict / CRC
sequence must leave identical tables, refcounts, free lists, LRU order,
counters and page bytes on both."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_smoke
from repro.models.blocks import ModelContext as JCtx
from repro.serve.kv_cache import PagedKVCache as JCache
from repro_torch.models.blocks import ModelContext as TCtx
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_cache import PagedKVCache as TCache

NUM_PAGES, PAGE, SLOTS, PER_SEQ = 10, 8, 4, 6


def _jax_copy(pages, src, dst):
    return jax.tree.map(lambda a: a.at[:, dst].set(a[:, src]), pages)


def _host_state(c):
    return {
        "table": c._table.tolist(), "ref": c._ref.tolist(),
        "free": list(c._free), "frontier": c._frontier.tolist(),
        "evictable": list(c._evictable), "published": dict(c._published),
        "index": {h: (p, tuple(b)) for h, (p, b) in c._index.items()},
        "counters": dict(c.counters), "crc": dict(c._page_crc),
        "quarantined": set(c._quarantined),
    }


def test_scripted_sequence_matches_reference():
    cfg = get_smoke("qwen2_0_5b")
    jc = JCache(cfg, JCtx(compute_dtype=jnp.float32), NUM_PAGES, PAGE,
                SLOTS, PER_SEQ)
    tc = TCache(cfg, TCtx(compute_dtype=torch.float32, device="cpu"),
                NUM_PAGES, PAGE, SLOTS, PER_SEQ)
    # distinct page contents on both sides, so copies and CRCs can differ
    data = np.random.default_rng(0).standard_normal(
        jc.pages["sl0"]["k"].shape).astype(np.float32)
    jc.pages = {"sl0": {"k": jnp.asarray(data), "v": jnp.asarray(-data)}}
    tc.pages["sl0"]["k"].copy_(torch.from_numpy(data))
    tc.pages["sl0"]["v"].copy_(torch.from_numpy(-data))
    jc.integrity_checks = tc.integrity_checks = True
    prompt = np.arange(20, dtype=np.int32)
    other = np.concatenate([np.arange(16), [99, 98]]).astype(np.int32)
    script = [
        ("grow", 0, 20), ("grow", 1, 9), ("register_prefix", 0, prompt),
        ("release", 0), ("lookup_prefix", other), ("adopt", 2),
        ("grow", 2, 30), ("ensure_private", 2, 8), ("trim", 1, 8),
        ("grow", 3, 48), ("lookup_prefix", other), ("adopt", 0),
        ("abort", 0), ("register_prefix", 2, other), ("corrupt_first",),
        ("verify",), ("slots_referencing_bad",), ("release", 2),
        ("release", 1), ("grow", 0, 48), ("grow", 1, 24),
        ("release", 0), ("release", 1), ("release", 3),
        ("lookup_prefix", prompt),
    ]
    last = {}
    for step in script:
        results = []
        for c, copy in ((jc, _jax_copy), (tc, ServeEngine._copy_page)):
            op, args = step[0], step[1:]
            if op == "adopt":
                res = c.adopt_prefix(args[0], last[id(c)][1])
            elif op == "abort":
                res = c.abort_adoption(args[0], *last[id(c)])
            elif op == "ensure_private":
                res = c.ensure_private(*args, copy)
            elif op == "corrupt_first":
                res = c.corruptible_pages()
                c.corrupt_page(res[0])
            elif op == "verify":
                res = c.verify_integrity()
                last[id(c)] = res
            elif op == "slots_referencing_bad":
                res = c.slots_referencing(last[id(c)][0][0])
            else:
                res = getattr(c, op)(*args)
            if op == "lookup_prefix":
                last[id(c)] = res
            results.append(res)
        assert results[0] == results[1], step
        assert _host_state(jc) == _host_state(tc), step
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            tc.pages["sl0"][name].numpy(),
            np.asarray(jc.pages["sl0"][name]))
    assert jc.counters["pages_forked"] >= 1
    assert jc.counters["pages_evicted"] >= 1
    assert jc.counters["pages_quarantined"] == 1
    assert tc.per_token_bytes() == jc.per_token_bytes()
    assert tc.dedup_stats() == jc.dedup_stats()


def test_table_is_pushed_only_when_it_changes():
    cfg = get_smoke("qwen2_0_5b")
    c = TCache(cfg, TCtx(compute_dtype=torch.float32, device="cpu"),
               NUM_PAGES, PAGE, SLOTS, PER_SEQ)
    first = c.table_device()
    assert c.table_device() is first  # unchanged: no new push
    c.grow(1, 10)
    second = c.table_device()
    assert second is not first
    assert second.dtype == torch.int32
    np.testing.assert_array_equal(second.numpy(), c._table)
    assert c.table_row(1).shape == (1, PER_SEQ)
    assert c.table_device() is second
