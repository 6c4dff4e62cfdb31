"""Continuous-batching serving engine of the port (``repro.serve.engine``).

The single-host paths of the reference, in eager PyTorch:

  * **Continuous batching** (scheduler.py): requests claim free batch
    slots and drain mid-decode; finished or preempted slots refill
    without flushing the batch.
  * **Paged KV pool** (kv_cache.py) with int8 page quantization; every
    prefill is a chunked span prefill (``prefill_chunk`` tokens per call,
    the final partial chunk bucketed to a power of two) through the same
    span datapath that verifies speculative drafts.
  * **Dense KV backend** (``paged=False``; the only one for Mamba and
    RWKV stacks and for encoder-decoders): per-slot ring caches and
    recurrent states (kv_cache.DenseKVCache). A prompt prefills in
    right-aligned spans at absolute positions (``chunk_prefill``; hybrid
    stacks thread their recurrent state through the spans), front-padded
    to a power-of-two bucket in one call (``bucket_prefill``, pure
    state-family stacks), or, when a sliding window makes the cache a ring
    narrower than the serve window or the model is an encoder-decoder
    (whose request brings its ``enc_feats``), in one full-prompt prefill;
    its cache row is then copied into the slot.
  * **Request extras**: ``enc_feats`` (1, encoder_seq, d_model) frames of
    an encoder-decoder request, and ``positions`` (3, 1, S) explicit
    M-RoPE rows, sliced per prefill chunk and continued past the prompt
    by max + 1. A request with explicit positions never publishes or
    adopts prefix pages: the index is keyed on tokens alone.
  * **Prefix caching**: full prompt pages are content-addressed; an
    admission that hits shares the cached pages (copy-on-write protected)
    and prefills only the prompt suffix.
  * **Self-speculative decoding** (``draft_k > 0``): an n-gram prompt-
    lookup drafter proposes ``draft_k`` tokens from a device-resident
    token history, one span decode scores them, and the longest prefix
    matching the model's own greedy targets is accepted.
  * **Device-resident decode**: a chunk is a Python loop of ``chunk``
    decode steps that never reads the device from the host; draft,
    verify, pick, EOS/budget masking, page writes and positions all stay
    on the device. The host drains once per chunk (one ``.cpu()``), so
    ``host_syncs == chunks``.

  * **Fault injection and admission control** (``faults``,
    ``admission``): the reference's deterministic chaos schedule, keyed
    by chunk-boundary index (KV page flips caught by per-page CRC stamps,
    quarantined and replayed; stragglers), and TTFT-deadline shedding
    with speculation dropped under queue pressure.

Greedy decoding is the parity contract with the reference engine;
``temperature > 0`` samples (Gumbel-max) from an explicit
``torch.Generator``. ``generate_pertoken`` is the reference's per-token
loop (dense prefill, then one decode call per token), kept as a
cross-check oracle. The reference's mesh and disaggregation paths (and
with them the worker-failure and transfer-drop faults) are not ported yet
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import api
from repro_torch.models.blocks import ModelContext, init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_map
from repro_torch.obs.metrics import (CounterDict, MetricsRegistry,
                                     QUEUE_WAIT_BUCKETS_STEPS)
from repro_torch.obs.steptrace import StepTrace
from repro_torch.obs.trace import SpanTracer
from repro_torch.serve.kv_cache import DenseKVCache, PagedKVCache
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

Tensor = torch.Tensor
PAD_TOKEN = -1  # emitted by finished slots inside a chunk


@dataclasses.dataclass
class ServeEngine:
    """``window``: max total tokens per request (prompt + generated).

    ``draft_k``: speculative draft length per decode step (0 disables).
    ``paged``: the KV backend (None -> paged where the family supports
    it; False -> dense per-slot caches). ``prefix_cache``: share
    prompt-prefix pages across requests (None -> on when paged).
    ``prefill_chunk``: span size for chunked prefill (clamped to the
    window). The device is ``ctx.device``."""

    cfg: ModelConfig
    ctx: ModelContext
    window: int
    max_batch: int = 4
    chunk: int = 8
    page_size: int = 8
    num_pages: Optional[int] = None
    paged: Optional[bool] = None
    eos_id: Optional[int] = None
    temperature: float = 0.0
    draft_k: int = 0
    prefix_cache: Optional[bool] = None
    prefill_chunk: int = 128
    # reference features not ported yet: setting either raises
    mesh: Any = None
    disaggregate: bool = False
    # serve.faults.FaultInjector (None: no fault schedule);
    # serve.admission.AdmissionController (None admits everything).
    # ``retry_budget`` bounds fault replays per request before the
    # deterministic terminal failure (state="failed").
    faults: Any = None
    admission: Any = None
    retry_budget: int = 3
    metrics: Any = None  # obs.MetricsRegistry (None -> fresh enabled one)
    tracer: Any = None  # obs.SpanTracer (None -> disabled)

    def __post_init__(self) -> None:
        cfg = self.cfg
        if self.mesh is not None:
            raise NotImplementedError("ServeEngine(mesh=...) is not ported "
                                      "yet")
        if self.disaggregate:
            raise NotImplementedError(
                "prefill/decode disaggregation is not ported yet")
        if self.paged is None:
            self.paged = api.supports_paged_decode(cfg)
        if self.paged and not api.supports_paged_decode(cfg):
            raise ValueError(f"{cfg.name}: paged serving unsupported")
        if self.draft_k and not self.paged:
            raise ValueError("speculative decoding (draft_k > 0) requires "
                             "the paged KV backend")
        if self.draft_k < 0:
            raise ValueError("draft_k must be >= 0")
        if self.prefix_cache is None:
            self.prefix_cache = self.paged
        if self.prefix_cache and not self.paged:
            raise ValueError("prefix caching requires the paged KV backend")
        self.device = self.ctx.device
        if self.metrics is None:
            self.metrics = MetricsRegistry()
        if self.tracer is None:
            self.tracer = SpanTracer(enabled=False)
        self.steptrace = StepTrace(
            source="serve", meta={"arch": cfg.name,
                                  "device": str(self.device)})
        self.counters = CounterDict(
            self.metrics,
            ("prefills", "chunks", "decode_steps", "host_syncs",
             "pertoken_steps", "pages_trimmed", "suffix_prefills",
             "prompt_tokens", "cached_prompt_tokens", "spec_steps",
             "spec_tokens", "prefill_span_calls", "span_prefill_compiles",
             "span_prefill_dense_compiles"),
            prefix="serve_")
        m = self.metrics
        self._m = {
            "ttft": m.histogram("serve_ttft_s"),
            "tpot": m.histogram("serve_tpot_s"),
            "e2e": m.histogram("serve_e2e_s"),
            "queue_wait": m.histogram("serve_queue_wait_steps",
                                      edges=QUEUE_WAIT_BUCKETS_STEPS),
            "prefill_hist": m.histogram("serve_prefill_s"),
            "chunk_hist": m.histogram("serve_chunk_s"),
            "prefill_time": m.counter("serve_prefill_time_s"),
            "decode_time": m.counter("serve_decode_time_s"),
            "prefill_tokens": m.counter("serve_prefill_tokens"),
            "decode_tokens": m.counter("serve_decode_tokens"),
            "generated_tokens": m.counter("serve_generated_tokens"),
            "admitted": m.counter("serve_requests_admitted"),
            "finished": m.counter("serve_requests_finished"),
            "preempted": m.counter("serve_requests_preempted"),
        }
        self._trace_pid = self.tracer.process("serve")
        self._device_tid = self.tracer.thread(
            self._trace_pid, self.max_batch, "device")
        self._req_obs: Dict[int, Dict[str, float]] = {}
        if self.paged:
            # +1 page of table headroom: a finished slot's frozen pos can
            # sit exactly at `window`, and speculative spans write up to
            # draft_k positions past the frontier; those must resolve to
            # trash.
            self.pages_per_seq = (
                -(-(self.window + self.draft_k) // self.page_size) + 1)
            if self.num_pages is None:
                self.num_pages = 1 + self.max_batch * self.pages_per_seq
            self.kv: Any = PagedKVCache(cfg, self.ctx, self.num_pages,
                                        self.page_size, self.max_batch,
                                        self.pages_per_seq)
        else:
            self.kv = DenseKVCache(cfg, self.ctx, self.window,
                                   self.max_batch)
        # Pure state-family stacks (mamba/rwkv) carry O(1) state: a prompt
        # is front-padded to a power-of-two bucket (masked embeddings; the
        # recurrent state stays zero through the pad prefix), which bounds
        # the reference's compile count to log2(window).
        self.bucket_prefill = (not self.paged
                               and not cfg.is_encoder_decoder
                               and set(cfg.sublayer_kinds()) <=
                               {"mamba", "rwkv"})
        # Chunked prefill through the dense span path: prompts are
        # right-aligned into fixed-size spans at absolute positions, so
        # attention needs no front padding. It needs append-only caches,
        # so sliding-window archs whose window is below the serve window
        # (a ring) take the full-prompt prefill instead, as do
        # encoder-decoders. mrope rows thread through the span paths.
        self.chunk_prefill = (not self.paged
                              and not self.bucket_prefill
                              and not cfg.is_encoder_decoder
                              and (cfg.sliding_window is None
                                   or self.window <= cfg.sliding_window))
        if self.retry_budget < 0:
            raise ValueError("retry_budget must be >= 0")
        self.fault_stats = CounterDict(
            self.metrics,
            ("fault_worker_failures", "fault_page_corruptions",
             "fault_pages_quarantined", "fault_transfer_drops",
             "fault_stragglers", "fault_detections", "retry_requeues",
             "retry_failures", "shed_requests", "shed_spec_chunks"),
            prefix="serve_")
        if self.faults is not None and self.paged:
            # CRC-stamp published pages so injected corruption is caught
            # at the next boundary, before any chunk could read it
            self.kv.integrity_checks = True
        self.span_len = max(1, min(self.prefill_chunk, self.window))
        # span shapes run so far, paged and dense, each with or without
        # mrope rows: the reference compiles one program per shape and
        # argument structure, so their counts are its
        # span_prefill_compiles and span_prefill_dense_compiles metrics
        self._span_shapes: set = set()
        self._dense_span_shapes: set = set()
        self.prefill_bucket_sizes: set = set()  # bucketed prefill lengths
        self._use_spec = False  # per run: draft_k > 0 and greedy
        self._gen: Optional[torch.Generator] = None
        self._reset_carry()

    # ------------------------------------------------------------ picks

    def _pick(self, logits: Tensor, temp: float) -> Tensor:
        """logits (B,1,V) -> (B,1) int32 next tokens: greedy argmax, or
        a Gumbel-max sample from the run's generator when temp > 0."""
        last = logits[:, -1, :].float()
        if temp > 0.0:
            u = torch.rand(last.shape, generator=self._gen,
                           device=last.device).clamp_(min=1e-20)
            last = last / max(temp, 1e-6) - torch.log(-torch.log(u))
        return torch.argmax(last, dim=-1)[:, None].to(torch.int32)

    def _draft_tokens(self, hist: Tensor, pos: Tensor, tok: Tensor
                      ) -> Tensor:
        """n-gram prompt-lookup drafter, fully on the device.

        hist: (B, W) token at each absolute position (< pos valid); tok:
        (B, 1) the current input token (position ``pos``). Finds the
        latest earlier occurrence of the tip bigram (hist[pos-1], tok)
        and proposes the ``draft_k`` tokens that followed it; misses are
        -1, which never match a greedy target."""
        b, w = hist.shape
        dk = self.draft_k
        dev = hist.device
        bidx = torch.arange(b, device=dev)
        idx = torch.arange(w, device=dev)[None, :]
        pcol = pos[:, None].long()
        prev = torch.nn.functional.pad(hist, (1, 0))[:, :w]
        last = hist[bidx, torch.clamp(pos.long() - 1, 0, w - 1)]
        m = (hist == tok) & (prev == last[:, None])
        m &= (idx >= 1) & (idx < pcol)
        # prefer the latest match whose dk-token continuation lies fully
        # inside known history; closer matches propose unwritten tokens
        j_full = torch.where(m & (idx + dk <= pcol - 1), idx, -1).amax(1)
        j_part = torch.where(m & (idx <= pcol - 2), idx, -1).amax(1)
        j = torch.where(j_full >= 0, j_full, j_part)
        ahead = j[:, None] + 1 + torch.arange(dk, device=dev)[None, :]
        drafts = hist[bidx[:, None], torch.clamp(ahead, 0, w - 1)]
        known = (ahead < pcol) & (j[:, None] >= 0)
        return torch.where(known, drafts, -1).to(torch.int32)

    # ------------------------------------------------------- programs

    @staticmethod
    def _copy_page(pages: Dict[str, Dict[str, Tensor]], src: int,
                   dst: int) -> Dict[str, Dict[str, Tensor]]:
        """Copy-on-write page copy, every layer and leaf, in place."""
        for sub in pages.values():
            for arr in sub.values():
                arr[:, dst] = arr[:, src]
        return pages

    def _prefill_span(self, params, span: Tensor, table: Tensor,
                      pos0: Tensor, valid: Tensor, temp: float,
                      mrope: Optional[Tensor] = None) -> Tensor:
        """One span-prefill call: the span's k/v land in the pages and
        only the last real token's logits are computed. ``mrope``
        (3, 1, T): the span's explicit rope rows."""
        shape = (tuple(span.shape), mrope is not None)
        if shape not in self._span_shapes:
            self._span_shapes.add(shape)
            self.metrics.compile_event("serve_span_prefill")
        state = {"pages": self.kv.pages, "page_table": table, "pos": pos0}
        idx = torch.clamp(valid - 1, 0, span.shape[1] - 1)
        logits, _ = api.decode_span_paged_fn(
            params, span, state, self.cfg, self.ctx, valid=valid,
            logits_at=idx, mrope_positions=mrope)
        return self._pick(logits, temp)

    def _prefill_dense(self, params, batch: Dict[str, Tensor], temp: float):
        """Full-prompt prefill of one request (its tokens and extras) into
        a fresh (1, W) cache row; returns (first token, cache)."""
        logits, cache = api.prefill_fn(params, batch, self.cfg, self.ctx,
                                       window=self.window)
        return self._pick(logits, temp), cache

    def _prefill_bucketed(self, params, tokens: Tensor, pad_left: Tensor,
                          temp: float):
        """Front-padded prefill of one request (state-family stacks) into
        a fresh cache row; returns (first token, cache)."""
        logits, cache = api.prefill_fn(params, {"tokens": tokens}, self.cfg,
                                       self.ctx, window=self.window,
                                       pad_left=pad_left)
        return self._pick(logits, temp), cache

    def _prefill_span_dense(self, params, cache, span: Tensor, pos0: Tensor,
                            temp: float, mrope: Optional[Tensor] = None):
        """One dense span-prefill call: a right-aligned chunk ends on a
        live token, whose logits alone go through the lm head."""
        shape = (tuple(span.shape), mrope is not None)
        if shape not in self._dense_span_shapes:
            self._dense_span_shapes.add(shape)
            self.metrics.compile_event("serve_span_prefill_dense")
        state = dict(cache)
        state["pos"] = pos0
        last = torch.full((span.shape[0],), span.shape[1] - 1,
                          dtype=torch.int32, device=span.device)
        logits, new_state = api.decode_span_fn(
            params, span, state, self.cfg, self.ctx, logits_at=last,
            mrope_positions=mrope)
        return self._pick(logits, temp), {"blocks": new_state["blocks"]}

    def _decode_step(self, params, table: Optional[Tensor], temp: float,
                     carry):
        tok, pos, done, n_out, max_new = carry
        if self.paged:
            state = {"pages": self.kv.pages, "page_table": table,
                     "pos": pos}
            logits, _ = api.decode_paged_fn(params, tok, state, self.cfg,
                                            self.ctx)
        else:
            logits, _ = api.decode_fn(params, tok, self.kv.state(pos),
                                      self.cfg, self.ctx)
        emitted = torch.where(done, PAD_TOKEN, tok[:, 0])
        n_out = n_out + torch.where(done, 0, 1).to(n_out.dtype)
        newly_done = ~done & (n_out >= max_new)
        if self.eos_id is not None:
            newly_done |= ~done & (tok[:, 0] == self.eos_id)
        done = done | newly_done
        # finished slots freeze: their (garbage) writes keep landing on
        # the same slot or the trash page and their position stops
        pos = torch.where(done, pos, pos + 1)
        nxt = self._pick(logits, temp)
        tok = torch.where(done[:, None], tok, nxt)
        return (tok, pos, done, n_out, max_new), emitted

    def _run_chunk(self, params, table: Optional[Tensor],
                   temp: float) -> Tensor:
        """``chunk`` decode steps with no host read; returns the emitted
        tokens (B, chunk) on the device."""
        carry = (self._tok, self._pos, self._done, self._n_out,
                 self._max_new)
        toks = []
        for _ in range(self.chunk):
            carry, emitted = self._decode_step(params, table, temp, carry)
            toks.append(emitted)
        self._tok, self._pos, self._done, self._n_out, _ = carry
        return torch.stack(toks, dim=1)

    def _spec_step(self, params, table: Tensor, temp: float, carry):
        """Draft -> one span decode scoring (1 + draft_k) tokens ->
        accept the longest prefix matching the model's greedy targets ->
        emit 1..1+draft_k tokens. Rollback of the rejected tail is the
        position bookkeeping alone: pages are append-only."""
        tok, pos, done, n_out, max_new, hist = carry
        dk = self.draft_k
        b = tok.shape[0]
        dev = tok.device
        bidx = torch.arange(b, device=dev)
        w = hist.shape[1]
        drafts = self._draft_tokens(hist, pos, tok)  # (B, dk)
        span = torch.cat([tok, drafts], dim=1)  # (B, 1+dk)
        state = {"pages": self.kv.pages, "page_table": table, "pos": pos}
        logits, _ = api.decode_span_paged_fn(params, span, state, self.cfg,
                                             self.ctx)
        greedy = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        # greedy[:, t] is the model's target for position pos + t + 1;
        # sampled runs would change the distribution, so drafts void
        match = (drafts == greedy[:, :dk]) & (temp <= 0.0)
        a = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        t_idx = torch.arange(1 + dk, device=dev)
        emit_ok = (t_idx[None, :] <= a[:, None]) & ~done[:, None]
        emit_ok &= (n_out[:, None] + t_idx[None, :]) < max_new[:, None]
        if self.eos_id is not None:
            is_eos = span == self.eos_id
            prior = torch.cumsum(is_eos.to(torch.int32), dim=1) - \
                is_eos.to(torch.int32)
            emit_ok &= prior == 0  # nothing emits past an EOS
        emitted = torch.where(emit_ok, span, PAD_TOKEN)
        n_emit = emit_ok.sum(dim=1).to(torch.int32)
        n_out = n_out + n_emit
        newly_done = ~done & (n_out >= max_new)
        if self.eos_id is not None:
            newly_done |= ~done & torch.any(emit_ok & is_eos, dim=1)
        done = done | newly_done
        # token history: write the emitted span at positions pos + t
        wpos = torch.clamp(pos[:, None].long() + t_idx[None, :], 0, w - 1)
        cur = hist[bidx[:, None], wpos]
        hist[bidx[:, None], wpos] = torch.where(emit_ok, span, cur)
        pos = pos + n_emit  # rollback == not advancing past acceptance
        if temp > 0.0:
            nxt = self._pick(logits[:, :1], temp)
        else:
            nxt = greedy[bidx, torch.clamp(a, 0, dk).long()][:, None]
        tok = torch.where(done[:, None], tok, nxt)
        return (tok, pos, done, n_out, max_new, hist), emitted

    def _run_chunk_spec(self, params, table: Tensor, temp: float
                        ) -> Tensor:
        """``chunk`` speculative steps; returns emitted (B, chunk, 1+dk)."""
        carry = (self._tok, self._pos, self._done, self._n_out,
                 self._max_new, self._hist)
        toks = []
        for _ in range(self.chunk):
            carry, emitted = self._spec_step(params, table, temp, carry)
            toks.append(emitted)
        (self._tok, self._pos, self._done, self._n_out, _,
         self._hist) = carry
        return torch.stack(toks, dim=1)

    # --------------------------------------------------------- carry state

    def _reset_carry(self) -> None:
        b, dev, i32 = self.max_batch, self.device, torch.int32
        self._tok = torch.zeros((b, 1), dtype=i32, device=dev)
        self._pos = torch.zeros((b,), dtype=i32, device=dev)
        self._done = torch.ones((b,), dtype=torch.bool, device=dev)
        self._n_out = torch.zeros((b,), dtype=i32, device=dev)
        self._max_new = torch.ones((b,), dtype=i32, device=dev)
        if self.draft_k:
            # draft_k + 1 columns of headroom keep every span write index
            # in range and distinct
            self._hist = torch.zeros((b, self.window + self.draft_k + 1),
                                     dtype=i32, device=dev)

    @staticmethod
    def _pow2_bucket(t: int, cap: int) -> int:
        """Length of a partial span: pow2 >= t (floor 4), capped at the
        full span size."""
        return min(cap, max(4, 1 << (t - 1).bit_length()))

    def _span_prefill_paged(self, params, slot: int, tokens: np.ndarray,
                            start: int, temp: float,
                            mrope: Optional[np.ndarray] = None) -> Tensor:
        """Prefill ``tokens`` at absolute positions ``start..`` in fixed-
        size span chunks; cold prompts (start=0) and cached-prefix
        suffixes (start=cached) share the path. Back padding inside a
        partial chunk writes to the trash page. ``mrope`` (3, S_total):
        the request's explicit rope rows by absolute position; each chunk
        slices its window (pad slots get zero rows)."""
        s_len = self.span_len
        if not self.kv.ensure_private(slot, start, self._copy_page):
            raise RuntimeError("page pool exhausted during CoW fork")
        dev, i32 = self.device, torch.int32
        table = self.kv.table_row(slot)
        first = None
        i = 0
        while i < len(tokens):
            t = min(s_len, len(tokens) - i)
            b_len = self._pow2_bucket(t, s_len)
            span = np.zeros((1, b_len), np.int32)
            span[0, :t] = tokens[i:i + t]
            chunk_m = None
            if mrope is not None:
                cm = np.zeros((3, 1, b_len), np.int32)
                cm[:, 0, :t] = mrope[:, start + i:start + i + t]
                chunk_m = torch.from_numpy(cm).to(dev)
            first = self._prefill_span(
                params, torch.from_numpy(span).to(dev), table,
                torch.full((1,), start + i, dtype=i32, device=dev),
                torch.full((1,), t, dtype=i32, device=dev), temp, chunk_m)
            self.counters["prefill_span_calls"] += 1
            i += t
        return first

    def _span_prefill_dense(self, params, slot: int, tokens: np.ndarray,
                            temp: float,
                            mrope: Optional[np.ndarray] = None) -> Tensor:
        """Chunked prefill on the dense backend: the prompt is RIGHT-
        aligned into fixed-size spans, so only the first chunk is
        front-padded; its dead positions sit at negative absolute
        positions. The first (partial) chunk buckets to a power of two;
        every other chunk is a full span. ``mrope`` (3, S): explicit rope
        rows; the dead front pad gets zero rows (its writes drop)."""
        s_len = self.span_len
        s = len(tokens)
        r = s % s_len or min(s, s_len)  # first (partial) chunk tokens
        b0 = self._pow2_bucket(r, s_len)
        pad = b0 - r
        padded = np.zeros((1, pad + s), np.int32)
        padded[0, pad:] = tokens
        m_full = None
        if mrope is not None:
            m_full = np.zeros((3, pad + s), np.int32)
            m_full[:, pad:] = mrope[:, :s]
        dev, i32 = self.device, torch.int32
        spec = api.cache_spec(self.cfg, 1, self.window, self.ctx)
        cache = {"blocks": init_cache(spec["blocks"], dev)}
        first = None
        i = 0
        while i < padded.shape[1]:
            b_len = b0 if i == 0 else s_len
            chunk_m = (None if m_full is None else torch.from_numpy(
                np.ascontiguousarray(m_full[:, None, i:i + b_len])).to(dev))
            first, cache = self._prefill_span_dense(
                params, cache,
                torch.from_numpy(padded[:, i:i + b_len]).to(dev),
                torch.full((1,), i - pad, dtype=i32, device=dev), temp,
                chunk_m)
            self.counters["prefill_span_calls"] += 1
            i += b_len
        self.kv.write_prefill(slot, cache)
        return first

    def _req_mrope(self, req: Request, s: int) -> Optional[np.ndarray]:
        """(3, S) absolute-indexed mrope rows for a resume prompt of
        length ``s``: the request's explicit positions, extended past the
        original prompt (generated tokens folded in on resume) by the
        standard max + 1 text continuation. None for text requests."""
        if self.cfg.pos_emb != "mrope":
            return None
        v = req.extras.get("positions")
        if v is None:
            return None  # text default: span paths broadcast positions
        m = np.asarray(v, np.int32).reshape(3, -1)
        if m.shape[1] < s:
            tail = int(m.max()) + 1 + np.arange(s - m.shape[1],
                                                dtype=np.int32)
            m = np.concatenate(
                [m, np.broadcast_to(tail, (3, tail.size))], axis=1)
        return m[:, :s]

    def _admit_into_slot(self, params, req: Request, slot: int,
                         temp: float) -> None:
        rp = req.resume_prompt()
        s = len(rp)
        self.counters["prefills"] += 1
        mrope = self._req_mrope(req, s)
        if self.paged:
            cached = req.cached_prefix_len
            # every paged prefill is a chunked span prefill; a prefix hit
            # just starts past the adopted pages (suffix-only compute)
            first = self._span_prefill_paged(params, slot, rp[cached:],
                                             cached, temp, mrope)
            if cached > 0:
                self.counters["suffix_prefills"] += 1
            if self.prefix_cache and mrope is None:
                # publish the full prompt pages for later admissions (and
                # this request's own resume after a preemption). Explicit
                # mrope requests never publish (or adopt): the index is
                # keyed on tokens alone, and the same tokens under other
                # position rows hold other KV.
                self.kv.register_prefix(slot, rp)
        elif self.chunk_prefill and not (req.extras.keys() - {"positions"}):
            first = self._span_prefill_dense(params, slot, rp, temp, mrope)
        elif self.bucket_prefill and not req.extras:
            sb = 1 << max(3, (s - 1).bit_length())  # pow2 >= s, floor 8
            self.prefill_bucket_sizes.add(sb)
            padded = np.zeros((1, sb), np.int32)
            padded[0, sb - s:] = rp  # right-aligned: the pad leads
            first, cache = self._prefill_bucketed(
                params, torch.from_numpy(padded).to(self.device),
                torch.full((1,), sb - s, dtype=torch.int32,
                           device=self.device), temp)
            self.kv.write_prefill(slot, cache)
        else:
            batch = {"tokens": torch.from_numpy(rp[None, :]).to(self.device)}
            for k, v in req.extras.items():
                batch[k] = torch.as_tensor(np.asarray(v)).to(self.device)
            first, cache = self._prefill_dense(params, batch, temp)
            self.kv.write_prefill(slot, cache)
        if self.draft_k and self._use_spec:
            row = np.zeros(self.window + self.draft_k + 1, np.int32)
            row[:s] = rp
            self._hist[slot] = torch.from_numpy(row).to(self.device)
        self._tok[slot] = first[0]
        self._pos[slot] = s
        self._done[slot] = False
        self._n_out[slot] = len(req.generated)
        self._max_new[slot] = req.max_new

    # ------------------------------------------------------------- faults

    def _fail_slot(self, slot: int, sched: ContinuousBatchingScheduler,
                   clock: int, reason: str) -> None:
        """Fault recovery for one running slot: release its pages, freeze
        the slot on the device, and replay the request (re-admission
        re-prefills ``resume_prompt()`` past surviving cached pages) with
        exponential backoff until the retry budget forces the terminal
        failure."""
        req = sched.running.get(slot)
        if req is None:
            return
        if self.paged:
            self.kv.release(slot)
        self._done[slot] = True
        pid = self._trace_pid
        self.tracer.end(pid=pid, tid=slot)  # req span
        self.tracer.instant("fault_replay", pid=pid, tid=slot, cat="serve",
                            args={"rid": req.rid, "reason": reason,
                                  "retries": req.retries})
        if req.retries >= self.retry_budget:
            sched.fail(req)
            self.fault_stats["retry_failures"] += 1
        else:
            backoff = self.chunk * (1 << min(req.retries, 6))
            sched.requeue(req, not_before=clock + backoff)
            self.fault_stats["retry_requeues"] += 1

    def _apply_faults(self, boundary: int, clock: int,
                      sched: ContinuousBatchingScheduler) -> None:
        """Inject this boundary's page flip, then run detection, in that
        order and before the chunk, so corrupted KV is quarantined before
        any decode step could read it: CRC-verify every stamped page,
        quarantine mismatches and replay every request still mapping
        them. Page flips target the paged pool only."""
        if not self.paged:
            return
        fs = self.fault_stats
        r = self.faults.page_flip(boundary)
        if r is not None:
            pids = self.kv.corruptible_pages()
            if pids:
                self.kv.corrupt_page(pids[r % len(pids)])
                fs["fault_page_corruptions"] += 1
        for bad_pid, _h in self.kv.verify_integrity():
            fs["fault_detections"] += 1
            fs["fault_pages_quarantined"] += 1
            for slot in self.kv.slots_referencing(bad_pid):
                self._fail_slot(slot, sched, clock, reason="kv_corruption")

    # ---------------------------------------------------------------- run

    def submit_check(self, req: Request) -> None:
        total = len(req.prompt) + req.max_new
        if total > self.window:
            raise ValueError(
                f"request {req.rid}: prompt+max_new={total} exceeds "
                f"window={self.window}")

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from cached pages."""
        total = self.counters["prompt_tokens"]
        return (self.counters["cached_prompt_tokens"] / total
                if total else 0.0)

    @property
    def acceptance_length(self) -> float:
        """Mean tokens emitted per speculative verify step (>= 1)."""
        steps = self.counters["spec_steps"]
        return (self.counters["spec_tokens"] / steps if steps else 1.0)

    def slo_summary(self) -> Dict[str, float]:
        """TTFT/TPOT percentiles, queue wait and the prefill/decode split
        straight from the registry."""
        m = self._m
        pf_t = float(m["prefill_time"].value)
        dc_t = float(m["decode_time"].value)
        return {
            "requests": float(m["finished"].value),
            "ttft_p50_s": m["ttft"].quantile(0.5),
            "ttft_p95_s": m["ttft"].quantile(0.95),
            "tpot_p50_s": m["tpot"].quantile(0.5),
            "tpot_p95_s": m["tpot"].quantile(0.95),
            "queue_wait_p50_steps": m["queue_wait"].quantile(0.5),
            "prefill_time_s": pf_t,
            "decode_time_s": dc_t,
            "prefill_tok_s": (float(m["prefill_tokens"].value) / pf_t
                              if pf_t > 0 else 0.0),
            "decode_tok_s": (float(m["decode_tokens"].value) / dc_t
                             if dc_t > 0 else 0.0),
        }

    def _grow_or_preempt(self, sched: ContinuousBatchingScheduler,
                         per_step: int) -> None:
        """Page headroom for the next chunk of every running slot, oldest
        first; on pressure preempt the youngest (its pages free up)."""
        pid = self._trace_pid
        order = sorted(sched.running,
                       key=lambda s: (sched.running[s].arrival,
                                      sched.running[s].rid))
        for slot in order:
            if slot not in sched.running:
                continue  # already preempted this boundary
            req = sched.running[slot]
            # tokens cached after the next chunk (+1 boundary)
            target = int(len(req.prompt) + len(req.generated)
                         + self.chunk * per_step + 1)
            while not self.kv.grow(slot, min(target, self.window)):
                victim = sched.preempt_victim()
                if victim is None:
                    raise RuntimeError(
                        "page pool too small for a single request")
                vslot = victim.slot
                sched.preempt(victim)
                self.kv.release(vslot)
                self._done[vslot] = True
                self.tracer.end(pid=pid, tid=vslot)  # req span
                self.tracer.instant("preempt", pid=pid, tid=vslot,
                                    cat="serve", args={"rid": victim.rid})
                self._m["preempted"].inc()
                if vslot == slot:
                    break  # we were the youngest: self-preempted

    def _admit(self, params, sched: ContinuousBatchingScheduler,
               clock: int, per_step: int, temp: float) -> None:
        """Admit waiting requests into free slots (never preempting)."""
        now, mtr, pid = self.tracer.clock, self._m, self._trace_pid
        while True:
            req = sched.next_admittable(clock)
            slots = sched.free_slots()
            if req is None or not slots:
                break
            slot = slots[0]
            if self.paged:
                rp = req.resume_prompt()
                # explicit-mrope requests bypass the token-keyed prefix
                # index (same tokens, other position rows => other KV)
                use_pc = self.prefix_cache and "positions" not in req.extras
                cached, pids = ((0, []) if not use_pc
                                else self.kv.lookup_prefix(rp))
                if cached:
                    self.kv.adopt_prefix(slot, pids)
                need = len(rp) + self.chunk * per_step + 1
                if not self.kv.grow(slot, min(need, self.window)):
                    if use_pc:
                        # undo adoption and its counters: the retry at the
                        # next boundary repeats the lookup
                        self.kv.abort_adoption(slot, cached, pids)
                    break  # no pages: wait for completions
                req.cached_prefix_len = cached
                self.counters["prompt_tokens"] += len(rp)
                self.counters["cached_prompt_tokens"] += cached
            wall = now()
            o = self._req_obs.setdefault(req.rid, {})
            o.setdefault("ready", wall)
            resumed = "admit" in o  # re-admission after a preemption
            o["admit"] = wall
            mtr["admitted"].inc()
            mtr["queue_wait"].observe(float(clock - req.arrival))
            self.tracer.begin(
                f"req:{req.rid}", pid=pid, tid=slot, cat="serve",
                args={"rid": req.rid, "prompt": len(req.prompt),
                      "resumed": resumed})
            sched.admit(req, slot)
            self._admit_into_slot(params, req, slot, temp)
            dt = now() - wall
            n_prefill = (len(req.prompt) + len(req.generated)
                         - req.cached_prefix_len)
            mtr["prefill_hist"].observe(dt)
            mtr["prefill_time"].add(dt)
            mtr["prefill_tokens"].add(n_prefill)
            self.tracer.complete(
                "prefill", dt, pid=pid, tid=slot, cat="serve",
                args={"tokens": n_prefill, "cached": req.cached_prefix_len})
            self.steptrace.record("prefill", dt, tokens=n_prefill,
                                  cached=req.cached_prefix_len, batch=1)

    def run(self, params, requests: Sequence[Request], *,
            generator: Optional[torch.Generator] = None,
            temperature: Optional[float] = None) -> Dict[int, np.ndarray]:
        """Drain all requests; returns {rid: generated tokens}.
        ``generator`` (on the engine's device) drives sampling when the
        temperature is > 0; default: seeded with 0."""
        sched = ContinuousBatchingScheduler(self.max_batch)
        self.scheduler = sched
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        self._gen = generator
        temp = float(self.temperature if temperature is None
                     else temperature)
        for req in requests:
            self.submit_check(req)
            sched.add(req)
        # greedy-match acceptance is only sound for greedy decoding:
        # sampled runs take the plain one-token chunk
        self._use_spec = bool(self.draft_k) and temp <= 0.0
        self._reset_carry()
        now, mtr, pid = self.tracer.clock, self._m, self._trace_pid
        self._req_obs = {}
        run_t0 = now()
        clock = 0
        boundary = -1  # chunk-boundary index: the fault-schedule clock
        per_step = 1 + self.draft_k if self._use_spec else 1
        while sched.has_work():
            boundary += 1
            wall = now()
            for r in sched.waiting:
                if r.arrival <= clock:  # "ready": anchors queue wait
                    self._req_obs.setdefault(r.rid, {}) \
                        .setdefault("ready", wall)
            if self.admission is not None:
                # enqueue-time shedding: a request whose best-case first
                # token already misses its TTFT deadline leaves before it
                # takes a decode slot
                for r in list(sched.waiting):
                    if r.arrival <= clock and self.admission.should_shed(
                            r, clock, chunk=self.chunk,
                            span_len=self.span_len, disaggregated=False):
                        sched.shed_request(r)
                        self.fault_stats["shed_requests"] += 1
                        self.tracer.instant(
                            "shed", pid=pid, tid=self._device_tid,
                            cat="serve", args={"rid": r.rid})
            if self.faults is not None:
                # quarantined pages and failed slots are settled before
                # admission or the chunk can observe them
                self._apply_faults(boundary, clock, sched)
            if self.paged:
                self._grow_or_preempt(sched, per_step)
            self._admit(params, sched, clock, per_step, temp)
            if not sched.running:
                if sched.next_admittable(clock) is not None:
                    raise RuntimeError(
                        "admission stalled with an empty batch: the page "
                        "pool cannot hold one request (shrink window or "
                        "grow num_pages)")
                if not sched.waiting:
                    # shedding emptied the queue this boundary; the loop
                    # condition settles whether work remains
                    continue
                # idle: jump the clock to the next arrival (or the
                # earliest replay backoff expiry of a requeued request)
                nxt = min(max(r.arrival, r.not_before)
                          for r in sched.waiting)
                clock = max(clock + self.chunk, nxt)
                continue
            # one device-resident chunk
            sched.record_occupancy(len(sched.running))
            chunk_t0 = now()
            live = len(sched.running)
            table = self.kv.table_device() if self.paged else None
            # under queue pressure, a plain chunk instead of a speculative
            # one: token-identical, since acceptance only ever matches the
            # model's own greedy targets
            use_spec = self._use_spec
            if use_spec and self.admission is not None \
                    and self.admission.drop_speculation(len(sched.waiting)):
                use_spec = False
                self.fault_stats["shed_spec_chunks"] += 1
            if use_spec:
                toks = self._run_chunk_spec(params, table, temp)
            else:
                toks = self._run_chunk(params, table, temp)
            clock += self.chunk
            if self.faults is not None:
                # straggler: one chunk of work took extra boundaries of
                # clock; it shifts TTFT and queue waits, never tokens
                extra = self.faults.straggler(boundary)
                if extra:
                    clock += extra * self.chunk
                    self.fault_stats["fault_stragglers"] += 1
                    self.tracer.instant(
                        "straggler", pid=pid, tid=self._device_tid,
                        cat="serve", args={"extra_boundaries": extra})
            self.counters["chunks"] += 1
            self.counters["decode_steps"] += self.chunk
            # drain: the single host read per chunk
            b = self.max_batch
            flat = torch.cat([toks.reshape(-1).to(torch.int32),
                              self._done.to(torch.int32),
                              self._pos]).cpu().numpy()
            self.counters["host_syncs"] += 1
            toks_h = flat[:toks.numel()].reshape(toks.shape)
            done_h = flat[toks.numel():toks.numel() + b].astype(bool)
            pos_h = flat[toks.numel() + b:]
            wall_drain = now()
            chunk_dt = wall_drain - chunk_t0
            emitted = 0
            for slot in list(sched.running):
                req = sched.running[slot]
                if use_spec:
                    # toks_h[slot]: (chunk, 1+draft_k); emitted tokens
                    # form a prefix of each step row
                    for step_row in toks_h[slot]:
                        cnt = 0
                        for t in step_row:
                            if t != PAD_TOKEN:
                                req.generated.append(int(t))
                                cnt += 1
                        if cnt:
                            self.counters["spec_steps"] += 1
                            self.counters["spec_tokens"] += cnt
                            emitted += cnt
                else:
                    for t in toks_h[slot]:
                        if t != PAD_TOKEN:
                            req.generated.append(int(t))
                            emitted += 1
                o = self._req_obs.get(req.rid, {})
                if req.generated and "first" not in o:
                    o["first"] = wall_drain
                    mtr["ttft"].observe(wall_drain - o.get("ready", run_t0))
                if done_h[slot]:
                    n = len(req.generated)
                    if "first" in o and n > 1:
                        mtr["tpot"].observe(
                            (wall_drain - o["first"]) / (n - 1))
                    mtr["e2e"].observe(wall_drain - o.get("ready", run_t0))
                    mtr["finished"].inc()
                    mtr["generated_tokens"].add(n)
                    self.tracer.end(pid=pid, tid=slot)  # req span
                    sched.complete(slot)
                    if self.paged:
                        if (self.prefix_cache
                                and "positions" not in req.extras):
                            # publish generated pages too: multi-turn
                            # prompts extending this output will hit
                            self.kv.register_prefix(
                                slot, np.concatenate(
                                    [req.prompt,
                                     np.asarray(req.generated, np.int32)]))
                        self.kv.release(slot)
                elif self.paged and self.cfg.sliding_window is not None:
                    # positions behind pos - window are masked out of
                    # attention: release their pages back to the pool
                    self.counters["pages_trimmed"] += self.kv.trim(
                        slot, int(pos_h[slot]) - self.cfg.sliding_window)
            mtr["decode_time"].add(chunk_dt)
            mtr["chunk_hist"].observe(chunk_dt)
            mtr["decode_tokens"].add(emitted)
            self.steptrace.record(
                "spec_decode" if use_spec else "decode", chunk_dt,
                batch=live, steps=self.chunk, tokens=emitted,
                queue_depth=len(sched.waiting))
            self.tracer.complete(
                "decode_chunk", chunk_dt, pid=pid, tid=self._device_tid,
                cat="serve", args={"live": live, "tokens": emitted})
        return {r.rid: np.asarray(r.generated, np.int32)
                for r in sched.finished}

    # ------------------------------------------------------- legacy API

    def generate(self, params, batch: Dict[str, Any], *, max_new: int,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> Tensor:
        """Single-batch generation served by the engine: one request per
        row, whose extras are its rows of the other batch keys
        (``enc_feats`` (B, ...); mrope ``positions`` (3, B, S), batch on
        axis 1). Returns (B, max_new) int32 tokens on the CPU; rows that
        hit EOS early are padded with the EOS id."""
        tokens = np.asarray(batch["tokens"])
        b = tokens.shape[0]
        reqs = []
        for i in range(b):
            req = Request(rid=i, prompt=tokens[i], max_new=max_new)
            req.extras = {k: (np.asarray(v)[:, i:i + 1] if k == "positions"
                              else np.asarray(v)[i:i + 1])
                          for k, v in batch.items() if k != "tokens"}
            reqs.append(req)
        out = self.run(params, reqs, generator=generator,
                       temperature=temperature)
        pad = self.eos_id if self.eos_id is not None else 0
        rows: List[np.ndarray] = []
        for i in range(b):
            row = out[i]
            if len(row) < max_new:
                row = np.concatenate(
                    [row, np.full(max_new - len(row), pad, np.int32)])
            rows.append(row)
        return torch.from_numpy(np.stack(rows))

    def generate_pertoken(self, params, batch: Dict[str, Any], *,
                          max_new: int, temperature: float = 0.0,
                          generator: Optional[torch.Generator] = None
                          ) -> Tensor:
        """The reference's per-token loop: a dense prefill of the batch,
        then one decode call and one pick per token, with no scheduler.
        Kept as a cross-check oracle of ``generate``. Samples from
        ``generator`` when it is given and the temperature is > 0. The
        batch may carry ``enc_feats`` and mrope ``positions``. Returns
        (B, max_new) int32 tokens on the device."""
        dev_batch = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                     for k, v in batch.items()}
        dev_batch["tokens"] = dev_batch["tokens"].to(torch.int32)
        self._gen = generator
        temp = temperature if generator is not None else 0.0
        logits, cache = api.prefill_fn(params, dev_batch, self.cfg,
                                       self.ctx, self.window)
        out = []
        tok = self._pick(logits, temp)
        for _ in range(max_new):
            out.append(tok)
            logits, cache = api.decode_fn(params, tok, cache, self.cfg,
                                          self.ctx)
            tok = self._pick(logits, temp)
            self.counters["pertoken_steps"] += 1
        return torch.cat(out, dim=1)


def quantize_weights(params: Any, dtype: torch.dtype = torch.float8_e4m3fn
                     ) -> Any:
    """Weight-only storage quantization, as the reference's: every
    floating leaf with two or more dims is cast to ``dtype``, the tied
    embedding included; 1-D leaves (norm scales) keep theirs. The model
    casts each weight back to the compute dtype where it reads it. An
    int8 cast truncates toward zero, so small weights become 0 (the
    reference's storage demo)."""
    return tree_map(lambda p: p.to(dtype)
                    if p.dim() >= 2 and p.is_floating_point() else p, params)
