"""Continuous-batching serving engine on the card.

Counterpart of ``repro/serving/engine.py`` (blocking, chunked and
speculative policies; contiguous and paged KV caches). A slot-based
engine in the vLLM style that consumes its KV cache only through the
:class:`~repro_torch.serving.kv_cache.KVCacheManager` protocol:

- blocking admission runs a request's whole prompt in one bucketed
  prefill (right-padded to a power of two from ``prefill_bucket_min``;
  logits are read at the prompt's last real position, pad KV is masked
  by the per-slot length), and retires it at once when the first token
  already ends it (budget, EOS, capacity);
- chunked admission only binds a slot; each step then runs at most one
  ``chunk_tokens`` prefill chunk over the slot's cached history
  (prefill over cache, K4), and the final chunk samples the first token;
- every engine step issues exactly **one** target dispatch over all
  decode slots (``decode_dispatches`` counts them): a ragged decode
  step (K1 on a contiguous cache, K2 on a paged one) or, speculating, a
  verify of every slot's ``gamma + 1`` candidate window (K4) after
  ``gamma`` draft dispatches of the self-draft. Each live slot advances
  at its own absolute position; free slots are frozen by the live mask.
  Prefill reaches the flash kernel (K3), every norm the RMSNorm kernel
  (K5);
- sampling is a greedy head outside the dispatch (argmax of the
  returned fp32 logits), so the committed speculative stream is the
  vanilla greedy stream.

PyTorch runs eagerly, so a "dispatch" is one call of a model function
built by :func:`build_closures`. Telemetry, device meshes, prefix
caching and SLO preemption are later slices.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as MD
from repro_torch.serving.kv_cache import (ContiguousCache,
                                          contiguous_kv_bytes, make_kv_cache)
from repro_torch.serving.scheduler import PrefillState, make_scheduler


def build_closures(cfg):
    """The engine's dispatch functions of ``(params, *operands)``, keyed
    by dispatch kind."""

    def prefill(params, batch, last_idx):
        """One bucketed whole-prompt prefill; returns (logits, rows) —
        the prompt's KV rows only, for the cache to splice."""
        return MD.prefill(params, cfg, batch, None, logit_index=last_idx)

    def decode(params, toks, cache, pos, live):
        """One fully ragged dispatch: every live slot advances at its own
        absolute position; non-live rows keep their KV exactly."""
        logits, new = MD.decode_step(params, cfg, toks,
                                     dict(cache, len=pos), live=live)
        new["len"] = cache["len"]  # positions are tracked host-side
        return logits, new

    def chunk_contiguous(params, batch, cache_k, cache_v, slot, hist_len,
                         logit_idx):
        """One prefill-chunk dispatch over a contiguous cache: the slot's
        rows are a view, not a copy."""
        return MD.prefill_chunk(params, cfg, batch,
                                cache_k[:, slot:slot + 1],
                                cache_v[:, slot:slot + 1], hist_len,
                                logit_index=logit_idx)

    def chunk_paged(params, batch, pool_k, pool_v, table, hist_len,
                    logit_idx):
        """Paged analogue: each layer gathers the slot's blocks through
        its table row into the dense history view, garbage blocks masked
        by ``hist_len``."""
        return MD.prefill_chunk(params, cfg, batch, pool_k, pool_v,
                                hist_len, logit_index=logit_idx,
                                block_table=table)

    def verify(params, toks, cache, pos, live):
        """One multi-token verify dispatch: every live slot's window of
        gamma + 1 candidates at its own position; rejected positions stay
        masked by the host-side length (rollback by bookkeeping)."""
        logits, new = MD.verify_tokens(params, cfg, toks,
                                       dict(cache, len=pos), live=live)
        new["len"] = cache["len"]
        return logits, new

    return {"prefill": prefill, "decode": decode,
            "chunk_contiguous": chunk_contiguous, "chunk_paged": chunk_paged,
            "verify": verify}


@dataclass
class EngineConfig:
    max_batch: int = 8           # decode slots
    max_seq_len: int = 2048      # KV positions per request (capacity)
    eos_token: int = -1          # -1 -> never stops on a token
    max_new_tokens: int = 64
    prefill_bucket_min: int = 16  # smallest prompt bucket (power-of-two
                                  # buckets up from here); 0 disables
    kv_cache: str = "contiguous"  # "contiguous" | "paged"
    kv_block_size: int = 16       # paged: positions per KV block
    kv_blocks: int = 0            # paged: pool size; 0 -> auto
                                  # (max_batch * max_seq_len / block_size)
    prefix_cache: bool = False    # later slice of the port (raises)
    scheduler: str = "blocking"   # "blocking" | "chunked" | "speculative"
                                  # ("slo" is a later slice)
    chunk_tokens: int = 64        # chunked: prompt tokens per chunk
    spec_gamma: int = 4           # speculative: draft tokens per step
    draft: str = "self"           # speculative draft: "self" (the
                                  # target's first k layers) or a
                                  # registry arch id sharing the vocab
    spec_draft_layers: int = 0    # self-draft depth; 0 -> n_layers // 2

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(
                f"max_batch={self.max_batch} must be >= 1 (the engine "
                "needs at least one decode slot)")
        if self.max_seq_len < 2:
            raise ValueError(
                f"max_seq_len={self.max_seq_len} must be >= 2 (one "
                "prompt position plus one decode position)")
        if self.scheduler not in ("blocking", "chunked", "speculative",
                                  "slo"):
            raise ValueError(f"unknown scheduler {self.scheduler!r} "
                             "(expected 'blocking', 'chunked', "
                             "'speculative' or 'slo')")
        if self.scheduler == "speculative" and self.spec_gamma < 1:
            raise ValueError(
                f"spec_gamma={self.spec_gamma} must be >= 1 (at least one "
                "draft token per verify step)")
        if self.scheduler == "chunked":
            if self.chunk_tokens < 1:
                raise ValueError(
                    f"chunk_tokens={self.chunk_tokens} must be >= 1")
            if (self.prefill_bucket_min > 0
                    and self.chunk_tokens % self.prefill_bucket_min):
                raise ValueError(
                    f"chunk_tokens={self.chunk_tokens} must be a multiple "
                    f"of the prefill bucket quantum (prefill_bucket_min="
                    f"{self.prefill_bucket_min})")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int | None = None
    # filled by the engine:
    output: list = field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    truncated_from: int | None = None  # original prompt length, if clipped
    prefill_chunks: int = 0            # prefill dispatches this request took
    spec_accepted: list = field(default_factory=list)
    # per-verify-round committed token counts; sums to len(output) - 1

    @property
    def ttft_s(self) -> float:
        """Time to the first sampled token (under chunked prefill: the
        end of the prompt's final chunk)."""
        return self.t_first - self.t_submit

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    @property
    def itl_s(self) -> float:
        """Mean inter-token latency over the decode phase."""
        n = len(self.output)
        return (self.t_done - self.t_first) / (n - 1) if n > 1 else 0.0


class ServingEngine:
    def __init__(self, params, cfg, ecfg: EngineConfig, *,
                 draft_params=None, draft_cfg=None, device="cuda"):
        MD.check_supported(cfg)
        self.device = resolve_device(device)
        where = params["embed"]["table"].device
        if where.type != self.device.type:
            raise ValueError(f"params live on {where}, the engine runs on "
                             f"{self.device}")
        if ecfg.prefix_cache:
            raise NotImplementedError(
                "prefix_cache (PrefixIndex: shared copy-on-write prompt "
                "blocks) is a later slice of the port")
        self.cfg, self.ecfg, self.params = cfg, ecfg, params
        B = ecfg.max_batch
        self.kv = make_kv_cache(cfg, ecfg, self.device)
        self.scheduler = make_scheduler(cfg, ecfg)
        # host-side slot bookkeeping
        self.slot_req: list[Request | None] = [None] * B
        self.slot_len = np.zeros(B, np.int32)     # tokens generated
        self.slot_pos = np.zeros(B, np.int32)     # absolute position
        self.slot_tok = np.zeros((B, 1), np.int32)
        self.slot_nprompt = np.zeros(B, np.int32)  # prompt length at bind
        self.waiting: deque[Request] = deque()
        self.finished: list[Request] = []
        self.prefilling: dict[int, PrefillState] = {}  # chunked policy
        self._next_rid = 0
        # dispatch accounting (the invariant: one target decode or verify
        # dispatch a step; chunk and draft dispatches counted apart)
        self.decode_dispatches = 0
        self.decode_steps = 0
        self.prefills = 0
        self.prefill_chunk_dispatches = 0
        self.draft_prefills = 0
        self.draft_dispatches = 0    # draft prefills + draft decodes
        self.verify_dispatches = 0
        self.spec_row_steps = 0      # (live row, verify step) events
        self.spec_drafted = 0        # candidate tokens proposed
        self.spec_committed = 0      # tokens committed by verify steps
        self.spec_draft_accepted = 0  # committed tokens that were drafted
        self._bucketed = ecfg.prefill_bucket_min > 0
        fns = build_closures(cfg)
        self._prefill_one, self._decode_ragged = fns["prefill"], fns["decode"]
        self._verify_ragged = fns["verify"]
        self._chunk_fns = {"contiguous": fns["chunk_contiguous"],
                           "paged": fns["chunk_paged"]}
        # speculative draft: a smaller model with its own contiguous
        # shadow cache of the committed sequence
        self.draft_params = self.draft_cfg = self.draft_kv = None
        self.draft_pos = np.zeros(B, np.int32)  # draft-valid KV per slot
        if self.scheduler.name == "speculative":
            self._init_draft(draft_params, draft_cfg)

    def _init_draft(self, draft_params, draft_cfg):
        """Resolve the draft: explicit params, a registry arch id (smoke
        size, seeded init, sharing the target's vocab), or the self-draft
        reusing the target's first k layers."""
        cfg, ecfg = self.cfg, self.ecfg
        if draft_params is not None:
            dcfg = draft_cfg or cfg
        elif ecfg.draft == "self":
            k = ecfg.spec_draft_layers or max(1, cfg.n_layers // 2)
            draft_params, dcfg = MD.self_draft_params(self.params, cfg, k)
        else:
            from repro_torch.configs import registry
            dcfg = registry.get_smoke_config(ecfg.draft).replace(
                dtype=cfg.dtype)
            draft_params = MD.init_params(dcfg, device=self.device)
        if dcfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}: speculative acceptance compares "
                "token ids, the models must share a tokenizer")
        MD.check_supported(dcfg)
        self.draft_params, self.draft_cfg = draft_params, dcfg
        self.draft_kv = ContiguousCache(dcfg, ecfg, self.device)
        fns = build_closures(dcfg)
        self._draft_prefill, self._draft_decode = (fns["prefill"],
                                                   fns["decode"])

    # -- public API -----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int | None = None) -> Request:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.shape[0] == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token array, "
                             f"got shape {prompt.shape}")
        req = Request(self._next_rid, prompt, max_new_tokens,
                      t_submit=time.time())
        self._next_rid += 1
        self.waiting.append(req)
        return req

    def has_work(self) -> bool:
        return bool(self.waiting or any(r is not None for r in self.slot_req))

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive until all submitted requests finish. Returns finished."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    def step(self):
        """One engine iteration: admit -> at most one prefill-chunk
        dispatch -> one ragged decode (or draft + verify) dispatch ->
        retire."""
        self.scheduler.admit(self)
        chunk_slot = self.scheduler.select_chunk(self)
        if chunk_slot is not None:
            self._run_chunk(chunk_slot)
        live = np.array([r is not None and i not in self.prefilling
                         for i, r in enumerate(self.slot_req)])
        if live.any():
            if self.draft_kv is not None:
                self._spec_step(live)
            else:
                self._decode_step(live)
        self.scheduler.retire(self)

    # -- internals ---------------------------------------------------------
    def _t(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the engine's device (on the CPU it
        shares the array's memory: never mutate an array a dispatch still
        reads — rebind it)."""
        return torch.from_numpy(a).to(self.device)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy sampling head over the returned fp32 logits (first
        index on ties, like ``jnp.argmax``)."""
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def _decode_step(self, live):
        cache = self.kv.decode_view(self.slot_pos, live)
        logits, new_cache = self._decode_ragged(
            self.params, self._t(self.slot_tok), cache,
            self._t(self.slot_pos), self._t(live))
        self.kv.commit(new_cache)
        self.decode_dispatches += 1
        self.decode_steps += 1
        new = self._sample(logits)
        for i in np.nonzero(live)[0]:
            self.slot_req[i].output.append(int(new[i]))
            self.slot_tok[i, 0] = int(new[i])
            self.slot_len[i] += 1
            self.slot_pos[i] += 1

    def _spec_step(self, live):
        """One speculative step: ``chain`` draft proposals per live slot
        (draft dispatches), then one target dispatch verifying every
        slot's window at its own position, then host-side longest-
        accepted-prefix commit with rollback. Candidate i commits iff it
        equals the target's argmax after candidate i - 1, and the first
        mismatch is replaced by that argmax, so the committed stream is
        the vanilla greedy stream."""
        B, C = self.ecfg.max_batch, self.ecfg.max_seq_len
        g = self.ecfg.spec_gamma
        # per-row commit cap: what budget and capacity let the row commit
        n_write = np.minimum(
            g + 1, np.maximum(
                1, np.minimum(
                    np.array([self._budget(r) if r is not None else 1
                              for r in self.slot_req]) - self.slot_len,
                    (C - 1) - self.slot_pos)))
        # candidates past the batch-wide cap can never commit: the
        # window is dispatched at width chain + 1
        chain = min(g, int(n_write[live].max()) - 1)
        cand = np.zeros((B, chain), np.int32)
        if chain > 0:
            # draft catch-up: a fully accepted round leaves the draft one
            # committed token behind; feed it through before proposing
            catch = live & (self.draft_pos < self.slot_pos)
            if catch.any():
                toks = np.zeros((B, 1), np.int32)
                for i in np.nonzero(catch)[0]:
                    req = self.slot_req[i]
                    toks[i, 0] = req.output[
                        int(self.draft_pos[i]) - int(self.slot_nprompt[i])]
                self._draft_dispatch(toks, catch)
                # rebind, never bump in place: on the CPU the dispatch's
                # position tensor shares this array's memory
                self.draft_pos = self.draft_pos + catch
            cur = self.slot_tok.copy()
            for t in range(chain):
                nxt = self._sample(self._draft_dispatch(cur, live))
                cand[:, t] = nxt
                cur = nxt[:, None].astype(np.int32)
                self.draft_pos = self.draft_pos + live  # rebind (above)
            self.spec_drafted += chain * int(live.sum())
        self._spec_verify_commit(live, cand, n_write, chain)

    def _spec_verify_commit(self, live, cand, n_write, chain):
        """The verify half of a speculative step: one target dispatch
        over every live row's (pending token + ``chain`` candidates)
        window, then commit and rollback."""
        toks = np.concatenate([self.slot_tok, cand], axis=1)  # (B, chain+1)
        cache = self.kv.verify_view(self.slot_pos, live,
                                    np.minimum(n_write, chain + 1))
        logits, new_cache = self._verify_ragged(
            self.params, self._t(toks), cache, self._t(self.slot_pos),
            self._t(live))
        self.kv.commit(new_cache)
        self.decode_dispatches += 1
        self.decode_steps += 1
        self.verify_dispatches += 1
        self.spec_row_steps += int(live.sum())
        greedy = self._sample(logits)                        # (B, chain+1)
        for i in np.nonzero(live)[0]:
            req = self.slot_req[i]
            a = 0
            while a < chain and cand[i, a] == greedy[i, a]:
                a += 1
            stream = list(cand[i, :a]) + [int(greedy[i, a])]
            committed = []
            for tok in stream[:int(n_write[i])]:
                committed.append(int(tok))
                if tok == self.ecfg.eos_token:
                    break  # vanilla stops after emitting EOS
            n = len(committed)
            req.output.extend(committed)
            req.spec_accepted.append(n)
            self.spec_committed += n
            self.spec_draft_accepted += min(n, a)
            p = int(self.slot_pos[i])
            self.slot_pos[i] = p + n
            self.slot_len[i] += n
            self.slot_tok[i, 0] = committed[-1]
            # target KV valid through the accepted prefix; the draft
            # through the committed tokens it consumed (chain of them)
            self.kv.commit_n(i, p + n)
            self.draft_pos[i] = p + min(chain, n)

    def _draft_dispatch(self, toks, live):
        """One ragged draft-model decode dispatch (chain or catch-up)."""
        cache = self.draft_kv.decode_view(self.draft_pos, live)
        logits, new_cache = self._draft_decode(
            self.draft_params, self._t(toks), cache,
            self._t(self.draft_pos), self._t(live))
        self.draft_kv.commit(new_cache)
        self.draft_dispatches += 1
        return logits

    def _budget(self, req: Request) -> int:
        """Generation budget; an explicit 0 means zero tokens."""
        return (req.max_new_tokens if req.max_new_tokens is not None
                else self.ecfg.max_new_tokens)

    def _prompt_cap(self) -> int:
        """Max admissible prompt tokens: capacity less one decode slot."""
        return self.ecfg.max_seq_len - 1

    def _bucket_len(self, n: int) -> int:
        """Smallest power-of-two bucket >= n (floor ``prefill_bucket_min``),
        capped at the prompt capacity; exact length when bucketing is off."""
        cap = self._prompt_cap()
        if not self._bucketed:
            return min(n, cap)
        b = self.ecfg.prefill_bucket_min
        while b < n:
            b *= 2
        return min(b, cap)

    def _admit_prologue(self, slot: int, req: Request):
        """Zero-budget insta-finish, truncation, capacity check. Returns
        ``(prompt, n_prompt, budget)`` to proceed, ``True`` when the
        request was consumed, ``False`` to defer it."""
        budget = self._budget(req)
        if budget <= 0:
            req.t_first = req.t_done = time.time()
            self.finished.append(req)
            return True
        cap = self._prompt_cap()
        prompt = req.prompt
        if int(prompt.shape[0]) > cap:
            req.truncated_from = int(prompt.shape[0])
            warnings.warn(
                f"request {req.rid}: prompt truncated from "
                f"{req.truncated_from} to {cap} tokens "
                f"(max_seq_len={self.ecfg.max_seq_len})", stacklevel=5)
            prompt = prompt[:cap]
        n_prompt = int(prompt.shape[0])
        if not self.kv.can_admit(n_prompt, budget):
            return False
        return prompt, n_prompt, budget

    def _admit_one(self, slot: int, req: Request) -> bool:
        """Blocking admission: the whole prompt in one bucketed prefill
        (and the draft's, when speculating), then bind the request to
        ``slot``."""
        pro = self._admit_prologue(slot, req)
        if isinstance(pro, bool):
            return pro
        prompt, n_prompt, budget = pro
        toks = np.zeros(self._bucket_len(n_prompt), np.int32)
        toks[:n_prompt] = prompt   # right-pad to the bucket length
        batch = {"tokens": torch.from_numpy(toks[None, :]).to(self.device)}
        logits, rows = self._prefill_one(self.params, batch, n_prompt - 1)
        self.prefills += 1
        req.prefill_chunks = 1
        tok = self._sample_first(req, logits)
        # admit-time retirement: the prefill token may already end the
        # request — it never occupies a decode slot then
        if (budget <= 1 or tok == self.ecfg.eos_token
                or n_prompt >= self.ecfg.max_seq_len - 1):
            req.t_done = time.time()
            self.finished.append(req)
            return True
        self.kv.splice(rows, slot, n_prompt, budget)
        if self.draft_kv is not None:
            # the draft shadows the committed sequence: prefill its cache
            # over the same bucketed batch
            _, drows = self._draft_prefill(self.draft_params, batch,
                                           n_prompt - 1)
            self.draft_kv.splice(drows, slot, n_prompt, budget)
            self.draft_prefills += 1
            self.draft_dispatches += 1
            self.draft_pos[slot] = n_prompt
        self._bind_decode(slot, req, tok, n_prompt)
        return True

    def _start_prefill(self, slot: int, req: Request) -> bool:
        """Chunked admission: bind ``req`` to ``slot`` and reserve its
        worst-case cache capacity — no dispatch; ``_run_chunk`` streams
        the prompt in over the following steps."""
        pro = self._admit_prologue(slot, req)
        if isinstance(pro, bool):
            return pro
        prompt, n_prompt, budget = pro
        self.kv.reserve(slot, n_prompt, budget)
        self.slot_req[slot] = req
        self.prefilling[slot] = PrefillState(
            prompt=np.asarray(prompt, np.int32), n_prompt=n_prompt,
            budget=budget)
        return True

    def _run_chunk(self, slot: int):
        """The next prefill chunk of ``slot``: one dispatch over (chunk
        tokens) x (cached history), the chunk's KV written at the running
        offset, and — on the final chunk — the first token sampled and
        the slot handed to the decode phase."""
        st = self.prefilling[slot]
        req = self.slot_req[slot]
        ct = self.ecfg.chunk_tokens
        n_tok = min(ct, st.n_prompt - st.done)
        toks = np.zeros(ct, np.int32)
        toks[:n_tok] = st.prompt[st.done:st.done + n_tok]
        batch = {"tokens": torch.from_numpy(toks[None, :]).to(self.device)}
        final = st.done + n_tok >= st.n_prompt
        # logits at the prompt's last position, chunk-local index
        # n_prompt - 1 - done (only read on the final chunk)
        logit_idx = st.n_prompt - 1 - st.done if final else 0
        view = self.kv.chunk_view(slot)
        sel = view["slot"] if view["kind"] == "contiguous" else view["table"]
        logits, ks, vs = self._chunk_fns[view["kind"]](
            self.params, batch, view["k"], view["v"], sel, st.done,
            logit_idx)
        self.kv.splice_partial(ks, vs, slot, st.done, n_tok)
        self.prefill_chunk_dispatches += 1
        req.prefill_chunks += 1
        st.done += n_tok
        if not final:
            return
        del self.prefilling[slot]
        tok = self._sample_first(req, logits)
        if (st.budget <= 1 or tok == self.ecfg.eos_token
                or st.n_prompt >= self.ecfg.max_seq_len - 1):
            req.t_done = time.time()
            self.finished.append(req)
            self.slot_req[slot] = None
            self.kv.free(slot)
            return
        self._bind_decode(slot, req, tok, st.n_prompt)

    def _sample_first(self, req: Request, logits) -> int:
        """The prompt's first token from prefill logits; stamps
        ``t_first`` (TTFT is measured here, never at an earlier chunk)."""
        tok = int(self._sample(logits)[0])
        req.t_first = time.time()
        req.output.append(tok)
        return tok

    def _bind_decode(self, slot: int, req: Request, tok: int, n_prompt: int):
        """Hand a freshly prefilled request to the decode phase."""
        self.slot_req[slot] = req
        self.slot_len[slot] = 1
        self.slot_pos[slot] = n_prompt
        self.slot_tok[slot, 0] = tok
        self.slot_nprompt[slot] = n_prompt

    def _retire_slot(self, i: int):
        req = self.slot_req[i]
        req.t_done = time.time()
        self.finished.append(req)
        self.slot_req[i] = None
        self.slot_len[i] = 0
        self.kv.free(i)
        if self.draft_kv is not None:
            self.draft_kv.free(i)
            self.draft_pos[i] = 0

    # -- metrics ---------------------------------------------------------------
    def summary(self) -> dict:
        """Serving report; the key set is the same with zero finished
        requests (zero defaults) as with N."""
        done = self.finished
        n = len(done)
        lat = [r.latency_s for r in done]
        ttft = [r.ttft_s for r in done]
        itl = [r.itl_s for r in done if len(r.output) > 1]
        toks = sum(len(r.output) for r in done)
        wall = (max(r.t_done for r in done)
                - min(r.t_submit for r in done)) if done else 0.0
        spec = self.draft_kv is not None
        draft_bytes = self.draft_kv.peak_resident_kv_bytes if spec else 0

        def pct(vals, q):
            return float(np.percentile(vals, q)) if vals else 0.0

        return {
            "requests": n,
            "tokens": toks,
            "tokens_per_s": ((toks / wall if wall > 0 else float("inf"))
                             if done else 0.0),
            "qps": (n / wall if wall > 0 else float("inf")) if done else 0.0,
            "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
            "ttft_p50_s": pct(ttft, 50),
            "ttft_p99_s": pct(ttft, 99),
            "mean_itl_s": float(np.mean(itl)) if itl else 0.0,
            "itl_p50_s": pct(itl, 50),
            "itl_p99_s": pct(itl, 99),
            "scheduler": self.scheduler.name,
            "decode_dispatches": self.decode_dispatches,
            "decode_steps": self.decode_steps,
            "dispatches_per_step": (self.decode_dispatches
                                    / max(1, self.decode_steps)),
            "prefills": self.prefills,
            "prefill_chunks": sum(r.prefill_chunks for r in done),
            "prefill_chunk_dispatches": self.prefill_chunk_dispatches,
            # speculative accounting: verify is the one target dispatch
            # of its step; the draft's dispatches are counted apart
            "verify_dispatches": self.verify_dispatches,
            "draft_prefills": self.draft_prefills,
            "draft_dispatches": self.draft_dispatches,
            "spec_gamma": self.ecfg.spec_gamma if spec else 0,
            "spec_row_steps": self.spec_row_steps,
            "spec_committed": self.spec_committed,
            "accepted_tokens_per_step": (
                self.spec_committed / max(1, self.spec_row_steps)
                if spec else 1.0),
            "acceptance_rate": (
                self.spec_draft_accepted / max(1, self.spec_drafted)
                if spec else 0.0),
            "truncated": sum(r.truncated_from is not None for r in done),
            "kv_cache": self.kv.name,
            "resident_kv_bytes": self.kv.resident_kv_bytes(),
            # high-water mark of the target cache plus the draft's
            # contiguous shadow cache, against the dense charge
            "peak_resident_kv_bytes": (self.kv.peak_resident_kv_bytes
                                       + draft_bytes),
            "draft_kv_bytes": draft_bytes,
            "contiguous_kv_bytes": contiguous_kv_bytes(
                self.cfg, self.ecfg.max_batch, self.ecfg.max_seq_len),
        }
