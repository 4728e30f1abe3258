"""Continuous-batching serving engine on the card.

Counterpart of ``repro/serving/engine.py`` for the blocking scheduler on
a contiguous KV cache. A slot-based engine in the vLLM style that
consumes its KV cache only through the :class:`~repro_torch.serving.
kv_cache.KVCacheManager` protocol:

- admission runs a request's whole prompt in one bucketed prefill
  (right-padded to a power of two from ``prefill_bucket_min``; logits
  are read at the prompt's last real position, pad KV is masked by the
  per-slot length), and retires it at once when the first token already
  ends it (budget, EOS, capacity);
- every engine step then issues exactly **one** ragged decode dispatch
  over all slots (``decode_dispatches`` counts them): each live slot
  advances at its own absolute position, free slots are frozen by the
  live mask. The dispatch reaches the split-KV decode kernel (K1), the
  prefill the flash kernel (K3), and every norm the RMSNorm kernel (K5);
- sampling is a greedy head outside the dispatch (argmax of the
  returned fp32 logits).

PyTorch runs eagerly, so a "dispatch" is one call of the model function
built by :func:`build_closures`. Telemetry, device meshes, prefix
caching, SLO preemption and speculative decoding are later slices.
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
from repro_torch.serving.kv_cache import contiguous_kv_bytes, make_kv_cache
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

    return {"prefill": prefill, "decode": decode}


@dataclass
class EngineConfig:
    max_batch: int = 8           # decode slots
    max_seq_len: int = 2048      # KV positions per request (capacity)
    eos_token: int = -1          # -1 -> never stops on a token
    max_new_tokens: int = 64
    prefill_bucket_min: int = 16  # smallest prompt bucket (power-of-two
                                  # buckets up from here); 0 disables
    kv_cache: str = "contiguous"  # "paged" is the next slice
    scheduler: str = "blocking"   # later slices: chunked, speculative, slo

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(
                f"max_batch={self.max_batch} must be >= 1 (the engine "
                "needs at least one decode slot)")
        if self.max_seq_len < 2:
            raise ValueError(
                f"max_seq_len={self.max_seq_len} must be >= 2 (one "
                "prompt position plus one decode position)")


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

    @property
    def ttft_s(self) -> float:
        """Time to the first sampled token."""
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
    def __init__(self, params, cfg, ecfg: EngineConfig, *, device="cuda"):
        MD.check_supported(cfg)
        self.device = resolve_device(device)
        where = params["embed"]["table"].device
        if where.type != self.device.type:
            raise ValueError(f"params live on {where}, the engine runs on "
                             f"{self.device}")
        self.cfg, self.ecfg, self.params = cfg, ecfg, params
        B = ecfg.max_batch
        self.kv = make_kv_cache(cfg, ecfg, self.device)
        self.scheduler = make_scheduler(cfg, ecfg)
        # host-side slot bookkeeping
        self.slot_req: list[Request | None] = [None] * B
        self.slot_len = np.zeros(B, np.int32)     # tokens generated
        self.slot_pos = np.zeros(B, np.int32)     # absolute position
        self.slot_tok = np.zeros((B, 1), np.int32)
        self.waiting: deque[Request] = deque()
        self.finished: list[Request] = []
        self.prefilling: dict[int, PrefillState] = {}  # chunked policy only
        self._next_rid = 0
        # dispatch accounting (the invariant: one decode dispatch a step)
        self.decode_dispatches = 0
        self.decode_steps = 0
        self.prefills = 0
        self._bucketed = ecfg.prefill_bucket_min > 0
        fns = build_closures(cfg)
        self._prefill_one, self._decode_ragged = fns["prefill"], fns["decode"]

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
        """One engine iteration: admit (whole-prompt prefills) -> one
        ragged decode dispatch -> retire."""
        self.scheduler.admit(self)
        live = np.array([r is not None and i not in self.prefilling
                         for i, r in enumerate(self.slot_req)])
        if live.any():
            self._decode_step(live)
        self.scheduler.retire(self)

    # -- internals ---------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy sampling head over the returned fp32 logits (first
        index on ties, like ``jnp.argmax``)."""
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def _decode_step(self, live):
        cache = self.kv.decode_view(self.slot_pos, live)
        dev = self.device
        logits, new_cache = self._decode_ragged(
            self.params, torch.from_numpy(self.slot_tok).to(dev), cache,
            torch.from_numpy(self.slot_pos).to(dev),
            torch.from_numpy(live).to(dev))
        self.kv.commit(new_cache)
        self.decode_dispatches += 1
        self.decode_steps += 1
        new = self._sample(logits)
        for i in np.nonzero(live)[0]:
            self.slot_req[i].output.append(int(new[i]))
            self.slot_tok[i, 0] = int(new[i])
            self.slot_len[i] += 1
            self.slot_pos[i] += 1

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
        """Blocking admission: the whole prompt in one bucketed prefill,
        then bind the request to ``slot``."""
        pro = self._admit_prologue(slot, req)
        if isinstance(pro, bool):
            return pro
        prompt, n_prompt, budget = pro
        toks = np.zeros(self._bucket_len(n_prompt), np.int32)
        toks[:n_prompt] = prompt   # right-pad to the bucket length
        batch = {"tokens": torch.from_numpy(toks[None, :]).to(self.device)}
        logits, rows = self._prefill_one(self.params, batch, n_prompt - 1)
        self.prefills += 1
        tok = int(self._sample(logits)[0])
        req.t_first = time.time()
        req.output.append(tok)
        # admit-time retirement: the prefill token may already end the
        # request — it never occupies a decode slot then
        if (budget <= 1 or tok == self.ecfg.eos_token
                or n_prompt >= self.ecfg.max_seq_len - 1):
            req.t_done = time.time()
            self.finished.append(req)
            return True
        self.kv.splice(rows, slot, n_prompt, budget)
        self.slot_req[slot] = req
        self.slot_len[slot] = 1
        self.slot_pos[slot] = n_prompt
        self.slot_tok[slot, 0] = tok
        return True

    def _retire_slot(self, i: int):
        req = self.slot_req[i]
        req.t_done = time.time()
        self.finished.append(req)
        self.slot_req[i] = None
        self.slot_len[i] = 0
        self.kv.free(i)

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
            "truncated": sum(r.truncated_from is not None for r in done),
            "kv_cache": self.kv.name,
            "resident_kv_bytes": self.kv.resident_kv_bytes(),
            "contiguous_kv_bytes": contiguous_kv_bytes(
                self.cfg, self.ecfg.max_batch, self.ecfg.max_seq_len),
        }
