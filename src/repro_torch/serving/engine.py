"""Continuous-batching serving engine on the card.

Counterpart of ``repro/serving/engine.py`` (blocking, chunked and
speculative policies; contiguous and paged KV caches). A slot-based
engine in the vLLM style that consumes its KV cache only through the
:class:`~repro_torch.serving.kv_cache.KVCacheManager` protocol:

- blocking admission runs a request's whole prompt in one bucketed
  prefill (right-padded to a power of two from ``prefill_bucket_min``;
  logits are read at the prompt's last real position, pad KV is masked
  by the per-slot length — except on a rolling sliding-window cache,
  whose prompts run at their exact length, since pads would roll into
  the window), and retires it at once when the first token already ends
  it (budget, EOS, capacity);
- chunked admission only binds a slot; each step then runs at most one
  ``chunk_tokens`` prefill chunk over the slot's cached history
  (prefill over cache, K4), and the final chunk samples the first token;
- every engine step issues exactly **one** target dispatch over all
  decode slots (``decode_dispatches`` counts them): a ragged decode
  step (K1 on a contiguous cache, K2 on a paged one) or, speculating, a
  verify of every slot's ``gamma + 1`` candidate window (K4) after
  ``gamma`` draft dispatches of the self-draft. Each live slot advances
  at its own absolute position; free slots are frozen by the live mask.
  Prefill reaches the flash kernel (K3), every RMSNorm the RMSNorm
  kernel (K5). The dense, MoE and vlm families run, with or without a
  rolling sliding window, whisper's encoder–decoder, and the recurrent
  families (xLSTM; Zamba2, whose shared attention block reaches K3 and
  K1), whose state a length-masked prefill keeps exact under
  bucketing; a vlm prompt's
  stub image prefix (zeros) takes the cache positions before its
  tokens and is counted in its length, and a whisper prompt's stub
  frames (zeros, ``encoder_len`` of them) feed the encoder at its
  admission. Where the paged layout or a policy cannot express the
  model (whisper, a rolling window, recurrent state), the engine falls
  back to the contiguous cache and to blocking admission, warning as
  the reference does;
- sampling is a head outside the dispatch over the returned fp32
  logits (:func:`make_sampler`): ``"greedy"`` (argmax; the committed
  speculative stream is then the vanilla greedy stream) or
  ``"temperature"`` (temperature and an optional top-k cut, one draw
  per row keyed by (seed, request id, absolute position), so a
  request's stream does not depend on its slot, its batch, the KV
  backend or a preemption);
- prefix caching (paged): a warm admission splices the cached
  block-aligned prefix and prefills only the suffix, in one chunk
  dispatch over the shared history (K4); a cold one publishes its full
  prompt blocks;
- the SLO policy preempts a live slot to a host :class:`SlotPacket`
  (``export_slot``) and later resumes it from its exact position
  (``import_slot``), losing no token;
- telemetry (:mod:`~repro_torch.serving.telemetry`): spans, metrics and
  per-dispatch wall times, off by default and then free of any host
  synchronisation.

PyTorch runs eagerly, so a "dispatch" is one call of a model function
built by :func:`build_closures`.

``EngineConfig.mesh = (data, model)`` serves every family over a
:class:`~repro_torch.distributed.mesh.DeviceMesh` of ``data * model``
devices (``ServingEngine(..., devices=)``; the first CUDA devices by
default, and a name may repeat — several shards on one device). Each
data replica serves ``max_batch / data`` of the slots (every slot, where
the batch does not divide over ``data``: the cache then splits its
positions over every axis); within it the ``model`` ranks hold the
serve-mode shards of :mod:`~repro_torch.distributed.sharding` and run
the unchanged model functions, one worker thread each, meeting at the
gathers of :mod:`~repro_torch.distributed.hints` — the recurrent
sublayers whole on every model rank, whisper's encoder at admission on
every rank of the replica, a model over the serve budget gathering
each layer's ``data`` shards at use (every rank then runs every
dispatch). Every dispatch is one ``DeviceMesh.run`` — still one target
dispatch a step — and the host scheduler and bookkeeping exist once.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import hints as H
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import DeviceMesh, PerRank, mesh_devices
from repro_torch.models import model as MD
from repro_torch.models.layers import dtype_of
from repro_torch.serving.kv_cache import (ContiguousCache,
                                          MeshContiguousCache,
                                          contiguous_kv_bytes,
                                          make_kv_cache)
from repro_torch.serving.scheduler import PrefillState, make_scheduler
from repro_torch.serving.telemetry import NULL_TELEMETRY


def build_closures(cfg):
    """The engine's dispatch functions of ``(params, *operands)``, keyed
    by dispatch kind."""

    masked = cfg.family in MD.RECURRENT_FAMILIES

    def prefill(params, batch, last_idx, n_valid):
        """One bucketed whole-prompt prefill; returns (logits, rows) —
        the prompt's KV rows only, and a recurrent family's state, for
        the cache to splice. A recurrent family's scan is length-masked
        at ``n_valid``: pad steps leave its state as they found it."""
        return MD.prefill(params, cfg, batch, None, logit_index=last_idx,
                          length=n_valid if masked else None)

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


_M32 = 0xFFFFFFFF

# the dispatch kinds that serve one request (one slot): on a mesh their
# logits come from the slot's data replica
_ONE_REQUEST = ("prefill", "draft_prefill", "chunk_contiguous",
                "chunk_paged")


def stub_frames(cfg, device) -> torch.Tensor | None:
    """Whisper's stub encoder input: one row of zero frame embeddings
    (1, encoder_len, d_model) in the model's dtype, as the reference
    engine feeds it; None for the other families."""
    if cfg.family != "audio":
        return None
    return torch.zeros((1, cfg.encoder_len, cfg.d_model),
                       dtype=dtype_of(cfg), device=device)


def stub_images(cfg, device) -> torch.Tensor | None:
    """A vlm's stub image prefix: one row of zeros (1, n_image_tokens,
    d_model) in the model's dtype; None for the other families."""
    if cfg.family != "vlm":
        return None
    return torch.zeros((1, cfg.n_image_tokens, cfg.d_model),
                       dtype=dtype_of(cfg), device=device)


def _mulmod32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 tensors holding 32-bit values, in
    16-bit halves so that no product overflows int64."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser: a bijection of [0, 2**32) with full
    avalanche, elementwise (no state, the same on every device)."""
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mulmod32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def draw_keys(seeds, rids, pos, device) -> torch.Tensor:
    """(B,) 32-bit stream keys folding in the seed, then the request id,
    then the absolute position, as the reference folds them into its
    PRNG key."""
    k = _mix32(torch.as_tensor(np.asarray(seeds, np.int64), device=device)
               & _M32)
    for x in (rids, pos):
        k = _mix32(k ^ (torch.as_tensor(np.asarray(x, np.int64),
                                        device=device) & _M32))
    return k


def vocab_keys(vocab: int, device) -> torch.Tensor:
    """(V,) 32-bit keys of the vocabulary indices (built once a head)."""
    return _mix32(torch.arange(vocab, dtype=torch.int64, device=device)
                  + 0x9E3779B9)


def gumbel_draw(lg: torch.Tensor, keys: torch.Tensor,
                vkeys: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row of ``lg`` (B, V) by Gumbel-max:
    ``argmax(lg + g)`` with ``g = -log(-log(u))`` and ``u`` a stateless
    hash of (row key, vocab key) — one batched pass, no generator."""
    bits = _mix32(keys[:, None] ^ vkeys[None, :])
    u = (bits.to(torch.float64) + 0.5) / 2.0 ** 32       # in (0, 1)
    return torch.argmax(lg.to(torch.float64) - torch.log(-torch.log(u)), -1)


def top_k_cut(lg: torch.Tensor, k: int) -> torch.Tensor:
    """With ``0 < k < V``: every logit below the row's k-th largest set to
    -inf; ties with it are kept (the reference's threshold cut, not a
    gather of k indices)."""
    if not 0 < k < lg.shape[-1]:
        return lg
    kth = torch.topk(lg, k, dim=-1).values[..., -1:]
    return torch.where(lg < kth, float("-inf"), lg)


def make_sampler(ecfg):
    """The sampling head over returned logits, ``(logits, seeds, rids,
    pos) -> int32 token ids`` on the host; outside the model dispatches,
    so backends and layouts can never perturb token selection.

    ``"greedy"``: argmax (first index on ties, like ``jnp.argmax``).
    ``"temperature"``: logits / max(temperature, 1e-6), then
    :func:`top_k_cut`, then one draw per row keyed by (seed, rid, pos)
    (:func:`gumbel_draw`). JAX's PRNG stream is not reproduced: sampled
    streams are held to self-consistency."""
    mode = ecfg.sample
    if mode == "greedy":
        def sample(logits, seeds, rids, pos):
            return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        return sample
    if mode == "temperature":
        temp = float(max(ecfg.temperature, 1e-6))
        top_k = int(ecfg.top_k)
        vkeys = {}   # (V, device) -> vocab_keys

        def sample(logits, seeds, rids, pos):
            lg = top_k_cut(logits.to(torch.float32) / temp, top_k)
            at = (lg.shape[-1], lg.device)
            if at not in vkeys:
                vkeys[at] = vocab_keys(*at)
            keys = draw_keys(seeds, rids, pos, lg.device)
            return gumbel_draw(lg, keys, vkeys[at]).to(
                torch.int32).cpu().numpy()
        return sample
    raise ValueError(f"unknown sample mode {mode!r}")


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one dispatch operand (the audit-log entry)."""
    shape: tuple
    dtype: torch.dtype


def operand_spec(x):
    """``x`` with every tensor replaced by its :class:`TensorSpec`."""
    if isinstance(x, torch.Tensor):
        return TensorSpec(tuple(x.shape), x.dtype)
    if isinstance(x, dict):
        return {k: operand_spec(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(operand_spec(v) for v in x)
    return x


@dataclass
class EngineConfig:
    max_batch: int = 8           # decode slots
    max_seq_len: int = 2048      # KV positions per request (capacity)
    eos_token: int = -1          # -1 -> never stops on a token
    max_new_tokens: int = 64
    sample: str = "greedy"       # "greedy" | "temperature"
    temperature: float = 1.0     # sampling temperature (sample="temperature")
    top_k: int = 0               # 0 -> full vocab
    seed: int = 0                # base sampling seed (per-request override
                                 # via ``submit(..., seed=)``)
    prefill_bucket_min: int = 16  # smallest prompt bucket (power-of-two
                                  # buckets up from here); 0 disables
    kv_cache: str = "contiguous"  # "contiguous" | "paged"
    kv_block_size: int = 16       # paged: positions per KV block
    kv_blocks: int = 0            # paged: pool size; 0 -> auto
                                  # (max_batch * max_seq_len / block_size)
    prefix_cache: bool = False    # paged: hash-based prefix caching —
                                  # admissions splice shared immutable
                                  # blocks for the longest cached
                                  # block-aligned prompt prefix and
                                  # prefill only the suffix. Ignored by
                                  # contiguous backends and the
                                  # speculative policy (the draft's
                                  # shadow cache needs the whole prompt)
    scheduler: str = "blocking"   # "blocking" | "chunked" |
                                  # "speculative" | "slo"
    chunk_tokens: int = 64        # chunked: prompt tokens per chunk
    spec_gamma: int = 4           # speculative: draft tokens per step
    draft: str = "self"           # speculative draft: "self" (the
                                  # target's first k layers) or a
                                  # registry arch id sharing the vocab
    spec_draft_layers: int = 0    # self-draft depth; 0 -> n_layers // 2
    mesh: tuple | None = None     # (data, model): serve over a device
                                  # mesh — each data replica max_batch /
                                  # data slots, weights and KV heads
                                  # split over model (the serve-mode
                                  # sharding rules); None -> one device

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
        if self.scheduler == "speculative":
            if self.spec_gamma < 1:
                raise ValueError(
                    f"spec_gamma={self.spec_gamma} must be >= 1 (at least "
                    "one draft token per verify step)")
            if self.sample != "greedy":
                raise ValueError(
                    "speculative decoding requires sample='greedy': "
                    "longest-accepted-prefix verification is exact only "
                    "against the target argmax (stochastic acceptance "
                    "would need rejection sampling)")
        if self.mesh is not None:
            m = tuple(int(x) for x in self.mesh)
            if len(m) != 2 or any(x < 1 for x in m):
                raise ValueError(
                    f"mesh={self.mesh!r} must be a (data, model) pair "
                    "of positive axis sizes")
            self.mesh = m
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
    seed: int | None = None            # per-request sampling seed
    # multi-tenant workload attribution (serving/workload.py traces):
    tenant: str = ""                   # tenant name ("" = untagged)
    priority: int = 0                  # higher preempts lower (SLO policy)
    slo: object | None = None          # scheduler.SLO TTFT/ITL targets
    arrival_s: float | None = None     # trace arrival time (virtual clock)
    # filled by the engine:
    output: list = field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    truncated_from: int | None = None  # original prompt length, if clipped
    prefill_chunks: int = 0            # prefill dispatches this request took
    preemptions: int = 0               # times evicted to the queue and
                                       # later resumed
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

    @property
    def slo_met(self) -> bool:
        """Whether the measured TTFT/ITL hit the request's targets
        (vacuously true without an SLO)."""
        if self.slo is None:
            return True
        return (self.ttft_s <= self.slo.ttft_s + 1e-9
                and self.itl_s <= self.slo.itl_s + 1e-9)


@dataclass
class SlotPacket:
    """Host-side snapshot of one live decode slot: everything needed to
    resume the stream later (SLO preemption) or elsewhere. ``kv`` is the
    backend-portable ``export_slot`` payload. Sampling is keyed by
    (seed, rid, position), so resuming is bitwise the same as never
    having moved."""
    req: Request
    seed: int
    tok: int          # pending input token (last sampled)
    pos: int          # absolute position
    gen_len: int      # tokens generated so far
    n_prompt: int     # prompt length at bind
    budget: int       # generation budget
    kv: dict          # export_slot payload (host tensors + metadata)
    hops: int = 0     # migrations this stream has survived


def request_breakdowns(done) -> dict:
    """Per-tenant and per-priority latency/SLO breakdowns over finished
    requests."""
    def pct(vals, q):
        return float(np.percentile(vals, q)) if vals else 0.0

    def bucket(key_fn):
        groups: dict = {}
        for r in done:
            groups.setdefault(key_fn(r), []).append(r)
        out = {}
        for k in sorted(groups, key=str):
            rs = groups[k]
            ttft = [r.ttft_s for r in rs]
            itl = [r.itl_s for r in rs if len(r.output) > 1]
            out[k] = {
                "requests": len(rs),
                "ttft_p50_s": pct(ttft, 50),
                "ttft_p99_s": pct(ttft, 99),
                "itl_p50_s": pct(itl, 50),
                "itl_p99_s": pct(itl, 99),
                "preemptions": sum(r.preemptions for r in rs),
                "slo_attainment": sum(r.slo_met for r in rs) / len(rs),
            }
        return out

    return {"by_tenant": bucket(lambda r: r.tenant or "default"),
            "by_priority": bucket(lambda r: r.priority)}


def shard_cfg(cfg, layout: str, model: int):
    """The config a rank's model functions run with: its own query and KV
    heads in the ``"heads"`` layout, every width global otherwise."""
    if layout != "heads" or model == 1:
        return cfg
    return cfg.replace(n_heads=cfg.n_heads // model,
                       n_kv_heads=cfg.n_kv_heads // model)


def place_params(params, cfg, mesh) -> tuple:
    """(per-rank param trees, their serve placement's spec tree):
    ``params`` as given when it is already one tree per rank
    (:func:`~repro_torch.distributed.sharding.init_params_sharded`, or
    a whole tree cut by ``shard_tree``) under the placement its shapes
    match (:func:`~repro_torch.distributed.sharding.
    infer_serve_specs`), else a whole tree cut by the serve rules."""
    if isinstance(params, (list, tuple)):
        if len(params) != mesh.size:
            raise ValueError(f"{len(params)} per-rank param trees for a "
                             f"mesh of {mesh.size} ranks")
        return PerRank(params), SH.infer_serve_specs(params[0], cfg, mesh)
    specs = SH.serve_specs(params, mesh)
    return PerRank(SH.shard_params(params, cfg, mesh, specs)), specs


class ServingEngine:
    def __init__(self, params, cfg, ecfg: EngineConfig, *,
                 draft_params=None, draft_cfg=None, device="cuda",
                 devices=None, telemetry=None,
                 telemetry_label: str | None = None):
        MD.check_supported(cfg)
        # tensor- and data-parallel serving: ``ecfg.mesh`` places this
        # engine on a (data, model) mesh of ``devices`` (the first CUDA
        # devices by default; the cluster hands each worker a disjoint
        # group) under the serve-mode sharding rules
        self.mesh = None
        # a placement that splits weights over data: the hints gather a
        # layer's shards at use (None where every rank holds its own)
        self._gather_specs = self._draft_gather = None
        self._self_draft = False   # the draft is the target's first layers
        self._dispatch_group = 0   # the data replica of a one-request call
        if ecfg.mesh is not None:
            self.mesh = DeviceMesh(ecfg.mesh,
                                   mesh_devices(ecfg.mesh, devices))
            self.device = self.mesh.devices[0]
            params, specs = place_params(params, cfg, self.mesh)
            if SH.splits_over_data(specs, self.mesh):
                self._gather_specs = specs
        else:
            self.device = resolve_device(device)
            where = params["embed"]["table"].device
            if where.type != self.device.type:
                raise ValueError(f"params live on {where}, the engine runs "
                                 f"on {self.device}")
        self.cfg, self.ecfg, self.params = cfg, ecfg, params
        # a shared telemetry hub; the disabled singleton by default, when
        # every hook is a no-op and nothing synchronises the card
        self.telemetry = NULL_TELEMETRY if telemetry is None else telemetry
        self.tel_label = telemetry_label or "engine"
        B = ecfg.max_batch
        self.kv = make_kv_cache(cfg, ecfg, self.device, mesh=self.mesh)
        self.scheduler = make_scheduler(cfg, ecfg)
        # each rank's attention layout and config (one device: "heads"
        # over itself, the config as given)
        self._attn = getattr(self.kv, "layout", "heads")
        self._cfg_rank = (cfg if self.mesh is None
                          else shard_cfg(cfg, self._attn, self.mesh.shape[1]))
        # host-side slot bookkeeping
        self.slot_req: list[Request | None] = [None] * B
        self.slot_len = np.zeros(B, np.int32)     # tokens generated
        self.slot_pos = np.zeros(B, np.int32)     # absolute position
        self.slot_tok = np.zeros((B, 1), np.int32)
        self.slot_rid = np.zeros(B, np.int32)     # sampling stream ids
        self.slot_seed = np.zeros(B, np.int32)
        self.slot_nprompt = np.zeros(B, np.int32)  # prompt length at bind
        self.waiting: deque[Request] = deque()
        self.finished: list[Request] = []
        self.prefilling: dict[int, PrefillState] = {}  # chunked policy
        self._next_rid = 0
        # clock: wall by default; trace replay switches to a virtual clock
        # (``set_now``) so latencies are deterministic simulated seconds
        self.clock = "wall"
        self.now_s = 0.0
        # SLO preemption: rid -> packet of an evicted, unfinished stream
        self.preempted_packets: dict[int, SlotPacket] = {}
        self.preemptions = 0
        self.preempted_kv_bytes = 0
        # schedule audit trail: admission order (rids) and (step, rid)
        # preemption events
        self.admission_log: list[int] = []
        self.preemption_log: list[tuple[int, int]] = []
        # the vlm's stub image prefix: positions before the prompt's
        # tokens in every cache, fed as a zero ``images`` operand
        self._n_prefix = (cfg.n_image_tokens if cfg.family == "vlm"
                          else 0)
        # prefix caching runs where the layout can alias blocks (paged,
        # with the index), positions map 1:1 to prompt tokens (no vlm
        # image prefix) and no second cache needs the whole prompt (the
        # speculative draft's contiguous shadow)
        self._prefix_on = (
            getattr(self.kv, "prefix", None) is not None
            and not self._n_prefix
            and self.scheduler.name != "speculative")
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
        # bucketed prefill where right-padding is harmless: causal
        # attention masks pad KV per row, and the recurrent families run
        # a length-masked scan (pad steps get decay 1 and zero input, so
        # the state handed to decode is bitwise the exact-length one); a
        # rolling window stays exact-length: its cache would roll the
        # pads in
        self._bucketed = (ecfg.prefill_bucket_min > 0
                          and cfg.sliding_window is None)
        # dispatch audit trail: (step, kind, operand specs) per dispatch
        self.dispatch_log: list[dict] = []
        self.step_index = 0
        # the dispatch functions, built once: the cost model's audit
        # (core.costmodel.entry_tracer) traces these very objects
        self._closures = fns = build_closures(self._cfg_rank)
        self._prefill_one, self._decode_ragged = fns["prefill"], fns["decode"]
        self._verify_ragged = fns["verify"]
        self._chunk_fns = {"contiguous": fns["chunk_contiguous"],
                           "paged": fns["chunk_paged"]}
        # the sampling head: (logits, seeds, rids, positions) -> tokens
        self._sample = make_sampler(ecfg)
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
            self._self_draft = True
            k = ecfg.spec_draft_layers or max(1, cfg.n_layers // 2)
            if self.mesh is not None:
                # every rank's draft is a view of its own target shard
                draft_params = PerRank(
                    MD.self_draft_params(p, cfg, k)[0] for p in self.params)
                dcfg = MD.self_draft_params(self.params[0], cfg, k)[1]
                self._draft_gather = self._gather_specs and {
                    key: (self._gather_specs[key] if key != "first_layers"
                          else self._gather_specs[key][:len(v)])
                    for key, v in draft_params[0].items()}
            else:
                draft_params, dcfg = MD.self_draft_params(self.params, cfg,
                                                          k)
        else:
            from repro_torch.configs import registry
            dcfg = registry.get_smoke_config(ecfg.draft).replace(
                dtype=cfg.dtype)
            draft_params = MD.init_params(dcfg, seed=ecfg.seed,
                                          device=self.device)
        if self.mesh is not None and not isinstance(draft_params, PerRank):
            draft_params, specs = place_params(draft_params, dcfg, self.mesh)
            self._draft_gather = (specs if SH.splits_over_data(specs,
                                                               self.mesh)
                                  else None)
        if dcfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}: speculative acceptance compares "
                "token ids, the models must share a tokenizer")
        if dcfg.family != cfg.family:
            raise ValueError(
                f"draft family {dcfg.family!r} != target family "
                f"{cfg.family!r}: prompt prefixes (e.g. vlm image "
                "tokens) must occupy the same positions in both caches")
        if cfg.family == "vlm" and (
                dcfg.n_image_tokens != cfg.n_image_tokens
                or dcfg.d_model != cfg.d_model):
            raise ValueError(
                f"vlm draft prefix mismatch (n_image_tokens "
                f"{dcfg.n_image_tokens} vs {cfg.n_image_tokens}, "
                f"d_model {dcfg.d_model} vs {cfg.d_model}): the image "
                "prefix must occupy identical positions — and the shared "
                "stub image batch identical feature width — in both "
                "caches")
        MD.check_supported(dcfg)
        self.draft_params, self.draft_cfg = draft_params, dcfg
        if self.mesh is None:
            self.draft_kv = ContiguousCache(dcfg, ecfg, self.device)
            self._draft_attn, dcfg_rank = "heads", dcfg
        else:
            self.draft_kv = MeshContiguousCache(dcfg, ecfg, self.mesh)
            self._draft_attn = self.draft_kv.layout
            dcfg_rank = shard_cfg(dcfg, self._draft_attn, self.mesh.shape[1])
        self._draft_closures = fns = build_closures(dcfg_rank)
        self._draft_prefill, self._draft_decode = (fns["prefill"],
                                                   fns["decode"])

    # -- public API -----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int | None = None,
               seed: int | None = None, *, tenant: str = "",
               priority: int = 0, slo=None,
               arrival_s: float | None = None) -> Request:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.shape[0] == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token array, "
                             f"got shape {prompt.shape}")
        req = Request(self._next_rid, prompt, max_new_tokens, seed=seed,
                      tenant=tenant, priority=int(priority), slo=slo,
                      arrival_s=arrival_s,
                      t_submit=(arrival_s if arrival_s is not None
                                else self._now()))
        self._next_rid += 1
        self.waiting.append(req)
        return req

    def set_now(self, t: float) -> None:
        """Switch to (and advance) the virtual clock: the workload replay
        calls this before each step, so every latency stamp is in
        deterministic simulated seconds."""
        self.clock = "virtual"
        self.now_s = float(t)

    def _now(self) -> float:
        return self.now_s if self.clock == "virtual" else time.time()

    def has_work(self) -> bool:
        """Anything queued, live, or evicted but unfinished."""
        return bool(self.waiting or self.preempted_packets
                    or any(r is not None for r in self.slot_req))

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive until all submitted requests finish. Returns finished."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # -- telemetry hooks ---------------------------------------------------
    def _log_dispatch(self, kind: str, *operands):
        """Append one dispatch-audit entry: the kind plus the shape and
        dtype of every operand (params excluded). On a mesh the dispatch
        is one program over the whole model, as the reference's is: the
        entry holds the operands the one-device engine passes
        (:meth:`_whole_operands`), so the audit prices the whole
        model's dispatch."""
        if self.mesh is not None:
            operands = self._whole_operands(kind, operands)
        self.dispatch_log.append({
            "step": self.step_index, "kind": kind,
            "spec": operand_spec(operands)})

    def _whole_operands(self, kind: str, operands) -> tuple:
        """A mesh dispatch's operands as the one-device engine's (meta
        tensors where a rank holds a shard): a request's batch as every
        rank has it, a cache view or a chunk's K/V history whole, a
        per-slot array over every slot."""
        kv = self.draft_kv if kind.startswith("draft") else self.kv
        out = []
        for i, x in enumerate(operands):
            if not isinstance(x, PerRank):
                out.append(x)
                continue
            first = next(v for v in x if v is not None)
            if isinstance(first, dict):
                out.append(first if "tokens" in first else kv.whole_spec())
            elif kind in ("chunk_contiguous", "chunk_paged") and i in (1, 2):
                out.append(kv.whole_spec()["kv"[i - 1]])
            elif kind == "chunk_paged":
                out.append(first)      # the slot's block-table row
            else:
                out.append(torch.empty((self.ecfg.max_batch,
                                        *first.shape[1:]),
                                       dtype=first.dtype, device="meta"))
        return tuple(out)

    def audit_functions(self) -> tuple:
        """(dispatch functions, params, draft functions, draft params)
        the audit traces a logged entry through: the engine's own; on a
        mesh, the whole model's — its functions built for the whole
        config and its params as meta tensors of the whole shapes, the
        program its log's operands (:meth:`_log_dispatch`) belong to."""
        if self.mesh is None:
            return (self._closures, self.params,
                    getattr(self, "_draft_closures", None), self.draft_params)
        whole = MD.init_params(self.cfg, device="meta")
        draft = dfns = None
        if self.draft_cfg is not None:
            dfns = build_closures(self.draft_cfg)
            if self._self_draft:
                draft = MD.self_draft_params(whole, self.cfg,
                                             self.draft_cfg.n_layers)[0]
            else:
                draft = MD.init_params(self.draft_cfg, device="meta")
        return build_closures(self.cfg), whole, dfns, draft

    def _vnow(self):
        """Virtual-clock stamp for spans: the replay clock when driven by
        one, None under the wall clock."""
        return self.now_s if self.clock == "virtual" else None

    def _span(self, name: str, cat: str = "phase", **labels):
        """A telemetry span on this engine's track (no-op when off)."""
        return self.telemetry.span(name, cat=cat, tid=self.tel_label,
                                   now_fn=self._vnow, **labels)

    def _dispatch(self, kind: str, fn, params, *args):
        """Issue one dispatch: always append the audit-log entry; with
        telemetry enabled, also time it to completion (the card
        synchronised) under a span named like the dispatch kind and feed
        the profiler a sample keyed to the log entry just written. The
        result is the same either way: waiting on it cannot change its
        bits. On a mesh the dispatch is one :meth:`DeviceMesh.run`
        (:meth:`_call`)."""
        self._log_dispatch(kind, *args)
        tel = self.telemetry
        if not tel.enabled:
            return self._call(kind, fn, params, args)
        idx = len(self.dispatch_log) - 1
        with tel.span(kind, cat="dispatch", tid=self.tel_label,
                      now_fn=self._vnow):
            t0 = time.perf_counter()
            out = self._call(kind, fn, params, args)
            for dev in self._devices():
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
        tel.profiler.record(self.tel_label, idx, kind, dt)
        tel.counter("engine_dispatches_total", engine=self.tel_label,
                    kind=kind, kv=self.kv.name).inc()
        tel.histogram("engine_dispatch_wall_s", engine=self.tel_label,
                      kind=kind, kv=self.kv.name).observe(dt)
        return out

    def _devices(self) -> list:
        """The distinct devices this engine runs on."""
        if self.mesh is None:
            return [self.device]
        return list(dict.fromkeys(self.mesh.devices))

    def _call(self, kind: str, fn, params, args):
        """``fn(params, *args)``; on a mesh, on each rank with its params,
        its share of every :class:`PerRank` operand and the hints armed
        for the dispatch's cache layout — on every rank, or, for a
        one-request dispatch (prefill, chunk), on the ranks of the
        request's data replica: those its operands name (the others'
        shares are None). A mesh result is the dispatch's tuple with the
        logits (its first element) whole on the engine's device — each
        data replica's rows from its first rank, in replica order — and
        every other element a :class:`PerRank`."""
        if self.mesh is None:
            return fn(params, *args)
        mesh = self.mesh
        draft = kind.startswith("draft")
        attn = self._draft_attn if draft else self._attn
        kv = self.draft_kv if draft else self.kv
        heads = (self.draft_cfg if draft else self.cfg).n_kv_heads
        plan = (self.ecfg.max_batch, heads)
        gather = self._draft_gather if draft else self._gather_specs
        ranks = [r for r in range(mesh.size)
                 if all(x[r] is not None for x in args
                        if isinstance(x, PerRank))]
        ranks = None if len(ranks) == mesh.size else ranks
        # a dispatch over every slot whose rows each replica holds its own
        # block of: an MoE's capacity and slot numbers are the whole
        # dispatch's, as one device's (a one-request dispatch's rows are
        # its replica's alone)
        data_rows = kind not in _ONE_REQUEST and kv.split_rows

        def one(r):
            shares = [x[r] if isinstance(x, PerRank) else x for x in args]
            with H.use_mesh(mesh, attn=attn, plan=plan, specs=gather,
                            pos_axes=getattr(kv, "pos_axes", None)
                            or ("model",), data_rows=data_rows):
                return fn(params[r], *shares)

        outs = mesh.run(one, ranks)
        if kind in _ONE_REQUEST:
            # the request's data replica's first rank (every rank may run
            # it: a gather over data, or a slot every replica holds)
            firsts = [mesh.rank_of(self._dispatch_group, 0)]
        elif not self.kv.split_rows:
            firsts = [0]   # every replica computes every row
        else:
            firsts = [mesh.rank_of(g, 0) for g in range(mesh.shape[0])]
        logits = torch.cat([outs[r][0].to(self.device) for r in firsts])
        rest = [PerRank(None if o is None else o[i] for o in outs)
                for i in range(1, len(outs[firsts[0]]))]
        return (logits, *rest)

    def _data_index(self, slot: int) -> int:
        """The data replica that serves ``slot`` (its rows of the slot
        arrays, its ranks' caches); 0 where every replica holds every
        slot."""
        if not self.kv.split_rows:
            return 0
        return int(slot) // (self.ecfg.max_batch // self.mesh.shape[0])

    def _request_ranks(self, slot: int) -> tuple:
        """The ranks a one-request dispatch (prefill, chunk) for ``slot``
        runs on: its data replica's, or every rank where the weights are
        gathered over ``data`` at use or every replica holds the slot."""
        if self._gather_specs is not None or not self.kv.split_rows:
            return tuple(range(self.mesh.size))
        return self.mesh.data_group(self._data_index(slot))

    def _finish(self, req: Request):
        """Retire ``req`` into ``finished`` (every finish site funnels
        here) and record its latency metrics."""
        self.finished.append(req)
        tel = self.telemetry
        if not tel.enabled:
            return
        tenant = req.tenant or "default"
        prio = str(req.priority)
        tel.counter("engine_requests_total", engine=self.tel_label,
                    tenant=tenant, priority=prio).inc()
        tel.counter("engine_tokens_total", engine=self.tel_label,
                    tenant=tenant, priority=prio).inc(len(req.output))
        tel.histogram("engine_ttft_s", engine=self.tel_label,
                      tenant=tenant, priority=prio).observe(
                          max(0.0, req.ttft_s))
        if len(req.output) > 1:
            tel.histogram("engine_itl_s", engine=self.tel_label,
                          tenant=tenant, priority=prio).observe(
                              max(0.0, req.itl_s))

    def step(self):
        """One engine iteration: admit -> at most one prefill-chunk
        dispatch -> one ragged decode (or draft + verify) dispatch ->
        retire."""
        self.step_index += 1
        with self._span("step", step=self.step_index):
            with self._span("admit"):
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
            with self._span("retire"):
                self.scheduler.retire(self)
        tel = self.telemetry
        if tel.enabled:
            tel.gauge("engine_live_slots", engine=self.tel_label).set(
                sum(r is not None for r in self.slot_req))
            tel.gauge("engine_waiting", engine=self.tel_label).set(
                len(self.waiting))
            tel.gauge("engine_resident_kv_bytes",
                      engine=self.tel_label).set(
                          self.kv.resident_kv_bytes())

    # -- internals ---------------------------------------------------------
    def _t(self, a: np.ndarray):
        """A host array as a tensor on the engine's device (on the CPU it
        shares the array's memory: never mutate an array a dispatch still
        reads — rebind it). On a mesh, a per-slot array (first dim
        ``max_batch``) as each rank's data replica's rows on its device."""
        if self.mesh is None:
            return torch.from_numpy(a).to(self.device)
        if not self.kv.split_rows:
            return PerRank(torch.from_numpy(a).to(dev)
                           for dev in self.mesh.devices)
        n = self.ecfg.max_batch // self.mesh.shape[0]
        out = PerRank()
        for r, dev in enumerate(self.mesh.devices):
            g = self.mesh.coords(r)[0]
            out.append(torch.from_numpy(a[g * n:(g + 1) * n]).to(dev))
        return out

    def _decode_step(self, live):
        cache = self.kv.decode_view(self.slot_pos, live)
        logits, new_cache = self._dispatch(
            "decode", self._decode_ragged, self.params,
            self._t(self.slot_tok), cache, self._t(self.slot_pos),
            self._t(live))
        with self._span("kv_commit", cat="kv"):
            self.kv.commit(new_cache)
        self.decode_dispatches += 1
        self.decode_steps += 1
        with self._span("sample"):
            new = self._sample(logits, self.slot_seed, self.slot_rid,
                               self.slot_pos)
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
                nxt = self._sample(self._draft_dispatch(cur, live),
                                   self.slot_seed, self.slot_rid,
                                   self.draft_pos)
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
        logits, new_cache = self._dispatch(
            "verify", self._verify_ragged, self.params, self._t(toks),
            cache, self._t(self.slot_pos), self._t(live))
        with self._span("kv_commit", cat="kv"):
            self.kv.commit(new_cache)
        self.decode_dispatches += 1
        self.decode_steps += 1
        self.verify_dispatches += 1
        self.spec_row_steps += int(live.sum())
        with self._span("sample"):
            greedy = self._sample(logits, self.slot_seed, self.slot_rid,
                                  self.slot_pos)              # (B, chain+1)
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
        logits, new_cache = self._dispatch(
            "draft_decode", self._draft_decode, self.draft_params,
            self._t(toks), cache, self._t(self.draft_pos), self._t(live))
        self.draft_kv.commit(new_cache)
        self.draft_dispatches += 1
        return logits

    def _budget(self, req: Request) -> int:
        """Generation budget; an explicit 0 means zero tokens."""
        return (req.max_new_tokens if req.max_new_tokens is not None
                else self.ecfg.max_new_tokens)

    def _prompt_cap(self) -> int:
        """Max admissible prompt tokens: capacity less one decode slot
        and less the vlm's image prefix (it shares the cache)."""
        return self.ecfg.max_seq_len - 1 - self._n_prefix

    def _batch(self, toks: np.ndarray, images: bool, slot: int = 0):
        """A one-row model batch of ``toks``; with ``images`` (the
        prompt's first dispatch), the vlm's zero stub image prefix in the
        cache dtype before them, or whisper's zero stub frames. On a mesh
        the batch of each rank of ``slot``'s data replica, on its
        device."""
        def on(device):
            batch = {"tokens": torch.from_numpy(toks[None, :]).to(device)}
            if images and self._n_prefix:
                batch["images"] = stub_images(self.cfg, device)
            if images and self.cfg.family == "audio":
                batch["frames"] = stub_frames(self.cfg, device)
            return batch

        if self.mesh is None:
            return on(self.device)
        self._dispatch_group = self._data_index(slot)
        group = self._request_ranks(slot)
        return PerRank(on(dev) if r in group else None
                       for r, dev in enumerate(self.mesh.devices))

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

    def _seed(self, req: Request) -> int:
        return req.seed if req.seed is not None else self.ecfg.seed

    def _admit_prologue(self, slot: int, req: Request):
        """Zero-budget insta-finish, truncation, capacity check. Returns
        ``(prompt, n_prompt, budget)`` to proceed — ``n_prompt`` counts
        the image prefix's positions too — ``True`` when the request was
        consumed, ``False`` to defer it."""
        budget = self._budget(req)
        if budget <= 0:
            req.t_first = req.t_done = self._now()
            self._finish(req)
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
        n_prompt = int(prompt.shape[0]) + self._n_prefix
        if not self.kv.can_admit(n_prompt, budget,
                                 prompt=prompt if self._prefix_on
                                 else None):
            return False
        return prompt, n_prompt, budget

    def _retires_at_admission(self, tok: int, n_prompt: int,
                              budget: int) -> bool:
        """The prefill token already ends the request (budget, EOS,
        capacity): it never occupies a decode slot."""
        return (budget <= 1 or tok == self.ecfg.eos_token
                or n_prompt >= self.ecfg.max_seq_len - 1)

    def _admit_one(self, slot: int, req: Request) -> bool:
        """Blocking admission: the whole prompt in one bucketed prefill
        (and the draft's, when speculating), then bind the request to
        ``slot``. A preempted request resumes from its packet instead;
        a prompt with a cached prefix prefills only its suffix."""
        if req.rid in self.preempted_packets:
            return self._resume_slot(slot, req)
        pro = self._admit_prologue(slot, req)
        if isinstance(pro, bool):
            return pro
        prompt, n_prompt, budget = pro
        if (self._prefix_on
                and self.kv.prefix_match_tokens(prompt, n_prompt)):
            return self._admit_prefix(slot, req, prompt, n_prompt, budget)
        n = int(prompt.shape[0])
        toks = np.zeros(self._bucket_len(n), np.int32)
        toks[:n] = prompt   # right-pad to the bucket length
        batch = self._batch(toks, images=True, slot=slot)
        logits, rows = self._dispatch("prefill", self._prefill_one,
                                      self.params, batch, n_prompt - 1,
                                      n_prompt)
        self.prefills += 1
        self.admission_log.append(req.rid)
        req.prefill_chunks = 1
        seed = self._seed(req)
        tok = self._sample_first(req, seed, logits, n_prompt)
        if self._retires_at_admission(tok, n_prompt, budget):
            req.t_done = self._now()
            self._finish(req)
            return True
        with self._span("kv_splice", cat="kv"):
            self.kv.splice(rows, slot, n_prompt, budget,
                           prompt=prompt if self._prefix_on else None)
        if self._prefix_on:
            # publish the prompt's full blocks (a cold miss): the next
            # request with this prefix splices them instead
            self.kv.register_prefix(slot, prompt, n_prompt)
        if self.draft_kv is not None:
            # the draft shadows the committed sequence: prefill its cache
            # over the same bucketed batch
            _, drows = self._dispatch("draft_prefill", self._draft_prefill,
                                      self.draft_params, batch, n_prompt - 1,
                                      n_prompt)
            self.draft_kv.splice(drows, slot, n_prompt, budget)
            self.draft_prefills += 1
            self.draft_dispatches += 1
            self.draft_pos[slot] = n_prompt
        self._bind_decode(slot, req, seed, tok, n_prompt)
        return True

    def _admit_prefix(self, slot: int, req: Request, prompt,
                      n_prompt: int, budget: int) -> bool:
        """Warm blocking admission: splice the cached prefix blocks into
        the slot (refcounts bumped, reservation charging only the
        suffix), then prefill just ``prompt[h:]`` in one chunk dispatch
        over the shared history at offset ``h`` (K4). The suffix is never
        empty: matches cap at ``(n_prompt - 1) // block_size`` blocks.
        The same tokens at the same absolute positions give the same
        KV, so attending the cached blocks equals recomputing them."""
        h = self.kv.splice_prefix(slot, prompt, n_prompt, budget)
        n_suf = n_prompt - h
        toks = np.zeros(self._bucket_len(n_suf), np.int32)
        toks[:n_suf] = prompt[h:]
        batch = self._batch(toks, images=False, slot=slot)
        view = self.kv.chunk_view(slot)
        sel = view["slot"] if view["kind"] == "contiguous" else view["table"]
        logits, ks, vs = self._dispatch(
            f"chunk_{view['kind']}", self._chunk_fns[view["kind"]],
            self.params, batch, view["k"], view["v"], sel, h, n_suf - 1)
        with self._span("kv_splice", cat="kv"):
            self.kv.splice_partial(ks, vs, slot, h, n_suf)
        self.prefill_chunk_dispatches += 1
        self.admission_log.append(req.rid)
        req.prefill_chunks = 1
        seed = self._seed(req)
        tok = self._sample_first(req, seed, logits, n_prompt)
        if self._retires_at_admission(tok, n_prompt, budget):
            # unlike the cold path the slot already holds KV (aliased
            # prefix + spliced suffix): release it
            req.t_done = self._now()
            self._finish(req)
            self.kv.free(slot)
            return True
        self.kv.register_prefix(slot, prompt, n_prompt)
        self._bind_decode(slot, req, seed, tok, n_prompt)
        return True

    def _start_prefill(self, slot: int, req: Request) -> bool:
        """Chunked admission: bind ``req`` to ``slot`` and reserve its
        worst-case cache capacity — no dispatch; ``_run_chunk`` streams
        the prompt in over the following steps, from the matched prefix
        on when one is cached."""
        if req.rid in self.preempted_packets:
            return self._resume_slot(slot, req)
        pro = self._admit_prologue(slot, req)
        if isinstance(pro, bool):
            return pro
        prompt, n_prompt, budget = pro
        if self._prefix_on:
            # doubles as the reservation (charging only the uncached
            # suffix); the chunk walk starts at done = h
            h = self.kv.splice_prefix(slot, prompt, n_prompt, budget)
        else:
            self.kv.reserve(slot, n_prompt, budget)
            h = 0
        self.admission_log.append(req.rid)
        self.slot_req[slot] = req
        self.prefilling[slot] = PrefillState(
            prompt=np.asarray(prompt, np.int32),
            n_prefix=n_prompt - int(prompt.shape[0]), n_prompt=n_prompt,
            budget=budget, seed=self._seed(req), done=h)
        return True

    def _run_chunk(self, slot: int):
        """The next prefill chunk of ``slot``: one dispatch over (chunk
        tokens) x (cached history), the chunk's KV written at the running
        offset, and — on the final chunk — the first token sampled and
        the slot handed to the decode phase. The first chunk of a vlm
        prompt also carries the image prefix, so it spans ``n_prefix +
        chunk_tokens`` positions and shifts every later boundary."""
        st = self.prefilling[slot]
        req = self.slot_req[slot]
        ct = self.ecfg.chunk_tokens
        first = st.done == 0
        tok_start = max(0, st.done - st.n_prefix)
        n_tok = min(ct, int(st.prompt.shape[0]) - tok_start)
        toks = np.zeros(ct, np.int32)
        toks[:n_tok] = st.prompt[tok_start:tok_start + n_tok]
        batch = self._batch(toks, images=first, slot=slot)
        n_valid = n_tok + (st.n_prefix if first else 0)
        final = st.done + n_valid >= st.n_prompt
        # logits at the prompt's last position, chunk-local index
        # n_prompt - 1 - done (only read on the final chunk)
        logit_idx = st.n_prompt - 1 - st.done if final else 0
        view = self.kv.chunk_view(slot)
        sel = view["slot"] if view["kind"] == "contiguous" else view["table"]
        logits, ks, vs = self._dispatch(
            f"chunk_{view['kind']}", self._chunk_fns[view["kind"]],
            self.params, batch, view["k"], view["v"], sel, st.done,
            logit_idx)
        with self._span("kv_splice", cat="kv"):
            self.kv.splice_partial(ks, vs, slot, st.done, n_valid)
        self.prefill_chunk_dispatches += 1
        req.prefill_chunks += 1
        st.done += n_valid
        if not final:
            return
        del self.prefilling[slot]
        tok = self._sample_first(req, st.seed, logits, st.n_prompt)
        if self._retires_at_admission(tok, st.n_prompt, st.budget):
            req.t_done = self._now()
            self._finish(req)
            self.slot_req[slot] = None
            self.kv.free(slot)
            return
        if self._prefix_on:
            # the prompt's KV is fully resident now: publish its blocks
            self.kv.register_prefix(slot, st.prompt, st.n_prompt)
        self._bind_decode(slot, req, st.seed, tok, st.n_prompt)

    def _sample_first(self, req: Request, seed: int, logits,
                      n_prompt: int) -> int:
        """The prompt's first token from prefill logits, keyed at
        position ``n_prompt - 1``; stamps ``t_first`` (TTFT is measured
        here, never at an earlier chunk)."""
        with self._span("sample"):
            tok = int(self._sample(logits, [seed], [req.rid],
                                   [n_prompt - 1])[0])
        req.t_first = self._now()
        req.output.append(tok)
        return tok

    def _bind_decode(self, slot: int, req: Request, seed: int, tok: int,
                     n_prompt: int):
        """Hand a freshly prefilled request to the decode phase."""
        self.slot_req[slot] = req
        self.slot_len[slot] = 1
        self.slot_pos[slot] = n_prompt
        self.slot_tok[slot, 0] = tok
        self.slot_rid[slot] = req.rid
        self.slot_seed[slot] = seed
        self.slot_nprompt[slot] = n_prompt

    def _retire_slot(self, i: int):
        req = self.slot_req[i]
        req.t_done = self._now()
        self._finish(req)
        self.slot_req[i] = None
        self.slot_len[i] = 0
        self.kv.free(i)
        if self.draft_kv is not None:
            self.draft_kv.free(i)
            self.draft_pos[i] = 0

    # -- preempt and requeue (slot <-> host packet) ------------------------
    def _pack_slot(self, slot: int) -> SlotPacket:
        """Snapshot slot ``slot``'s live stream into a host packet and
        release the slot. With prefix caching the packet carries the
        spliced prompt, so the importer re-matches and aliases it."""
        req = self.slot_req[slot]
        n_prompt = int(self.slot_nprompt[slot])
        with self._span("kv_export", cat="kv"):
            pkt = SlotPacket(
                req=req, seed=int(self.slot_seed[slot]),
                tok=int(self.slot_tok[slot, 0]),
                pos=int(self.slot_pos[slot]),
                gen_len=int(self.slot_len[slot]),
                n_prompt=n_prompt,
                budget=self._budget(req),
                kv=self.kv.export_slot(
                    slot, int(self.slot_pos[slot]),
                    prompt=(req.prompt[:n_prompt]
                            if self._prefix_on else None),
                    n_prompt=n_prompt if self._prefix_on else None))
        self.slot_req[slot] = None
        self.slot_len[slot] = 0
        self.kv.free(slot)
        return pkt

    def _unpack_slot(self, pkt: SlotPacket, slot: int) -> None:
        """Land a packet in free slot ``slot`` and rebind the stream (the
        inverse of :meth:`_pack_slot`; the import re-runs the reservation
        arithmetic, so callers check ``can_admit`` first)."""
        with self._span("kv_import", cat="kv"):
            self.kv.import_slot(pkt.kv, slot, pkt.n_prompt, pkt.budget)
        self.slot_req[slot] = pkt.req
        self.slot_len[slot] = pkt.gen_len
        self.slot_pos[slot] = pkt.pos
        self.slot_tok[slot, 0] = pkt.tok
        self.slot_rid[slot] = pkt.req.rid
        self.slot_seed[slot] = pkt.seed
        self.slot_nprompt[slot] = pkt.n_prompt

    def preempt_slot(self, slot: int) -> SlotPacket:
        """Evict slot ``slot``'s live stream to the waiting queue: pack
        it into a host packet and requeue the request. No token is lost:
        admission later resumes the stream at its exact position, and
        sampling keyed by (seed, rid, position) makes the resumed stream
        bitwise the unpreempted one."""
        req = self.slot_req[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not live")
        if slot in self.prefilling:
            raise RuntimeError(
                f"slot {slot} is mid-prefill: chunked prefill state "
                "cannot be packed (no sampled token yet) — preempt only "
                "decode-phase slots")
        if self.draft_kv is not None:
            raise RuntimeError(
                "preemption is unsupported under speculative decoding: "
                "the draft's shadow cache is not part of the export "
                "packet and cannot resume")
        with self._span("preempt", rid=req.rid):
            pkt = self._pack_slot(slot)
        self.preempted_packets[req.rid] = pkt
        req.preemptions += 1
        self.preemptions += 1
        self.preempted_kv_bytes += int(pkt.kv["kv_bytes"])
        self.preemption_log.append((self.step_index, req.rid))
        self.waiting.append(req)
        self.telemetry.counter("engine_preemptions_total",
                               engine=self.tel_label).inc()
        return pkt

    def _resume_slot(self, slot: int, req: Request) -> bool:
        """Admission of a preempted request: re-import its packet into
        ``slot`` (no prefill: its tokens are already sampled). False
        defers while the cache cannot take it back."""
        pkt = self.preempted_packets[req.rid]
        if not self.kv.can_admit(pkt.n_prompt, pkt.budget):
            return False
        del self.preempted_packets[req.rid]
        self._unpack_slot(pkt, slot)
        self.admission_log.append(req.rid)
        return True

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
        peak = self.kv.peak_resident_kv_bytes + draft_bytes
        prefix = getattr(self.kv, "prefix", None)
        parts = int(getattr(self.kv, "kv_partitions", 1))

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
            # SLO-policy preemption accounting (0 under other policies)
            "preemptions": self.preemptions,
            "preempted_kv_bytes": self.preempted_kv_bytes,
            "slo_attainment": (sum(r.slo_met for r in done) / n
                               if n else 1.0),
            **request_breakdowns(done),
            "kv_cache": self.kv.name,
            # prefix-cache accounting (zeros where the backend has no
            # index)
            "prefix_hit_rate": float(
                getattr(self.kv, "prefix_hit_rate", 0.0)),
            "prefix_hits": int(getattr(self.kv, "prefix_hits", 0)),
            "prefix_hit_tokens": int(
                getattr(self.kv, "prefix_hit_tokens", 0)),
            "prefix_lookups": int(getattr(self.kv, "prefix_lookups", 0)),
            "prefix_evictions": prefix.evictions if prefix is not None else 0,
            "resident_shared_kv_bytes": int(
                getattr(self.kv, "resident_shared_kv_bytes", 0)),
            "resident_kv_bytes": self.kv.resident_kv_bytes(),
            # high-water mark of the target cache plus the draft's
            # contiguous shadow cache, against the dense charge
            "peak_resident_kv_bytes": peak,
            "draft_kv_bytes": draft_bytes,
            "contiguous_kv_bytes": contiguous_kv_bytes(
                self.cfg, self.ecfg.max_batch, self.ecfg.max_seq_len),
            # mesh-serving accounting: the (data, model) shape (None on
            # one device), the devices spanned, and the residency each
            # device holds of the partitioned KV (heads over model and,
            # contiguous, slots over data; positions over model where
            # the heads do not divide it)
            "mesh": self.ecfg.mesh,
            "mesh_devices": 1 if self.mesh is None else self.mesh.size,
            "kv_partitions": parts,
            "resident_kv_bytes_per_device": -(-peak // parts),
            # telemetry fold-in: always present; all zero when disabled
            "telemetry": self.telemetry.engine_aggregates(self.tel_label),
        }
