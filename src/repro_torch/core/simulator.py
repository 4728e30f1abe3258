"""The PIM-AI analytical hardware simulator (paper §3.1).

Counterpart of ``repro/core/simulator.py``. It consumes the op stream
that :mod:`repro_torch.core.costmodel` traces from the serving engine's
own dispatch functions on ``meta`` tensors (:mod:`repro_torch.core.trace`)
and charges time + energy per op against a :class:`HardwareProfile`,
following the paper's model:

- GEMM/GEMV/conv: time = max(OPs / TOPS, operand bytes / mem BW) — the
  per-op roofline that makes prefill compute-bound and decode
  memory-bound without any phase-specific switches. Energy =
  OPs * pJ/OP + bytes * 8 * pJ/bit.
- activation/normalization (elementwise + reduce): time = OPs / vector
  throughput (the paper's "execution cycles for other functions");
  operands assumed register/cache resident (fused), so no main-memory
  charge.
- data movement (gather/scatter — embeddings, KV-cache update):
  bytes / mem BW, memory energy only.
- KV history: the decode step is traced at two cache lengths and each
  op's cost is linear-fit in the cache length (``trace_linear``), which
  reproduces "the simulator accounts for these data transfers to main
  memory for all previous iterations" from the real graph.
- synchronization: H2D of the prompt tokens, D2H of each generated
  token, host orchestration per phase step (sub-ms cloud / tens of ms
  mobile, §3.3).
- quantization: weight bytes are scaled by ``weight_bits``/16 (W4A16
  mobile mode); KV/activation traffic by ``act_bits``/16. Compute OPs
  are unchanged (the tensor units run 16-bit accumulate).

Two translations from the reference, and only these: the reshuffles the
model charges nothing for are named by the aten ops the port's tracer
records (:data:`ATEN_DATA_PRIMS`), and a hand-written kernel's record
is priced by the rule of the work it replaces in the paper's model
(:data:`KERNEL_RULES`). The simulator runs no device work: every stream
is traced on meta tensors, so it runs on any host.
"""
from __future__ import annotations

import math
import warnings
from collections import deque
from dataclasses import astuple, dataclass, replace

import numpy as np

from repro_torch.core import costmodel as CM
from repro_torch.core import trace as T
from repro_torch.core.profiles import HardwareProfile
from repro_torch.models import model as MD
from repro_torch.serving.engine import (EngineConfig, Request,
                                        request_breakdowns)
from repro_torch.serving.kv_cache import (PrefixIndex, _export_span,
                                          contiguous_kv_bytes,
                                          kv_bytes_per_token,
                                          paged_resident_kv_bytes)
from repro_torch.serving.scheduler import (make_scheduler, policy_supported,
                                           slo_sort_key)
from repro_torch.serving.workload import autoscale_decision


@dataclass
class PhaseResult:
    seconds: float = 0.0
    energy_j: float = 0.0
    compute_s: float = 0.0
    memory_s: float = 0.0
    host_s: float = 0.0
    ops: float = 0.0
    mem_bytes: float = 0.0
    host_bytes: float = 0.0

    def add(self, other: "PhaseResult", times: float = 1.0):
        for f in ("seconds", "energy_j", "compute_s", "memory_s", "host_s",
                  "ops", "mem_bytes", "host_bytes"):
            setattr(self, f, getattr(self, f) + getattr(other, f) * times)


@dataclass
class SimConfig:
    weight_bits: int = 16
    act_bits: int = 16          # KV cache + activations
    orchestration_s: float = 0.0  # host service time per phase step
    tp_degree: int = 1          # chips sharing one model copy (collectives)


# Reshuffles that fuse into the surrounding op (RoPE rotation concat,
# QKV splits, padding) and are charged nothing, by the reference's JAX
# primitive names; ``split`` and ``slice`` are views in aten (never
# recorded) and ``sort`` keeps its name.
FUSED_DATA_PRIMS = ("split", "concatenate", "pad", "slice", "rev", "sort",
                    "top_k")
# The aten op the port's tracer records for each reshuffle above, by the
# JAX primitive it stands for (``stack`` and ``roll`` lower to
# ``concatenate`` in JAX).
ATEN_DATA_PRIMS = {"cat": "concatenate", "stack": "concatenate",
                   "roll": "concatenate", "constant_pad_nd": "pad",
                   "flip": "rev", "topk": "top_k"}

# The rule each hand-written kernel's record (``kind="kernel"``, its
# ``cost()``) is priced by: that of the work it replaces in the paper's
# model, keyed by the wrapper names of :mod:`repro_torch.kernels.ops`.
# - "normalization": K5 is the RMSNorm (and the residual add) — vector
#   OPs, operands resident, no memory charge;
# - "attention_scores": K3 is the prefill's QK^T / AV — kept resident,
#   compute only (the GEMM rule for a weightless >= 2-batch-dim product);
# - "stream": the kernel reads the KV history (K1, K2, K4) or the int4
#   weights (K6) from memory — the roofline over its cost() bytes.
KERNEL_RULES = {
    "add_rmsnorm": "normalization",
    "flash_attention": "attention_scores",
    "decode_attention": "stream",
    "paged_decode_attention": "stream",
    "prefill_attention": "stream",
    "quant_gemv": "stream",
}


def kernel_rule(name: str) -> str:
    """The pricing rule of the kernel record ``name``; raises on a
    kernel the table does not name."""
    try:
        return KERNEL_RULES[name]
    except KeyError:
        raise ValueError(
            f"kernel record {name!r} has no pricing rule: name it in "
            "simulator.KERNEL_RULES") from None


def _op_cost(op: T.OpRecord, hw: HardwareProfile, sim: SimConfig
             ) -> PhaseResult:
    r = PhaseResult()
    wscale = sim.weight_bits / 16.0
    ascale = sim.act_bits / 16.0
    rule = kernel_rule(op.kernel or op.prim) if op.kind == "kernel" else ""
    if rule == "normalization":
        op = replace(op, kind="reduce")
    elif rule == "attention_scores":
        op = replace(op, kind="gemm", weight_bytes=0.0, batch_dims=2)
    if op.kind in ("gemm", "gemv", "conv"):
        # attention-score GEMMs (QK^T / AV: >= 2 batch dims, no weight
        # operand) stay SRAM-resident in any serious implementation
        # (the flash kernels; the paper's "similar TTFT across profiles"
        # requires it too): charge compute, not the quadratic
        # intermediate. Expert/KV streams (<= 1 batch dim or GEMV)
        # remain fully memory-charged.
        act_resident = (op.kind == "gemm" and op.weight_bytes == 0
                        and op.batch_dims >= 2)
        w_bytes = op.weight_bytes * wscale
        if act_resident:
            bytes_total = 0.0
        elif op.kind == "gemm":
            # prefill/train weight GEMM: the weight tile is streamed
            # once; activations stay SRAM-resident between fused ops
            # (paper §3.1 charges GEMMs by TOPs + the weight/KV streams
            # from main memory).
            bytes_total = w_bytes
        else:
            bytes_total = w_bytes + (op.in_bytes - op.weight_bytes
                                     + op.out_bytes) * ascale
        t_compute = op.flops / hw.ops_per_s
        t_mem = bytes_total / (hw.mem_bw_gbs * 1e9)
        r.compute_s = t_compute
        r.memory_s = t_mem
        r.seconds = max(t_compute, t_mem)
        # MAC energy scales with the narrow-operand width: an INT4xFP16
        # MAC switches ~w/16 of the multiplier array of a 16-bit MAC.
        # This reproduces the paper's Fig-5 encode-energy savings
        # (15-28%) under W4A16.
        compute_pj = hw.pj_per_op * (wscale if op.weight_bytes > 0
                                     else ascale)
        r.energy_j = (op.flops * compute_pj
                      + bytes_total * 8 * hw.mem_pj_per_bit) * 1e-12
        r.ops = op.flops
        r.mem_bytes = bytes_total
    elif op.kind == "kernel":
        # a kernel streaming the KV history or the weights: its cost()
        # bytes are what it must move (KV read once, outputs written
        # once) and its FLOPs what it computes — charge the roofline
        # over those numbers directly.
        bytes_total = (op.in_bytes + op.out_bytes) * ascale
        t_compute = op.flops / hw.ops_per_s
        t_mem = bytes_total / (hw.mem_bw_gbs * 1e9)
        r.compute_s = t_compute
        r.memory_s = t_mem
        r.seconds = max(t_compute, t_mem)
        r.energy_j = (op.flops * hw.pj_per_op * ascale
                      + bytes_total * 8 * hw.mem_pj_per_bit) * 1e-12
        r.ops = op.flops
        r.mem_bytes = bytes_total
    elif op.kind in ("elementwise", "reduce"):
        t = op.flops / hw.vector_ops_per_s
        r.compute_s = t
        r.seconds = t
        r.energy_j = op.flops * hw.pj_per_op * 1e-12
        r.ops = op.flops
    elif op.kind in ("data", "other"):
        # reshuffles that fuse into the surrounding op are SRAM-resident;
        # true memory traffic (embedding gather, KV-cache read/update)
        # is charged.
        if ATEN_DATA_PRIMS.get(op.prim, op.prim) in FUSED_DATA_PRIMS:
            return r
        bytes_total = (op.in_bytes + op.out_bytes) * ascale
        t = bytes_total / (hw.mem_bw_gbs * 1e9)
        r.memory_s = t
        r.seconds = t
        r.energy_j = bytes_total * 8 * hw.mem_pj_per_bit * 1e-12
        r.mem_bytes = bytes_total
    return r


def _host_transfer(n_bytes: float, hw: HardwareProfile, *, d2h: bool
                   ) -> PhaseResult:
    bw = (hw.d2h_bw_gbs if d2h else hw.h2d_bw_gbs) * 1e9
    pj = hw.d2h_pj_per_bit if d2h else hw.h2d_pj_per_bit
    r = PhaseResult()
    r.seconds = n_bytes / bw
    r.host_s = r.seconds
    r.energy_j = n_bytes * 8 * pj * 1e-12
    r.host_bytes = n_bytes
    return r


def _tp_collective(n_bytes: float, hw: HardwareProfile) -> PhaseResult:
    """Intra-node partial-result exchange (PIM DIMM interconnect /
    NVLink-switch path), charged at the interconnect parameters."""
    r = PhaseResult()
    if n_bytes <= 0 or hw.interconnect_bw_gbs <= 0:
        return r
    r.seconds = n_bytes / (hw.interconnect_bw_gbs * 1e9)
    r.host_s = r.seconds
    r.energy_j = n_bytes * 8 * hw.interconnect_pj_per_bit * 1e-12
    r.host_bytes = n_bytes
    return r


# Op streams folded by _folded: id -> (the stream, its folded form)
_FOLDED: dict = {}
_FOLDED_MAX = 4096


def _folded(ops) -> list:
    """``ops`` with equal records merged, in first-seen order:
    [(record, multiplicity)]. The port's tracer records every layer's
    ops (the reference's records a layer scan's body once, times its
    trip count), so a model's stream repeats the same few dozen records
    per layer; pricing each once, times its multiplicity, keeps a
    schedule's thousands of priced steps cheap. Memoized by identity:
    the pricer's memos hand out the same list every time."""
    hit = _FOLDED.get(id(ops))
    if hit is not None and hit[0] is ops:
        return hit[1]
    groups: dict = {}
    for op in ops:
        key = astuple(op)
        if key in groups:
            groups[key][1] += 1
        else:
            groups[key] = [op, 1]
    if len(_FOLDED) >= _FOLDED_MAX:
        _FOLDED.clear()
    folded = [tuple(g) for g in groups.values()]
    _FOLDED[id(ops)] = (ops, folded)
    return folded


def _stream_cost(ops, hw: HardwareProfile, sim: SimConfig,
                 at: float | None = None) -> PhaseResult:
    """The summed ``_op_cost`` of an op stream — of a linear-in-length
    stream evaluated at cache length ``at``."""
    r = PhaseResult()
    for op, n in _folded(ops):
        r.add(_op_cost(op if at is None else op.at(at), hw, sim), n)
    return r


# ---------------------------------------------------------------------------
# trace-driven serving mirror (serving/workload.py replay, analytically)
# ---------------------------------------------------------------------------

class _TraceSlotSim:
    """The *mechanism* half of ``ServingEngine``, analytically: slot
    arrays, the paged-pool ledger, and the admission / preemption /
    retirement hooks — driven by the **real** scheduler-policy objects
    (``make_scheduler``), so the simulated schedule cannot drift from
    the engine's by construction. Where the engine dispatches a
    function, this charges the traced cost model instead; where it moves
    KV bytes, this charges a host transfer.

    Faithfulness bounds: blocking/SLO admission only (no chunked
    prefill or speculation — the trace replay gate runs those
    schedulers on the real engine), and EOS is assumed never sampled
    (token *values* are not simulated; the trace engines run with
    ``eos_token=-1``), so every stream runs to its budget or the
    capacity — exactly what the length-driven schedule needs."""

    _TOKEN = -(2 ** 30)   # placeholder "sampled token": never equal to
                          # a real eos id, so retirement is length-driven

    def __init__(self, sim: "LLMSimulator", ecfg, *, kv_cache: str,
                 kv_block_size: int, prefill_sim=None):
        self.sim = sim
        self.hw, self.scfg = sim.hw, sim.sim
        self.ecfg = ecfg
        self.kv_kind = kv_cache
        self.block_size = kv_block_size
        B, C = ecfg.max_batch, ecfg.max_seq_len
        # the attribute surface the scheduler policies touch
        self.slot_req = [None] * B
        self.slot_len = np.zeros(B, np.int32)
        self.slot_pos = np.zeros(B, np.int32)
        self.slot_nprompt = np.zeros(B, np.int32)
        self.waiting: deque = deque()
        self.finished: list = []
        self.prefilling: dict = {}    # always empty: blocking admission
        self.preempted_packets: dict = {}
        self.preemptions = 0
        self.preempted_kv_bytes = 0
        self.admission_log: list[int] = []
        self.preemption_log: list[tuple[int, int]] = []
        self.scheduler = make_scheduler(sim.cfg, ecfg)
        self.step_index = 0
        self.now_s = 0.0
        self.decode_steps = 0
        self.prefills = 0
        # paged-pool ledger: block counts are all the schedule needs
        # (the real backend's lazy allocation fills each slot's table
        # as a contiguous prefix — mirrored by a per-slot count)
        if kv_cache == "paged":
            if C % kv_block_size:
                raise ValueError(
                    f"kv_block_size={kv_block_size} must divide "
                    f"max_seq_len={C}")
            self._free_blocks = ecfg.kv_blocks or B * (C // kv_block_size)
            self._nblk = np.zeros(B, np.int64)
            self._rsv = np.zeros(B, np.int64)
        # prefix caching: the *real* PrefixIndex over virtual block ids
        # (minted from a counter — identity is all the LRU/refcount
        # machinery reads), so match/acquire/release/register/evict
        # replay the engine's hit/miss/eviction schedule by
        # construction. Enabled exactly where the engine enables it
        # (ServingEngine._prefix_on): paged + prefix_cache, token-only
        # prompts (no vlm image prefix); the trace sim is blocking/slo
        # only, so the speculative exclusion is vacuous here.
        self.prefix = None
        cfg = sim.cfg
        if (kv_cache == "paged" and getattr(ecfg, "prefix_cache", False)
                and not (cfg.family == "vlm" and cfg.n_image_tokens)):
            self.prefix = PrefixIndex(kv_block_size)
        self._next_vbid = 0
        # per-slot shared aliases, in table order (aliased prefix ids
        # first, then ids registered from this slot's private blocks) —
        # release order at free must match the engine's table scan
        self._vshared: list[list[int]] = [[] for _ in range(B)]
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.prefill_chunk_dispatches = 0
        # pricing: prefill dispatches may run on different hardware
        # (xPU prefill tier); decode and transfers on this sim's
        self._psim = prefill_sim or sim
        self.enc = PhaseResult()
        self.dec = PhaseResult()
        self.xfer = PhaseResult()
        self._bpt = kv_bytes_per_token(sim.cfg) * (sim.sim.act_bits / 16.0)
        self._dec_ops = sim._decode_ops_linear(
            B, C, ragged=True, kv_cache=kv_cache,
            kv_block_size=kv_block_size)

    # -- clock / engine surface -------------------------------------------
    def set_now(self, t: float) -> None:
        self.now_s = float(t)

    def _now(self) -> float:
        return self.now_s

    def has_work(self) -> bool:
        return bool(self.waiting or self.preempted_packets
                    or any(r is not None for r in self.slot_req))

    def _budget(self, req) -> int:
        return (req.max_new_tokens if req.max_new_tokens is not None
                else self.ecfg.max_new_tokens)

    def _prompt_cap(self) -> int:
        cfg = self.sim.cfg
        n_prefix = (cfg.n_image_tokens
                    if cfg.family == "vlm" and cfg.n_image_tokens else 0)
        return self.ecfg.max_seq_len - 1 - n_prefix

    def _bucket_len(self, n: int) -> int:
        """The prefill dispatch length the engine would compile
        (power-of-two buckets), so the priced prefill matches the
        dispatched one — and the number of distinct traces stays
        small."""
        cfg = self.sim.cfg
        cap = self._prompt_cap()
        bucketed = (self.ecfg.prefill_bucket_min > 0
                    and cfg.family in MD.TRANSFORMER_FAMILIES
                    + ("audio",) + MD.RECURRENT_FAMILIES
                    and cfg.sliding_window is None)
        if not bucketed:
            return min(n, cap)
        b = self.ecfg.prefill_bucket_min
        while b < n:
            b *= 2
        return min(b, cap)

    # -- paged-pool ledger -------------------------------------------------
    def _need_blocks(self, n_prompt: int, budget: int) -> int:
        n_pos = min(n_prompt + max(budget, 1) - 1,
                    self.ecfg.max_seq_len - 1)
        return math.ceil(max(n_pos, 1) / self.block_size)

    def can_admit(self, n_prompt: int, budget: int, prompt=None) -> bool:
        if self.kv_kind != "paged":
            return True
        need = self._need_blocks(n_prompt, budget)
        avail = self._free_blocks - int(self._rsv.sum())
        if self.prefix is not None:
            # evictable credit applies even promptless (resume/route):
            # see PagedCache.can_admit
            ids = (self.prefix.match(prompt, n_prompt)
                   if prompt is not None else [])
            need -= len(ids)
            avail += self.prefix.evictable(excluding=ids)
        return avail >= need

    def prefix_match_tokens(self, prompt, n_prompt: int) -> int:
        """Mirror of ``PagedCache.prefix_match_tokens`` (pure query —
        the cluster mirror's affinity router reads it)."""
        if self.prefix is None:
            return 0
        return len(self.prefix.match(prompt, n_prompt)) * self.block_size

    def _alloc_private(self, k: int) -> None:
        """Take ``k`` private blocks from the pool, evicting LRU
        zero-ref shared blocks under pressure — the exact discipline of
        ``PagedCache._alloc_block``."""
        for _ in range(k):
            if self._free_blocks == 0 and self.prefix is not None:
                if self.prefix.evict_lru() is not None:
                    self._free_blocks += 1
            self._free_blocks -= 1

    def _register(self, slot: int, prompt, n_prompt: int) -> None:
        """Mirror of ``PagedCache.register_prefix``: publish this
        slot's full prompt blocks, minting a fresh virtual id per newly
        registered block (a duplicate hash keeps the private copy,
        exactly as the real cache does)."""
        if self.prefix is None:
            return
        full = n_prompt // self.block_size
        if not full:
            return
        keys = self.prefix.keys_for(prompt, full)
        h = len(self._vshared[slot])
        for k in range(h, full):
            if self.prefix.register(keys[k], self._next_vbid):
                self._vshared[slot].append(self._next_vbid)
                self._next_vbid += 1

    def _ledger_bind(self, slot: int, n_prompt: int, budget: int, *,
                     n_valid: int | None = None,
                     shared_ids=()) -> None:
        """Mirror of ``PagedCache.splice`` / ``splice_prefix`` (fresh
        admit) / ``import_slot`` (resume): alias the matched shared
        prefix, allocate the private remainder, reserve the worst
        case."""
        if self.kv_kind != "paged":
            return
        held = n_prompt if n_valid is None else n_valid
        now = max(1, math.ceil(max(held, 1) / self.block_size))
        h = len(shared_ids)
        if shared_ids:
            self.prefix.acquire(shared_ids)
        self._vshared[slot] = list(shared_ids)
        self._alloc_private(now - h)
        self._nblk[slot] = now
        self._rsv[slot] = max(0, self._need_blocks(n_prompt, budget) - now)

    def _ledger_grow(self, slot: int) -> None:
        """Mirror of ``decode_view``'s lazy allocation at the write
        head (one block when the position crosses a boundary)."""
        if self.kv_kind != "paged":
            return
        b = int(self.slot_pos[slot]) // self.block_size
        if b >= int(self._nblk[slot]):
            self._alloc_private(1)
            self._nblk[slot] = b + 1
            self._rsv[slot] = max(0, int(self._rsv[slot]) - 1)

    def _ledger_free(self, slot: int) -> None:
        if self.kv_kind != "paged":
            return
        shared = self._vshared[slot]
        self._free_blocks += int(self._nblk[slot]) - len(shared)
        for bid in shared:   # table order — LRU insertion order matters
            self.prefix.release(bid)
        self._vshared[slot] = []
        self._nblk[slot] = 0
        self._rsv[slot] = 0

    def _span_bytes(self, n_valid: int) -> int:
        """Bytes of one exported slot packet — the quantized span the
        real ``export_slot`` ships."""
        if self.kv_kind == "paged":
            span = max(1, math.ceil(max(n_valid, 1)
                                    / self.block_size)) * self.block_size
        else:
            span = min(_export_span(n_valid), self.ecfg.max_seq_len)
        return int(span * self._bpt)

    # -- admission / preemption mechanism (called by the scheduler) --------
    def _suffix_cost(self, n_suf: int) -> PhaseResult:
        """Price of a warm suffix-only admission: one ``chunk_{kind}``
        dispatch over the bucketed suffix (the engine's warm path
        reuses the chunked-prefill closure at the matched history
        offset), the suffix token ids H2D — the shared-prefix KV
        ingest is exactly the cost the cache avoids — and the
        first-token D2H."""
        psim = self._psim
        r = PhaseResult()
        nb = self._bucket_len(n_suf)
        r.add(_stream_cost(psim._chunk_ops(nb, self.ecfg.max_seq_len,
                                           self.kv_kind, self.block_size),
                           psim.hw, psim.sim))
        r.add(_host_transfer(nb * 4, psim.hw, d2h=False))
        r.add(_host_transfer(4, psim.hw, d2h=True))
        if psim.sim.tp_degree > 1:
            cfg = psim.cfg
            per_tok = (2 * cfg.n_layers * cfg.d_model * 2
                       * (psim.sim.tp_degree - 1) / psim.sim.tp_degree)
            r.add(_tp_collective(per_tok * nb, psim.hw))
        r.seconds += psim.sim.orchestration_s
        r.host_s += psim.sim.orchestration_s
        return r

    def _admit_one(self, slot: int, req) -> bool:
        if req.rid in self.preempted_packets:
            return self._resume_slot(slot, req)
        budget = self._budget(req)
        if budget <= 0:
            req.t_first = req.t_done = self._now()
            self.finished.append(req)
            return True
        cap = self._prompt_cap()
        n_tok = int(req.prompt.shape[0])
        if n_tok > cap:
            req.truncated_from = n_tok
            n_tok = cap
        cfg = self.sim.cfg
        n_prefix = (cfg.n_image_tokens
                    if cfg.family == "vlm" and cfg.n_image_tokens else 0)
        n_prompt = n_tok + n_prefix
        prompt = req.prompt[:n_tok] if self.prefix is not None else None
        if not self.can_admit(n_prompt, budget, prompt=prompt):
            return False
        if (self.prefix is not None
                and self.prefix_match_tokens(prompt, n_prompt)):
            return self._admit_prefix(slot, req, prompt, n_prompt, budget)
        # one bucketed whole-prompt prefill dispatch, priced on the
        # prefill tier's hardware
        self.enc.add(self._psim.encode(1, self._bucket_len(n_tok)))
        self.prefills += 1
        self.admission_log.append(req.rid)
        req.prefill_chunks = 1
        req.t_first = self._now()
        req.output.append(self._TOKEN)
        if budget <= 1 or n_prompt >= self.ecfg.max_seq_len - 1:
            req.t_done = self._now()   # admit-time retirement
            self.finished.append(req)
            return True
        if self.prefix is not None:     # cold miss, counted on splice
            self.prefix_lookups += 1
            self.prefix_lookup_tokens += n_prompt
        self._ledger_bind(slot, n_prompt, budget)
        if self.prefix is not None:
            self._register(slot, prompt, n_prompt)
        self.slot_req[slot] = req
        self.slot_len[slot] = 1
        self.slot_pos[slot] = n_prompt
        self.slot_nprompt[slot] = n_prompt
        return True

    def _admit_prefix(self, slot: int, req, prompt, n_prompt: int,
                      budget: int) -> bool:
        """Warm admission: mirror of ``ServingEngine._admit_prefix``
        step for step — alias the matched blocks, price only the
        suffix chunk, publish on decode bind."""
        ids = self.prefix.match(prompt, n_prompt)
        h_tok = len(ids) * self.block_size
        # counters land exactly where PagedCache.splice_prefix puts them
        self.prefix_lookups += 1
        self.prefix_lookup_tokens += n_prompt
        self.prefix_hits += 1
        self.prefix_hit_tokens += h_tok
        n_suf = n_prompt - h_tok
        self.enc.add(self._suffix_cost(n_suf))
        self.prefill_chunk_dispatches += 1
        self.prefills += 1
        self.admission_log.append(req.rid)
        req.prefill_chunks = 1
        req.t_first = self._now()
        req.output.append(self._TOKEN)
        if budget <= 1 or n_prompt >= self.ecfg.max_seq_len - 1:
            # admit-time retirement: the engine acquires on splice and
            # releases on free — replay the LRU recency poke, including
            # the suffix allocs (which can evict under pressure)
            now = max(1, math.ceil(n_prompt / self.block_size))
            self.prefix.acquire(ids)
            self._alloc_private(now - len(ids))
            for bid in ids:
                self.prefix.release(bid)
            self._free_blocks += now - len(ids)
            req.t_done = self._now()
            self.finished.append(req)
            return True
        self._ledger_bind(slot, n_prompt, budget, shared_ids=ids)
        self._register(slot, prompt, n_prompt)
        self.slot_req[slot] = req
        self.slot_len[slot] = 1
        self.slot_pos[slot] = n_prompt
        self.slot_nprompt[slot] = n_prompt
        return True

    def _pack_slot(self, slot: int) -> dict:
        req = self.slot_req[slot]
        n_prompt = int(self.slot_nprompt[slot])
        pkt = {"req": req, "pos": int(self.slot_pos[slot]),
               "gen_len": int(self.slot_len[slot]),
               "n_prompt": n_prompt,
               "budget": self._budget(req),
               "kv_bytes": self._span_bytes(int(self.slot_pos[slot]))}
        if self.prefix is not None:   # shared-block provenance
            pkt["prompt"] = req.prompt[:n_prompt]
        self.slot_req[slot] = None
        self.slot_len[slot] = 0
        self._ledger_free(slot)
        return pkt

    def _unpack_slot(self, pkt: dict, slot: int) -> None:
        # mirror of import_slot's provenance re-match: alias whatever
        # prefix the importing pool already holds, copy only the tail
        ids = ()
        if self.prefix is not None and pkt.get("prompt") is not None:
            ids = self.prefix.match(pkt["prompt"], pkt["n_prompt"])
        self._ledger_bind(slot, pkt["n_prompt"], pkt["budget"],
                          n_valid=pkt["pos"], shared_ids=ids)
        self.slot_req[slot] = pkt["req"]
        self.slot_len[slot] = pkt["gen_len"]
        self.slot_pos[slot] = pkt["pos"]
        self.slot_nprompt[slot] = pkt["n_prompt"]

    def preempt_slot(self, slot: int) -> dict:
        req = self.slot_req[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not live")
        pkt = self._pack_slot(slot)
        self.preempted_packets[req.rid] = pkt
        req.preemptions += 1
        self.preemptions += 1
        self.preempted_kv_bytes += pkt["kv_bytes"]
        self.preemption_log.append((self.step_index, req.rid))
        self.waiting.append(req)
        # eviction ships the packet to host memory
        self.xfer.add(_host_transfer(pkt["kv_bytes"], self.hw, d2h=True))
        return pkt

    def _resume_slot(self, slot: int, req) -> bool:
        pkt = self.preempted_packets[req.rid]
        if not self.can_admit(pkt["n_prompt"], pkt["budget"]):
            return False
        del self.preempted_packets[req.rid]
        self._unpack_slot(pkt, slot)
        self.admission_log.append(req.rid)
        self.xfer.add(_host_transfer(pkt["kv_bytes"], self.hw, d2h=False))
        return True

    def _retire_slot(self, i: int) -> None:
        req = self.slot_req[i]
        req.t_done = self._now()
        self.finished.append(req)
        self.slot_req[i] = None
        self.slot_len[i] = 0
        self._ledger_free(i)

    # -- the step loop -----------------------------------------------------
    def _decode_step_cost(self, l_mean: float) -> PhaseResult:
        r = _stream_cost(self._dec_ops, self.hw, self.scfg, at=l_mean)
        B = self.ecfg.max_batch
        r.add(_host_transfer(B * 4, self.hw, d2h=True))
        r.add(_host_transfer(B * 4, self.hw, d2h=False))
        if self.scfg.tp_degree > 1:
            cfg = self.sim.cfg
            per_tok = (2 * cfg.n_layers * cfg.d_model * 2
                       * (self.scfg.tp_degree - 1) / self.scfg.tp_degree)
            r.add(_tp_collective(per_tok * B, self.hw))
        r.seconds += self.scfg.orchestration_s
        r.host_s += self.scfg.orchestration_s
        return r

    def step(self) -> PhaseResult | None:
        """One engine iteration, in the exact order ``ServingEngine.
        step`` runs it: admit -> one ragged decode dispatch over the
        live slots -> retire. Returns the step's decode cost (the
        cluster mirror max-reduces it across parallel workers)."""
        self.step_index += 1
        self.scheduler.admit(self)
        live = [i for i, r in enumerate(self.slot_req) if r is not None]
        cost = None
        if live:
            for i in live:
                self._ledger_grow(i)
            l_mean = float(np.mean([int(self.slot_pos[i]) for i in live]))
            cost = self._decode_step_cost(l_mean)
            self.dec.add(cost)
            self.decode_steps += 1
            for i in live:
                self.slot_req[i].output.append(self._TOKEN)
                self.slot_len[i] += 1
                self.slot_pos[i] += 1
        self.scheduler.retire(self)
        return cost


class _TraceWorker:
    """One tier worker of the cluster mirror (a ``_TraceSlotSim`` plus
    the routing flags ``ClusterEngine.Worker`` carries)."""

    def __init__(self, role: str, idx: int, eng: _TraceSlotSim):
        self.role = role
        self.idx = idx
        self.alive = True
        self.draining = False
        self.eng = eng

    def live_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.eng.slot_req) if r is not None]

    def free_slot(self) -> int | None:
        for i, r in enumerate(self.eng.slot_req):
            if r is None:
                return i
        return None


class _TraceClusterSim:
    """``ClusterEngine``, analytically: the same admit → place → step
    loop over ``_TraceWorker`` tiers, the same least-loaded router and
    prefill-rate throttle, and — critically — the same shared
    :func:`repro_torch.serving.workload.autoscale_decision` at the same step
    cadence, so the rescale schedule is bit-identical to the engine's.
    Healthy clusters only (no straggler drain / kill injection — those
    paths are exercised on the real engine)."""

    def __init__(self, sim: "LLMSimulator", ecfg, *, kv_cache: str,
                 kv_block_size: int, n_prefill: int, n_decode: int,
                 opts: dict, prefill_sim=None):
        self.sim = sim
        self.ecfg = ecfg
        self.opts = opts
        mk = lambda: _TraceSlotSim(sim, ecfg, kv_cache=kv_cache,
                                   kv_block_size=kv_block_size,
                                   prefill_sim=prefill_sim)
        self.prefill_workers = [_TraceWorker("prefill", i, mk())
                                for i in range(n_prefill)]
        self.decode_workers = [_TraceWorker("decode", n_prefill + i, mk())
                               for i in range(n_decode)]
        self.waiting: deque = deque()
        self.pending: deque = deque()
        self.finished: list = []
        self._pf_rr = 0
        self.prefix_routed = 0
        self.handoffs = 0
        self.migrations = 0
        self.kv_transfer_bytes = 0
        self.migration_bytes = 0
        self.steps = 0
        self.rescale_log: list[tuple[int, str]] = []
        self.now_s = 0.0
        self.xfer = PhaseResult()      # interconnect handoff / migration
        self.decode_wall_s = 0.0       # parallel decode tier: max/step

    # -- surface -----------------------------------------------------------
    def set_now(self, t: float) -> None:
        self.now_s = float(t)
        for w in self.prefill_workers + self.decode_workers:
            w.eng.set_now(t)

    def _now(self) -> float:
        return self.now_s

    def has_work(self) -> bool:
        return bool(self.waiting or self.pending
                    or any(w.alive and w.live_slots()
                           for w in self.decode_workers))

    @property
    def decode_steps(self) -> int:
        return sum(w.eng.decode_steps
                   for w in self.prefill_workers + self.decode_workers)

    # -- internals (mirroring ClusterEngine method-for-method) -------------
    def _budget_slots(self, w) -> int:
        cap = self.ecfg.max_batch
        inf = int(self.opts.get("in_flight", 0))
        return min(inf, cap) if inf else cap

    def _decode_headroom(self) -> int:
        cap = 0
        for w in self.decode_workers:
            if w.alive and not w.draining:
                cap += max(0, self._budget_slots(w) - len(w.live_slots()))
        return cap - len(self.pending)

    def _collect(self, eng: _TraceSlotSim) -> None:
        if eng.finished:
            self.finished.extend(eng.finished)
            eng.finished.clear()

    def _interconnect(self, n_bytes: int) -> PhaseResult:
        hw = self.sim.hw
        bw = (hw.interconnect_bw_gbs or hw.h2d_bw_gbs) * 1e9
        pj = (hw.interconnect_pj_per_bit
              if hw.interconnect_bw_gbs else hw.h2d_pj_per_bit)
        r = PhaseResult()
        r.seconds = n_bytes / bw
        r.host_s = r.seconds
        r.host_bytes = n_bytes
        r.energy_j = n_bytes * 8 * pj * 1e-12
        return r

    def _export_slot(self, w: _TraceWorker, slot: int, *,
                     migration: bool = False) -> None:
        pkt = w.eng._pack_slot(slot)
        self.kv_transfer_bytes += pkt["kv_bytes"]
        if migration:
            self.migrations += 1
            self.migration_bytes += pkt["kv_bytes"]
        else:
            self.handoffs += 1
        self.pending.append(pkt)
        self.xfer.add(self._interconnect(pkt["kv_bytes"]))

    def _migrate_all(self, w: _TraceWorker) -> None:
        for slot in w.live_slots():
            self._export_slot(w, slot, migration=True)

    def _autoscale(self) -> None:
        routable = [w for w in self.decode_workers
                    if w.alive and not w.draining]
        alive_pf = [w for w in self.prefill_workers if w.alive]
        decision = autoscale_decision(
            waiting=len(self.waiting), pending=len(self.pending),
            live=sum(len(w.live_slots()) for w in routable),
            n_prefill=len(alive_pf), n_decode=len(routable),
            slots_per_worker=self.ecfg.max_batch)
        if decision == "to_decode":
            w = alive_pf[-1]
            self.prefill_workers.remove(w)
            w.role = "decode"
            self.decode_workers.append(w)
        elif decision == "to_prefill":
            w = min(routable, key=lambda o: (len(o.live_slots()),
                                             self.decode_workers.index(o)))
            self._migrate_all(w)
            self.decode_workers.remove(w)
            w.role = "prefill"
            self.prefill_workers.append(w)
        if decision:
            self.rescale_log.append((self.steps, decision))

    def _admit_prefills(self) -> None:
        head = self._decode_headroom()
        if not self.waiting:
            return
        pws = [w for w in self.prefill_workers if w.alive]
        rate = int(self.opts.get("prefill_rate", 0))
        quota = rate * len(pws) if rate > 0 else float("inf")
        while self.waiting and head > 0 and quota > 0:
            quota -= 1
            w = self._pick_prefill_worker(pws, self.waiting[0])
            req = self.waiting.popleft()
            w.eng.waiting.append(req)
            w.eng.scheduler.admit(w.eng)
            self._collect(w.eng)   # admit-time retirements finish here
            if w.eng.waiting:
                # deferred by the worker's pool ledger: push back, stop
                self.waiting.appendleft(w.eng.waiting.popleft())
                break
            for slot in w.live_slots():
                self._export_slot(w, slot)
                head -= 1

    def _pick_prefill_worker(self, pws: list, req) -> "_TraceWorker":
        """Mirror of ``ClusterEngine._pick_prefill_worker``: prefix
        affinity over round-robin, same cursor discipline, same
        in-worker-order tie break."""
        rr = pws[self._pf_rr % len(pws)]
        self._pf_rr += 1
        eng0 = pws[0].eng
        if eng0.prefix is None:
            return rr
        prompt = req.prompt[:eng0._prompt_cap()]
        n_prompt = int(prompt.shape[0])
        best, score = None, 0
        for w in pws:
            s = w.eng.prefix_match_tokens(prompt, n_prompt)
            if s > score:
                best, score = w, s
        if best is None:
            return rr
        self.prefix_routed += 1
        return best

    def _route(self, pkt: dict) -> _TraceWorker | None:
        best = None
        for w in self.decode_workers:
            if not w.alive or w.draining:
                continue
            live = len(w.live_slots())
            if live >= self._budget_slots(w) or w.free_slot() is None:
                continue
            if not w.eng.can_admit(pkt["n_prompt"], pkt["budget"]):
                continue
            if best is None or live < len(best.live_slots()):
                best = w
        return best

    def _place_pending(self) -> None:
        still: deque = deque()
        while self.pending:
            pkt = self.pending.popleft()
            w = self._route(pkt)
            if w is None:
                still.append(pkt)
                continue
            w.eng._unpack_slot(pkt, w.free_slot())
        self.pending = still

    def step(self) -> None:
        self.steps += 1
        if (self.opts.get("autoscale")
                and self.steps % int(self.opts.get("autoscale_interval", 8))
                == 0):
            self._autoscale()
        if self.opts.get("slo_aware") and len(self.waiting) > 1:
            now = self._now()
            ordered = sorted(self.waiting,
                             key=lambda r: slo_sort_key(r, now))
            self.waiting.clear()
            self.waiting.extend(ordered)
        self._admit_prefills()
        self._place_pending()
        wall = 0.0
        for w in self.decode_workers:
            if not w.alive or not w.live_slots():
                continue
            cost = w.eng.step()
            self._collect(w.eng)
            if cost is not None:
                wall = max(wall, cost.seconds)
        self.decode_wall_s += wall


# model config -> its DispatchPricer (see LLMSimulator.__init__)
_PRICERS: dict = {}


def pricer_of(cfg) -> CM.DispatchPricer:
    """The one :class:`~repro_torch.core.costmodel.DispatchPricer` of
    ``cfg`` the simulators share."""
    if cfg not in _PRICERS:
        _PRICERS[cfg] = CM.DispatchPricer(cfg)
    return _PRICERS[cfg]


class LLMSimulator:
    """Per-(model, profile) generation simulator: encode + decode."""

    def __init__(self, cfg, hw: HardwareProfile, sim: SimConfig | None = None):
        self.cfg = cfg
        self.hw = hw
        self.sim = sim or SimConfig()
        # all traced op streams come from the static cost model, which
        # prices the serving engine's real dispatch closures
        # (engine.build_closures -> core/costmodel.DispatchPricer), one
        # pricer per model config shared by every simulator of it: the
        # streams depend on the config only, never on the hardware.
        # The memo dicts are aliased under their historical names so
        # memoization regressions stay visible to the tests.
        self.pricer = pricer_of(cfg)
        self._decode_linear = self.pricer.decode_linear
        self._prefill_cache = self.pricer.prefill_cache
        self._chunk_cache = self.pricer.chunk_cache
        self._verify_linear = self.pricer.verify_linear

    # -- traced op streams (delegated to the dispatch pricer) --------------
    def _prefill_ops(self, batch: int, n_in: int):
        return self.pricer.prefill_ops(batch, n_in)

    def _decode_ops_linear(self, batch: int, max_len: int, *,
                           ragged: bool = False,
                           kv_cache: str = "contiguous",
                           kv_block_size: int = 16):
        return self.pricer.decode_ops_linear(
            batch, max_len, ragged=ragged, kv_cache=kv_cache,
            kv_block_size=kv_block_size)

    def _verify_ops_linear(self, batch: int, max_len: int, gamma: int, *,
                           kv_cache: str = "contiguous",
                           kv_block_size: int = 16):
        return self.pricer.verify_ops_linear(
            batch, max_len, gamma, kv_cache=kv_cache,
            kv_block_size=kv_block_size)

    def _chunk_ops(self, chunk_tokens: int, capacity: int,
                   kind: str = "contiguous", kv_block_size: int = 16):
        return self.pricer.chunk_ops(chunk_tokens, capacity, kind,
                                     kv_block_size)

    # -- phases --------------------------------------------------------------
    def encode(self, batch: int, n_in: int) -> PhaseResult:
        """Prefill the prompt; ends when the first token is ready."""
        total = _stream_cost(self._prefill_ops(batch, n_in), self.hw,
                             self.sim)
        # prompt token ids H2D + first-token D2H
        total.add(_host_transfer(batch * n_in * 4, self.hw, d2h=False))
        total.add(_host_transfer(batch * 4, self.hw, d2h=True))
        # per-layer TP partial-result exchange (x2: attn out + mlp out)
        if self.sim.tp_degree > 1:
            per_tok = (2 * self.cfg.n_layers * self.cfg.d_model * 2
                       * (self.sim.tp_degree - 1) / self.sim.tp_degree)
            total.add(_tp_collective(per_tok * batch * n_in, self.hw))
        total.seconds += self.sim.orchestration_s
        total.host_s += self.sim.orchestration_s
        return total

    def decode(self, batch: int, n_in: float, n_out: int, *,
               ragged: bool = False, kv_cache: str = "contiguous",
               kv_block_size: int = 16) -> PhaseResult:
        """Generate n_out tokens after the first (cache grows each step).

        ``n_in`` may be fractional (mean prompt length of a ragged
        batch); ``ragged`` charges the engine's single-dispatch ragged
        decode graph instead of the aligned one; ``kv_cache="paged"``
        charges the block-table graph over resident-sized pools."""
        ops = self._decode_ops_linear(batch, int(math.ceil(n_in)) + n_out,
                                      ragged=ragged, kv_cache=kv_cache,
                                      kv_block_size=kv_block_size)
        total = PhaseResult()
        # evaluate the linear per-op model at each step's cache length;
        # summing the linear model over steps == evaluating at the mean L.
        L_mean = n_in + (n_out - 1) / 2.0
        step = _stream_cost(ops, self.hw, self.sim, at=L_mean)
        for f in ("seconds", "energy_j", "compute_s", "memory_s", "host_s",
                  "ops", "mem_bytes", "host_bytes"):
            setattr(total, f, getattr(step, f) * n_out)
        # per-step: next-token id D2H+H2D, orchestration, TP exchange
        per_step_host = _host_transfer(batch * 4, self.hw, d2h=True)
        per_step_host.add(_host_transfer(batch * 4, self.hw, d2h=False))
        if self.sim.tp_degree > 1:
            per_tok = (2 * self.cfg.n_layers * self.cfg.d_model * 2
                       * (self.sim.tp_degree - 1) / self.sim.tp_degree)
            per_step_host.add(_tp_collective(per_tok * batch, self.hw))
        for f in ("seconds", "energy_j", "host_s", "host_bytes"):
            setattr(total, f, getattr(total, f)
                    + getattr(per_step_host, f) * n_out)
        total.seconds += self.sim.orchestration_s * n_out
        total.host_s += self.sim.orchestration_s * n_out
        return total

    def serve(self, n_ins=None, n_out: int = 0, *,
              kv_cache: str = "contiguous",
              kv_block_size: int = 16, max_seq_len: int | None = None,
              scheduler: str = "blocking", chunk_tokens: int = 64,
              gamma: int = 4, acceptance: float = 0.8,
              draft_layers: int = 0,
              cluster: tuple | None = None,
              trace=None, step_quantum_s: float = 0.01,
              max_batch: int = 8, kv_blocks: int = 0,
              cluster_opts: dict | None = None,
              prefill_sim: "LLMSimulator | None" = None,
              prefix_cache: bool = False,
              mesh: tuple | None = None) -> dict:
        """Continuous-batching cloud scenario (matches ``ServingEngine``):
        per-request prefill + one fully-ragged decode dispatch per step
        over the whole batch, each row's KV span growing from its own
        prompt length. The linear per-op cost model is evaluated at the
        batch-mean cache length (summing a linear model over ragged rows
        == evaluating it at the row mean).

        ``kv_cache`` selects the cache backend being modelled, exactly
        mirroring ``EngineConfig.kv_cache``: ``"paged"`` traces the
        block-table decode graph and reports resident KV bytes from the
        blocks the workload actually touches, instead of the dense
        ``batch x max_seq_len`` charge (``max_seq_len`` defaults to the
        workload's own ``max(n_in) + n_out`` capacity).

        ``scheduler`` mirrors ``EngineConfig.scheduler``. ``"chunked"``
        charges the chunked-prefill schedule instead of the blocking
        one: prompts stream in as ``chunk_tokens``-sized chunks
        (shortest-remaining-first, as the engine schedules them), each
        simulated step carrying one chunk dispatch plus one ragged
        decode dispatch for the already-prefilled rows — so simulated
        TTFT/TPOT reflect the head-of-line-blocking policy, not just
        the op totals.

        ``"speculative"`` charges the draft/verify schedule: ``gamma``
        small-model dispatches plus one multi-token target verify per
        round, with ``acceptance`` the per-candidate acceptance
        probability (expected commits per round follow the greedy
        longest-prefix law) and ``draft_layers`` the draft's depth
        (0 -> n_layers // 2 self-draft). This is where the PIM
        energy/token claim becomes measurable: decode is memory-bound,
        so amortizing one target weight stream over the accepted
        tokens cuts energy per token roughly by the commit rate.

        ``cluster=(n_prefill, n_decode)`` mirrors
        ``serving.cluster.ClusterEngine``: prefills round-robin over
        ``n_prefill`` workers (sequential per worker), each request's KV
        is handed off once over the device interconnect (charged bytes
        + energy), and the decode batch splits across ``n_decode``
        workers stepping in parallel. Blocking scheduler only — exactly
        the restriction the engine enforces.

        ``trace=`` (a :class:`repro_torch.serving.workload.Trace`) switches to
        the step-driven multi-tenant mirror: the simulator runs the
        *actual* scheduler-policy objects (``BlockingScheduler`` /
        ``SLOScheduler``, and the shared cluster autoscale policy) over
        an analytical slot mechanism on the same virtual clock the
        ``replay`` driver uses, so the admission order, preemption log
        and rescale schedule are reproduced exactly — and then priced
        per dispatch through the hardware cost model. ``scheduler``
        must be ``"blocking"`` or ``"slo"``; ``max_batch`` /
        ``max_seq_len`` / ``step_quantum_s`` mirror the engine
        configuration; ``cluster`` + ``cluster_opts`` (``autoscale``,
        ``autoscale_interval``, ``prefill_rate``, ``in_flight``,
        ``slo_aware``) mirror ``ClusterConfig``; ``prefill_sim`` prices
        prefill dispatches on different hardware (the paper's
        xPU-prefill / PIM-decode split); ``prefix_cache=True`` mirrors
        ``EngineConfig.prefix_cache`` — the trace mirror runs the
        *real* ``PrefixIndex`` over virtual block ids, so the engine's
        hit/miss/eviction schedule is reproduced exactly and warm
        admissions are priced as suffix-only chunk dispatches (the
        avoided prefix prefill + KV ingest is the saving)."""
        if mesh is not None:
            d, m = int(mesh[0]), int(mesh[1])
            if d < 1 or m < 1:
                raise ValueError(
                    f"mesh={mesh!r} must be a (data, model) pair of "
                    "positive axis sizes (mirrors EngineConfig.mesh)")
            if trace is not None or cluster is not None:
                raise ValueError(
                    "mesh= mirrors one mesh-sharded ServingEngine; the "
                    "cluster/trace mirrors compose at the worker level "
                    "(each worker is its own sub-mesh) — price each "
                    "worker's serve(mesh=...) separately instead")
            if scheduler != "blocking":
                raise ValueError(
                    f"mesh serving mirrors the blocking engine, got "
                    f"scheduler={scheduler!r}")
            if n_ins is None:
                raise TypeError("serve(mesh=...) needs an n_ins workload")
            return self._serve_mesh(
                n_ins, n_out, d=d, m=m, kv_cache=kv_cache,
                kv_block_size=kv_block_size, max_seq_len=max_seq_len)
        if trace is not None:
            if scheduler not in ("blocking", "slo"):
                raise ValueError(
                    f"trace serving mirrors blocking/slo admission, got "
                    f"scheduler={scheduler!r}")
            cap = max_seq_len or (
                max(int(r.prompt.shape[0]) for r in trace.requests)
                + max(int(r.max_new_tokens) for r in trace.requests) + 1)
            if cluster is not None:
                if scheduler != "blocking":
                    raise ValueError(
                        f"cluster serving requires scheduler='blocking', "
                        f"got {scheduler!r} (mirrors ClusterEngine)")
                return self._serve_trace_cluster(
                    trace, kv_cache=kv_cache, kv_block_size=kv_block_size,
                    cap=cap, max_batch=max_batch, kv_blocks=kv_blocks,
                    n_prefill=int(cluster[0]), n_decode=int(cluster[1]),
                    step_quantum_s=step_quantum_s,
                    opts=cluster_opts or {}, prefill_sim=prefill_sim,
                    prefix_cache=prefix_cache)
            return self._serve_trace(
                trace, kv_cache=kv_cache, kv_block_size=kv_block_size,
                cap=cap, scheduler=scheduler, max_batch=max_batch,
                kv_blocks=kv_blocks,
                step_quantum_s=step_quantum_s, prefill_sim=prefill_sim,
                prefix_cache=prefix_cache)
        if n_ins is None:
            raise TypeError("serve() needs a workload: either n_ins/"
                            "n_out or trace=")
        batch = len(n_ins)
        cap = max_seq_len or (max(int(n) for n in n_ins) + n_out)
        if cluster is not None:
            if scheduler != "blocking":
                raise ValueError(
                    f"cluster serving requires scheduler='blocking', got "
                    f"{scheduler!r} (mirrors ClusterEngine)")
            return self._serve_cluster(
                n_ins, n_out, kv_cache=kv_cache,
                kv_block_size=kv_block_size, cap=cap,
                n_prefill=int(cluster[0]), n_decode=int(cluster[1]))
        if scheduler in ("chunked", "speculative"):
            if not policy_supported(self.cfg):
                # the same predicate make_scheduler consults: families
                # these policies cannot express fall back to blocking
                warnings.warn(
                    f"{scheduler} scheduling unsupported for family="
                    f"{self.cfg.family!r} sliding_window="
                    f"{self.cfg.sliding_window}; simulating the blocking "
                    "schedule", stacklevel=2)
            elif scheduler == "chunked":
                return self._serve_chunked(
                    n_ins, n_out, kv_cache=kv_cache,
                    kv_block_size=kv_block_size, cap=cap,
                    chunk_tokens=chunk_tokens)
            else:
                return self._serve_speculative(
                    n_ins, n_out, kv_cache=kv_cache,
                    kv_block_size=kv_block_size, cap=cap, gamma=gamma,
                    acceptance=acceptance, draft_layers=draft_layers)
        enc = PhaseResult()
        t_cum = ttft_sum = 0.0
        ttfts = []
        for n in n_ins:
            e = self.encode(1, int(n))
            enc.add(e)
            t_cum += e.seconds      # prefills run sequentially: request i
            ttfts.append(t_cum)     # waits for every earlier admit too
            ttft_sum += t_cum
        n_mean = sum(float(n) for n in n_ins) / batch
        dec = self.decode(batch, n_mean, n_out, ragged=True,
                          kv_cache=kv_cache, kv_block_size=kv_block_size)
        contiguous_bytes = contiguous_kv_bytes(self.cfg, batch, cap)
        if kv_cache == "paged":
            # positions each request ever writes: its prompt plus all
            # but the last generated token, capped by the capacity
            resident = paged_resident_kv_bytes(
                self.cfg, [min(int(n) + n_out - 1, cap) for n in n_ins],
                kv_block_size)
        else:
            resident = contiguous_bytes
        out = {
            "encode": enc,
            "decode": dec,
            "ttft_s": ttft_sum / batch,
            "ttft_per_req_s": ttfts,
            "tokens_per_s": batch * n_out / dec.seconds,
            "energy_per_token_j": dec.energy_j / (batch * n_out),
            "qps": batch / (enc.seconds + dec.seconds),
            "decode_dispatches": n_out,   # one per step, whole batch
            "kv_cache": kv_cache,
            "scheduler": "blocking",
            "prefill_chunks": batch,      # one monolithic chunk each
            "resident_kv_bytes": resident,
            "contiguous_kv_bytes": contiguous_bytes,
        }
        if scheduler == "speculative":
            # unsupported-family fallback: keep the documented
            # speculative keys present (degenerate values) so callers
            # reading them do not crash on ssm/hybrid/SWA configs
            out.update(accepted_tokens_per_step=1.0, acceptance=0.0,
                       spec_gamma=gamma, draft_dispatches=0,
                       draft_kv_bytes=0)
        return out

    def _serve_mesh(self, n_ins, n_out: int, *, d: int, m: int,
                    kv_cache: str, kv_block_size: int,
                    max_seq_len: int | None) -> dict:
        """Analytical mirror of one mesh-sharded ``ServingEngine``
        (``EngineConfig.mesh=(d, m)``), matching the engine's layout:

        - **model axis** (``m``): one engine spans ``m`` devices in
          tensor parallel — aggregate bandwidth/compute
          (:meth:`HardwareProfile.scaled`, the same convention the
          ``pim_engine`` tp_degree=128 profile uses) plus the per-layer
          partial-result exchange ``_tp_collective`` charges through
          ``tp_degree`` (the gather-rows all-gathers of the bitwise TP
          layout move the same per-token d_model bytes).
        - **data axis** (``d``): the slot batch splits round-robin
          across ``d`` KV shards that decode concurrently inside the
          one dispatch — charged as ``d`` parallel serves merged
          with seconds = max, energy/bytes/ops = sum.

        Reports the engine's mesh accounting keys: ``mesh``,
        ``kv_partitions`` (heads-over-model and, for contiguous,
        batch-over-data — mirroring ``cache_shardings`` /
        ``pool_shardings`` in the divisible case), and
        ``resident_kv_bytes_per_device``."""
        cap = max_seq_len or (max(int(n) for n in n_ins) + n_out)
        sub = self
        if m > 1:
            sub = LLMSimulator(
                self.cfg, self.hw.scaled(m, name=f"{self.hw.name}@tp{m}"),
                replace(self.sim, tp_degree=self.sim.tp_degree * m))
            # the sub-simulator shares this one's pricer (one per config):
            # sharding never changes the traced functions, only the
            # hardware they are priced on
        shards = [list(n_ins[i::d]) for i in range(d)]
        shards = [s for s in shards if s]
        runs = [sub.serve(s, n_out, kv_cache=kv_cache,
                          kv_block_size=kv_block_size, max_seq_len=cap)
                for s in shards]

        def merged(key):
            out = PhaseResult()
            for f in ("seconds", "compute_s", "memory_s", "host_s"):
                setattr(out, f, max(getattr(r[key], f) for r in runs))
            for f in ("energy_j", "ops", "mem_bytes", "host_bytes"):
                setattr(out, f, sum(getattr(r[key], f) for r in runs))
            return out

        enc, dec = merged("encode"), merged("decode")
        batch = len(n_ins)
        ttfts = [0.0] * batch
        for i, run in enumerate(runs):
            for j, t in enumerate(run["ttft_per_req_s"]):
                ttfts[i + j * len(shards)] = t
        resident = sum(r["resident_kv_bytes"] for r in runs)
        heads = getattr(self.cfg, "n_kv_heads", 0) or self.cfg.n_heads
        if kv_cache == "paged":
            # pools shard heads-over-model only; replicate otherwise
            parts = m if heads % m == 0 else 1
        else:
            # batch over data and heads (or, failing that, the
            # sequence) over model
            parts = len(shards) * m
        return {
            "encode": enc,
            "decode": dec,
            "ttft_s": sum(ttfts) / batch,
            "ttft_per_req_s": ttfts,
            "tokens_per_s": batch * n_out / dec.seconds,
            "energy_per_token_j": dec.energy_j / (batch * n_out),
            "qps": batch / (enc.seconds + dec.seconds),
            "decode_dispatches": n_out,   # still one per step: the mesh
            "kv_cache": kv_cache,         # shards inside the dispatch
            "scheduler": "blocking",
            "prefill_chunks": batch,
            "resident_kv_bytes": resident,
            "contiguous_kv_bytes": contiguous_kv_bytes(
                self.cfg, batch, cap),
            "mesh": (d, m),
            "mesh_devices": d * m,
            "kv_partitions": parts,
            "resident_kv_bytes_per_device": -(-resident // parts),
        }

    def _serve_chunked(self, n_ins, n_out: int, *, kv_cache: str,
                       kv_block_size: int, cap: int,
                       chunk_tokens: int) -> dict:
        """Step-driven chunked-prefill schedule (mirrors
        ``ChunkedScheduler``): every step runs at most one prefill
        chunk (shortest-remaining-first) plus one ragged decode
        dispatch over all already-prefilled rows. TTFT is the wall
        clock at a request's final chunk; rows then decode ``n_out``
        tokens (the same per-request token count :meth:`decode`
        charges), retiring as they finish."""
        batch = len(n_ins)
        chunk_step = _stream_cost(
            self._chunk_ops(chunk_tokens, cap, kv_cache, kv_block_size),
            self.hw, self.sim)
        dec_ops = self._decode_ops_linear(batch, cap, ragged=True,
                                          kv_cache=kv_cache,
                                          kv_block_size=kv_block_size)

        def decode_step_cost(l_mean: float) -> PhaseResult:
            r = _stream_cost(dec_ops, self.hw, self.sim, at=l_mean)
            r.add(_host_transfer(batch * 4, self.hw, d2h=True))
            r.add(_host_transfer(batch * 4, self.hw, d2h=False))
            if self.sim.tp_degree > 1:
                per_tok = (2 * self.cfg.n_layers * self.cfg.d_model * 2
                           * (self.sim.tp_degree - 1) / self.sim.tp_degree)
                r.add(_tp_collective(per_tok * batch, self.hw))
            return r

        # schedule state: remaining prefill positions / decoded tokens
        remaining = [int(n) for n in n_ins]
        decoded = [-1] * batch          # -1: still prefilling
        ttfts = [0.0] * batch
        enc = PhaseResult()
        dec = PhaseResult()
        t = 0.0
        steps = total_chunks = decode_dispatches = 0
        while (any(r > 0 for r in remaining)
               or any(0 <= d < n_out for d in decoded)):
            step_s = self.sim.orchestration_s
            pending = [i for i in range(batch) if remaining[i] > 0]
            if pending:  # one chunk, shortest-remaining-first
                i = min(pending, key=lambda j: (remaining[j], j))
                remaining[i] = max(0, remaining[i] - chunk_tokens)
                enc.add(chunk_step)
                step_s += chunk_step.seconds
                total_chunks += 1
                if remaining[i] == 0:
                    decoded[i] = 0      # first token sampled this step
                    ttfts[i] = t + step_s
            live = [i for i in range(batch) if 0 <= decoded[i] < n_out]
            if live:
                l_mean = (sum(float(n_ins[i]) + decoded[i] for i in live)
                          / len(live))
                d = decode_step_cost(l_mean)
                dec.add(d)
                step_s += d.seconds
                decode_dispatches += 1
                for i in live:
                    decoded[i] += 1
            t += step_s
            steps += 1
        enc.add(_host_transfer(sum(int(n) for n in n_ins) * 4, self.hw,
                               d2h=False))
        contiguous_bytes = contiguous_kv_bytes(self.cfg, batch, cap)
        if kv_cache == "paged":
            resident = paged_resident_kv_bytes(
                self.cfg, [min(int(n) + n_out - 1, cap) for n in n_ins],
                kv_block_size)
        else:
            resident = contiguous_bytes
        total_toks = batch * n_out
        return {
            "encode": enc,
            "decode": dec,
            "ttft_s": sum(ttfts) / batch,
            "ttft_per_req_s": ttfts,
            "tokens_per_s": total_toks / max(dec.seconds, 1e-12),
            "energy_per_token_j": dec.energy_j / total_toks,
            "qps": batch / max(t, 1e-12),
            "decode_dispatches": decode_dispatches,
            "kv_cache": kv_cache,
            "scheduler": "chunked",
            "prefill_chunks": total_chunks,
            "steps": steps,
            "resident_kv_bytes": resident,
            "contiguous_kv_bytes": contiguous_bytes,
        }

    def _serve_cluster(self, n_ins, n_out: int, *, kv_cache: str,
                       kv_block_size: int, cap: int, n_prefill: int,
                       n_decode: int) -> dict:
        """Disaggregated prefill/decode schedule (mirrors
        ``ClusterEngine``): prompts prefill round-robin across
        ``n_prefill`` workers (sequential per worker — one prefill
        dispatch at a time each, like the engine), every request's KV
        crosses the device boundary once (prompt positions times
        bytes/token, charged at the interconnect parameters — the
        Sangam-style KV-movement constraint), and the decode batch
        splits evenly across ``n_decode`` workers whose ragged decode
        steps run in parallel — wall-clock decode is the slowest
        worker's, energy is the sum."""
        if n_prefill < 1 or n_decode < 1:
            raise ValueError(f"cluster needs >= 1 worker per phase, got "
                             f"({n_prefill}, {n_decode})")
        batch = len(n_ins)
        # prefill tier + per-request KV handoff
        bpt = kv_bytes_per_token(self.cfg) * (self.sim.act_bits / 16.0)
        bw = (self.hw.interconnect_bw_gbs or self.hw.h2d_bw_gbs) * 1e9
        pj = (self.hw.interconnect_pj_per_bit
              if self.hw.interconnect_bw_gbs else self.hw.h2d_pj_per_bit)
        enc = PhaseResult()
        xfer = PhaseResult()
        busy = [0.0] * n_prefill
        ttfts = []
        for i, n in enumerate(n_ins):
            e = self.encode(1, int(n))
            enc.add(e)
            w = i % n_prefill
            busy[w] += e.seconds
            # TTFT is to the first sampled token — the prefill worker
            # samples it before the handoff, exactly like the engine
            ttfts.append(busy[w])
            tb = int(n) * bpt
            ts = tb / bw
            xfer.seconds += ts
            xfer.host_s += ts
            xfer.host_bytes += tb
            xfer.energy_j += tb * 8 * pj * 1e-12
        # decode tier: batch split evenly, workers step in parallel
        n_mean = sum(float(n) for n in n_ins) / batch
        sizes = [batch // n_decode + (1 if i < batch % n_decode else 0)
                 for i in range(n_decode)]
        sizes = [s for s in sizes if s > 0]
        dec = PhaseResult()
        wall = 0.0
        for sb in sizes:
            d = self.decode(sb, n_mean, n_out, ragged=True,
                            kv_cache=kv_cache, kv_block_size=kv_block_size)
            dec.add(d)              # energy / ops / bytes sum over workers
            wall = max(wall, d.seconds)
        dec.seconds = wall          # ... but the workers run in parallel
        contiguous_bytes = contiguous_kv_bytes(self.cfg, batch, cap)
        if kv_cache == "paged":
            resident = paged_resident_kv_bytes(
                self.cfg, [min(int(n) + n_out - 1, cap) for n in n_ins],
                kv_block_size)
        else:
            resident = contiguous_bytes
        total_toks = batch * n_out
        makespan = max(busy) + xfer.seconds + wall
        return {
            "encode": enc,
            "decode": dec,
            "kv_transfer": xfer,
            "kv_transfer_bytes": xfer.host_bytes,
            "kv_transfer_s": xfer.seconds,
            "kv_transfer_energy_j": xfer.energy_j,
            "cluster": (n_prefill, n_decode),
            "ttft_s": sum(ttfts) / batch,
            "ttft_per_req_s": ttfts,
            "tokens_per_s": total_toks / max(wall, 1e-12),
            "energy_per_token_j": dec.energy_j / total_toks,
            "qps": batch / max(makespan, 1e-12),
            "decode_dispatches": n_out * len(sizes),  # one per worker step
            "kv_cache": kv_cache,
            "scheduler": "blocking",
            "prefill_chunks": batch,
            "resident_kv_bytes": resident,
            "contiguous_kv_bytes": contiguous_bytes,
        }

    # -- trace-driven multi-tenant mirror ----------------------------------
    def _trace_requests(self, trace):
        """Real ``Request`` objects for the trace, in replay submit
        order — rids match the trace's, so schedule logs compare
        directly against ``workload.replay``'s translated ones."""
        order = sorted(trace.requests, key=lambda r: (r.arrival_s, r.rid))
        return deque(
            Request(tr.rid, np.asarray(tr.prompt, np.int32),
                    int(tr.max_new_tokens), seed=tr.seed,
                    tenant=tr.tenant, priority=int(tr.priority),
                    slo=tr.slo, arrival_s=float(tr.arrival_s),
                    t_submit=float(tr.arrival_s))
            for tr in order)

    def _trace_summary(self, done, preemptions: int) -> dict:
        if not done:
            return {"requests": 0}
        ttft = [r.ttft_s for r in done]
        return {
            "requests": len(done),
            "tokens": sum(len(r.output) for r in done),
            "mean_ttft_s": float(np.mean(ttft)),
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99)),
            "mean_itl_s": float(np.mean(
                [r.itl_s for r in done if len(r.output) > 1] or [0.0])),
            "preemptions": preemptions,
            "slo_attainment": sum(r.slo_met for r in done) / len(done),
            **request_breakdowns(done),
        }

    def _serve_trace(self, trace, *, kv_cache: str, kv_block_size: int,
                     cap: int, scheduler: str, max_batch: int,
                     step_quantum_s: float, kv_blocks: int = 0,
                     prefill_sim=None, prefix_cache: bool = False,
                     max_steps: int = 200_000) -> dict:
        """Single-engine trace mirror: the replay loop of
        ``serving.workload.replay``, verbatim, over the analytical slot
        mechanism — same virtual clock, same arrival quantization, same
        (real) scheduler policy. The returned ``admission_order`` /
        ``preemption_log`` / per-request virtual TTFTs are equal to the
        engine replay's; the PhaseResults price that schedule on this
        simulator's hardware."""
        ecfg = EngineConfig(max_batch=max_batch, max_seq_len=cap,
                            scheduler=scheduler, kv_cache=kv_cache,
                            kv_block_size=kv_block_size,
                            kv_blocks=kv_blocks,
                            prefix_cache=prefix_cache)
        tsim = _TraceSlotSim(self, ecfg, kv_cache=kv_cache,
                             kv_block_size=kv_block_size,
                             prefill_sim=prefill_sim)
        queue = self._trace_requests(trace)
        it = 0
        while queue or tsim.has_work():
            if it >= max_steps:
                raise RuntimeError(
                    f"trace {trace.name!r} did not drain in "
                    f"{max_steps} steps")
            now = it * step_quantum_s
            tsim.set_now(now)
            while queue and queue[0].arrival_s <= now:
                tsim.waiting.append(queue.popleft())
            tsim.step()
            it += 1
        tsim.set_now(it * step_quantum_s)
        done = tsim.finished
        toks = sum(len(r.output) for r in done)
        enc, dec, xfer = tsim.enc, tsim.dec, tsim.xfer
        busy = enc.seconds + dec.seconds + xfer.seconds
        energy = enc.energy_j + dec.energy_j + xfer.energy_j
        horizon = it * step_quantum_s
        return {
            "trace": trace.name,
            "scheduler": scheduler,
            "kv_cache": kv_cache,
            "steps": it,
            "step_quantum_s": step_quantum_s,
            "virtual_s": horizon,
            "decode_steps": tsim.decode_steps,
            "tokens": toks,
            "requests": {r.rid: r for r in done},
            "admission_order": list(tsim.admission_log),
            "preemption_log": list(tsim.preemption_log),
            "preemptions": tsim.preemptions,
            "preempted_kv_bytes": tsim.preempted_kv_bytes,
            "prefills": tsim.prefills,
            "prefix_lookups": tsim.prefix_lookups,
            "prefix_hits": tsim.prefix_hits,
            "prefix_hit_tokens": tsim.prefix_hit_tokens,
            "prefix_hit_rate": (tsim.prefix_hit_tokens
                                / tsim.prefix_lookup_tokens
                                if tsim.prefix_lookup_tokens else 0.0),
            "prefix_evictions": (tsim.prefix.evictions
                                 if tsim.prefix is not None else 0),
            "summary": self._trace_summary(done, tsim.preemptions),
            # priced on this simulator's hardware profile
            "encode": enc,
            "decode": dec,
            "kv_transfer": xfer,
            "busy_s": busy,
            "energy_j": energy,
            "energy_per_token_j": energy / max(1, toks),
            "tokens_per_s": toks / max(dec.seconds, 1e-12),
            "qps": len(done) / max(busy, 1e-12),
            "utilization": busy / max(horizon, 1e-12),
        }

    def _serve_trace_cluster(self, trace, *, kv_cache: str,
                             kv_block_size: int, cap: int, max_batch: int,
                             n_prefill: int, n_decode: int,
                             step_quantum_s: float, opts: dict,
                             kv_blocks: int = 0, prefill_sim=None,
                             prefix_cache: bool = False,
                             max_steps: int = 200_000) -> dict:
        """Disaggregated trace mirror: ``ClusterEngine`` replay over
        analytical workers — including the shared autoscale policy, the
        prefill-rate throttle and the per-request KV handoff, each
        priced (prefill dispatches optionally on ``prefill_sim``'s
        xPU-class hardware — the paper's heterogeneous split)."""
        if n_prefill < 1 or n_decode < 1:
            raise ValueError(f"cluster needs >= 1 worker per phase, got "
                             f"({n_prefill}, {n_decode})")
        ecfg = EngineConfig(max_batch=max_batch, max_seq_len=cap,
                            scheduler="blocking", kv_cache=kv_cache,
                            kv_block_size=kv_block_size,
                            kv_blocks=kv_blocks,
                            prefix_cache=prefix_cache)
        csim = _TraceClusterSim(self, ecfg, kv_cache=kv_cache,
                                kv_block_size=kv_block_size,
                                n_prefill=n_prefill, n_decode=n_decode,
                                opts=opts, prefill_sim=prefill_sim)
        queue = self._trace_requests(trace)
        it = 0
        while queue or csim.has_work():
            if it >= max_steps:
                raise RuntimeError(
                    f"trace {trace.name!r} did not drain in "
                    f"{max_steps} steps")
            now = it * step_quantum_s
            csim.set_now(now)
            while queue and queue[0].arrival_s <= now:
                csim.waiting.append(queue.popleft())
            csim.step()
            it += 1
        csim.set_now(it * step_quantum_s)
        done = csim.finished
        toks = sum(len(r.output) for r in done)
        workers = csim.prefill_workers + csim.decode_workers
        enc = PhaseResult()
        dec = PhaseResult()
        for w in workers:
            enc.add(w.eng.enc)
            dec.add(w.eng.dec)
        # decode workers step in parallel: wall is the per-step max,
        # energy/ops stay the sum over workers
        dec.seconds = csim.decode_wall_s
        xfer = csim.xfer
        busy = enc.seconds + dec.seconds + xfer.seconds
        energy = enc.energy_j + dec.energy_j + xfer.energy_j
        horizon = it * step_quantum_s
        return {
            "trace": trace.name,
            "scheduler": "blocking",
            "kv_cache": kv_cache,
            "cluster": (n_prefill, n_decode),
            "n_prefill": len(csim.prefill_workers),
            "n_decode": len(csim.decode_workers),
            "steps": it,
            "step_quantum_s": step_quantum_s,
            "virtual_s": horizon,
            "decode_steps": csim.decode_steps,
            "tokens": toks,
            "requests": {r.rid: r for r in done},
            "handoffs": csim.handoffs,
            "migrations": csim.migrations,
            "kv_transfer_bytes": csim.kv_transfer_bytes,
            "migration_bytes": csim.migration_bytes,
            "rescale_events": len(csim.rescale_log),
            "rescale_log": list(csim.rescale_log),
            "prefix_routed": csim.prefix_routed,
            "prefix_lookups": sum(w.eng.prefix_lookups for w in workers),
            "prefix_hits": sum(w.eng.prefix_hits for w in workers),
            "prefix_hit_tokens": sum(w.eng.prefix_hit_tokens
                                     for w in workers),
            "prefix_hit_rate": (
                sum(w.eng.prefix_hit_tokens for w in workers)
                / max(1, sum(w.eng.prefix_lookup_tokens for w in workers))
                if any(w.eng.prefix_lookup_tokens for w in workers)
                else 0.0),
            "prefix_evictions": sum(w.eng.prefix.evictions for w in workers
                                    if w.eng.prefix is not None),
            "summary": self._trace_summary(
                done, sum(r.preemptions for r in done)),
            "encode": enc,
            "decode": dec,
            "kv_transfer": xfer,
            "busy_s": busy,
            "energy_j": energy,
            "energy_per_token_j": energy / max(1, toks),
            "tokens_per_s": toks / max(dec.seconds, 1e-12),
            "qps": len(done) / max(busy, 1e-12),
            "utilization": busy / max(horizon, 1e-12),
        }

    def _draft_cfg(self, draft_layers: int):
        """Config of the self-draft model: the target's first k layers
        (0 -> half depth), mirroring ``model.self_draft_params``'s
        clamping exactly — an MoE target drafted at k <= its leading
        dense layers really does run a dense-only draft, and the cost
        model must charge that, not a deeper one."""
        k = int(draft_layers) or max(1, self.cfg.n_layers // 2)
        k = max(1, min(k, self.cfg.n_layers))
        return self.cfg.replace(
            n_layers=k,
            first_dense_layers=min(self.cfg.first_dense_layers, k)
            if self.cfg.is_moe else self.cfg.first_dense_layers)

    def _serve_speculative(self, n_ins, n_out: int, *, kv_cache: str,
                           kv_block_size: int, cap: int, gamma: int,
                           acceptance: float, draft_layers: int) -> dict:
        """Draft/verify schedule (mirrors ``SpeculativeScheduler``):
        blocking admission prefills target *and* draft; every round
        then charges ``gamma`` draft decode dispatches plus **one**
        multi-token target verify dispatch (``model.verify_tokens``
        traced for real, ragged + live-masked, over the configured
        cache backend). With per-candidate acceptance probability
        ``a``, the greedy longest-prefix law commits ``E = sum_{i=1..g}
        a^i + 1`` tokens per round in expectation, so the run needs
        ``n_out / E`` rounds — each streaming the target's weights
        once. Decode being memory-bound, energy/token falls by ~E while
        the draft's (small) passes add back a fraction — the LP-Spec
        trade the paper's mobile scenario banks on."""
        batch = len(n_ins)
        dsim = LLMSimulator(self._draft_cfg(draft_layers), self.hw,
                            self.sim)
        # blocking admission: sequential target + draft prefills
        enc = PhaseResult()
        t_cum = ttft_sum = 0.0
        ttfts = []
        for n in n_ins:
            e = self.encode(1, int(n))
            d = dsim.encode(1, int(n))
            enc.add(e)
            enc.add(d)
            t_cum += e.seconds + d.seconds
            ttfts.append(t_cum)
            ttft_sum += t_cum
        # expected commits per verify round (greedy longest prefix)
        a = min(max(float(acceptance), 0.0), 1.0)
        commits = 1.0 + sum(a ** i for i in range(1, gamma + 1))
        rounds = max(1, math.ceil(n_out / commits))
        n_mean = sum(float(n) for n in n_ins) / batch
        max_len = int(math.ceil(n_mean)) + n_out
        l_mean = n_mean + (n_out - 1) / 2.0
        verify = _stream_cost(
            self._verify_ops_linear(batch, max_len, gamma,
                                    kv_cache=kv_cache,
                                    kv_block_size=kv_block_size),
            self.hw, self.sim, at=l_mean)
        draft_step = _stream_cost(
            dsim._decode_ops_linear(batch, max_len, ragged=True), self.hw,
            self.sim, at=l_mean)
        per_round = PhaseResult()
        per_round.add(verify)
        for f in ("seconds", "energy_j", "compute_s", "memory_s",
                  "host_s", "ops", "mem_bytes", "host_bytes"):
            setattr(per_round, f, getattr(per_round, f)
                    + gamma * getattr(draft_step, f))
        # per round: committed token ids D2H + next inputs H2D,
        # orchestration once (draft chain is host-driven but tiny)
        per_round.add(_host_transfer(batch * 4 * commits, self.hw,
                                     d2h=True))
        per_round.add(_host_transfer(batch * 4, self.hw, d2h=False))
        if self.sim.tp_degree > 1:
            per_tok = (2 * self.cfg.n_layers * self.cfg.d_model * 2
                       * (self.sim.tp_degree - 1) / self.sim.tp_degree)
            per_round.add(_tp_collective(per_tok * batch, self.hw))
        per_round.seconds += self.sim.orchestration_s
        per_round.host_s += self.sim.orchestration_s
        dec = PhaseResult()
        for f in ("seconds", "energy_j", "compute_s", "memory_s",
                  "host_s", "ops", "mem_bytes", "host_bytes"):
            setattr(dec, f, getattr(per_round, f) * rounds)
        contiguous_bytes = contiguous_kv_bytes(self.cfg, batch, cap)
        if kv_cache == "paged":
            resident = paged_resident_kv_bytes(
                self.cfg, [min(int(n) + n_out - 1, cap) for n in n_ins],
                kv_block_size)
        else:
            resident = contiguous_bytes
        # the draft's contiguous shadow cache is resident KV too
        draft_bytes = contiguous_kv_bytes(dsim.cfg, batch, cap)
        resident += draft_bytes
        total_toks = batch * n_out
        return {
            "encode": enc,
            "decode": dec,
            "ttft_s": ttft_sum / batch,
            "ttft_per_req_s": ttfts,
            "tokens_per_s": total_toks / max(dec.seconds, 1e-12),
            "energy_per_token_j": dec.energy_j / total_toks,
            "qps": batch / max(enc.seconds + dec.seconds, 1e-12),
            "draft_kv_bytes": draft_bytes,
            "decode_dispatches": rounds,       # one target verify each
            "draft_dispatches": rounds * gamma,
            "accepted_tokens_per_step": commits,
            "acceptance": a,
            "spec_gamma": gamma,
            "kv_cache": kv_cache,
            "scheduler": "speculative",
            "prefill_chunks": batch,
            "resident_kv_bytes": resident,
            "contiguous_kv_bytes": contiguous_bytes,
        }

    def generate(self, batch: int, n_in: int, n_out: int) -> dict:
        enc = self.encode(batch, n_in)
        dec = self.decode(batch, n_in, n_out)
        return {
            "encode": enc,
            "decode": dec,
            "ttft_s": enc.seconds,
            "tokens_per_s": batch * n_out / dec.seconds,
            "energy_per_token_j": dec.energy_j / (batch * n_out),
            "query_s": (enc.seconds + dec.seconds) / 1.0,
            "qps": batch / (enc.seconds + dec.seconds),
            "energy_per_query_j": (enc.energy_j + dec.energy_j) / batch,
        }
