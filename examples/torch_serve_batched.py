"""Serve a model with batched requests through the port's
continuous-batching engine on both KV-cache backends, and cross-check
the engine against the port's PIM-AI simulator.

Counterpart of ``examples/serve_batched.py``. Sections:

- backends: the same requests on the contiguous and the paged
  (block-table) cache — outputs equal, the paged layout's resident KV
  beside the dense ``max_batch x max_seq_len`` charge;
- ``--telemetry``: the top-5 slowest spans and the per-kind
  measured-vs-predicted dispatch calibration;
- scheduling: one long prompt ahead of short ones, blocking against
  chunked prefill (the shorts' TTFT), and speculative decoding with
  half- and full-depth self-drafts (float32; tokens equal to blocking);
- prefix caching: requests sharing a preamble, cold against warm;
- ``--cluster N,M``: the disaggregated cluster, one decode worker
  drained mid-stream (outputs equal to the single engine);
- the simulator cross-check: the overload trace replayed through the
  engine and through ``LLMSimulator.serve(trace=...)`` (admission order,
  preemptions and every request's TTFT equal), then the analytical
  ragged serve of this workload on two Table-1 profiles. The simulated
  figures are model outputs of ``repro_torch.core.profiles``.

On the card (the default) the model is qwen1.5-0.5b at its published
width (bf16, seeded weights); with ``--device cpu`` it is the
reference's phi3-mini smoke config on the kernels' plain versions.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py
      PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
      PYTHONPATH=src python examples/torch_serve_batched.py --telemetry
      PYTHONPATH=src python examples/torch_serve_batched.py \
          --scheduler chunked --cluster 1,2
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import registry
from repro_torch.core import profiles as HW
from repro_torch.core.simulator import LLMSimulator, SimConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as MD
from repro_torch.serving import (ClusterConfig, ClusterEngine, EngineConfig,
                                 ServingEngine, Telemetry)
from repro_torch.serving.telemetry import (dispatch_calibration,
                                           format_calibration)
from repro_torch.serving.workload import make_named_trace, replay

QUANTUM = 0.01


def model_config(device):
    if device.type == "cuda":
        return registry.get_config("qwen1.5-0.5b")
    return registry.get_smoke_config("phi3-mini-3.8b")


def _engine(params, cfg, device, telemetry=None, label=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq_len", 96)
    return ServingEngine(params, cfg, EngineConfig(**kw), device=device,
                         telemetry=telemetry, telemetry_label=label)


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p)
    eng.run()
    return {r.rid: r.output for r in eng.finished}


def backends(params, cfg, device, prompts, args):
    tel = Telemetry() if args.telemetry else None
    engines, outputs = [], {}
    for kv in ("contiguous", "paged"):
        eng = _engine(params, cfg, device, tel, kv, max_new_tokens=12,
                      kv_cache=kv, scheduler=args.scheduler,
                      chunk_tokens=16, spec_gamma=args.gamma)
        engines.append(eng)
        outputs[kv] = _serve(eng, prompts)
        s = eng.summary()
        print(f"\n[{kv}] {s['requests']} requests, {s['tokens']} tokens, "
              f"{s['tokens_per_s']:.1f} tok/s, mean TTFT "
              f"{s['mean_ttft_s']*1e3:.0f} ms ({device.type})")
        print(f"  single-dispatch decode: {s['decode_dispatches']} "
              f"dispatches over {s['decode_steps']} steps "
              f"({s['dispatches_per_step']:.2f}/step), "
              f"{s['prefill_chunks']} prefill chunks")
        print(f"  resident KV: {s['resident_kv_bytes']/1024:.0f} KiB peak "
              f"vs {s['contiguous_kv_bytes']/1024:.0f} KiB dense "
              f"(max_batch x max_seq_len)")
    print(f"\npaged outputs equal contiguous: "
          f"{outputs['paged'] == outputs['contiguous']}")
    if tel is not None:
        print(f"\ntelemetry: {len(tel.tracer.spans)} spans across "
              f"{len(engines)} engines; top-5 slowest:")
        for s in tel.tracer.slowest(5):
            print(f"  {s.wall_dur_s*1e3:9.2f} ms  [{s.tid}] "
                  f"{'  ' * s.depth}{s.name} ({s.cat})")
        print("\ndispatch calibration (host reference roofline):")
        print(format_calibration(dispatch_calibration(engines, tel)))
    return outputs["contiguous"]


def scheduling(params, cfg, device, prompts, rng, gamma):
    print("\nscheduling: 1 long (72) prompt ahead of 6 shorts, "
          "chunk_tokens=16")
    hol = [rng.integers(0, cfg.vocab_size, size=n)
           for n in [72] + [int(rng.integers(6, 14)) for _ in range(6)]]
    outs = {}
    for sched in ("blocking", "chunked"):
        eng = _engine(params, cfg, device, max_new_tokens=8,
                      scheduler=sched, chunk_tokens=16)
        outs[sched] = _serve(eng, hol)
        short = [r.ttft_s for r in eng.finished if len(r.prompt) < 72]
        print(f"  [{sched:8s}] short-request TTFT p50 "
              f"{np.percentile(short, 50)*1e3:7.1f} ms, p99 "
              f"{np.percentile(short, 99)*1e3:7.1f} ms "
              f"({eng.summary()['prefill_chunks']} prefill chunks)")
    print(f"  chunked outputs equal blocking: "
          f"{outs['chunked'] == outs['blocking']}")

    # float32: the verify and decode paths agree on every argmax there
    print(f"\nspeculative decoding: gamma={gamma}, self-draft, the same "
          "10 requests, float32")
    cfg32 = cfg.replace(dtype="float32")
    params32 = MD.init_params(cfg32, seed=0, device=device)
    spec = {}
    for label, layers in (("blocking", None), ("half-depth", 0),
                          ("full-depth", 99)):
        kw = ({} if layers is None else dict(
            scheduler="speculative", spec_gamma=gamma,
            spec_draft_layers=layers))
        eng = _engine(params32, cfg32, device, max_new_tokens=12, **kw)
        spec[label] = _serve(eng, prompts)
        s = eng.summary()
        if layers is None:
            print(f"  [{label:10s}] 1.00 tokens/dispatch by definition "
                  f"({s['decode_dispatches']} target dispatches)")
        else:
            print(f"  [{label:10s}] acceptance rate "
                  f"{s['acceptance_rate']:.2f}, "
                  f"{s['accepted_tokens_per_step']:.2f} tokens/dispatch "
                  f"({s['verify_dispatches']} verifies + "
                  f"{s['draft_dispatches']} draft dispatches)")
    print(f"  speculative outputs equal blocking: "
          f"{spec['half-depth'] == spec['blocking']} / "
          f"{spec['full-depth'] == spec['blocking']}")
    del params32


def prefix_caching(params, cfg, device, rng):
    print("\nprefix cache: 8 requests sharing a 48-token preamble, "
          "10-block paged pool")
    pre = rng.integers(0, cfg.vocab_size, size=48)
    prompts = [np.concatenate([pre, rng.integers(
        0, cfg.vocab_size, size=int(rng.integers(4, 12)))])
        for _ in range(8)]
    outs = {}
    for label, on in (("cold", False), ("warm", True)):
        eng = _engine(params, cfg, device, max_new_tokens=8,
                      kv_cache="paged", kv_block_size=16, kv_blocks=10,
                      prefix_cache=on)
        outs[label] = _serve(eng, prompts)
        s = eng.summary()
        print(f"  [{label}] {s['prefix_hits']}/{s['prefix_lookups']} "
              f"admissions hit, token hit rate {s['prefix_hit_rate']:.2f}, "
              f"{s['prefix_hit_tokens']} prompt tokens spliced instead "
              f"of prefilled, shared KV resident "
              f"{s['resident_shared_kv_bytes']/1024:.0f} KiB")
    print(f"  warm outputs equal cold prefill: "
          f"{outs['warm'] == outs['cold']}")


def cluster(params, cfg, device, prompts, spec, single):
    n_p, n_d = (int(x) for x in spec.split(","))
    print(f"\ndisaggregated cluster: {n_p} prefill + {n_d} decode "
          f"workers on {device}, drain worker 0 mid-stream")
    clu = ClusterEngine(params, cfg, EngineConfig(
        max_batch=4, max_seq_len=96, max_new_tokens=12),
        ClusterConfig(n_prefill=n_p, n_decode=n_d, devices=(device,)))
    for p in prompts:
        clu.submit(p)
    for _ in range(3):   # let decode slots go live...
        clu.step()
    clu.drain_worker(0)  # ...then migrate them off worker 0
    clu.run()
    s = clu.summary()
    print(f"  {s['requests']} requests, {s['tokens']} tokens; "
          f"TTFT p50 {s['ttft_p50_s']*1e3:.0f} ms, "
          f"p99 {s['ttft_p99_s']*1e3:.0f} ms")
    print(f"  {s['handoffs']} prefill→decode handoffs + "
          f"{s['migrations']} drain migrations moved "
          f"{s['kv_transfer_bytes']/1024:.0f} KiB of KV between workers")
    print(f"  cluster outputs equal single engine: "
          f"{ {r.rid: r.output for r in clu.finished} == single}")
    for w in s["per_worker"]:
        print(f"    [{w['role']}-{w['idx']}] {w['device']} "
              f"steps={w['steps']} dispatches={w['decode_dispatches']} "
              f"{'draining' if w['draining'] else 'routable'}")


def trace_mirror(params, cfg, device):
    """The overload trace through the engine (SLO policy) and through
    the simulator's schedule mirror: (schedule equal, the mirror's
    result)."""
    tr = make_named_trace("overload", vocab_size=cfg.vocab_size, seed=0)
    eng = _engine(params, cfg, device, max_new_tokens=16, scheduler="slo",
                  eos_token=-1)
    rep = replay(eng, tr, step_quantum_s=QUANTUM)
    sim = LLMSimulator(cfg, HW.PIM_AI_SERVER, SimConfig())
    r = sim.serve(trace=tr, scheduler="slo", max_batch=4, max_seq_len=96,
                  step_quantum_s=QUANTUM)
    same = (r["admission_order"] == rep["admission_order"]
            and r["preemption_log"] == rep["preemption_log"]
            and r["steps"] == rep["steps"]
            and {i: q.ttft_s for i, q in r["requests"].items()}
            == {i: q.ttft_s for i, q in rep["requests"].items()})
    print(f"\nsimulator trace mirror (overload, SLO, {len(tr)} requests): "
          f"schedule equals the engine's: {same} "
          f"({r['preemptions']} preemptions, {r['steps']} steps); on "
          f"{HW.PIM_AI_SERVER.name}: {r['energy_per_token_j']*1e3:.2f} "
          "mJ/token")
    return same, r


def analytical_serve(lens, n_out=12):
    """The ragged continuous-batching workload on the paper's hardware:
    full-width phi3-mini W4A16 on two Table-1 profiles, both backends.
    Returns [(kv backend, profile name, serve() result)]."""
    full = registry.get_config("phi3-mini-3.8b")
    print(f"\nanalytical ragged serve ({len(lens)} slots, W4A16, "
          f"{n_out} new tokens; model outputs):")
    rows = []
    for kv in ("contiguous", "paged"):
        for hw in (HW.PIM_AI_MOBILE, HW.SNAPDRAGON_8_GEN3):
            sim = LLMSimulator(full, hw, SimConfig(weight_bits=4))
            r = sim.serve(lens, n_out, kv_cache=kv)
            rows.append((kv, hw.name, r))
            print(f"  {kv:10s} {hw.name:20s}: "
                  f"{r['tokens_per_s']:8.1f} tok/s, "
                  f"{r['energy_per_token_j']*1e3:6.1f} mJ/token, "
                  f"resident KV {r['resident_kv_bytes']/2**20:.0f} MiB "
                  f"(dense {r['contiguous_kv_bytes']/2**20:.0f} MiB)")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernels, qwen1.5-0.5b at its published "
                    "width; cpu: their plain versions, the phi3-mini smoke "
                    "config")
    ap.add_argument("--scheduler", default="blocking",
                    choices=["blocking", "chunked", "speculative"],
                    help="scheduling policy of the backend comparison")
    ap.add_argument("--gamma", type=int, default=4,
                    help="speculative: draft tokens per verify step")
    ap.add_argument("--cluster", default=None, metavar="N,M",
                    help="also run the disaggregated cluster with N "
                    "prefill and M decode workers (e.g. 1,2)")
    ap.add_argument("--telemetry", action="store_true",
                    help="instrument the backend comparison and print the "
                    "slowest spans and the dispatch calibration")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = model_config(device)
    params = MD.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    lens = [int(rng.integers(8, 24)) for _ in range(10)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    print(f"{cfg.name}: 10 requests (prompt lengths 8-24) into 4 slots "
          f"({args.scheduler} scheduler) on {device}")
    single = backends(params, cfg, device, prompts, args)
    scheduling(params, cfg, device, prompts, rng, args.gamma)
    prefix_caching(params, cfg, device, rng)
    if args.cluster:
        cluster(params, cfg, device, prompts, args.cluster, single)
    trace_mirror(params, cfg, device)
    analytical_serve(lens[:4])


if __name__ == "__main__":
    main()
