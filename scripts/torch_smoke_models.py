"""Dev smoke: loss + prefill + decode + a chunked-prefill serve pass for
every registry arch at its smoke config, on the port.

Counterpart of ``scripts/smoke_models.py``: family-specific regressions
surface here without waiting on the full test suite. Unlike the
reference, which prints ``FAIL`` and still exits 0, this exits 1 when
any arch fails.

Usage: PYTHONPATH=src python scripts/torch_smoke_models.py
       [ARCH ...] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
import traceback
import warnings


def smoke(name: str, device: str) -> str:
    """One arch's pass; returns its summary line, raises on a fault."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    from repro_torch.serving import (ChunkedScheduler, EngineConfig,
                                     ServingEngine)

    cfg = registry.get_smoke_config(name)
    params = MD.init_params(cfg, seed=0, device=device)
    n_params = sum(t.numel() for t in _leaves(params))
    batch = MD.make_dummy_batch(cfg, 2, 32, "train", device=device)
    with torch.no_grad():
        loss, _ = MD.loss_fn(params, cfg, batch)
        assert torch.isfinite(loss), f"{name}: loss not finite"
        # prefill 16 tokens, decode 3
        pre = MD.make_dummy_batch(cfg, 2, 16, "prefill", device=device)
        logits, cache = MD.prefill(params, cfg, pre, 24)
        assert torch.isfinite(logits).all(), f"{name}: prefill NaN"
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        for _ in range(3):
            logits, cache = MD.decode_step(params, cfg, tok, cache)
            assert torch.isfinite(logits).all(), f"{name}: decode NaN"
            tok = logits.argmax(-1)[:, None].to(torch.int32)
    # a chunked-prefill serve pass of one long and one short prompt
    # (families without chunk support fall back to blocking)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the expected fallback warnings
        eng = ServingEngine(params, cfg, EngineConfig(
            max_batch=2, max_seq_len=64, max_new_tokens=3,
            scheduler="chunked", chunk_tokens=16), device=device)
    rng = np.random.default_rng(0)
    for n in (40, 6):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n))
    done = eng.run()
    assert len(done) == 2, f"{name}: serve retired {len(done)}/2"
    assert all(len(r.output) == 3 for r in done), f"{name}: serve output"
    mode = ("chunked" if isinstance(eng.scheduler, ChunkedScheduler)
            else "blocking-fallback")
    bucketed = "bucketed" if eng._bucketed else "exact-len"
    return (f"OK   {name:20s} loss={float(loss):.3f} params={n_params} "
            f"serve={mode}/{eng.summary()['prefill_chunks']}ch "
            f"prefill={bucketed}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> int:
    from repro_torch.configs import registry
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("archs", nargs="*")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    failed = []
    for name in args.archs or registry.list_archs():
        try:
            print(smoke(name, args.device), flush=True)
        except Exception as e:  # noqa: BLE001 — report every arch
            failed.append(name)
            print(f"FAIL {name:20s} {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    if failed:
        print(f"{len(failed)} failed: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
