"""Deterministic synthetic LM data pipeline.

Training substrate for the end-to-end drivers and tests. Two design
constraints from the 1000+-node posture:

- **Deterministic + seekable**: every batch is a pure function of
  ``(seed, step)``, so restart-after-failure reproduces the exact token
  stream without data-loader state in the checkpoint (only the step
  index is saved). No host may drift from the others.
- **Host-shardable**: each host materializes only its slice of the
  global batch (``host_shard_slice``); the global batch is defined
  globally and sliced by host index the way a multi-host TPU pod feeds
  ``jax.make_array_from_process_local_data``.

The synthetic stream is a Zipf-distributed token source with injected
n-gram structure (so the loss actually decreases — useful for the
train-for-a-few-hundred-steps example) plus next-token labels.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # Zipf exponent of the unigram prior
    ngram_repeat: int = 8        # period of the injected copy structure


def host_shard_slice(global_batch: int, host_index: int, host_count: int
                     ) -> slice:
    """Rows [start, stop) of the global batch owned by this host."""
    if global_batch % host_count:
        raise ValueError(
            f"global_batch {global_batch} not divisible by host_count "
            f"{host_count}")
    per = global_batch // host_count
    return slice(host_index * per, (host_index + 1) * per)


class SyntheticLMStream:
    """Deterministic ``(seed, step) -> batch`` synthetic LM stream."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1):
        self.cfg = cfg
        self.sl = host_shard_slice(cfg.global_batch, host_index, host_count)
        # Zipf-ish unigram distribution over the vocab, fixed by seed.
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()
        self._perm = rng.permutation(cfg.vocab_size)  # hide rank order

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))

    def batch_at(self, step: int) -> dict:
        """Full batch for ``step``, sliced to this host's rows."""
        cfg = self.cfg
        rng = self._rng_for(step)
        n = cfg.global_batch
        s = cfg.seq_len + 1  # +1 -> tokens/labels shift
        toks = self._perm[
            rng.choice(cfg.vocab_size, size=(n, s), p=self._probs)]
        # inject learnable structure: periodic copy of the first token of
        # each period (a trivially learnable n-gram dependency)
        r = cfg.ngram_repeat
        if r > 1 and s > r:
            anchors = toks[:, :: r]
            for j in range(1, r, 2):
                w = toks[:, j::r]
                w[:, : anchors.shape[1]][:, : w.shape[1]] = \
                    anchors[:, : w.shape[1]]
        toks = toks.astype(np.int32)
        sl = self.sl
        return {
            "tokens": toks[sl, :-1],
            "labels": toks[sl, 1:],
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_train_stream(cfg, global_batch: int, seq_len: int, *, seed: int = 0,
                      host_index: int = 0, host_count: int = 1
                      ) -> SyntheticLMStream:
    """Stream matching an :class:`ArchConfig`'s vocab."""
    return SyntheticLMStream(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                   global_batch=global_batch, seed=seed),
        host_index=host_index, host_count=host_count)
