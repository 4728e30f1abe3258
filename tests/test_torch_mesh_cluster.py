"""The disaggregated cluster with mesh workers on the CPU: one prefill
and two decode workers, each a (1, 2) mesh engine over its own two of
``devices=("cpu",) * 6`` (qwen1.5-0.5b's smoke config in float32,
weights bridged from the JAX package), decode worker 0 killed after two
steps: the streams are the single blocking engine's, and the handoffs,
migrations and transferred bytes are those of the same cluster with one
device a worker — every packet the single device's, byte for byte, and
``kv_transfer_bytes`` their sum. A cluster with too few devices for its
mesh workers raises."""
from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.serving import (ClusterConfig, ClusterEngine, EngineConfig,
                                 ServingEngine)
from _torch_threads import one_thread  # noqa: F401

KW = dict(max_batch=2, max_seq_len=64, max_new_tokens=6)
LENS = (12, 30, 7, 21, 16, 9)


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(5), jcfg)
    return cfg, bridge.params_from_jax(jax.device_get(jp), cfg,
                                       device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENS]


def _run_cluster(tp, cfg, mesh, devices, kv):
    clu = ClusterEngine(tp, cfg, EngineConfig(**KW, kv_cache=kv, mesh=mesh),
                        ClusterConfig(n_prefill=1, n_decode=2,
                                      devices=devices))
    packets = []
    for w in clu.prefill_workers + clu.decode_workers:
        pack = w.eng._pack_slot

        def packing(slot, _pack=pack):
            pkt = _pack(slot)
            packets.append(pkt.kv)
            return pkt

        w.eng._pack_slot = packing
    for p in _prompts(cfg.vocab_size):
        clu.submit(p)
    for _ in range(2):
        clu.step()
    clu.kill_worker(0)
    clu.run()
    return clu, {r.rid: r.output for r in clu.finished}, packets


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_mesh_workers_kill_and_handoff(setup, kv):
    cfg, tp = setup
    eng = ServingEngine(tp, cfg, EngineConfig(**KW, kv_cache=kv),
                        device="cpu")
    for p in _prompts(cfg.vocab_size):
        eng.submit(p)
    eng.run()
    want = {r.rid: r.output for r in eng.finished}
    clu, got, packets = _run_cluster(tp, cfg, (1, 2), ("cpu",) * 6, kv)
    base, same, base_packets = _run_cluster(tp, cfg, None, ("cpu",) * 3, kv)
    assert got == want == same
    s, b = clu.summary(), base.summary()
    assert s["migrations"] > 0 and s["handoffs"] == len(LENS)
    for key in ("handoffs", "migrations", "kv_transfer_bytes"):
        assert s[key] == b[key], key
    assert s["kv_transfer_bytes"] == sum(p["kv_bytes"] for p in packets)
    assert [p["kv_bytes"] for p in packets] == [p["kv_bytes"]
                                               for p in base_packets]
    for w in clu.prefill_workers + clu.decode_workers:
        assert w.eng.mesh.shape == (1, 2)
        assert w.eng.summary()["mesh_devices"] == 2
    assert s["dispatches_per_step"] == pytest.approx(1.0)


def test_mesh_cluster_needs_a_device_group_per_worker(setup):
    cfg, tp = setup
    with pytest.raises(ValueError, match="needs 6 devices"):
        ClusterEngine(tp, cfg, EngineConfig(**KW, mesh=(1, 2)),
                      ClusterConfig(n_prefill=1, n_decode=2,
                                    devices=("cpu",) * 5))
