"""The port's three-term roofline (``repro_torch.roofline.analysis``)
on the cases of ``tests/test_roofline.py``, at the H100 constants of
``core/profiles.DGX_H100`` over its eight cards; and, for one record,
the port's terms equal the reference's after rescaling each by its own
constants (the formulas are the reference's). Pure arithmetic on
records: no trace, no device."""
from __future__ import annotations

import json

import pytest

from repro.roofline import analysis as JA
from repro_torch.core.profiles import DGX_H100
from repro_torch.roofline import analysis as A


def fake_record(**kw):
    rec = {
        "arch": "x", "shape": "train_4k", "mesh": "single",
        "devices": 256,
        "flops": 1e12,                       # per device: a rank's trace
        "bytes_accessed": 1e11,
        "collectives": {"total_bytes": 5e10},
        "trace": {"flops": 2.56e15},         # global
        "params": 1e9, "active_params": 1e9,
        "memory": {"peak_memory_in_bytes": 1 << 30},
        "ok": True,
    }
    rec.update(kw)
    return rec


def test_h100_constants_from_the_profile():
    assert A.PEAK_FLOPS == pytest.approx(989.5e12)
    assert A.HBM_BW == pytest.approx(3350e9)
    assert A.LINK_BW == pytest.approx(450e9)
    assert A.PEAK_FLOPS == DGX_H100.tops * 1e12 / 8
    assert A.DEFAULT_RESULTS.endswith("torch_dryrun.jsonl")


def test_three_terms_and_kappa():
    c = A.analyze_record(fake_record())
    assert c["kappa"] == pytest.approx(10.0)
    assert c["compute_s"] == pytest.approx(2.56e15 / 256 / A.PEAK_FLOPS)
    assert c["memory_s"] == pytest.approx(1e11 * 10 / A.HBM_BW)
    assert c["collective_s"] == pytest.approx(5e10 / A.LINK_BW)
    assert c["bottleneck"] in ("compute", "memory", "collective")
    # a record whose trace carries bytes takes them, not kappa's estimate
    t = A.analyze_record(fake_record(trace={"flops": 2.56e15,
                                            "bytes": 2.56e14}))
    assert t["memory_s"] == pytest.approx(2.56e14 / 256 / A.HBM_BW)


def test_model_flops_train_vs_decode():
    train = A.analyze_record(fake_record(shape="train_4k"))
    dec = A.analyze_record(fake_record(shape="decode_32k"))
    assert train["model_flops"] == 6 * 1e9 * 4096 * 256
    assert dec["model_flops"] == 2 * 1e9 * 128


def test_bottleneck_is_argmax():
    c = A.analyze_record(fake_record(collectives={"total_bytes": 1e15}))
    assert c["bottleneck"] == "collective"
    m = A.analyze_record(fake_record(collectives={"total_bytes": 0},
                                     trace={"flops": 1.0, "bytes": 1e18}))
    assert m["bottleneck"] == "memory"


def test_peak_bytes_tolerates_memory_schema_drift():
    old = A.analyze_record(fake_record())
    assert old["peak_bytes_per_chip"] == 1 << 30
    new = A.analyze_record(fake_record(
        memory={"peak_memory_bytes": 1 << 29}))
    assert new["peak_bytes_per_chip"] == 1 << 29
    bare = A.analyze_record(fake_record(
        memory={"argument_size_in_bytes": 100,
                "output_size_in_bytes": 20, "temp_size_in_bytes": 3}))
    assert bare["peak_bytes_per_chip"] == 123
    assert A.analyze_record(fake_record(memory={}))[
        "peak_bytes_per_chip"] == 0


def test_load_records_dedupes_latest(tmp_path):
    p = tmp_path / "d.jsonl"
    with open(p, "w") as f:
        f.write(json.dumps(fake_record(flops=1.0)) + "\n")
        f.write(json.dumps(fake_record(flops=2.0)) + "\n")
        f.write(json.dumps(fake_record(mesh="multi", flops=3.0)) + "\n")
        f.write(json.dumps({"arch": "x", "shape": "s", "mesh": "single",
                            "ok": False}) + "\n")
        f.write("not json\n")
    recs = A.load_records(str(p), mesh="single")
    assert len(recs) == 1
    assert recs[0]["flops"] == 2.0
    assert len(A.load_records(str(p), mesh=None)) == 2
    assert len(A.analyze_file(str(p), mesh="multi")) == 1


def test_advice_mentions_dominant_term():
    for rec, word in ((fake_record(collectives={"total_bytes": 0},
                                   trace={"flops": 2.56e15, "bytes": 1.0}),
                       "compute"),
                      (fake_record(collectives={"total_bytes": 1e16}),
                       "collective"),
                      (fake_record(trace={"flops": 1.0, "bytes": 1e18}),
                       "memory")):
        c = A.analyze_record(rec)
        assert c["bottleneck"] == word
        assert A.advice(c).startswith(word)


def test_markdown_table():
    cells = [A.analyze_record(fake_record()),
             A.analyze_record(fake_record(shape="decode_32k"))]
    md = A.to_markdown(cells)
    lines = md.splitlines()
    assert lines[0].startswith("| arch | shape | mesh |")
    assert len(lines) == 2 + len(cells)
    assert lines[2].count("|") == lines[0].count("|")
    assert "train_4k" in lines[2] and "decode_32k" in lines[3]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_terms_equal_reference_after_rescaling(shape):
    """Each term is the reference's formula: the port's times its
    constant equals the reference's times its own."""
    rec = fake_record(shape=shape, trace={"flops": 2.56e15,
                                          "bytes": 3.1e14})
    ours, ref = A.analyze_record(rec), JA.analyze_record(rec)
    for term, ka, kr in (("compute_s", A.PEAK_FLOPS, JA.PEAK_FLOPS),
                         ("memory_s", A.HBM_BW, JA.HBM_BW),
                         ("collective_s", A.LINK_BW, JA.LINK_BW)):
        assert ours[term] * ka == pytest.approx(ref[term] * kr, rel=1e-12)
    for key in ("kappa", "model_flops", "model_flops_ratio",
                "hlo_flops_global", "peak_bytes_per_chip"):
        assert ours[key] == ref[key], key
    bound = max(ours[t] for t in ("compute_s", "memory_s", "collective_s"))
    jbound = max(ref[t] for t in ("compute_s", "memory_s", "collective_s"))
    assert ours["roofline_frac"] * bound * A.PEAK_FLOPS == pytest.approx(
        ref["roofline_frac"] * jbound * JA.PEAK_FLOPS, rel=1e-12)
