"""The port's scripts (``scripts/torch_*.py``) that stand in for the
reference's ``lint_telemetry.py``, ``smoke_models.py``,
``collective_breakdown.py`` and ``render_experiments.py``, on the CPU:
the lint passes on the port's engine and fails on a copy that logs a
dispatch outside ``_dispatch``; its runtime check passes; the smoke
script exits 0 on two archs and 1 when one fails; the render is
idempotent and refuses ``PERF.md``; the breakdown runs on a small
cell."""
from __future__ import annotations

import json
import pathlib
import sys

import pytest

from repro_torch.models import model as MD
from _torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import torch_collective_breakdown as BD  # noqa: E402
import torch_lint_telemetry as LT  # noqa: E402
import torch_render_experiments as RE  # noqa: E402
import torch_smoke_models as SM  # noqa: E402


def test_lint_passes_on_the_engine():
    assert LT.ENGINE_PY.name == "engine.py"
    assert "repro_torch" in LT.ENGINE_PY.parts
    assert LT.lint_static() == []
    assert LT.main(["--skip-runtime"]) == 0


def test_lint_fails_on_a_dispatch_outside_dispatch(tmp_path, capsys,
                                                   monkeypatch):
    src = LT.ENGINE_PY.read_text()
    anchor = "    def _devices(self) -> list:\n"
    assert anchor in src
    bad = src.replace(anchor, "    def _stray(self):\n"
                      "        self._log_dispatch(\"decode\")\n\n" + anchor)
    path = tmp_path / "engine.py"
    path.write_text(bad)
    problems = LT.lint_static(path)
    assert len(problems) == 1 and "'_stray'" in problems[0]
    monkeypatch.setattr(LT, "ENGINE_PY", path)
    assert LT.main(["--skip-runtime"]) == 1
    assert "FAIL static" in capsys.readouterr().out
    # a file with no call site at all: the lint is on the wrong seam
    empty = tmp_path / "empty.py"
    empty.write_text("x = 1\n")
    assert "no _log_dispatch" in LT.lint_static(empty)[0]


def test_lint_runtime_on_cpu():
    assert LT.lint_runtime("cpu") == []


def test_smoke_exit_codes(monkeypatch, capsys):
    assert SM.main(["qwen1.5-0.5b", "xlstm-350m", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("OK   ") == 2
    real = MD.decode_step

    def broken(params, cfg, *a, **kw):
        if cfg.family == "ssm":
            raise RuntimeError("injected decode fault")
        return real(params, cfg, *a, **kw)

    monkeypatch.setattr(MD, "decode_step", broken)
    assert SM.main(["qwen1.5-0.5b", "xlstm-350m", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "OK   qwen1.5-0.5b" in out
    assert "FAIL xlstm-350m" in out and "injected decode fault" in out


def _record(arch, shape, flops):
    return {"arch": arch, "shape": shape, "mesh": "single", "devices": 256,
            "flops": flops, "bytes_accessed": 1e9,
            "collectives": {"total_bytes": 1e8},
            "trace": {"flops": flops * 256, "bytes": 2e11},
            "params": 1e9, "active_params": 1e9,
            "memory": {"peak_memory_in_bytes": 1 << 30}, "ok": True}


def test_render_is_idempotent(tmp_path, monkeypatch):
    res = tmp_path / "r.jsonl"
    res.write_text("\n".join(json.dumps(_record(a, s, f)) for a, s, f in (
        ("qwen1.5-0.5b", "decode_32k", 1e9),
        ("qwen1.5-0.5b", "train_4k", 1e13))) + "\n")
    target = tmp_path / "EXPERIMENTS.md"
    target.write_text(f"# E\n\n## Roofline\n\n{RE.BASE}\n\nold table\n\n"
                      "## Next\n\nkept\n")
    RE.render(str(target), str(res), None)
    once = target.read_text()
    assert "old table" not in once and "| qwen1.5-0.5b | train_4k |" in once
    assert once.endswith("## Next\n\nkept\n")
    RE.render(str(target), str(res), str(tmp_path / "missing.jsonl"))
    assert target.read_text() == once
    # the command line: the port's default records, the target an argument
    monkeypatch.chdir(tmp_path)
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "torch_dryrun.jsonl").write_text(res.read_text())
    assert RE.main([str(target)]) == 0
    assert target.read_text() == once
    perf = tmp_path / "PERF.md"
    perf.write_text(RE.BASE + "\n\n## x\n")
    with pytest.raises(ValueError, match="PERF.md"):
        RE.render(str(perf), str(res), None)


def test_breakdown_on_a_small_cell(capsys):
    rows = BD.breakdown("qwen1.5-0.5b", "decode_32k", {"n_layers": 2},
                        mesh_shape=(2, 2))
    assert rows and all(k == "all-gather" for k, *_ in rows)
    assert rows == sorted(rows, key=lambda r: -r[2])
    # 4 hint sites a layer, the embedding and the logits
    assert sum(n for *_, n in rows) == 4 * 2 + 2
    assert BD.main(["qwen1.5-0.5b", "decode_32k", '{"n_layers": 1}']) == 0
    assert "all-gather" in capsys.readouterr().out
