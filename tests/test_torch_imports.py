"""The port, its chip smoke script and its examples import neither JAX
nor anything of the JAX package (``repro``), and the port's entry
points refuse a CUDA device that is absent instead of carrying on on
the CPU."""
from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "torch_w4_mobile_decode.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.name} imports {bad}"


def test_cuda_entry_points_refuse_a_missing_card(monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_smoke_config("qwen1.5-0.5b")
    with pytest.raises(RuntimeError, match="cuda"):
        MD.init_params(cfg)


def test_w4_example_refuses_a_missing_card(monkeypatch):
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_w4_mobile_decode as tw4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tw4.run(n_steps=1, verbose=False)
