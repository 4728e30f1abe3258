"""The port and its chip smoke script import neither JAX nor anything of
the JAX package (``repro``), and the port's entry points refuse a CUDA
device that is absent instead of carrying on on the CPU."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
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
