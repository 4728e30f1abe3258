"""The port's serving launcher (``python -m repro_torch.launch.serve``) at
the smoke size on the CPU, greedy and sampled, on both KV backends."""
from __future__ import annotations

import pytest

from repro_torch.launch import serve


@pytest.mark.parametrize("extra", [
    [],
    ["--sample", "temperature", "--temperature", "0.8", "--top-k", "20"],
    ["--kv-cache", "paged", "--sample", "temperature"],
], ids=["greedy", "temperature", "paged-temperature"])
def test_serve_main_runs(capsys, extra):
    argv = ["--smoke", "--device", "cpu", "--requests", "3",
            "--prompt-len", "9", "--max-new", "4", "--slots", "2",
            "--capacity", "32"] + extra
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out
    assert "sample output (rid 0)" in out
    assert serve.main(argv) == 0
    assert capsys.readouterr().out.splitlines()[1] == out.splitlines()[1]


def test_serve_refuses_ckpt_dir_and_says_why(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--smoke", "--device", "cpu", "--ckpt-dir", "/nowhere"])
    assert e.value.code == 2
    with pytest.raises(SystemExit):
        serve.main(["--help"])
    assert "--ckpt-dir" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "internvl2-26b"])
def test_serve_main_runs_moe_and_vlm(capsys, arch):
    """The launcher serves the MoE and vlm smoke models from the
    registry, as the reference's does."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--prompt-len", "9", "--max-new", "4", "--slots", "2",
            "--capacity", "32", "--kv-cache", "paged"]
    assert serve.main(argv) == 0
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
