"""The port's serving engine against the JAX engine on the paged KV cache
for the MoE and vlm families (deepseek-moe-16b, internvl2-26b, dbrx-132b
smoke configs, float32, CPU): equal blocking streams."""
from __future__ import annotations

import pytest

from test_torch_families_engine import ARCHS, check_blocking_streams


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_blocking_streams_match_reference(arch):
    check_blocking_streams(arch, "paged")
