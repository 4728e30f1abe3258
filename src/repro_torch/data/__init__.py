"""The deterministic synthetic LM stream: ``pipeline.py`` is a verbatim
copy of ``repro/data/pipeline.py`` (numpy only, so every batch is the
reference's bit for bit)."""
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    SyntheticLMStream,
    host_shard_slice,
    make_train_stream,
)
