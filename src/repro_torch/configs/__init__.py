from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES, smoke_config  # noqa: F401
