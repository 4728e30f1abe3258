"""Roofline tooling over the dry-run's records: the three-term analysis
(:mod:`~repro_torch.roofline.analysis`) and the collective recorder
(:mod:`~repro_torch.roofline.collective_bytes`)."""
