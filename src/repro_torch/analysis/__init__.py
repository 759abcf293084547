"""The dry run's analysis: per-device op statistics of an eager step
(:mod:`repro_torch.analysis.opstats`) and their roofline on an H100
(:mod:`repro_torch.analysis.roofline`)."""
