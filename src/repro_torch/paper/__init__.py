"""The paper's tables and figures on the port: one module per table or
figure, each with a ``run(device=…)`` returning ``name`` /
``us_per_call`` / ``derived`` rows (``python -m repro_torch.paper.run``
prints them all)."""
