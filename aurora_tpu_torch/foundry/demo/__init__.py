"""Demo helpers for the serving stack (port of ``aurora_tpu/foundry/demo``)."""
