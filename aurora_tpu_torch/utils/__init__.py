"""Utilities of the port: profiling (:mod:`aurora_tpu_torch.utils.profiling`)."""
