"""``python -m aurora_tpu_torch``: the command-line driver (:mod:`aurora_tpu_torch.cli`)."""

from aurora_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
