"""The 0.1 degree HighRes model on the card: 1801 x 3600 (1800 x 3600 after the crop),
patch 10, stage depths (6, 8, 8) / (8, 8, 6).

Counterpart of ``tools/highres_bench.py``. The model is the released one
(``AuroraHighRes``: ``HIGHRES_CONFIG`` with LoRA, which its checkpoint holds; the JAX tool
runs it without LoRA, which the card's kernels fold into their weights anyway) with the
production knobs of ``tools/highres_bench.py:35-37``: the backbone in bf16 under
``autocast`` with bf16-stored weights, bf16 values in the level aggregation and
de-aggregation; ``--default-config`` builds the facade's default config instead (float32 all
through, as the serving registry and the command-line interface build it). The batch is seeded N(0, 1) fields (|N(0, 1)| for the static ones), batch 1,
history 2, 13 levels, made on the card: 3.4 GB of atmospheric history. The token grid is
the 0.25 degree model's (180 x 360); the patch embedding and the un-patchify move 6.25x
the pixels.

One row, as ``variant_bench``'s: the roll-out's step times (the 3rd step is the first steady
one), grid points per second, peak device memory, launches per step and the last
prediction's variables with their NaN / inf counts. Weights: seeded, gates opened, unless
``main(argv, model=...)`` is given a model.

Usage: ``python -m aurora_tpu_torch.tools.highres_bench [--steps 3] [--default-config]
[--device cpu] [--H 1801 --W 3600]``.
"""

from __future__ import annotations

import argparse
from datetime import datetime
from typing import Optional

from aurora_tpu_torch.model.aurora import Aurora, AuroraHighRes
from aurora_tpu_torch.tools import card_line, report, resolve_device, result
from aurora_tpu_torch.tools.perf_breakdown import config_form
from aurora_tpu_torch.tools.variant_bench import build_variant, raw_batch, run_rollout


def main(argv=None, *, model: Optional[Aurora] = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--default-config", action="store_true",
                    help="the facade's default config (float32) in place of the production "
                         "knobs")
    ap.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    ap.add_argument("--H", type=int, default=1801)
    ap.add_argument("--W", type=int, default=3600)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if model is None:
        model = build_variant(AuroraHighRes, dev, production=not args.default_config)
    if model.device.type != dev.type:
        raise ValueError(f"the model is on {model.device}, the tool runs on {dev}")
    batch = raw_batch(model.cfg, args.H, args.W, device=dev, absolute=False,
                      when=datetime(2020, 6, 1, 12))
    r = run_rollout(model, batch, args.steps)
    return [report(result("highres_0.1deg", 1e3 * r["step_s"][-1], dev, card=card_line(dev),
                          config=config_form(model.cfg), patch_size=model.cfg.patch_size,
                          params=sum(p.numel() for p in model.parameters()), **r))]


if __name__ == "__main__":
    main()
