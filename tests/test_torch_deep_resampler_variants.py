"""The air-pollution model of the port with de-aggregations of depth 2 (``dec_depth = 2``:
``level_decoder`` and ``level_decoder_alternate``, the second resampler of
``separate_perceiver``), against ``aurora_tpu`` in float64 on the CPU: its forward at the
variants' small architecture, gates open, at a mean relative error of at most 1e-8 per output
variable. The weights are numpy-seeded on the JAX tree's structure; the one JAX compile of
the file is the forward. The resampler itself and the small model at depth 2 are in
``tests/test_torch_deep_resampler.py``.
"""

import aurora_tpu
import aurora_tpu_torch
from tests.test_torch_support import (
    SMALL_ARCH,
    VARIANT_LEVELS,
    batch_errors,
    make_pollution_batch,
    seeded_matched_variant,
    torch_batch,
)

POLLUTION = dict(SMALL_ARCH, level_condition=tuple(int(x) for x in VARIANT_LEVELS),
                 use_lora=False, dec_depth=2)


def test_air_pollution_depth2_deaggregation_matches_f64():
    jm, params, tm = seeded_matched_variant(aurora_tpu.AuroraAirPollution,
                                            aurora_tpu_torch.AuroraAirPollution, **POLLUTION)
    dec = tm.decoder
    assert len(dec.level_decoder.layers) == len(dec.level_decoder_alternate.layers) == 2
    assert len(tm.encoder.level_agg.layers) == 1
    batch = make_pollution_batch()
    errs = batch_errors(tm(torch_batch(batch)), jm.forward(params, batch))
    assert max(errs.values()) <= 1e-8, errs
