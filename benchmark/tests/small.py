"""The small configuration the CPU tests run the harness at: the released model's shapes
and knobs with widths of 64 and two blocks a stage, on a 33 x 64 grid of four levels (the
rolled windows, the padding and the patch-merge pad all occur)."""

SMALL = dict(embed_dim=64, encoder_depths=[2, 2, 2], encoder_num_heads=[2, 4, 8],
             decoder_depths=[2, 2, 2], decoder_num_heads=[8, 4, 2], num_heads=4,
             window_size=[2, 3, 4],
             grid=dict(H=33, W=64, levels=[100, 250, 500, 850], history=2, batch=1))
FORECAST = {"steps": 4}
SEED = 2**31 + 12345


def traffic_update(workload: str) -> dict:
    return FORECAST if "forecast" in workload else {}
