"""The Aurora model: seeded init, the forward pass, the batch wrapper and the released
variants (port of ``aurora_tpu/model/aurora.py``).

``forward`` runs normalise -> clamp -> variant pre-hook -> encoder (f32) -> backbone (bf16
under ``autocast``) -> decoder -> variant post-hook -> gated clamps -> unnormalise
(``forward_core``, which keeps gradients and is what the train steps call; ``forward`` is
the ``no_grad`` step on a :class:`Batch`). The
Fourier encodings are computed on the host in float64. The model runs on the card unless
the caller passes ``device="cpu"``. The variants (air pollution, ocean waves) are hook
functions dispatched on ``cfg.variant`` plus a host-side ``batch_transform_hook``; each
released model is a facade class with its default config and checkpoint name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from aurora_tpu_torch.batch import Batch, Metadata
from aurora_tpu_torch.fourier import (
    absolute_time_expansion,
    lead_time_expansion,
    levels_expansion,
)
from aurora_tpu_torch.model.config import (
    HIGHRES_CONFIG,
    LARGE_CONFIG,
    SMALL_CONFIG,
    AuroraConfig,
)
from aurora_tpu_torch.model.decoder import Decoder
from aurora_tpu_torch.model.encoder import Encoder, EncoderEncodings
from aurora_tpu_torch.model.nn import DrawKey, Linear, checkpointed, draw_key, full_f32_products
from aurora_tpu_torch.model.swin3d import Backbone
from aurora_tpu_torch.normalisation import (
    normalise_atmos_var,
    normalise_surf_var,
    unnormalise_atmos_var,
    unnormalise_surf_var,
)
from aurora_tpu_torch.model.spmd import (
    decoder_apply_sharded,
    decoder_apply_whole,
    encoder_apply_sharded,
    encoder_apply_whole,
    spmd_local_aligned,
)
from aurora_tpu_torch.parallel.sharding import (
    data_mesh,
    gathered_params,
    global_grid,
    shard_leading,
    spatial_mesh,
)
from aurora_tpu_torch.posencoding import pos_scale_enc_cached
from aurora_tpu_torch.utils.profiling import span

__all__ = [
    "Aurora",
    "AuroraPretrained",
    "AuroraSmallPretrained",
    "AuroraSmall",
    "Aurora12hPretrained",
    "AuroraHighRes",
    "AuroraAirPollution",
    "AuroraWave",
    "PREDICT_DIFFERENCE_HISTORY_DIM",
    "cast_backbone_params",
    "full_f32_products",
    "grid_encodings",
    "resolve_device",
]

# For every air-pollution variable predicted as a difference, the history index the
# difference is taken against (``aurora_tpu/model/aurora.py:68-75``).
PREDICT_DIFFERENCE_HISTORY_DIM = {
    "pm1": 0, "pm2p5": 0, "pm10": 0,
    "co": 1, "tcco": 1,
    "no": 0, "tc_no": 0,
    "no2": 0, "tcno2": 0,
    "so2": 1, "tcso2": 1,
    "go3": 1, "gtco3": 1,
}


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the card. Raises when no card is present and the caller
    did not ask for the CPU: the port never carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available. Pass device='cpu' to run the plain versions "
            "of the kernels on the CPU."
        )
    return torch.device("cuda")


# ------------------------------------------------------------------- variant hooks


def _pollution_pre_encoder(model: "Aurora", surf, atmos):
    """Log-transform for the spikey chemistry variables, mixed with the clipped value by a
    learned ``(2, 1)`` combiner (``aurora_tpu/model/aurora.py:141-170``)."""
    cfg = model.cfg
    eps = 1e-4
    divisor = -math.log(eps)

    def transform(z, combiner):
        feats = torch.stack(
            [z.clamp(0.0, 2.5), (torch.log(z.clamp(min=eps)) - math.log(eps)) / divisor], dim=-1
        )
        return combiner(feats)[..., 0]

    surf = {
        k: transform(v, model.surf_feature_combiner[k]) if k in cfg.positive_surf_vars else v
        for k, v in surf.items()
    }
    atmos = {
        k: transform(v, model.atmos_feature_combiner[k]) if k in cfg.positive_atmos_vars else v
        for k, v in atmos.items()
    }
    return surf, atmos


def _pollution_post_decoder(surf_prev, atmos_prev, surf_pred, atmos_pred, atmos_levels,
                            cfg: AuroraConfig):
    """Difference prediction with the ``_mod`` heads, against the normalised input history,
    and the SO2 clamp on the levels of 850 hPa and more when LoRA is on
    (``aurora.py:171-192``)."""

    def transform(prev, pred, name):
        if name in PREDICT_DIFFERENCE_HISTORY_DIM:
            d = PREDICT_DIFFERENCE_HISTORY_DIM[name]
            return pred[name] + (1 + pred[f"{name}_mod"]) * prev[name][:, d]
        return pred[name]

    surf_out = {k: transform(surf_prev, surf_pred, k) for k in surf_prev}
    atmos_out = {k: transform(atmos_prev, atmos_pred, k) for k in atmos_prev}
    if cfg.use_lora and "so2" in atmos_out:
        so2 = atmos_out["so2"]
        low = torch.tensor([lvl >= 850 for lvl in atmos_levels], device=so2.device)
        atmos_out["so2"] = torch.where(low[:, None, None], so2.clamp(max=1.0), so2)
    return surf_out, atmos_out


def _wave_pre_encoder(surf, cfg: AuroraConfig):
    """Split angles into sin/cos and add the presence-density channels
    (``aurora.py:195-212``). The sin and cos are taken from the value before its NaNs are
    zeroed, so a masked point gives sin = cos = 0."""
    out = dict(surf)
    for name in list(out):
        x = out[name]
        if name in cfg.density_channel_surf_vars and f"{name}_density" not in out:
            out[f"{name}_density"] = (~torch.isnan(x)).to(x.dtype)
            out[name] = torch.nan_to_num(x, nan=0.0)
        if name in cfg.angle_surf_vars:
            out[f"{name}_sin"] = torch.nan_to_num(torch.sin(torch.deg2rad(x)), nan=0.0)
            out[f"{name}_cos"] = torch.nan_to_num(torch.cos(torch.deg2rad(x)), nan=0.0)
            del out[name]
    return out


def _wave_post_decoder(surf_pred, static_norm, cfg: AuroraConfig):
    """Angles back from sin/cos; NaN where the predicted density is below 1/2 or off the
    wave mask ``wmb`` (``aurora.py:215-236``)."""
    out = dict(surf_pred)
    wmb_mask = (static_norm["wmb"] > 0).to(next(iter(out.values())).dtype)
    for name in cfg.angle_surf_vars:
        if f"{name}_sin" in out and f"{name}_cos" in out:
            sin, cos = out.pop(f"{name}_sin"), out.pop(f"{name}_cos")
            out[name] = torch.rad2deg(torch.atan2(sin, cos)) % 360
    for name in cfg.density_channel_surf_vars:
        if name in out:
            density = torch.sigmoid(out.pop(f"{name}_density")) * wmb_mask
            out[name] = torch.where(density < 0.5, torch.nan, out[name] * wmb_mask)
    return out


def _on_device(a, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)


def grid_encodings(cfg: AuroraConfig, lat, lon, atmos_levels, dtype: torch.dtype,
                   device) -> dict[str, torch.Tensor]:
    """``pos``/``scale`` ``(L, D)``, ``levels`` ``(C_A, D)``, ``levels_dec`` ``(C_A, 2D)`` and
    ``lead_time`` ``(D,)`` of a grid: host float64 arithmetic, rounded once to ``dtype`` on
    ``device``. Constants of the grid, the levels and the config."""
    D = cfg.embed_dim
    pos, scale = pos_scale_enc_cached(D, lat, lon, cfg.patch_size)
    levels = np.asarray(atmos_levels, dtype=np.float64)
    lead = lead_time_expansion(np.array(cfg.timestep_hours, np.float64), D)
    return dict(
        pos=_on_device(pos, device, dtype),
        scale=_on_device(scale, device, dtype),
        levels=_on_device(levels_expansion(levels, D), device, dtype),
        levels_dec=_on_device(levels_expansion(levels, cfg.decoder_embed_dim), device, dtype),
        lead_time=_on_device(lead, device, dtype),
    )


def cast_backbone_params(model: "Aurora", dtype: torch.dtype = torch.bfloat16) -> "Aurora":
    """Store the backbone weights in ``dtype`` (in place). Under ``autocast`` the backbone
    computes in bf16 and every kernel casts its weights per use, so bf16 storage gives the
    same compute with half the weight memory."""
    model.backbone.to(dtype)
    return model


class Aurora(nn.Module):
    """The Aurora forecasting model.

    ``Aurora(cfg, device=None, dtype=torch.float32, seed=0, **overrides)``: parameters are
    created on ``device`` (the card when None) and initialised from ``seed`` with a
    ``torch.Generator``. ``model(batch)`` returns the prediction one timestep ahead.
    """

    def __init__(
        self,
        cfg: Optional[AuroraConfig] = None,
        *,
        device=None,
        dtype: torch.dtype = torch.float32,
        seed: Optional[int] = 0,
        **overrides,
    ):
        super().__init__()
        self._grid_encodings = None  # (key, tensors) of grid_encodings
        cfg = cfg or self.default_config()
        if overrides:
            cfg = cfg.replace(**overrides)
        self.cfg = cfg
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.encoder = Encoder(cfg, **kw)
        self.backbone = Backbone(cfg.backbone, **kw)
        self.decoder = Decoder(cfg, **kw)
        if cfg.variant == "air_pollution":
            # (2, 1) mixes of the clipped value and its log transform.
            self.surf_feature_combiner = nn.ModuleDict(
                {v: Linear(2, 1, **kw) for v in cfg.positive_surf_vars})
            self.atmos_feature_combiner = nn.ModuleDict(
                {v: Linear(2, 1, **kw) for v in cfg.positive_atmos_vars})
        if seed is not None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            self.encoder.reset_parameters(gen)
            self.backbone.reset_parameters(gen)
            self.decoder.reset_parameters(gen)
            with torch.no_grad():
                for name, p in self.named_parameters():
                    if "feature_combiner" in name:  # The mean of the two channels.
                        p.fill_(0.5 if name.endswith("weight") else 0.0)

    # The knobs that change how the model computes, not its parameters.
    RUNTIME_KNOBS = ("remat", "remat_scope", "drop_path", "drop_rate", "attention_impl",
                     "mlp_impl")

    def set_knobs(self, **knobs) -> "Aurora":
        """Set knobs of :data:`RUNTIME_KNOBS` on the built model (every submodule's copy of
        the config): the same weights under another ``remat_scope`` or on another backbone
        route, say. Returns the model."""
        bad = sorted(set(knobs) - set(self.RUNTIME_KNOBS))
        if bad:
            raise ValueError(f"not a runtime knob: {bad}; these are {self.RUNTIME_KNOBS}")
        cfg = self.cfg.replace(**knobs)
        for m in self.modules():
            if isinstance(getattr(m, "cfg", None), AuroraConfig):
                m.cfg = cfg
            elif hasattr(m, "cfg"):
                m.cfg = cfg.backbone
        return self

    # Released-checkpoint identity (``aurora_tpu/model/aurora.py:434-437``); pinned revisions.
    default_checkpoint_repo = "microsoft/aurora"
    default_checkpoint_name = "aurora-0.25-finetuned.ckpt"
    default_checkpoint_revision = "0be7e57c685dac86b78c4a19a3ab149d13c6a3dd"

    @classmethod
    def default_config(cls) -> AuroraConfig:
        return LARGE_CONFIG.replace(use_lora=True)

    @property
    def device(self) -> torch.device:
        return self.encoder.surf_level_encoding.device

    def load_checkpoint(self, repo: Optional[str] = None, name: Optional[str] = None,
                        revision: Optional[str] = None, strict: bool = True) -> "Aurora":
        """Download this variant's released checkpoint from the Hugging Face hub (pinned
        revision, cached by ``huggingface_hub``) and load it into the model; returns the
        model. Needs the network on first use."""
        from aurora_tpu_torch.checkpoint import load_checkpoint

        return self._load_tree(load_checkpoint(self, repo=repo, name=name, revision=revision,
                                               dtype=None, strict=strict))

    def load_checkpoint_local(self, path, strict: bool = True) -> "Aurora":
        """Load a reference-format ``.ckpt`` file into the model; returns the model.
        ``strict`` as :func:`aurora_tpu_torch.checkpoint.convert_reference_checkpoint`."""
        from aurora_tpu_torch.checkpoint import load_torch_checkpoint

        return self._load_tree(load_torch_checkpoint(path, self.cfg, dtype=None, strict=strict))

    def _load_tree(self, tree) -> "Aurora":
        # The tree keeps the file's dtype and each parameter rounds it once, to its own. It
        # was validated against the model (a LoRA bank the file predates keeps the model's
        # own values), so only the leaves it holds are loaded.
        from aurora_tpu_torch.convert import load_numpy_params

        return load_numpy_params(self, tree, strict=False)

    def batch_transform_hook(self, batch: Batch) -> Batch:
        """Transform the batch right after receiving it, before ``forward`` crops it and
        before ``rollout`` starts its history (``aurora_tpu/model/aurora.py:473-475``). The
        identity here; a variant overrides it. Must be idempotent: ``rollout`` calls it once
        and ``forward`` again on every step."""
        return batch

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the model takes its inputs in: the encoder's (the backbone may be stored
        in bf16)."""
        return self.encoder.surf_level_encoding.dtype

    def _apply(self, fn, *args, **kwargs):
        # ``model.to`` and its kin: the device copy of the grid encodings is of the old
        # device or dtype, so it goes now rather than at the next step.
        self._grid_encodings = None
        return super()._apply(fn, *args, **kwargs)

    def grid_encodings(self, metadata: Metadata, dtype: torch.dtype) -> dict[str, torch.Tensor]:
        """The encodings that are constants of the grid and the config: ``pos``, ``scale``,
        ``levels``, ``levels_dec`` and ``lead_time`` (:func:`grid_encodings`'s values).

        One copy on the model's device is kept on the instance for the last (grid contents,
        levels, patch, widths, timestep, dtype, device) asked for; another key replaces it,
        so two grids in turn never hold two copies (0.27 GB at 0.25 degrees). It is not a
        buffer and never enters the ``state_dict``."""
        cfg = self.cfg
        lat = np.asarray(metadata.lat, dtype=np.float64)
        lon = np.asarray(metadata.lon, dtype=np.float64)
        levels = tuple(float(x) for x in metadata.atmos_levels)
        key = (lat.shape, lat.tobytes(), lon.shape, lon.tobytes(), levels, cfg.patch_size,
               cfg.embed_dim, cfg.decoder_embed_dim, cfg.timestep_hours, dtype, self.device)
        if self._grid_encodings is None or self._grid_encodings[0] != key:
            self._grid_encodings = None  # The old copy goes before the new one is made.
            self._grid_encodings = (key, grid_encodings(cfg, lat, lon, levels, dtype,
                                                        self.device))
        return self._grid_encodings[1]

    def step_encodings(self, times, dtype: torch.dtype):
        """The encodings that change from step to step, on the model's device: the absolute
        time ``(B, D)`` of ``times`` (one per batch element) and, for ``dynamic_vars`` models,
        the ``(B, 6)`` time features in the order of ``AuroraConfig.dynamic_var_names``
        (else None). Host float64, rounded once to ``dtype``."""
        cfg = self.cfg
        abs_hours = np.array([t.timestamp() / 3600 for t in times], dtype=np.float64)
        absolute_time = _on_device(absolute_time_expansion(abs_hours, cfg.embed_dim),
                                   self.device, dtype)
        dynamic = None
        if cfg.dynamic_vars:
            dynamic = _on_device([
                [np.cos(2 * np.pi * t.hour / 24), np.sin(2 * np.pi * t.hour / 24),
                 np.cos(2 * np.pi * t.weekday() / 7), np.sin(2 * np.pi * t.weekday() / 7),
                 np.cos(2 * np.pi * t.day / 365.25), np.sin(2 * np.pi * t.day / 365.25)]
                for t in times
            ], self.device, dtype)
        return absolute_time, dynamic

    def prepare_encodings(self, batch: Batch, dtype: torch.dtype) -> EncoderEncodings:
        """All Fourier encodings, computed on the host in float64 (rounded to ``dtype``): the
        grid's constants from the model's device copy, the step's own made anew."""
        md = batch.metadata
        with span("aurora:encodings"):
            absolute_time, dynamic = self.step_encodings(md.time, dtype)
            return EncoderEncodings(**self.grid_encodings(md, dtype),
                                    absolute_time=absolute_time, dynamic_scalars=dynamic)

    def forward_core(self, surf, static, atmos, enc: EncoderEncodings, rollout_step: int,
                     atmos_levels, generator: Optional[torch.Generator] = None,
                     key: Optional[DrawKey] = None):
        """Unnormalised ``surf (B, T, H, W)``, ``static (H, W)``, ``atmos (B, T, C, H, W)``
        -> unnormalised predictions ``(B, H, W)`` / ``(B, C, H, W)``.

        Keeps gradients (the train steps call it, as the JAX train step calls
        ``forward_core``). With ``cfg.remat`` under ``remat_scope="full"`` the encoder, the
        backbone and the decoder are each rematerialised as a whole
        (``aurora_tpu/model/aurora.py:311-368``), the backbone's stages and blocks inside.

        ``generator`` (the JAX function's ``rng``) turns the training-only stochastic knobs
        ``cfg.drop_path`` / ``cfg.drop_rate`` on: one seed is drawn from it here, outside
        every rematerialised region, and every mask of the backbone derives from it
        (:mod:`aurora_tpu_torch.model.nn`). ``key`` passes a seed already drawn instead (the
        roll-out train step folds its step index into one). Neither: deterministic.

        Under a data mesh (an entered :class:`~aurora_tpu_torch.parallel.Mesh` with ``data``
        above 1, or parameters placed by :func:`~aurora_tpu_torch.parallel.shard_params`)
        ``surf`` and ``atmos`` are this rank's slice of the batch and so are the outputs
        (:func:`~aurora_tpu_torch.parallel.gather_batch` joins them); ``enc`` may hold the
        whole batch's time encodings, of which the rank's part is taken; ZeRO-split
        parameters are gathered for the call.

        Under a ``(lat, lon)`` mesh (``aurora_tpu/model/aurora.py:299-360``) the fields are
        this rank's block of the grid (:func:`~aurora_tpu_torch.parallel.shard_batch_arrays`)
        and so are the outputs (:func:`~aurora_tpu_torch.parallel.gather_batch` joins them);
        ``enc`` holds the whole grid's encodings. The encoder and decoder run on the rank's
        block where the pixel grid splits into whole patches (:mod:`~aurora_tpu_torch.model.
        spmd`), else whole on every rank; the backbone on the rank's block of the token grid.
        Gradients flow through every move between the blocks (the train steps run under such
        a mesh), and a key's masks are each rank's part of the one-process draw."""
        if generator is not None:
            if key is not None:
                raise ValueError("pass a generator or a key, not both")
            key = draw_key(generator)
        mesh = data_mesh(self)
        if mesh is not None:
            local = next(iter(surf.values())).shape[0]
            enc = dataclasses.replace(
                enc, absolute_time=shard_leading(enc.absolute_time, mesh, local),
                dynamic_scalars=shard_leading(enc.dynamic_scalars, mesh, local))
        with full_f32_products(), gathered_params(self):
            return self._forward_core(surf, static, atmos, enc, rollout_step, atmos_levels, key)

    def _forward_core(self, surf, static, atmos, enc, rollout_step, atmos_levels, key):
        cfg = self.cfg
        outer = cfg.remat and cfg.remat_scope == "full"
        stats = dict(cfg.surf_stats)
        B, T, H, W = next(iter(surf.values())).shape
        mesh = spatial_mesh()
        grid = (H, W) if mesh is None else global_grid(H, W, mesh)
        patch_res = (cfg.latent_levels, grid[0] // cfg.patch_size, grid[1] // cfg.patch_size)
        local = mesh is not None and spmd_local_aligned(cfg, B * mesh.shape["data"], *grid,
                                                         mesh)

        surf_n = {k: normalise_surf_var(v, k, stats) for k, v in surf.items()}
        static_n = {k: normalise_surf_var(v, k, stats) for k, v in static.items()}
        atmos_n = {k: normalise_atmos_var(v, k, atmos_levels) for k, v in atmos.items()}
        static_exp = {k: v[None, None].expand(B, T, H, W) for k, v in static_n.items()}
        surf_t = {
            k: v.clamp(min=0) if k in cfg.positive_surf_vars else v for k, v in surf_n.items()
        }
        atmos_t = {
            k: v.clamp(min=0) if k in cfg.positive_atmos_vars else v for k, v in atmos_n.items()
        }

        if cfg.variant == "air_pollution":
            surf_t, atmos_t = _pollution_pre_encoder(self, surf_t, atmos_t)
        elif cfg.variant == "wave":
            surf_t = _wave_pre_encoder(surf_t, cfg)

        with span("aurora:encoder"):
            if mesh is None:
                x = checkpointed(outer, self.encoder, surf_t, static_exp, atmos_t, enc,
                                 atmos_levels)
            else:
                encode = encoder_apply_sharded if local else encoder_apply_whole
                x = checkpointed(outer, encode, self.encoder, surf_t, static_exp, atmos_t, enc,
                                 atmos_levels, grid, mesh)
        if cfg.autocast:
            x = x.to(torch.bfloat16)
        with span("aurora:backbone"):
            x = checkpointed(outer, self.backbone, x, enc.lead_time, rollout_step, patch_res,
                             key)
        if cfg.autocast:
            x = x.to(torch.float32)
        # The decoder's variables are the hook-supplemented ones.
        with span("aurora:decoder"):
            if mesh is None:
                surf_pred, atmos_pred = checkpointed(
                    outer, self.decoder, x, tuple(surf_t), tuple(atmos_t), enc.levels_dec,
                    patch_res, H, W, atmos_levels,
                )
            elif local:
                surf_pred, atmos_pred = checkpointed(
                    outer, decoder_apply_sharded, self.decoder, x, tuple(surf_t),
                    tuple(atmos_t), enc.levels_dec, atmos_levels)
            else:
                surf_pred, atmos_pred = checkpointed(
                    outer, decoder_apply_whole, self.decoder, x, tuple(surf_t), tuple(atmos_t),
                    enc.levels_dec, atmos_levels, grid, mesh)

        if cfg.variant == "air_pollution":
            surf_pred, atmos_pred = _pollution_post_decoder(
                surf_n, atmos_n, surf_pred, atmos_pred, atmos_levels, cfg)
        elif cfg.variant == "wave":
            surf_pred = _wave_post_decoder(surf_pred, static_n, cfg)
        else:  # Drop the modulation heads no post hook consumes.
            surf_pred = {k: v for k, v in surf_pred.items() if not k.endswith("_mod")}
            atmos_pred = {k: v for k, v in atmos_pred.items() if not k.endswith("_mod")}

        pred_step = rollout_step + 1
        gate = pred_step >= 1 if cfg.clamp_at_first_step else pred_step > 1
        if gate:
            surf_pred = {
                k: v.clamp(min=0) if k in cfg.positive_surf_vars else v
                for k, v in surf_pred.items()
            }
            atmos_pred = {
                k: v.clamp(min=0) if k in cfg.positive_atmos_vars else v
                for k, v in atmos_pred.items()
            }
        surf_out = {k: unnormalise_surf_var(v, k, stats) for k, v in surf_pred.items()}
        atmos_out = {k: unnormalise_atmos_var(v, k, atmos_levels) for k, v in atmos_pred.items()}
        return surf_out, atmos_out

    def crop(self, batch: Batch) -> Batch:
        """``batch.crop(patch_size)``; under a ``(lat, lon)`` mesh, where the batch holds the
        rank's block, the batch itself, which the caller cropped before splitting it (its
        metadata's whole grid must be a multiple of the patch size)."""
        if spatial_mesh() is None:
            return batch.crop(patch_size=self.cfg.patch_size)
        n = np.shape(batch.metadata.lat)[0]
        if n % self.cfg.patch_size:
            raise ValueError(f"under a (lat, lon) mesh crop the batch before splitting it: "
                             f"{n} latitudes, patch {self.cfg.patch_size}")
        return batch

    @torch.no_grad()
    def forward(self, batch: Batch) -> Batch:
        """One prediction step: returns a :class:`Batch` one timestep ahead. Its static
        variables are the (cropped) ones the caller passed, as the JAX package returns them,
        not the device copies the model computed with. Under a ``(lat, lon)`` mesh the batch
        holds the rank's block (:func:`~aurora_tpu_torch.parallel.shard_batch`) and so does
        the prediction."""
        cfg = self.cfg
        batch = self.batch_transform_hook(batch)
        batch = self.crop(batch)
        dtype = self.compute_dtype
        enc = self.prepare_encodings(batch, torch.float32 if dtype == torch.bfloat16 else dtype)
        with span("aurora:upload"):
            b = batch.to(self.device, dtype)
        surf_pred, atmos_pred = self.forward_core(
            b.surf_vars, b.static_vars, b.atmos_vars, enc,
            batch.metadata.rollout_step, tuple(batch.metadata.atmos_levels),
        )
        md = batch.metadata
        return Batch(
            surf_vars={k: v[:, None] for k, v in surf_pred.items()},
            static_vars=dict(batch.static_vars),
            atmos_vars={k: v[:, None] for k, v in atmos_pred.items()},
            metadata=Metadata(
                lat=md.lat,
                lon=md.lon,
                time=tuple(t + cfg.timestep for t in md.time),
                atmos_levels=md.atmos_levels,
                rollout_step=md.rollout_step + 1,
            ),
        )


class AuroraPretrained(Aurora):
    default_checkpoint_name = "aurora-0.25-pretrained.ckpt"
    default_checkpoint_revision = "0be7e57c685dac86b78c4a19a3ab149d13c6a3dd"

    @classmethod
    def default_config(cls):
        return LARGE_CONFIG


class AuroraSmallPretrained(Aurora):
    """The small model (D = 256). On the card it runs in its default config (float32 all
    through) or with the production knobs (bf16): K2, K3 and K4 take its D = 256 shapes in
    both."""

    default_checkpoint_name = "aurora-0.25-small-pretrained.ckpt"
    default_checkpoint_revision = "0be7e57c685dac86b78c4a19a3ab149d13c6a3dd"

    @classmethod
    def default_config(cls):
        return SMALL_CONFIG


AuroraSmall = AuroraSmallPretrained


class Aurora12hPretrained(Aurora):
    default_checkpoint_name = "aurora-0.25-12h-pretrained.ckpt"
    default_checkpoint_revision = "15e76e47b65bf4b28fd2246b7b5b951d6e2443b9"

    @classmethod
    def default_config(cls):
        return LARGE_CONFIG.replace(timestep_hours=12.0)


class AuroraHighRes(Aurora):
    default_checkpoint_name = "aurora-0.1-finetuned.ckpt"
    default_checkpoint_revision = "0be7e57c685dac86b78c4a19a3ab149d13c6a3dd"

    @classmethod
    def default_config(cls):
        return HIGHRES_CONFIG.replace(use_lora=True)


class AuroraAirPollution(Aurora):
    """Air-pollution fine-tune at CAMS 0.4 degrees (``aurora_tpu/model/aurora.py:605-635``)."""

    default_checkpoint_name = "aurora-0.4-air-pollution.ckpt"
    default_checkpoint_revision = "1764d5630a53d3d7a7d169ca335236fc343e4bfc"

    @classmethod
    def default_config(cls):
        pollution_surf = ("pm1", "pm2p5", "pm10", "tcco", "tc_no", "tcno2", "gtco3", "tcso2")
        pollution_atmos = ("co", "no", "no2", "go3", "so2")
        return LARGE_CONFIG.replace(
            variant="air_pollution",
            surf_vars=("2t", "10u", "10v", "msl") + pollution_surf,
            static_vars=(
                ("lsm", "z", "slt")
                + ("static_ammonia", "static_ammonia_log", "static_co", "static_co_log")
                + ("static_nox", "static_nox_log", "static_so2", "static_so2_log")
            ),
            atmos_vars=("z", "u", "v", "t", "q") + pollution_atmos,
            patch_size=3,
            timestep_hours=12.0,
            level_condition=(50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000),
            dynamic_vars=True,
            atmos_static_vars=True,
            separate_perceiver=pollution_atmos,
            modulation_heads=tuple(PREDICT_DIFFERENCE_HISTORY_DIM),
            positive_surf_vars=pollution_surf,
            positive_atmos_vars=pollution_atmos,
            simulate_indexing_bug=True,
            use_lora=True,
        )


class AuroraWave(Aurora):
    """Ocean-wave fine-tune at 0.25 degrees (``aurora_tpu/model/aurora.py:638-700``)."""

    default_checkpoint_name = "aurora-0.25-wave.ckpt"
    default_checkpoint_revision = "74598e8c65d53a96077c08bb91acdfa5525340c9"

    @classmethod
    def default_config(cls):
        wave_vars = (
            ("swh", "mwd", "mwp", "pp1d", "shww", "mdww", "mpww", "shts", "mdts", "mpts")
            + ("swh1", "mwd1", "mwp1", "swh2", "mwd2", "mwp2", "wind", "10u_wave", "10v_wave")
        )
        angle_vars = ("mwd", "mdww", "mdts", "mwd1", "mwd2")
        # The model's own variable set: angles split into sin/cos, a density channel per
        # wave variable.
        supplemented: tuple[str, ...] = ()
        for name in ("2t", "10u", "10v", "msl") + wave_vars:
            if name in angle_vars:
                supplemented += (f"{name}_sin", f"{name}_cos")
            else:
                supplemented += (name,)
            if name in wave_vars:
                supplemented += (f"{name}_density",)
        return LARGE_CONFIG.replace(
            variant="wave",
            surf_vars=supplemented,
            static_vars=("lsm", "z", "slt", "wmb", "lat_mask"),
            lora_mode="from_second",
            stabilise_level_agg=True,
            density_channel_surf_vars=wave_vars,
            angle_surf_vars=angle_vars,
            use_lora=True,
        )

    def batch_transform_hook(self, batch: Batch) -> Batch:
        """Split the 10 m neutral wind into components and NaN-mask absent waves
        (``aurora_tpu/model/aurora.py:673-700``). On the host, in numpy; idempotent."""
        surf = dict(batch.surf_vars)
        if "dwi" in surf and "wind" in surf:
            wind, dwi = _numpy(surf["wind"]), _numpy(surf.pop("dwi"))
            surf["10u_wave"] = -wind * np.sin(np.deg2rad(dwi))
            surf["10v_wave"] = -wind * np.cos(np.deg2rad(dwi))
        if batch.metadata.rollout_step == 0:
            for name_sh, others in [
                ("swh", ("mwd", "mwp", "pp1d")),
                ("shww", ("mdww", "mpww")),
                ("shts", ("mdts", "mdts")),
                ("swh1", ("mwd1", "mwp1")),
                ("swh2", ("mwd2", "mwp2")),
            ]:
                mask = _numpy(surf[name_sh]) < 1e-4
                if mask.sum() > 0:
                    for name in (name_sh,) + others:
                        x = np.array(_numpy(surf[name]), copy=True)
                        x[mask] = np.nan
                        surf[name] = x
        return dataclasses.replace(batch, surf_vars=surf)


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
