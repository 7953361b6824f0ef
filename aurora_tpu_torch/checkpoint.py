"""Reference checkpoints into the port: the port of ``aurora_tpu/checkpoint.py``, in numpy.

The released state dicts (PyTorch naming and layout, reference aurora/model/aurora.py:409-456)
become the parameter tree that :func:`aurora_tpu_torch.convert.load_numpy_params` loads into
a model, with the JAX package's layouts:

* Linear ``weight``: ``(out, in)`` -> ``(in, out)``.
* Patch-embed variable kernels: ``(D, 1, T, P, P)`` -> ``(T, P, P, D)``.
* LoRA banks: per-step modules -> stacked ``A: (S, r, in)``, ``B: (S, r, out)``.
* Perceiver ``ModuleList`` indices -> named fields (``attn``/``mlp``/``ln1``/``ln2``).
* Schema migrations of the older released files (ID-based -> name-based parameters, the
  air-pollution and wave renames), as reference aurora/model/compat.py.

The tree's path ``a.b.0.c`` is the port's parameter name, so a model built on the ``meta``
device gives the structure a tree is validated against without allocating a weight. Native
save and restore are ``torch.save`` / ``torch.load(weights_only=True)`` of a model's
``state_dict``, and of a training state (the model's and the optimiser's state dicts and the
step). The leaves are numpy arrays: nothing here needs JAX.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.normalisation import level_to_str

__all__ = [
    "convert_torch_state_dict",
    "adapt_checkpoint_pretrained",
    "adapt_checkpoint_air_pollution",
    "adapt_checkpoint_wave",
    "adapt_max_history_size",
    "tree_path_shapes",
    "model_param_shapes",
    "validate_params",
    "convert_reference_checkpoint",
    "load_torch_checkpoint",
    "load_checkpoint",
    "save_params",
    "restore_params",
    "save_train_state",
    "restore_train_state",
]

_RESAMPLER_RE = re.compile(
    r"(level_agg|level_decoder_alternate|level_decoder)\.layers\.(\d+)\.([0-3])\."
)
_RESAMPLER_SLOT = {"0": "attn", "1": "mlp", "2": "ln1", "3": "ln2"}

# Path components after which a numeric component is a *list index*.
_LIST_PARENTS = {"encoder_layers", "decoder_layers", "blocks", "_rs_layers"}


def _rename(key: str) -> str:
    """Torch parameter name -> parameter path (dot-separated)."""
    k = key
    # Perceiver resampler slots; tag its `layers` so they parse as list indices.
    k = _RESAMPLER_RE.sub(
        lambda m: f"{m.group(1)}._rs_layers.{m.group(2)}.{_RESAMPLER_SLOT[m.group(3)]}.", k
    )
    # Perceiver-style MLPs: Sequential indices -> fc1/fc2.
    k = k.replace(".net.0.", ".fc1.").replace(".net.2.", ".fc2.")
    # Backbone lead-time MLP.
    k = k.replace("time_mlp.0.", "time_mlp.fc1.").replace("time_mlp.2.", "time_mlp.fc2.")
    # FiLM modulation.
    k = k.replace("ln_modulation.1.", "modulation.")
    return k


def _set_path(tree: dict, parts: list[str], value) -> None:
    node = tree
    for i, part in enumerate(parts[:-1]):
        if part.isdigit() and i > 0 and parts[i - 1] in _LIST_PARENTS:
            idx = int(part)
            assert isinstance(node, list)
            while len(node) <= idx:
                node.append({})
            node = node[idx]
        else:
            if part not in node:
                node[part] = [] if parts[i + 1].isdigit() and part in _LIST_PARENTS else {}
            node = node[part]
    node[parts[-1]] = value


def _strip_rs_tag(tree):
    """Rename the temporary ``_rs_layers`` tag back to ``layers``."""
    if isinstance(tree, dict):
        return {("layers" if k == "_rs_layers" else k): _strip_rs_tag(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_strip_rs_tag(v) for v in tree]
    return tree


def convert_torch_state_dict(
    sd: Mapping[str, np.ndarray],
    cfg: AuroraConfig,
    dtype=np.float32,
    leaf_fn=None,
) -> dict:
    """Convert an (already schema-migrated) torch state dict into a parameter tree.

    ``leaf_fn(value, dtype)`` constructs each leaf (default: ``np.asarray(value, dtype)``,
    a view where no cast is needed; ``dtype=None`` keeps the file's); pass e.g.
    ``lambda v, d: v.shape`` for a structural dry run.
    """
    if leaf_fn is None:
        leaf_fn = lambda v, d: np.asarray(v, d)  # noqa: E731
    tree: dict = {}
    lora_acc: dict[str, dict[int, np.ndarray]] = {}

    for key, value in sd.items():
        v = np.asarray(value)
        k = _rename(key)

        m = re.search(r"(lora_qkv|lora_proj)\.loras\.(\d+)\.(lora_A|lora_B)$", k)
        if m:
            base = k[: m.start()] + m.group(1) + "." + ("A" if m.group(3) == "lora_A" else "B")
            if m.group(3) == "lora_B":
                v = v.T  # torch (out, r) -> (r, out)
            lora_acc.setdefault(base, {})[int(m.group(2))] = v
            continue

        parts = k.split(".")
        if v.ndim == 5:
            v = np.transpose(v[:, 0], (1, 2, 3, 0))  # (D, 1, T, P, P) -> (T, P, P, D)
        elif v.ndim == 2 and parts[-1] == "weight":
            v = v.T  # Linear (out, in) -> (in, out)
        _set_path(tree, parts, leaf_fn(v, dtype))

    for base, steps in lora_acc.items():
        stacked = np.stack([steps[i] for i in range(len(steps))], axis=0)
        _set_path(tree, base.split("."), leaf_fn(stacked, dtype))

    return _strip_rs_tag(tree)


# ------------------------------------------------------------------ schema migration


def adapt_checkpoint_pretrained(patch_size: int, d: dict) -> dict:
    """ID-based -> name-based parameters of the original released checkpoints (reference
    aurora/model/compat.py:18-75)."""
    d = dict(d)
    for k in list(d):
        if k.startswith("net."):
            d[k[4:]] = d.pop(k)

    if "encoder.surf_token_embeds.weight" in d:
        weight = d.pop("encoder.surf_token_embeds.weight")
        assert weight.shape[1] == 4 + 3
        for i, name in enumerate(("2t", "10u", "10v", "msl", "lsm", "z", "slt")):
            d[f"encoder.surf_token_embeds.weights.{name}"] = weight[:, [i]]

    if "encoder.atmos_token_embeds.weight" in d:
        weight = d.pop("encoder.atmos_token_embeds.weight")
        assert weight.shape[1] == 5
        for i, name in enumerate(("z", "u", "v", "t", "q")):
            d[f"encoder.atmos_token_embeds.weights.{name}"] = weight[:, [i]]

    for head, names in (
        ("surf_head", ("2t", "10u", "10v", "msl")),
        ("atmos_head", ("z", "u", "v", "t", "q")),
    ):
        if f"decoder.{head}.weight" in d:
            weight = d.pop(f"decoder.{head}.weight")
            bias = d.pop(f"decoder.{head}.bias")
            n = len(names)
            assert weight.shape[0] == n * patch_size**2
            weight = weight.reshape(patch_size**2, n, -1)
            bias = bias.reshape(patch_size**2, n)
            plural = head.replace("head", "heads")
            for i, name in enumerate(names):
                d[f"decoder.{plural}.{name}.weight"] = weight[:, i]
                d[f"decoder.{plural}.{name}.bias"] = bias[:, i]
    return d


_POLLUTION_LEVELS = (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)
_POLLUTION_SURF = ("pm1", "pm2p5", "pm10", "tcco", "tc_no", "tcno2", "gtco3", "tcso2")


def adapt_checkpoint_air_pollution(patch_size: int, d: dict) -> dict:
    """Air-pollution checkpoint migration, with the deliberate ``z``/``static_z`` aliasing
    and the merge of the two patch-embed biases (reference compat.py:78-270)."""
    d = dict(d)

    if "encoder.surf_token_embeds.weight_new" in d:
        weight = d.pop("encoder.surf_token_embeds.weight_new")
        assert weight.shape[1] == (3 + 5) + 4 * 2 + 3 * 2
        names = (
            _POLLUTION_SURF
            + ("static_ammonia", "static_ammonia_log", "static_co", "static_co_log")
            + ("static_nox", "static_nox_log", "static_so2", "static_so2_log")
            + ("tod_cos", "tod_sin", "dow_cos", "dow_sin", "doy_cos", "doy_sin")
        )
        for i, name in enumerate(names):
            d[f"encoder.surf_token_embeds.weights.{name}"] = weight[:, [i]]

    if (
        "encoder.atmos_token_embeds.weights.z" in d
        and "encoder.atmos_token_embeds_new.layers.50.weight" in d
    ):
        bias = d.pop("encoder.atmos_token_embeds.bias")
        for name in ("z", "u", "v", "t", "q"):
            weight = d.pop(f"encoder.atmos_token_embeds.weights.{name}")
            for level in _POLLUTION_LEVELS:
                d[f"encoder.atmos_token_embeds.layers.{level}.weights.{name}"] = np.array(
                    weight, copy=True
                )
                d[f"encoder.atmos_token_embeds.layers.{level}.bias"] = np.array(bias, copy=True)

    if "encoder.atmos_token_embeds.weight_new2" in d:
        weight = d.pop("encoder.atmos_token_embeds.weight_new2")
        assert weight.shape[1] == 17
        names = (
            ("static_lsm", "static_z", "static_slt")
            + ("static_static_ammonia", "static_static_ammonia_log")
            + ("static_static_co", "static_static_co_log")
            + ("static_static_nox", "static_static_nox_log")
            + ("static_static_so2", "static_static_so2_log")
            + ("static_tod_cos", "static_tod_sin", "static_dow_cos")
            + ("static_dow_sin", "static_doy_cos", "static_doy_sin")
        )
        for level in _POLLUTION_LEVELS:
            for i, name in enumerate(names):
                d[f"encoder.atmos_token_embeds.layers.{level_to_str(level)}.weights.{name}"] = (
                    weight[:, [i]]
                )

    d.pop("encoder.atmos_token_embeds.weight_new", None)

    for level in _POLLUTION_LEVELS:
        ls = level_to_str(level)
        d.pop(f"encoder.atmos_token_embeds_new.layers.{ls}.weight", None)

        n1 = f"encoder.atmos_token_embeds_new.layers.{ls}.weight_new"
        if n1 in d:
            weight = d.pop(n1)
            assert weight.shape[1] == 5
            for i, name in enumerate(("co", "no", "no2", "go3", "so2")):
                d[f"encoder.atmos_token_embeds.layers.{ls}.weights.{name}"] = weight[:, [i]]

        # The original implementation indexes `z` through `static_z`'s embedding.
        d[f"encoder.atmos_token_embeds.layers.{ls}.weights.z"] = d[
            f"encoder.atmos_token_embeds.layers.{ls}.weights.static_z"
        ]

        n1 = f"encoder.atmos_token_embeds_new.layers.{ls}.bias"
        n2 = f"encoder.atmos_token_embeds.layers.{ls}.bias"
        if n1 in d:
            assert n2 in d
            d[n2] = d[n2] + d.pop(n1)  # Two original instances: the biases add.

        d.pop(f"encoder.atmos_token_embeds_new.layers.{ls}.weight_new2", None)

    for name in ("2t", "10u", "10v", "msl"):
        d.pop(f"surf_feature_combiner.{name}.weight", None)
        d.pop(f"surf_feature_combiner.{name}.bias", None)
    for name in ("z", "u", "v", "t", "q"):
        d.pop(f"atmos_feature_combiner.{name}.weight", None)
        d.pop(f"atmos_feature_combiner.{name}.bias", None)

    for k in list(d):
        if k.startswith("decoder.level_decoder_new"):
            d["decoder.level_decoder_alternate" + k.removeprefix("decoder.level_decoder_new")] = (
                d.pop(k)
            )

    if "decoder.surf_head_new.weight" in d:
        weight = d.pop("decoder.surf_head_new.weight")
        bias = d.pop("decoder.surf_head_new.bias")
        weight = weight.reshape(patch_size**2, 8, -1)
        bias = bias.reshape(patch_size**2, 8)
        for i, name in enumerate(_POLLUTION_SURF):
            d[f"decoder.surf_heads.{name}.weight"] = weight[:, i]
            d[f"decoder.surf_heads.{name}.bias"] = bias[:, i]

    if "decoder.surf_head_mod.weight" in d:
        weight = d.pop("decoder.surf_head_mod.weight")
        bias = d.pop("decoder.surf_head_mod.bias")
        n = 4 + 8
        weight = weight.reshape(patch_size**2, n, -1)
        bias = bias.reshape(patch_size**2, n)
        for i, name in enumerate(("2t", "10u", "10v", "msl") + _POLLUTION_SURF):
            if name in _POLLUTION_SURF:
                d[f"decoder.surf_heads.{name}_mod.weight"] = weight[:, i]
                d[f"decoder.surf_heads.{name}_mod.bias"] = bias[:, i]

    for suffix in ("", "_mod"):
        for level in _POLLUTION_LEVELS:
            k_w = f"decoder.atmos_head{suffix}.layers.{level}.weight"
            if k_w in d:
                weight = d.pop(k_w)
                bias = d.pop(f"decoder.atmos_head{suffix}.layers.{level}.bias")
                if suffix != "_mod":
                    weight = weight.reshape(patch_size**2, 5, -1)
                    bias = bias.reshape(patch_size**2, 5)
                    for i, v in enumerate(("z", "u", "v", "t", "q")):
                        d[f"decoder.atmos_heads.{v}{suffix}.layers.{level}.weight"] = weight[:, i]
                        d[f"decoder.atmos_heads.{v}{suffix}.layers.{level}.bias"] = bias[:, i]

            k_w = f"decoder.atmos_head{suffix}_new.layers.{level}.weight"
            if k_w in d:
                weight = d.pop(k_w)
                bias = d.pop(f"decoder.atmos_head{suffix}_new.layers.{level}.bias")
                weight = weight.reshape(patch_size**2, 5, -1)
                bias = bias.reshape(patch_size**2, 5)
                for i, v in enumerate(("co", "no", "no2", "go3", "so2")):
                    d[f"decoder.atmos_heads.{v}{suffix}.layers.{level}.weight"] = weight[:, i]
                    d[f"decoder.atmos_heads.{v}{suffix}.layers.{level}.bias"] = bias[:, i]
    return d


def adapt_checkpoint_wave(patch_size: int, d: dict) -> dict:
    """Wave checkpoint renames (reference compat.py:273-284)."""
    d = dict(d)
    for n1, n2 in [(".k_ln.", ".ln_k."), (".q_ln.", ".ln_q.")]:
        for k in list(d):
            if n1 in k:
                d[k.replace(n1, n2)] = d.pop(k)
    return d


def adapt_max_history_size(d: dict, max_history_size: int) -> dict:
    """Zero-pad the history axis of the encoder's patch embeddings for a model with a larger
    ``max_history_size`` (reference aurora/model/aurora.py:469-504)."""
    d = dict(d)
    for name, weight in list(d.items()):
        if name.startswith("encoder.surf_token_embeds.weights.") or name.startswith(
            "encoder.atmos_token_embeds."
        ) and ".weights." in name:
            if weight.ndim != 5:
                continue
            T = weight.shape[2]
            if T > max_history_size:
                raise AssertionError(
                    f"Cannot load checkpoint with `max_history_size` {T} into model "
                    f"with `max_history_size` {max_history_size}."
                )
            if T < max_history_size:
                new = np.zeros(
                    (weight.shape[0], 1, max_history_size, *weight.shape[3:]),
                    dtype=np.asarray(weight).dtype,
                )
                new[:, :, :T] = weight
                d[name] = new
    return d


# ------------------------------------------------------------------ validation


def tree_path_shapes(tree, prefix="") -> dict[str, tuple]:
    """Flatten a parameter tree (leaves with a ``shape``, or shapes) into ``{path: shape}``."""
    out: dict[str, tuple] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(tree_path_shapes(v, f"{prefix}{k}."))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(tree_path_shapes(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tuple(getattr(tree, "shape", tree))
    return out


def model_param_shapes(cfg: AuroraConfig) -> dict[str, tuple]:
    """``{parameter name: shape}`` of the port's model for ``cfg``, from a model built on the
    ``meta`` device: no parameter memory is allocated."""
    from aurora_tpu_torch.model.aurora import Aurora

    model = Aurora(cfg, device="meta", seed=None)
    return {name: tuple(p.shape) for name, p in model.named_parameters()}


def validate_params(params, cfg: AuroraConfig) -> dict[str, list[str]]:
    """Structurally compare a converted tree with the model of ``cfg``.

    Returns ``{"missing": [...], "unexpected": [...], "mismatched": [...]}``: all empty iff
    the checkpoint covers the model exactly.
    """
    want = model_param_shapes(cfg)
    got = tree_path_shapes(params)
    return {
        "missing": sorted(set(want) - set(got)),
        "unexpected": sorted(set(got) - set(want)),
        "mismatched": sorted(
            f"{k}: ckpt{got[k]} vs model{want[k]}"
            for k in set(want) & set(got)
            if want[k] != got[k]
        ),
    }


def convert_reference_checkpoint(
    sd: Mapping[str, np.ndarray],
    cfg: AuroraConfig,
    dtype=np.float32,
    strict: bool = True,
    leaf_fn=None,
) -> dict:
    """Schema-migrate and convert a raw reference state dict into a parameter tree.

    ``strict=True`` validates the result one to one against the model's own parameters
    (missing, unexpected or shape-mismatched paths raise ``ValueError``). LoRA banks are
    exempt when the config enables LoRA but the file predates it, as the reference loads
    them with ``strict=False`` (docs/finetuning.md).
    """
    sd = adapt_checkpoint_pretrained(cfg.patch_size, sd)
    if cfg.variant == "air_pollution":
        sd = adapt_checkpoint_air_pollution(cfg.patch_size, sd)
    elif cfg.variant == "wave":
        sd = adapt_checkpoint_wave(cfg.patch_size, sd)
    sd = adapt_max_history_size(sd, cfg.max_history_size)

    params = convert_torch_state_dict(sd, cfg, dtype=dtype, leaf_fn=leaf_fn)
    if strict:
        problems = validate_params(params, cfg)
        if cfg.use_lora:
            problems["missing"] = [p for p in problems["missing"] if "lora" not in p]
        msgs = [f"{kind}: {v}" for kind, v in problems.items() if v]
        if msgs:
            raise ValueError(
                "checkpoint does not match the model parameter structure;\n" + "\n".join(msgs)
            )
    return params


# ------------------------------------------------------------------ files


def load_torch_checkpoint(path, cfg: AuroraConfig, dtype=np.float32, strict: bool = True) -> dict:
    """Read a reference ``.ckpt`` file and convert it into a parameter tree: the schema
    migrations of the variant, the history size, the conversion and (``strict``) the
    validation, as reference ``Aurora.load_checkpoint_local`` (aurora.py:432-456)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in raw.items()}
    return convert_reference_checkpoint(sd, cfg, dtype=dtype, strict=strict)


def load_checkpoint(model, repo=None, name=None, revision=None, dtype=np.float32,
                    strict: bool = True) -> dict:
    """Download a released checkpoint from the Hugging Face hub and convert it.

    The per-variant default (repo, file, pinned revision) comes from the model's class, as
    reference ``Aurora.load_checkpoint`` (aurora.py:409-430). Needs the ``huggingface_hub``
    package and, on first use, the network.
    """
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise ImportError(
            "load_checkpoint downloads from the Hugging Face hub and needs the "
            "`huggingface_hub` package; load a file already on disk with "
            "load_torch_checkpoint or Aurora.load_checkpoint_local instead."
        ) from e

    path = hf_hub_download(
        repo_id=repo or getattr(model, "default_checkpoint_repo", "microsoft/aurora"),
        filename=name or model.default_checkpoint_name,
        revision=revision or model.default_checkpoint_revision,
    )
    return load_torch_checkpoint(path, model.cfg, dtype=dtype, strict=strict)


def save_params(model: torch.nn.Module, path) -> None:
    """Save a model's parameters (its ``state_dict``) with ``torch.save``."""
    torch.save(model.state_dict(), path)


def restore_params(path, like: torch.nn.Module | None = None):
    """Read parameters saved by :func:`save_params`. With ``like``, load them into that model
    (on its device, in its dtypes) and return it; otherwise return the state dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if like is None:
        return sd
    like.load_state_dict(sd)
    return like


def save_train_state(path, model: torch.nn.Module, optimizer, step: int = 0) -> None:
    """Save a training state, the model's and the optimiser's state dicts and the step, with
    ``torch.save`` (the counterpart of ``aurora_tpu/checkpoint.py:497-536``, whose Orbax
    format is not carried over). ``optimizer``: the bound optimiser of
    :func:`aurora_tpu_torch.training.adamw` (AdamW moments, the accumulated gradient of a
    ``MultiSteps`` cycle and its count), or any object with ``state_dict``."""
    torch.save({"params": model.state_dict(), "opt_state": optimizer.state_dict(),
                "step": int(step)}, path)


def restore_train_state(path, model: torch.nn.Module, optimizer) -> int:
    """Load a state saved by :func:`save_train_state` into ``model`` and ``optimizer`` (built
    as for the save, the optimiser bound to the model); returns the step. The tensors land on
    the model's device, in its dtypes."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["params"])
    optimizer.load_state_dict(state["opt_state"])
    return int(state["step"])
