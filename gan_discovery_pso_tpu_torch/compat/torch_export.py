"""Export the pipelines' msgpack checkpoints as reference PyTorch state dicts
(counterpart of `gan_discovery_pso_tpu/compat/torch_export.py`).

A thin layer over `compat/weights.py`: `core/checkpoint.py load_pytree` →
(params, state) → the `*_state_dict` functions → `torch.save`. The state
dicts carry the reference's names, so the reference's nets load them with
`load_state_dict(strict=True)`. Sources are the `{params, state}` saves
(CAE encoder/decoder, cnn `model_*`, inverter `encoder`) and the GAN
checkpoints `{epoch, state: GanTrainState, loss}` (`best_g`,
`checkpoint_g`: `model` picks the generator or the discriminator, and the
epoch and loss come from the file). A `.tar` destination holds the
reference's `{'epoch', 'model_state_dict', 'loss'}`, any other the bare
state dict. Tensors are fp32 on the CPU, the BN counters int64.
"""

from __future__ import annotations

from pathlib import Path

import torch

from gan_discovery_pso_tpu_torch.compat import weights as W

_EXPORTERS = {
    "generator": W.generator_state_dict,
    "discriminator": lambda params, state: W.discriminator_state_dict(params),
    "encoder": lambda params, state: W.encoder_state_dict(params),
    "cae_encoder": W.cae_encoder_state_dict,
    "cae_decoder": W.cae_decoder_state_dict,
    "resnet50": W.resnet_state_dict,
    "resnet101": W.resnet_state_dict,
    "resnet152": W.resnet_state_dict,
}
MODELS = tuple(sorted(_EXPORTERS))


def _read(src: str | Path, model: str, epoch: int, loss: float) -> tuple:
    """(params, state, epoch, loss) of a msgpack checkpoint."""
    from gan_discovery_pso_tpu_torch.core.checkpoint import load_pytree, restore_tree

    d = restore_tree(load_pytree(src))
    st = d.get("state", {})
    if not (isinstance(st, dict) and "gen_params" in st):
        return d["params"], st or {}, epoch, loss
    # a GAN train state
    epoch = int(d.get("epoch", epoch) or 0)
    if d.get("loss") is not None:
        loss = float(d["loss"])
    if model == "generator":
        return st["gen_params"], st["gen_state"], epoch, loss
    if model == "discriminator":
        return st["disc_params"], {}, epoch, loss
    raise ValueError(f"{src} is a GAN checkpoint; model must be 'generator' or "
                     f"'discriminator', not {model!r}")


def export_torch_checkpoint(src: "str | Path | tuple", model: str, dst: str | Path,
                            epoch: int = 0, loss: float = 0.0) -> Path:
    """Write `model`'s reference state dict from `src` (a msgpack path or a
    (params, state) pair) to `dst` (see the module docstring)."""
    if model not in _EXPORTERS:
        raise ValueError(f"unknown model {model!r}; choose from {list(MODELS)}")
    if isinstance(src, (str, Path)):
        params, state, epoch, loss = _read(src, model, epoch, loss)
    else:
        params, state = src
    try:
        sd = W.to_tensors(_EXPORTERS[model](params, state))
    except KeyError as e:
        raise KeyError(f"checkpoint is missing expected entry {e} for model {model!r} — is "
                       f"this really a {model} checkpoint of this package?") from e
    dst = Path(dst)
    dst.parent.mkdir(parents=True, exist_ok=True)
    if dst.suffix == ".tar":
        torch.save({"epoch": int(epoch), "model_state_dict": sd, "loss": float(loss)}, dst)
    else:
        torch.save(sd, dst)
    return dst
