"""Import reference PyTorch checkpoints as the pipelines' msgpack saves
(counterpart of `gan_discovery_pso_tpu/compat/torch_import.py`).

A thin layer over `compat/weights.py`: the reference checkpoint's state
dict (`.tar` `{'epoch', 'model_state_dict', 'loss'}` or a bare `.pt`,
`load_reference_checkpoint`) → the JAX package's (params, state) trees
(the `*_tree` functions) → `{'params', 'state'}` through `core/checkpoint.py
save_pytree`, byte-equal to the JAX package's `convert_torch_checkpoint`
output. Either package's loaders read the file.
"""

from __future__ import annotations

from pathlib import Path

from gan_discovery_pso_tpu_torch.compat import weights as W

_RESNET_LAYERS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                  "resnet152": (3, 8, 36, 3)}


def _stateless(tree_fn):
    return lambda sd: (tree_fn(sd), {})


_IMPORTERS = {
    "generator": W.generator_tree,
    "discriminator": _stateless(W.discriminator_tree),
    "encoder": _stateless(W.encoder_tree),
    "cae_encoder": W.cae_encoder_tree,
    "cae_decoder": W.cae_decoder_tree,
    **{name: (lambda sd, layers=layers: W.resnet_tree(sd, layers))
       for name, layers in _RESNET_LAYERS.items()},
}
MODELS = tuple(sorted(_IMPORTERS))


def convert_torch_checkpoint(src: str | Path, model: str, dst: str | Path | None = None):
    """A reference checkpoint of `model` (one of MODELS) as (params, state)
    numpy trees in the JAX layout; with `dst`, also written there as
    `{'params', 'state'}`."""
    if model not in _IMPORTERS:
        raise ValueError(f"unknown model {model!r}; choose from {list(MODELS)}")
    sd = W.load_reference_checkpoint(src)
    try:
        params, state = _IMPORTERS[model](sd)
    except KeyError as e:
        raise KeyError(f"state dict at {src} is missing expected key {e} for model {model!r} "
                       f"— is this really a reference {model} checkpoint?") from e
    if dst is not None:
        from gan_discovery_pso_tpu_torch.core.checkpoint import save_pytree

        save_pytree(dst, {"params": params, "state": state})
    return params, state
