"""Model loaders of the pipeline stages (counterpart of
`gan_discovery_pso_tpu/pipelines/stages.py`: `load_gan` :463,
`assessor_factory` :481, `load_cnn` :610).

They read the flax-msgpack checkpoints the JAX package's `dcgan` and
`cnn-multipatient` stages write (`core/checkpoint.py`) and return the port's
`nn.Module`s, in eval mode, on the requested device (the card unless the
caller names another), built through `compat/weights.py`. The training
stages themselves are later slices (ROADMAP A9, A10).
"""

from __future__ import annotations

from pathlib import Path

from gan_discovery_pso_tpu_torch.compat.weights import (
    generator_state_dict,
    resnet_state_dict,
    to_tensors,
)
from gan_discovery_pso_tpu_torch.core.checkpoint import load_pytree, restore_tree
from gan_discovery_pso_tpu_torch.core.device import resolve_device
from gan_discovery_pso_tpu_torch.models import Generator, GeneratorDef, ResNet, ResNetDef


def load_gan(model_dir: str | Path, best: bool = True, device=None) -> Generator:
    """The generator of a dcgan run (`best_g.msgpack`, or `checkpoint_g` with
    best=False: {'epoch', 'state': {'gen_params', 'gen_state', ...},
    'loss'}); its widths come from the checkpoint's shapes."""
    device = resolve_device(device)
    name = "best_g.msgpack" if best else "checkpoint_g.msgpack"
    state = restore_tree(load_pytree(Path(model_dir) / name)["state"])
    params = state["gen_params"]
    z_dim, f2 = params["convt1"]["w"].shape[:2]
    f, channels = params["convt3"]["w"].shape[:2]
    if f2 != 2 * f:
        raise ValueError(f"{model_dir}/{name}: convt1 has {f2} output channels, "
                         f"not twice convt3's {f} inputs — not a DCGAN generator")
    gen = Generator(GeneratorDef(int(z_dim), int(channels), int(f)), device=device)
    gen.load_state_dict(to_tensors(generator_state_dict(params, state["gen_state"]),
                                   device=device), strict=True)
    return gen.eval()


def assessor_factory(cfg, data_cfg, n_class: int):
    """The reference get_cnn (util_cnn.py:24-38): (ResNetDef, None, None) for
    ResNet50/101/152, the triple the JAX package returns."""
    name = str(cfg.model_cnn.model_name)
    iid = tuple(data_cfg.iid_classes)
    if name.startswith("ResNet"):
        return ResNetDef(name, data_cfg.channel, n_class, iid), None, None
    if name == "AlexNet":
        raise NotImplementedError(
            "AlexNet assessors are not ported yet (ROADMAP A3: models)")
    raise ValueError(name)


def load_cnn(model_dir: str | Path, rdef: ResNetDef, label=None, device=None) -> ResNet:
    """The assessor of a cnn-multipatient run (`model.msgpack`, or
    `model_{label}.msgpack` of a cnn run: {'params', 'state'})."""
    device = resolve_device(device)
    name = f"model_{label}.msgpack" if label is not None else "model.msgpack"
    d = load_pytree(Path(model_dir) / name)
    params, state = restore_tree(d["params"]), restore_tree(d["state"])
    # the checkpoint's keys reveal the family it was trained as; a mismatch
    # would otherwise surface as a missing key deep in the weight mapping
    looks_resnet = "bn1" in params and "layer1" in params
    looks_alexnet = "fc1" in params and "conv4" in params
    want_resnet = type(rdef).__name__ == "ResNetDef"
    if want_resnet and looks_alexnet:
        raise ValueError(
            f"{model_dir}/{name} is an AlexNet checkpoint but the config "
            "resolves a ResNet assessor — set model_cnn.model_name=AlexNet "
            "(and its network block) for THIS stage too, not only for "
            "cnn/cnn-multipatient"
        )
    if not want_resnet and looks_resnet:
        raise ValueError(
            f"{model_dir}/{name} is a ResNet checkpoint but the config "
            "resolves an AlexNet assessor — drop model_cnn.model_name="
            "AlexNet for this stage or point --path-cnn at an AlexNet run"
        )
    net = ResNet(rdef, device=device)
    net.load_state_dict(to_tensors(resnet_state_dict(params, state), device=device),
                        strict=True)
    return net.eval()
