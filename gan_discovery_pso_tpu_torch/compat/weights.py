"""Carry weights into the port's modules.

The port's own counterpart of `gan_discovery_pso_tpu/compat/torch_export.py:
32-128` (it imports nothing of the JAX package). The JAX package's parameter
trees already hold torch layouts (conv OIHW, transposed conv IOHW, linear
(out, in)), so values copy verbatim and only the names change to the
reference's state-dict names, which the port's modules carry:

    tree = jax params/state (nested dicts; leaves are arrays of any kind
           np.asarray accepts, BN stats as an object with .mean/.var, a dict
           or a (mean, var) pair)
    generator_state_dict(params, state) / resnet_state_dict(params, state) /
    encoder_state_dict(params) / discriminator_state_dict(params) /
    encoder_attgan_state_dict(params, state) / alexnet_state_dict(params) /
    cae_encoder_state_dict(params, state) / cae_decoder_state_dict(params, state) /
    vqvae_state_dict(params, state, variant) / pixelcnn_state_dict(params)
        → {name: np.ndarray}
    to_tensors(...) → {name: torch.Tensor}, ready for
        module.load_state_dict(..., strict=True)

and back (counterpart of `compat/torch_import.py:54,121`):

    generator_tree(state_dict) / resnet_tree(state_dict)
        → (params, state) numpy trees in the JAX layout, BN stats as
          `{mean, var}` dicts and every dict's keys sorted, the form a JAX
          run's checkpoint holds (`core/checkpoint.py` writes it);
    encoder_tree(state_dict) / discriminator_tree(state_dict) /
    alexnet_tree(state_dict) → params (none of them has state);
    encoder_attgan_tree(state_dict) / cae_encoder_tree(state_dict) /
    cae_decoder_tree(state_dict) / vqvae_tree(state_dict, variant)
        → (params, state); pixelcnn_tree(state_dict) → params;
    gan_train_state_tree(G, D, opt_g, opt_d, step) → the JAX package's
        `GanTrainState` (params, BN state, optax Adam/RMSprop states, step),
        and `load_gan_train_state` back; `optimizer_tree` /
        `load_optimizer_tree` map torch's Adam and RMSprop states (exp_avg,
        exp_avg_sq, square_avg, step) to optax's (mu, nu, count)

AlexNet, the VQ-VAEs and the PixelCNN have no reference name map in the
JAX package: their state-dict names are the JAX trees' paths (`conv1`…
`fc3`; `encoder.conv1`, `codebook`, `enc_res1.bn2`; `layers.0.vert`). The CAE's are the
reference's (JAX `compat/torch_export.py:89-110`).

`load_reference_checkpoint` reads the reference's `.tar`
(`{'epoch', 'model_state_dict', 'loss'}`) and bare `.pt` state dicts.
`cluster_model_from_sklearn` turns a fitted sklearn `KMeans` or
`GaussianMixture` (a JAX run's `{algorithm}.pkl`) into the port's model.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _bn_stats(st):
    """(running_mean, running_var) from a stats object or its plain forms."""
    if hasattr(st, "mean"):
        return _np(st.mean), _np(st.var)
    if isinstance(st, dict):
        return _np(st["mean"]), _np(st["var"])
    m, v = st
    return _np(m), _np(v)


def _put_conv(sd: dict, prefix: str, p: dict):
    sd[f"{prefix}.weight"] = _np(p["w"])
    if "b" in p:
        sd[f"{prefix}.bias"] = _np(p["b"])


def _put_bn(sd: dict, prefix: str, p: dict, st):
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])
    if st is None:  # the parameters alone (an optimizer's moments)
        return
    sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"] = _bn_stats(st)
    # strict load_state_dict wants the counter torch BN modules carry
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def generator_state_dict(params: dict, state: dict | None) -> dict:
    """DCGAN generator tree → `Generator` state dict (`gen.*` names); with
    state None, the parameter entries alone."""
    sd: dict = {}
    _put_conv(sd, "gen.0.0", params["convt1"])
    _put_bn(sd, "gen.0.1", params["bn1"], None if state is None else state["bn1"])
    _put_conv(sd, "gen.1.0", params["convt2"])
    _put_bn(sd, "gen.1.1", params["bn2"], None if state is None else state["bn2"])
    _put_conv(sd, "gen.2", params["convt3"])
    return sd


def encoder_state_dict(params: dict) -> dict:
    """Plain encoder params → `Encoder` state dict (`enc.*` names, JAX
    `compat/torch_export.py:81-87`)."""
    sd: dict = {}
    _put_conv(sd, "enc.0", params["conv1"])
    _put_conv(sd, "enc.2.0", params["conv2"])
    _put_conv(sd, "enc.3", params["conv3"])
    return sd


def discriminator_state_dict(params: dict) -> dict:
    """DCGAN discriminator params → `Discriminator` state dict (`disc.*`
    names, JAX `compat/torch_export.py:73-77`)."""
    sd: dict = {}
    _put_conv(sd, "disc.0", params["conv1"])
    _put_conv(sd, "disc.2.0", params["conv2"])
    _put_conv(sd, "disc.3", params["conv3"])
    return sd


def encoder_attgan_state_dict(params: dict, state: dict) -> dict:
    """AttGAN encoder (params, state) → `EncoderAttGAN` state dict
    (`enc_layers.{i}.layers.0` conv, `.1` BN with its running stats)."""
    sd: dict = {}
    i = 0
    while f"conv{i}" in params:
        _put_conv(sd, f"enc_layers.{i}.layers.0", params[f"conv{i}"])
        _put_bn(sd, f"enc_layers.{i}.layers.1", params[f"bn{i}"], state[f"bn{i}"])
        i += 1
    return sd


def resnet_state_dict(params: dict, state: dict) -> dict:
    """ResNet-50/101/152 tree → `ResNet` state dict."""
    sd: dict = {}
    _put_conv(sd, "conv1", params["conv1"])
    _put_bn(sd, "bn1", params["bn1"], state["bn1"])
    li = 1
    while f"layer{li}" in params:
        for bi, (bp, bs) in enumerate(zip(params[f"layer{li}"], state[f"layer{li}"])):
            pfx = f"layer{li}.{bi}"
            for ci in (1, 2, 3):
                _put_conv(sd, f"{pfx}.conv{ci}", bp[f"conv{ci}"])
                _put_bn(sd, f"{pfx}.bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
            if "ds_conv" in bp:
                _put_conv(sd, f"{pfx}.identity_downsample.0", bp["ds_conv"])
                _put_bn(sd, f"{pfx}.identity_downsample.1", bp["ds_bn"], bs["ds_bn"])
        li += 1
    sd["fc.weight"] = _np(params["fc"]["w"])
    sd["fc.bias"] = _np(params["fc"]["b"])
    return sd


_ALEXNET_LAYERS = ("conv1", "conv2", "conv3", "conv4", "fc1", "fc2", "fc3")
# (JAX tree key, state-dict prefix) of the CAE's convs and linears, and of
# its BNs
_CAE_ENCODER = ((("conv1", "encoder_cnn.0"), ("conv2", "encoder_cnn.2"),
                 ("conv3", "encoder_cnn.5"), ("fc1", "encoder_linear.0"),
                 ("fc2", "encoder_linear.2")), (("bn2", "encoder_cnn.3"),))
_CAE_DECODER = ((("fc1", "decoder_linear.0"), ("fc2", "decoder_linear.2"),
                 ("convt1", "decoder_conv.0"), ("convt2", "decoder_conv.3"),
                 ("convt3", "decoder_conv.6")),
                (("bn1", "decoder_conv.1"), ("bn2", "decoder_conv.4")))


def alexnet_state_dict(params: dict) -> dict:
    """AlexNet params → `AlexNet` state dict (the JAX tree's names)."""
    sd: dict = {}
    for name in _ALEXNET_LAYERS:
        _put_conv(sd, name, params[name])
    return sd


def _cae_state_dict(layout, params: dict, state: dict) -> dict:
    layers, bns = layout
    sd: dict = {}
    for key, prefix in layers:
        _put_conv(sd, prefix, params[key])
    for key, prefix in bns:
        _put_bn(sd, prefix, params[key], state[key])
    return sd


def cae_encoder_state_dict(params: dict, state: dict) -> dict:
    """CAE encoder (params, state) → `CAEEncoder` state dict."""
    return _cae_state_dict(_CAE_ENCODER, params, state)


def cae_decoder_state_dict(params: dict, state: dict) -> dict:
    """CAE decoder (params, state) → `CAEDecoder` state dict."""
    return _cae_state_dict(_CAE_DECODER, params, state)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _conv_tree(sd: dict, prefix: str) -> dict:
    p = {"w": _host(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["b"] = _host(sd[f"{prefix}.bias"])
    return p


def _bn_tree(sd: dict, prefix: str) -> tuple[dict, dict]:
    return ({"bias": _host(sd[f"{prefix}.bias"]), "scale": _host(sd[f"{prefix}.weight"])},
            {"mean": _host(sd[f"{prefix}.running_mean"]),
             "var": _host(sd[f"{prefix}.running_var"])})


def _sorted(node):
    """Dict keys in sorted order, as a tree that passed through jax.jit has
    them (a JAX run's checkpoints)."""
    if isinstance(node, dict):
        return {k: _sorted(node[k]) for k in sorted(node)}
    if isinstance(node, list):
        return [_sorted(v) for v in node]
    return node


def _bn_params(sd: dict, prefix: str) -> dict:
    return {"bias": _host(sd[f"{prefix}.bias"]), "scale": _host(sd[f"{prefix}.weight"])}


def generator_params_tree(sd: dict) -> dict:
    """The parameter entries of a `Generator` state dict (or any {name:
    tensor} over its parameter names, such as Adam's moments) → the JAX
    package's generator params."""
    return _sorted({"convt1": _conv_tree(sd, "gen.0.0"), "bn1": _bn_params(sd, "gen.0.1"),
                    "convt2": _conv_tree(sd, "gen.1.0"), "bn2": _bn_params(sd, "gen.1.1"),
                    "convt3": _conv_tree(sd, "gen.2")})


def generator_tree(sd: dict) -> tuple[dict, dict]:
    """`Generator` state dict → the JAX package's generator (params, state)."""
    _, s1 = _bn_tree(sd, "gen.0.1")
    _, s2 = _bn_tree(sd, "gen.1.1")
    return generator_params_tree(sd), _sorted({"bn1": s1, "bn2": s2})


def encoder_tree(sd: dict) -> dict:
    """`Encoder` state dict → the JAX package's plain-encoder params."""
    return _sorted({"conv1": _conv_tree(sd, "enc.0"), "conv2": _conv_tree(sd, "enc.2.0"),
                    "conv3": _conv_tree(sd, "enc.3")})


def discriminator_tree(sd: dict) -> dict:
    """`Discriminator` state dict → the JAX package's discriminator params."""
    return _sorted({"conv1": _conv_tree(sd, "disc.0"), "conv2": _conv_tree(sd, "disc.2.0"),
                    "conv3": _conv_tree(sd, "disc.3")})


def encoder_attgan_tree(sd: dict) -> tuple[dict, dict]:
    """`EncoderAttGAN` state dict → the JAX package's AttGAN (params, state)."""
    params, state = {}, {}
    i = 0
    while f"enc_layers.{i}.layers.0.weight" in sd:
        params[f"conv{i}"] = _conv_tree(sd, f"enc_layers.{i}.layers.0")
        params[f"bn{i}"], state[f"bn{i}"] = _bn_tree(sd, f"enc_layers.{i}.layers.1")
        i += 1
    return _sorted(params), _sorted(state)


def alexnet_tree(sd: dict) -> dict:
    """`AlexNet` state dict → the JAX package's AlexNet params."""
    return _sorted({name: _conv_tree(sd, name) for name in _ALEXNET_LAYERS})


def _cae_tree(layout, sd: dict) -> tuple[dict, dict]:
    layers, bns = layout
    params = {key: _conv_tree(sd, prefix) for key, prefix in layers}
    state = {}
    for key, prefix in bns:
        params[key], state[key] = _bn_tree(sd, prefix)
    return _sorted(params), _sorted(state)


def cae_encoder_tree(sd: dict) -> tuple[dict, dict]:
    """`CAEEncoder` state dict → the JAX package's CAE encoder (params, state)."""
    return _cae_tree(_CAE_ENCODER, sd)


def cae_decoder_tree(sd: dict) -> tuple[dict, dict]:
    """`CAEDecoder` state dict → the JAX package's CAE decoder (params, state)."""
    return _cae_tree(_CAE_DECODER, sd)


def resnet_tree(sd: dict) -> tuple[dict, dict]:
    """`ResNet` state dict → the JAX package's ResNet (params, state)."""
    params, state = {"conv1": _conv_tree(sd, "conv1")}, {}
    params["bn1"], state["bn1"] = _bn_tree(sd, "bn1")
    li = 1
    while f"layer{li}.0.conv1.weight" in sd:
        blocks, bstates = [], []
        bi = 0
        while f"layer{li}.{bi}.conv1.weight" in sd:
            pfx = f"layer{li}.{bi}"
            bp, bs = {}, {}
            for ci in (1, 2, 3):
                bp[f"conv{ci}"] = _conv_tree(sd, f"{pfx}.conv{ci}")
                bp[f"bn{ci}"], bs[f"bn{ci}"] = _bn_tree(sd, f"{pfx}.bn{ci}")
            if f"{pfx}.identity_downsample.0.weight" in sd:
                bp["ds_conv"] = _conv_tree(sd, f"{pfx}.identity_downsample.0")
                bp["ds_bn"], bs["ds_bn"] = _bn_tree(sd, f"{pfx}.identity_downsample.1")
            blocks.append(bp)
            bstates.append(bs)
            bi += 1
        params[f"layer{li}"], state[f"layer{li}"] = blocks, bstates
        li += 1
    params["fc"] = {"b": _host(sd["fc.bias"]), "w": _host(sd["fc.weight"])}
    return _sorted(params), _sorted(state)


# -- the VQ-VAE family and the PixelCNN prior ------------------------------------
# (conv paths, BN paths, plain leaves) of each variant: a module path is its
# JAX tree path, dotted


_VQ_RES = tuple(f"{side}_res{i}" for side in ("enc", "dec") for i in (1, 2))
_VQVAE_LAYOUTS = {
    "vqvae_dcgan": (("encoder.conv1", "encoder.conv2", "encoder.conv3"), ("encoder.bn2",),
                    ("codebook",)),
    "vqvae": (("enc_conv1", "enc_conv2", *(f"{r}.conv{j}" for r in _VQ_RES for j in (1, 2)),
               "dec_convt1", "dec_convt2"),
              ("enc_bn1", *(f"{r}.bn{j}" for r in _VQ_RES for j in (1, 2)), "dec_bn1"),
              ("codebook",)),
    "vqvae_mnist": (("enc_conv1", "enc_conv2", "enc_conv3", "dec_convt1", "dec_convt2",
                     "dec_convt3"), (), ("codebook",)),
}


def _at(tree: dict, path: str):
    for key in path.split("."):
        tree = tree[key]
    return tree


def _put(tree: dict, path: str, value) -> None:
    *head, last = path.split(".")
    for key in head:
        tree = tree.setdefault(key, {})
    tree[last] = value


def vqvae_state_dict(params: dict, state: dict, variant: str = "vqvae_dcgan") -> dict:
    """A VQ-VAE tree of the JAX package's `variant` → the port's module state
    dict (`VQVAEGan`, `VQVAE` or `VQVAEMnist`); vqvae_dcgan's decoder under
    `decoder.` with the Generator's names."""
    convs, bns, leaves = _VQVAE_LAYOUTS[variant]
    sd: dict = {}
    for path in convs:
        _put_conv(sd, path, _at(params, path))
    for path in bns:
        _put_bn(sd, path, _at(params, path), _at(state, path))
    for path in leaves:
        sd[path] = _np(_at(params, path))
    if variant == "vqvae_dcgan":
        sd.update({f"decoder.{k}": v for k, v in
                   generator_state_dict(params["decoder"], state["decoder"]).items()})
    return sd


def vqvae_tree(sd: dict, variant: str = "vqvae_dcgan") -> tuple[dict, dict]:
    """The port's VQ-VAE state dict → the JAX package's (params, state) of
    `variant`."""
    convs, bns, leaves = _VQVAE_LAYOUTS[variant]
    params, state = {}, {}
    for path in convs:
        _put(params, path, _conv_tree(sd, path))
    for path in bns:
        p, st = _bn_tree(sd, path)
        _put(params, path, p)
        _put(state, path, st)
    for path in leaves:
        _put(params, path, _host(sd[path]))
    if variant == "vqvae_dcgan":
        params["decoder"], state["decoder"] = generator_tree(
            {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")})
    return _sorted(params), _sorted(state)


_PIXEL_CONVS = ("vert", "v2h", "horiz", "h_res")


def pixelcnn_state_dict(params: dict) -> dict:
    """The JAX package's PixelCNN params → `PixelCNN` state dict."""
    sd = {"embedding": _np(params["embedding"])}
    for i, lp in enumerate(params["layers"]):
        sd[f"layers.{i}.class_embed"] = _np(lp["class_embed"])
        for name in _PIXEL_CONVS:
            _put_conv(sd, f"layers.{i}.{name}", lp[name])
    _put_conv(sd, "out1", params["out1"])
    _put_conv(sd, "out2", params["out2"])
    return sd


def pixelcnn_tree(sd: dict) -> dict:
    """`PixelCNN` state dict → the JAX package's PixelCNN params."""
    layers = []
    while f"layers.{len(layers)}.class_embed" in sd:
        i = len(layers)
        layers.append({"class_embed": _host(sd[f"layers.{i}.class_embed"]),
                       **{name: _conv_tree(sd, f"layers.{i}.{name}") for name in _PIXEL_CONVS}})
    return _sorted({"embedding": _host(sd["embedding"]), "layers": layers,
                    "out1": _conv_tree(sd, "out1"), "out2": _conv_tree(sd, "out2")})


# -- optimizer state and the GAN train state ------------------------------------


def _copy(t) -> np.ndarray:
    # a copy: on the CPU a tensor's numpy view aliases what the optimizer
    # updates in place
    return np.array(_host(t), copy=True)


def optimizer_tree(opt: torch.optim.Optimizer, named_params, to_tree, step: int) -> list:
    """An Adam or RMSprop optimizer's state over `named_params` ((name,
    parameter) pairs, the order of its one param group) as the optax state
    the JAX package's `make_optimizer` builds, `_plainify`d:

        Adam:    [{count, mu, nu}, {}]     (scale_by_adam, scale_by_learning_rate)
        RMSprop: [{nu}, {}]                (scale_by_rms, scale)

    each inside `[{}, ...]` (add_decayed_weights first) where the group has
    a weight decay. `to_tree` maps {parameter name: array} to the JAX params
    tree; `count` is torch's step (`step` where the optimizer has not
    stepped yet)."""
    group = opt.param_groups[0]
    moments = ("exp_avg", "exp_avg_sq") if isinstance(opt, torch.optim.Adam) else ("square_avg",)
    trees = []
    for key in moments:
        trees.append(to_tree({name: _copy(opt.state[p][key]) if opt.state.get(p)
                              else np.zeros(tuple(p.shape), np.float32)
                              for name, p in named_params}))
    first = opt.state.get(named_params[0][1])
    count = int(first["step"]) if first else step
    if len(trees) == 2:
        inner = {"count": np.asarray(count, np.int32), "mu": trees[0], "nu": trees[1]}
    else:
        inner = {"nu": trees[0]}
    chain = [inner, {}]
    return [{}, chain] if group["weight_decay"] else chain


def load_optimizer_tree(opt: torch.optim.Optimizer, named_params, tree: list, to_sd,
                        step: int) -> None:
    """The inverse of `optimizer_tree`: the optax state `tree` into `opt`
    (`to_sd` maps the JAX params tree to {parameter name: array}). A count
    of 0 leaves the optimizer fresh, as torch starts one."""
    chain = tree[1] if opt.param_groups[0]["weight_decay"] else tree
    inner = chain[0]
    adam = isinstance(opt, torch.optim.Adam)
    count = int(inner["count"]) if adam else step
    if count == 0:
        return
    keys = (("exp_avg", "mu"), ("exp_avg_sq", "nu")) if adam else (("square_avg", "nu"),)
    moments = {key: to_sd(inner[src]) for key, src in keys}
    sd = opt.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(count), dtype=torch.float32),
                       **{key: torch.from_numpy(np.array(m[name], np.float32))
                          for key, m in moments.items()}}
                   for i, (name, _p) in enumerate(named_params)}
    opt.load_state_dict(sd)


def _gen_moments_sd(params: dict) -> dict:
    return generator_state_dict(params, None)


def gan_train_state_tree(gen: nn.Module, disc: nn.Module, opt_g, opt_d, step: int) -> dict:
    """The DCGAN's train state as the JAX package's `GanTrainState`
    (`train/dcgan.py:45`) in a checkpoint: {disc_params, gen_params,
    gen_state, opt_d, opt_g, step}, every array a host copy."""
    gen_params, gen_state = generator_tree({k: _copy(v) for k, v in gen.state_dict().items()})
    return {"disc_params": discriminator_tree({k: _copy(v) for k, v in
                                               disc.state_dict().items()}),
            "gen_params": gen_params, "gen_state": gen_state,
            "opt_d": optimizer_tree(opt_d, list(disc.named_parameters()), discriminator_tree,
                                    step),
            "opt_g": optimizer_tree(opt_g, list(gen.named_parameters()), generator_params_tree,
                                    step),
            "step": np.asarray(step, np.int32)}


def load_gan_train_state(tree: dict, gen: nn.Module, disc: nn.Module, opt_g, opt_d) -> int:
    """A `GanTrainState` tree (either package's `checkpoint_g`/`best_g`
    `state`) into the modules and optimizers, in place; returns its step.
    The BN counters `num_batches_tracked` restart at 0 (the JAX state has
    none; with a momentum, torch never reads them)."""
    step = int(tree["step"])
    device = next(gen.parameters()).device
    gen.load_state_dict(to_tensors(generator_state_dict(tree["gen_params"], tree["gen_state"]),
                                   device=device), strict=True)
    disc.load_state_dict(to_tensors(discriminator_state_dict(tree["disc_params"]),
                                    device=device), strict=True)
    load_optimizer_tree(opt_g, list(gen.named_parameters()), tree["opt_g"], _gen_moments_sd,
                        step)
    load_optimizer_tree(opt_d, list(disc.named_parameters()), tree["opt_d"],
                        discriminator_state_dict, step)
    return step


def to_tensors(sd: dict, device=None) -> dict:
    """{name: array} → {name: tensor}: fp32, the BN counters int64."""
    return {k: torch.as_tensor(np.ascontiguousarray(
                v if v.dtype == np.int64 else v.astype(np.float32)), device=device)
            for k, v in sd.items()}


def load_reference_checkpoint(path: str | Path, map_location="cpu") -> dict:
    """State dict from a reference `.tar` ({'model_state_dict': ...}) or a
    bare `.pt` state dict."""
    obj = torch.load(path, map_location=map_location, weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        return obj["model_state_dict"]
    return obj


def cluster_model_from_sklearn(model, device=None):
    """A fitted sklearn `KMeans` (its `cluster_centers_`) or full-covariance
    `GaussianMixture` (`weights_`, `means_`, `covariances_`,
    `precisions_cholesky_`) → the port's `analysis.cluster` model, whose
    `predict` gives sklearn's labels. Read by attribute: sklearn need not
    be installed where the port runs."""
    from gan_discovery_pso_tpu_torch.analysis.cluster import GaussianMixture, KMeans

    if hasattr(model, "cluster_centers_"):
        out = KMeans(len(model.cluster_centers_), device=device)
        out.cluster_centers_ = np.asarray(model.cluster_centers_, np.float64)
        for name in ("labels_", "inertia_", "n_iter_"):
            setattr(out, name, getattr(model, name, None))
        return out
    if getattr(model, "covariance_type", "full") != "full" or not hasattr(
            model, "precisions_cholesky_"):
        raise ValueError(f"{type(model).__name__}: a fitted KMeans or full-covariance "
                         "GaussianMixture is needed")
    out = GaussianMixture(len(model.weights_), device=device)
    for name in ("weights_", "means_", "covariances_", "precisions_cholesky_"):
        setattr(out, name, np.asarray(getattr(model, name), np.float64))
    for name in ("converged_", "n_iter_", "lower_bound_"):
        setattr(out, name, getattr(model, name, None))
    return out
