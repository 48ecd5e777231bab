"""The pso-inverter's swarm for one patient: the encoder over the patient's
slices gives the swarm's initial positions, then `make_inverter_runner`'s
call with the hybrid fitness, as the pso-inverter stage's phase 2 makes
them."""

from __future__ import annotations

import torch

from gan_discovery_pso_tpu_torch.models import (
    Encoder, EncoderDef, Generator, GeneratorDef, ResNet, ResNetDef)
from gan_discovery_pso_tpu_torch.ops import fp32_parity
from gan_discovery_pso_tpu_torch.pso import make_inverter_runner, state_from_positions
from port_bench.entries import common


class Entry:
    def __init__(self, cfg: dict, state_dicts: dict, device, precision: str):
        img, z = cfg["image"], cfg["gan"]["z_dim"]
        self.gen = common.load(Generator(
            GeneratorDef(z, img["channels"], cfg["gan"]["features_g"]), device="meta"),
            state_dicts["gen"], device)
        a = cfg["assessor"]
        self.cnn = common.load(ResNet(
            ResNetDef(a["model_name"], img["channels"], a["n_class"]), device="meta"),
            state_dicts["assessor"], device)
        self.enc = common.load(Encoder(
            EncoderDef(z, img["channels"], cfg["encoder"]["features_e"]), device="meta"),
            state_dicts["encoder"], device)
        self.hp = common.pso_config(cfg)
        dtype, self.context = common.precision(precision)
        f = cfg["fitness"]
        self.run = make_inverter_runner(
            self.hp, control=f["control"], threshold=f["threshold"], eps=f["eps"],
            w_ass=f["w_ass"], w_rec=f["w_rec"], dtype=dtype, device=device)

    def call(self, inputs: dict, record: dict | None = None) -> dict:
        src = inputs["source"]
        with common.capture(record, gen=self.gen, assessor=self.cnn), self.context():
            # the stage's `_encode`: the encoder in fp32 parity
            with fp32_parity(), torch.inference_mode():
                latents = self.enc(src).reshape(src.shape[0], -1)
            init = state_from_positions(latents[None], inputs["velocities"], self.hp.w_inertia)
            final, history, _ = self.run(self.gen, self.cnn, inputs["class_idx"], src, None,
                                         init_state=init, r1=inputs["r1"], r2=inputs["r2"])
        if record is not None:
            record["encoder_out"] = latents
        return common.to_host(final, history)
