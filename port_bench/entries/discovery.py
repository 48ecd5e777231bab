"""The discovery sweep: `make_batched_discovery_runner`, called once a call
with every swarm of the call (the batched stage's call with
--batch-classes; the sequential stage's call with one class)."""

from __future__ import annotations

from gan_discovery_pso_tpu_torch.models import Generator, GeneratorDef, ResNet, ResNetDef
from gan_discovery_pso_tpu_torch.pso import make_batched_discovery_runner, state_from_positions
from port_bench.entries import common

class Entry:
    def __init__(self, cfg: dict, state_dicts: dict, device, precision: str):
        img = cfg["image"]
        self.gen = common.load(Generator(
            GeneratorDef(cfg["gan"]["z_dim"], img["channels"], cfg["gan"]["features_g"]),
            device="meta"), state_dicts["gen"], device)
        a = cfg["assessor"]
        self.cnn = common.load(ResNet(
            ResNetDef(a["model_name"], img["channels"], a["n_class"]), device="meta"),
            state_dicts["assessor"], device)
        self.hp = common.pso_config(cfg)
        dtype, self.context = common.precision(precision)
        f = cfg["fitness"]
        self.run = make_batched_discovery_runner(
            self.hp, control=f["control"], threshold=f["threshold"], eps=f["eps"],
            dtype=dtype, device=device)

    def call(self, inputs: dict, record: dict | None = None) -> dict:
        init = state_from_positions(inputs["positions"], inputs["velocities"],
                                    self.hp.w_inertia)
        with common.capture(record, gen=self.gen, assessor=self.cnn), self.context():
            final, history, _ = self.run(self.gen, self.cnn, inputs["classes"],
                                         init_state=init, r1=inputs["r1"], r2=inputs["r2"])
        return common.to_host(final, history)
