"""The yardstick's counts: model FLOP on the reference equal the program's
model at the cells' shapes, and the kernels' work at known shapes."""

import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT
from port_bench.work import flops
from port_bench.work.kernels import bound_us, rescale_work, swarm_update_work

from gan_discovery_pso_tpu_torch.models import (
    Encoder, EncoderDef, Generator, GeneratorDef, ResNet, ResNetDef)


def config(name: str) -> dict:
    return json.loads((ROOT / "port_bench" / "configs" / f"{name}.json").read_text())


def program_flops(model, x) -> int:
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.eval()(x)
    return counter.get_total_flops()


def test_reference_counts_equal_the_programs():
    cfg = config("dcgan_z10-resnet50.discovery")
    rows = flops.per_row(cfg)
    assert rows == {"gen": 13_371_904, "assessor": 155_894_272}
    assert rows["gen"] + rows["assessor"] == 169_266_176
    meta = {"device": "meta"}
    assert program_flops(Generator(GeneratorDef(10, 1, 64), **meta),
                         torch.zeros(1, 10, 1, 1, **meta)) == rows["gen"]
    assert program_flops(ResNet(ResNetDef("ResNet50", 1, 8), **meta),
                         torch.zeros(1, 1, 28, 28, **meta)) == rows["assessor"]
    inv = config("dcgan_z10-resnet50.inverter")
    rows = flops.per_row(inv)
    assert program_flops(Encoder(EncoderDef(10, 1, 64), **meta),
                         torch.zeros(1, 1, 28, 28, **meta)) == rows["encoder"]
    assert program_flops(ResNet(ResNetDef("ResNet50", 1, 2), **meta),
                         torch.zeros(1, 1, 28, 28, **meta)) == rows["assessor"]
    assert flops.call_flops(inv, 10, 2) == 10 * (rows["gen"] + rows["assessor"]) \
        + 2 * rows["encoder"]


def test_kernel_work_at_the_cells_shapes():
    # B1 at [8, 32, 10] with no particle improved: inputs then outputs
    nbytes, ops = swarm_update_work(8, 32, 10, 0)
    assert nbytes == 4 * (3 * 2560 + 4 * 256 + 80 + 24) + 4 * (3 * 2560 + 256 + 80 + 16) + 8
    assert ops == 10 * 2560 + 2 * 256
    assert swarm_update_work(8, 32, 10, 5)[0] == nbytes - 4 * 5 * 10
    # B2 over 256 images of 784 pixels, fp32 out: 1.6 MB, bound by bytes
    nbytes, ops = rescale_work(256, 784, 4)
    assert (nbytes, ops) == (8 * 256 * 784, 6 * 256 * 784)
    assert abs(bound_us(nbytes, ops) - nbytes / 3.35e12 * 1e6) < 1e-12
