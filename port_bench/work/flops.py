"""Model operations of a configuration, counted on the plain reference
models at the cell's shapes by `torch.utils.flop_counter` (convolutions and
matrix products, 2 per multiply-add; BatchNorm, activations and pools are
not counted). Counted on the "meta" device: nothing is computed."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference import models


def per_row(cfg: dict) -> dict:
    """{role: FLOP of one row's forward}: "gen" from one latent, the
    assessor and the encoder from one image."""
    img = cfg["image"]
    out = {}
    for role, model in models.build(cfg, "meta").items():
        x = (torch.zeros(1, cfg["gan"]["z_dim"], device="meta") if role == "gen"
             else torch.zeros(1, img["channels"], img["size"], img["size"], device="meta"))
        with FlopCounterMode(display=False) as counter:
            model(x)
        out[role] = counter.get_total_flops()
    return out


def call_flops(cfg: dict, evals: int, encoded: int = 0) -> int:
    """FLOP of one call: a generator and an assessor forward per fitness
    evaluation, an encoder forward per encoded image."""
    rows = per_row(cfg)
    return evals * (rows["gen"] + rows["assessor"]) + encoded * rows.get("encoder", 0)
