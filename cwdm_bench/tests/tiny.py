"""A tiny configuration of a cell for runs on the CPU: the production
family at 32 channels, two levels, one ResBlock a level, on 48×48×30
phantoms (a 16³ latent)."""

import copy
import json
from pathlib import Path

from cwdm_bench import harness

ROOT = Path(__file__).resolve().parents[2]


def config(name: str) -> dict:
    with open(ROOT / "cwdm_bench" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["model"].update(num_channels=32, channel_mult="1,2", num_res_blocks=1)
    cfg["geometry"] = {"raw": [48, 48, 30], "crop_xy": 8, "pad_z": 32, "crop_z": 30}
    return cfg


def traffic(workload: str) -> dict:
    return dict(harness.load_cell(workload)["traffic"], cases=3)


def run(workload: str, config_name: str, seed: int = 2**31 + 17, seconds: float = 1.0,
        trace: bool = False) -> dict:
    """The cell on the CPU at the tiny size, with ``config_name``'s file."""
    return harness.run_cell(workload, seed, seconds, trace, device="cpu",
                            config=config(config_name), traffic=traffic(workload))
