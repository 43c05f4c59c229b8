"""A cell at a size a CPU test holds: 12x12 (or ``res``), a few iterations a
job, the mesh tiers' plain version with the card's winner table (the CPU
would otherwise take the chunked stream and the exact table)."""

import torch

from rtbench import run

SHIP_OPTIONS = dict(antialiasing=True, megakernel=True, mesh_pallas=True, winner_table="oct",
                    mesh_sort="need")


def overrides(workload: str, iterations: int = 2) -> dict:
    out = dict(ITERATIONS=iterations, host_threads=2)
    if workload.startswith("cornellShipTex"):
        out["options"] = SHIP_OPTIONS
    return out


def tiny_run(workload, seed=2**31 + 5, seconds=0.2, trace=False, res=12, **kw):
    torch.set_num_threads(2)
    return run.run_cell(workload, seed, seconds, trace, device="cpu", resolution=(res, res),
                        overrides=overrides(workload, kw.pop("iterations", 2)), **kw)
