"""Small versions of the benchmark's cells for the tests."""

import copy
import json
import pathlib

from pgbench import spec

CELLS = ("bowl870k-spinup", "bowl870k-northstar-settled")
# figures of the small meshes, made by the JAX package's generator
FIGURES = json.loads((pathlib.Path(__file__).parent / "mesh_figures.json").read_text())


def small(name, traffic=None, h=0.25, nz=3, advance=None):
    """(cfg, traffic) of a cell (``name``), or of a configuration file and
    a traffic mix by their names, on a coarse bowl (the physics, solver,
    limits and segment kept; ``advance`` caps the set-up's steps)."""
    if traffic is None:
        bench = spec.benchmark()
        cell = spec.cell(bench, name)
        cfg = copy.deepcopy(spec.config(bench, cell["config"]))
        traffic = cell["traffic"]
    else:
        cfg = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
    cfg["mesh"].update(h=h, nz=nz, figures=FIGURES[f"{h},{nz}"])
    traffic = copy.deepcopy(spec.traffic(traffic))
    if advance is not None:
        traffic["advance_steps"] = min(traffic["advance_steps"], advance)
    return cfg, traffic
