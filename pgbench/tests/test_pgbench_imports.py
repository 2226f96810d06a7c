"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program either.  Each check runs
in a fresh interpreter and compares whole top-level module names (the
port's name begins with the JAX package's)."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = ["jax", "jaxlib", "flax", "nupgcm_tpu"]


def top_level_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def all_modules() -> list:
    base = ROOT / "pgbench"
    mods = []
    for p in sorted(base.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts or rel.parts[1] == "metrics":
            continue
        mods.append(".".join(p for p in rel.parts if p != "__init__"))
    return mods


def test_a_whole_small_run_loads_no_jax():
    code = ("from pgbench import run\nfrom pgbench.tests.small import small\n"
            "import io\n"
            "cfg, tr = small('bowl_full_54k', 'closures', advance=2)\n"
            "tr.update(segment_steps=3, refresh_every=2)\n"
            "a = run.parse(['--workload', 'bowl870k-spinup', '--seed', '3', '--seconds', '0.2'])\n"
            "assert run.run(a, device='cpu', cfg=cfg, traffic=tr, out=io.StringIO()) == 0\n"
            "from pgbench import spec\n"
            "b = spec.benchmark()\n"
            "for m in b['end_to_end'] + b['per_layer']: spec.reader(m['name'])\n")
    names = top_level_after(code)
    assert "nupgcm_tpu_torch" in names          # the system under test is loaded ...
    assert not names & set(FORBIDDEN)           # ... and JAX is not


def test_every_benchmark_module_loads_no_jax():
    names = top_level_after("\n".join(f"import {m}" for m in all_modules()))
    assert not names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = top_level_after("import pgbench.reference.pg_bowl, pgbench.judge")
    assert not names & set(FORBIDDEN + ["nupgcm_tpu_torch"])


def test_the_run_refuses_a_process_that_loaded_jax():
    from pgbench import run

    sys.modules["jax"] = type(sys)("jax")
    try:
        assert run.loaded_forbidden() == ["jax"]
    finally:
        del sys.modules["jax"]
    assert "nupgcm_tpu" not in run.loaded_forbidden()
