"""Seconds of the program's build, the sum of its top-level ``build.*``
spans (the mesh, the spaces, the FE tables, the kernels' load, the
model's constants and operators), as the program recorded them before
the window."""

TOP = ("build.mesh", "build.spaces", "build.fedata", "build.kernels", "build.constants",
       "build.operators")


def read(rec):
    b = (rec.get("program") or {}).get("build")
    if not b:
        return None
    return sum(b[k]["total_s"] for k in TOP if k in b)
