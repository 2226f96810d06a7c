"""The port's measurement probes against the Pallas kernels they replace.

On the CPU the port's wrappers run their plain versions; those are held
against verbatim transcriptions of the TPU kernels, run in interpret
mode, on the same numpy inputs:

  * K3 ``stream_saddle`` vs ``stream_kernel``/``stream_once`` of
    tools/profile_matvec.py:159-188, on the bowl3D(0.35, 0.5, nz=3)
    dof tables (default, bucketed window plan);
  * K4 ``stream_probe`` vs ``kernel``/``once`` of
    tools/profile_stream.py:52-79, at 1140 x 1024 cells;
  * K1 pinned (``saddle_matvec(..., pinned=True)``) vs
    ``window.saddle_matvec`` with ``_tensor_spec`` pinned to block 0 as
    tools/profile_matvec.py:203-211 patches it, on an unbucketed plan
    (block 0 holds cells 0-127).

Bars: K3 and K4 write float32 (the TPU kernels' out_shape) whatever the
input type, and both sides sum in their own order, so 2e-6 of each
lane's sum of |values| (plus |carry| or |w0|); K1 pinned as
tests/test_torch_kernels.py, f64 1e-12 and f32 2e-6 max|y|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import nupgcm_tpu as npj
from nupgcm_tpu.ops import window as W
from nupgcm_tpu_torch.ops import kernels as K

LANE_BAR = 2e-6
BARS = {"float64": 1e-12, "float32": 2e-6}


@pytest.fixture(scope="module")
def fe():
    mesh = npj.generators.bowl3D(0.35, 0.5, nz=3)
    spaces = npj.Spaces(mesh, u_diri_tags=[], u_diri_vals=[],
                        b_diri_tags=[], b_diri_vals=[])
    return npj.FEData(mesh, spaces)


def _saddle_tensors(fe, dtype, seed):
    rng = np.random.default_rng(seed)
    nc = fe.n_cells_padded
    nlu, nlp = fe.cd_u.shape[1], fe.cd_p.shape[1]
    return [rng.standard_normal(s).astype(dtype) for s in
            ((nc, 3 * nlu, 3 * nlu), (nc, 3 * nlu, nlp), (nc, nlp, 3 * nlu))]


# --- tools/profile_matvec.py:159-188, verbatim but for interpret=True and
# the cast of the last store to the output type: a no-op in float32, and
# float64 inputs (which the TPU, running float32, never saw) would
# otherwise store a float64 value into the float32 carry, which Pallas
# refuses
def stream_kernel(w0u_ref, w0p_ref, c_ref, uu_ref, up_ref, pu_ref, o_ref):
    b = pl.program_id(0)

    @pl.when(b == 0)
    def _():
        o_ref[:] = c_ref[:]

    acc = (jnp.sum(uu_ref[0], axis=0, keepdims=True)
           + jnp.sum(up_ref[0], axis=0, keepdims=True)
           + jnp.sum(pu_ref[0], axis=0, keepdims=True))
    o_ref[:] = (o_ref[:] + 1e-30 * acc).astype(o_ref.dtype)


def stream_once(plan, carry, uu_b, up_b, pu_b):
    nlu3 = 3 * plan.nlu
    w0u, w0p = plan.device_arrays()[0], plan.device_arrays()[1]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(plan.nb,),
        in_specs=[
            pl.BlockSpec((1, plan.B), lambda b, *_: (0, 0)),
            pl.BlockSpec((1, nlu3 * nlu3, plan.B), lambda b, *_: (b, 0, 0)),
            pl.BlockSpec((1, nlu3 * plan.nlp, plan.B), lambda b, *_: (b, 0, 0)),
            pl.BlockSpec((1, plan.nlp * nlu3, plan.B), lambda b, *_: (b, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, plan.B), lambda b, *_: (0, 0)))
    return pl.pallas_call(
        stream_kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((1, plan.B), jnp.float32),
        interpret=True,
    )(w0u, w0p, carry, uu_b, up_b, pu_b)


# --- tools/profile_stream.py:52-79, verbatim but for interpret=True
def probe_once(parts, w0, idx):
    nb = parts[0].shape[0]

    def kernel(w0_ref, *refs):
        t_refs = refs[:len(parts)]
        o_ref = refs[-1]
        b = pl.program_id(0)

        @pl.when(b == 0)
        def _():
            o_ref[:] = jnp.zeros_like(o_ref)

        acc = sum(jnp.sum(r[0], axis=0, keepdims=True)[:, :128]
                  for r in t_refs)
        o_ref[:] = o_ref[:] + acc + w0_ref[b].astype(jnp.float32)

    specs = [pl.BlockSpec((1, p.shape[1], 128), lambda b, *_: (b, 0, 0))
             for p in parts]
    specs += [pl.BlockSpec((1, 1, 1280), lambda b, *_: (b, 0, 0))
              for _ in idx]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(nb,),
        in_specs=specs,
        out_specs=pl.BlockSpec((1, 128), lambda b, *_: (0, 0)))
    return pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((1, 128), jnp.float32),
        interpret=True,
    )(w0, *parts, *idx)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_stream_saddle_matches_pallas_stream_kernel(fe, dtype):
    T = _saddle_tensors(fe, dtype, seed=5)
    carry = (1e-28 * np.random.default_rng(6).standard_normal((1, 128))).astype(np.float32)
    plan = W.build_window_plan(fe.cd_u, fe.cd_p, fe.spaces.u_space.ndof, fe.spaces.n_p)
    blocked = W.blocked_saddle_tensors(*map(jnp.asarray, T), plan)
    o_tpu = np.asarray(stream_once(plan, jnp.asarray(carry), *blocked))
    t = [torch.from_numpy(a) for a in T]
    o = K.stream_saddle(*t, torch.from_numpy(carry)).numpy()
    scale = K.stream_saddle_plain(*[a.abs() for a in t], torch.from_numpy(np.abs(carry)))
    assert o.shape == o_tpu.shape == (1, 128) and o.dtype == np.float32
    assert np.all(np.abs(o - o_tpu) <= LANE_BAR * scale.numpy())


@pytest.mark.parametrize("with_idx", [False, True], ids=["noidx", "idx"])
@pytest.mark.parametrize("B", [128, 512])
@pytest.mark.parametrize("n_inputs", [3, 1])
def test_stream_probe_matches_pallas_kernel(n_inputs, B, with_idx):
    rows, ncell = 1140, 1024
    nb = ncell // B
    rng = np.random.default_rng(7)
    row_counts = (900, 120, 120) if n_inputs == 3 else (rows,)
    parts = [rng.standard_normal((nb, r * B // 128, 128)).astype(np.float32)
             for r in row_counts]
    idx = ([rng.integers(-50, 50, (nb, 1, 1280)).astype(np.int32) for _ in range(8)]
           if with_idx else [])
    w0 = rng.integers(0, 50, nb).astype(np.int32)
    o_tpu = np.asarray(probe_once([jnp.asarray(p) for p in parts], jnp.asarray(w0),
                                  [jnp.asarray(i) for i in idx]))
    o, chk = K.stream_probe([torch.from_numpy(p) for p in parts], torch.from_numpy(w0),
                            [torch.from_numpy(i) for i in idx] if with_idx else None)
    scale = sum(np.abs(p).sum((0, 1)) for p in parts) + np.abs(w0).sum()
    assert o.shape == (1, 128) and o.dtype == torch.float32
    assert np.all(np.abs(o.numpy() - o_tpu) <= LANE_BAR * scale)
    if with_idx:
        assert int(chk) == sum(int(i.astype(np.int64).sum()) for i in idx)
    else:
        assert chk is None


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pinned_saddle_matches_pallas_pinned_blocks(fe, monkeypatch, dtype):
    uu, up, pu = _saddle_tensors(fe, dtype, seed=8)
    sp = fe.spaces
    n, n_p = sp.u_space.ndof, sp.n_p
    x = np.random.default_rng(9).standard_normal(3 * n + n_p).astype(dtype)
    plan = W.build_window_plan(fe.cd_u, fe.cd_p, n, n_p, bucketed=False)
    assert plan.bperm is None and plan.nb > 1
    uu_b, up_b, pu_b = W.blocked_saddle_tensors(jnp.asarray(uu), jnp.asarray(up),
                                                jnp.asarray(pu), plan)
    monkeypatch.setattr(W, "_INTERPRET", True)
    monkeypatch.setattr(W, "_tensor_spec", lambda rows, B, off=0: pl.BlockSpec(
        (1, rows, B), lambda b, *_: (0, 0, 0)))
    y_tpu = np.asarray(W.saddle_matvec(uu_b[:1], up_b[:1], pu_b[:1], jnp.asarray(x),
                                       plan, "full"))
    y = K.saddle_matvec(torch.from_numpy(uu[:128]), torch.from_numpy(up[:128]),
                        torch.from_numpy(pu[:128]), None,
                        torch.from_numpy(fe.cd_u.astype(np.int32)),
                        torch.from_numpy(fe.cd_p.astype(np.int32)),
                        torch.from_numpy(x), "full", n, pinned=True).numpy()
    assert y.shape == y_tpu.shape
    assert np.abs(y - y_tpu).max() <= BARS[dtype] * np.abs(y_tpu).max()
    # pinning changes the operator: the production kernel disagrees
    y_full = K.saddle_matvec_plain(*map(torch.from_numpy, (uu, up, pu)), None,
                                   torch.from_numpy(fe.cd_u.astype(np.int32)),
                                   torch.from_numpy(fe.cd_p.astype(np.int32)),
                                   torch.from_numpy(x), "full", n).numpy()
    assert np.abs(y_full - y_tpu).max() > 1e-3 * np.abs(y_tpu).max()


def test_probe_wrappers_count_plain_calls_and_refuse_other_devices():
    K.reset_counts()
    t = torch.zeros((2, 4, 4))
    K.stream_saddle(t, t, t, torch.zeros((1, 128)))
    K.stream_probe([torch.zeros((1, 1, 128))], torch.zeros(1, dtype=torch.int32))
    assert K.plain_calls["stream_saddle"] == 1 and K.plain_calls["stream_probe"] == 1
    assert all(v == 0 for v in K.launches.values())
    m = torch.zeros((2, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.stream_saddle(m, m, m, torch.zeros((1, 128), device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.stream_probe([torch.zeros((1, 1, 128), device="meta")],
                       torch.zeros(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="pinned runs mode 'full' only"):
        K.saddle_matvec(m, None, None, None, None, None, torch.zeros(3), "uu", 1,
                        pinned=True)
