"""The plain reference against tiny cases of each configuration, and the
controls one precision below it failing where the program passes."""

import numpy as np
import pytest
import torch

from slatebench import gen
from slatebench.reference import dense

from .conftest import SEED, cells_of


def test_hpl_residual_passes_an_f64_solve_and_fails_an_f32_one():
    n = 192
    A = torch.empty((n, n), dtype=torch.float64)
    b = torch.empty((n, 1), dtype=torch.float64)
    gen.hpl_fill(A, b, torch.Generator(), SEED, 0)
    assert float(A.min()) >= -0.5 and float(A.max()) < 0.5
    x = torch.from_numpy(np.linalg.solve(A.numpy(), b.numpy()))
    assert dense.hpl_scaled_residual(A, x, b) < 1.0
    assert dense.hpl_scaled_residual(A, dense.solve_f32(A, b), b) > 1e3
    x_bad = x.clone()
    x_bad[0] += 1e-9 * float(x.abs().max())
    assert dense.hpl_scaled_residual(A, x_bad, b) > 16.0


def test_hpl_fill_is_the_same_for_a_seed_and_differs_by_solve():
    A1, b1, A2, b2 = (torch.empty(s, dtype=torch.float64)
                      for s in ((64, 64), (64, 1), (64, 64), (64, 1)))
    g = torch.Generator()
    gen.hpl_fill(A1, b1, g, SEED, 3)
    gen.hpl_fill(A2, b2, g, SEED, 3)
    assert torch.equal(A1, A2) and torch.equal(b1, b2)
    gen.hpl_fill(A2, b2, g, SEED, 4)
    assert not torch.equal(A1, A2)


@pytest.mark.parametrize("routine", ["gesv", "posv", "gels"])
def test_served_reference_solves_and_the_tf32_control_misses(routine):
    g = torch.Generator().manual_seed(5)
    a, b = gen.make_operands(routine, 48, 4, 1, torch.float32, g,
                             torch.device("cpu"))
    a, b = a[0].numpy(), b[0].numpy()
    ref = dense.solve_f64(routine, a, b)
    if routine == "gels":
        r = a.astype(np.float64).T @ (a.astype(np.float64) @ ref - b)
        assert np.abs(r).max() < 1e-9
    else:
        assert np.abs(a.astype(np.float64) @ ref - b).max() < 1e-9
    x32 = np.linalg.lstsq(a, b, rcond=None)[0] if routine == "gels" \
        else np.linalg.solve(a, b)
    assert dense.rel_gap(x32, ref) < 1e-5
    assert dense.rel_gap(dense.solve_tf32(routine, a, b), ref) > 1e-4
    assert dense.rel_gap(x32 * np.nan, ref) == float("inf")


def test_tf32_keeps_ten_mantissa_bits():
    x = np.array([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -3.0], dtype=np.float32)
    t = dense.tf32(x)
    assert t[0] == np.float32(1.0 + 2.0 ** -10)
    assert t[1] == np.float32(1.0)
    assert t[2] == np.float32(-3.0)


def test_the_generator_gives_every_seed_the_same_work():
    t = {"routines": ["gesv", "gels"], "dims": [8, 13], "nrhs": [1, 4],
         "rate_per_s": 100, "operands": "host"}
    r1 = gen.Requests(t, 2.0, 1, torch.float32, torch.device("cpu"))
    r2 = gen.Requests(t, 2.0, 2 ** 33 + 7, torch.float32, torch.device("cpu"))
    assert len(r1) == len(r2) == 200
    assert sorted(r1.kind.tolist()) == sorted(r2.kind.tolist())
    assert not np.array_equal(r1.kind, r2.kind)
    assert np.allclose(np.sort(np.diff(r1.due, prepend=0.0)),
                       np.sort(np.diff(r2.due, prepend=0.0)))
    assert abs(r1.due[-1] - 2.0) < 1e-12
    r3 = gen.Requests(t, 2.0, 1, torch.float32, torch.device("cpu"))
    assert np.array_equal(r1.operands(17)[0], r3.operands(17)[0])


@pytest.mark.parametrize("side", ["program", "control"])
def test_control_readings_on_tiny_cells(tiny_root, bench, side):
    """The program passes every limit and the control fails one, in each
    cell, at a size the CPU holds (the chip reads both at the cells' own
    sizes with ``slatebench/control.py``)."""
    from slatebench import run as runner
    from slatebench.cells import Cell

    for name in [w["name"] for w in bench["workloads"]]:
        cell = Cell(bench, name, tiny_root)
        kw = cell.entry().control_options() if side == "control" else None
        run, res = runner.execute(name, SEED + 1, 0.3, False, device="cpu",
                                  root=tiny_root, entry_kw=kw)
        if side == "program":
            assert res["correct"], (name, res["checks"])
        elif name in cells_of(bench, "dense_solve"):
            assert not res["correct"], (name, res["checks"])
        else:
            assert run.control_gap > res["checks"]["gap_max"]["limit"], name
