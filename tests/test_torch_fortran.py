"""The Fortran bindings over the port's C API: ``tools/fortran/slate_tpu.f90``
(generated from ``include/slate_tpu.h``, read in place) links against the
port's library unchanged, because the library exports every symbol the
module binds.  Mirrors ``tests/test_fortran.py``: the compiled smoke program
and example run only where a Fortran compiler exists (none on this image, so
they skip); the symbol checks run everywhere."""

import os
import re
import shutil
import subprocess

import pytest

from slate_tpu_torch import c_api

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = os.path.join(ROOT, "tools", "fortran", "slate_tpu.f90")


@pytest.fixture(scope="module")
def lib_path():
    return c_api.build()


@pytest.fixture(scope="module")
def exported(lib_path):
    nm = subprocess.run(["nm", "-D", "--defined-only", lib_path], capture_output=True,
                        text=True, timeout=60, check=True).stdout
    return {line.split()[-1] for line in nm.splitlines() if " T " in line}


def bound_names():
    """The C names of the module's ``bind(c, name=...)`` interfaces (a
    declaration may continue over an ``&`` line break)."""
    with open(MODULE) as f:
        return re.findall(r'bind\(c,\s*&?\s*name="(\w+)"\)', f.read())


def test_every_bound_symbol_resolves(exported):
    names = bound_names()
    assert len(names) == len(set(names)) == 59
    assert set(names) <= exported, sorted(set(names) - exported)


def test_module_binds_the_whole_header():
    """Every declaration of the header has its interface, so nothing the C
    API offers is out of a Fortran caller's reach."""
    assert set(bound_names()) == set(c_api.signatures())


@pytest.fixture
def fortran(lib_path, tmp_path):
    """``fortran(program)``: the module and ``program`` compiled and linked
    against the port's library; skips without a Fortran compiler."""
    fc = next((c for c in ("gfortran", "flang", "ifort") if shutil.which(c)), None)
    if fc is None:
        pytest.skip("no Fortran compiler")
    lib_dir = os.path.dirname(lib_path)

    def build(program):
        exe = str(tmp_path / os.path.splitext(os.path.basename(program))[0])
        out = subprocess.run([fc, MODULE, program, "-J", str(tmp_path), "-L", lib_dir,
                              f"-l{os.path.basename(lib_path)[3:-3]}",
                              f"-Wl,-rpath,{lib_dir}", "-o", exe],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        return exe
    return build


@pytest.mark.parametrize("program,marker", [
    (os.path.join("tools", "fortran", "smoke.f90"), "FORTRAN PASS"),
    (os.path.join("examples", "fortran", "ex05_blas.f90"), "ex05 OK")])
def test_fortran_program(fortran, program, marker):
    exe = fortran(os.path.join(ROOT, program))
    run = subprocess.run([exe], capture_output=True, text=True, timeout=300,
                         env=dict(c_api.child_env("cpu"), OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert marker in run.stdout
